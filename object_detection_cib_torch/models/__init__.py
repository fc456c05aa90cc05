"""models (see the package docstring)."""
