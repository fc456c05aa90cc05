"""data (see the package docstring)."""
