"""core (see the package docstring)."""
