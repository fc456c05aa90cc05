"""cli (see the package docstring)."""
