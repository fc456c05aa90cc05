"""ops (see the package docstring)."""
