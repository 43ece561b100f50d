"""Part of the frozen reference copy (see the package docstring)."""
