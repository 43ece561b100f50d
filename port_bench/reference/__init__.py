"""The plain reference and its driver (see segsde/__init__.py)."""
