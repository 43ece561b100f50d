"""Data of the port."""
