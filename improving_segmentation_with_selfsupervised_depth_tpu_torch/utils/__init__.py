"""Shared utilities of the port: seeding, filesystem glob, logging, the
phase spans of the host's work (`spans.py`)."""
