"""Shared utilities of the port: seeding, filesystem glob, logging."""
