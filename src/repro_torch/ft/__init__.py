"""Fault injection for the port (a copy of the reference registry)."""
