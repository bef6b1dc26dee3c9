"""Runners of a cell, one a configuration kind (its ``kind`` field)."""
