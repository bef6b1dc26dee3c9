"""Small numeric helpers."""
