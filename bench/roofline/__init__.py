"""Peaks of the card and the work of each kernel's call, from its shapes."""
