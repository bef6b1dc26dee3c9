"""Data makers, one a configuration generator (its ``generator``)."""
