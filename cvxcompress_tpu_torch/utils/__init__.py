"""Container IO helpers."""
