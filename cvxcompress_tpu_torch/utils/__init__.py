"""Container file IO and synthetic volumes."""
