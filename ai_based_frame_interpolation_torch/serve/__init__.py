"""Serving of the port (the request batcher; HTTP comes later)."""
