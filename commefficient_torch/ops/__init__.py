"""Compression core of the port: count sketch, top-k, flat layouts."""
