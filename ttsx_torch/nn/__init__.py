"""Layers of the port, channels-last [B, T, C] like ``ttsx.nn``."""
