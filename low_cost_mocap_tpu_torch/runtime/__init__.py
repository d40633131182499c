"""Serving runtime: frame sources and the engine."""
