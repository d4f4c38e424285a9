"""Serving: one query image to top-k database images."""
