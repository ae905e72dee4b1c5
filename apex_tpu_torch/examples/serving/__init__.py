"""Serving example."""
