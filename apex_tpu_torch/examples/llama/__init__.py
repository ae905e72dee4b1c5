"""Llama examples."""
