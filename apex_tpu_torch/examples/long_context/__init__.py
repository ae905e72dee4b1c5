"""Long-context examples."""
