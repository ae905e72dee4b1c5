"""GPT examples."""
