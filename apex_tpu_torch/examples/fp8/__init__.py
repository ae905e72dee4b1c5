"""The FP8 delayed-scaling example."""
