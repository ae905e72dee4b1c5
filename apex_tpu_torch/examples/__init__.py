"""Runnable examples of the port (``python -m apex_tpu_torch.examples...``)."""
