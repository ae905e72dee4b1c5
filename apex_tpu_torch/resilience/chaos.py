"""Fault injection (counterpart of apex_tpu/resilience/chaos.py): only
``poison_loss`` so far, the NaN that the training step's gate must catch.
"""

import torch

__all__ = ["poison_loss"]


def poison_loss(loss, armed):
    """``loss * NaN`` when ``armed`` is truthy, identity otherwise.

    Multiplicative (``loss + NaN`` would leave the gradients finite), so
    the loss and every gradient through it go non-finite, like a real
    blowup. ``armed`` may be a number or a 0-d tensor on any device; it
    is not read on the host.
    """
    armed = torch.as_tensor(armed, device=loss.device).bool()
    return loss * torch.where(armed, float("nan"), 1.0)
