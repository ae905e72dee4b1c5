"""Registered in-step metric taps (counterpart of
apex_tpu/monitor/taps.py).

Every tap the port's layers keep for :func:`~apex_tpu_torch.monitor.
taps_from_intermediates` to read has a row here, under the JAX package's
tap name: a tap renamed or dropped by a refactor shows as a missing row
in a test, not as a flat dashboard weeks later.
"""

#: tap name -> (where it is kept, what the value means)
REGISTERED_TAPS = {
    "moe_aux_loss": (
        "transformer/moe.py MoEMLP.aux_loss: the load-balancing auxiliary "
        "loss of each MoE layer's last forward, BEFORE the "
        "moe_aux_loss_coeff weighting"
    ),
    "layer_out_rms": (
        "transformer/layer.py ParallelTransformerLayer.layer_out_rms (when "
        "TransformerConfig.collect_layer_metrics): fp32 RMS of the layer's "
        "output hidden states, the per-layer activation-scale series the "
        "replay flight recorder (resilience/replay/targets.py) stacks "
        "into a (layers,) vector"
    ),
}

#: the module attribute each tap is kept in
TAP_ATTRIBUTES = {"moe_aux_loss": "aux_loss", "layer_out_rms": "layer_out_rms"}

__all__ = ["REGISTERED_TAPS", "TAP_ATTRIBUTES"]
