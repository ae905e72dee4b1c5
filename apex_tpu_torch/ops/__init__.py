"""Ops with hand-written CUDA kernels and their plain PyTorch versions:
``ops.layer_norm`` (``layer_norm``, ``rms_norm``) and ``ops.attention``
(``flash_attention``, ``causal_mask``, ``window_mask``), both
differentiable through their backward kernels; ``ops.rope`` (rotary
positions, plain PyTorch, as XLA fuses them in the JAX package);
``ops.xentropy`` (softmax cross-entropy with label smoothing, plain
PyTorch); ``ops.softmax`` (the scaled, masked softmax family that
BERT's unfused attention runs, plain PyTorch in fp32);
``ops.multi_tensor`` (flat buffers of a parameter collection and the
``multi_tensor_*`` functional ops, whose sum of squares is kernel #9 on
the card); and ``ops.mlp`` and ``ops.fused_dense`` (GEMM chains with an
fp32 result, plain PyTorch). The functions are not
re-exported here, so that ``ops.layer_norm`` stays the module."""
