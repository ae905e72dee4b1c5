"""The JAX package's examples/multihead_attn example, ported."""
