"""The JAX package's examples/imagenet example, ported."""
