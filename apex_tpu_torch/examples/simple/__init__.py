"""The JAX package's examples/simple example, ported."""
