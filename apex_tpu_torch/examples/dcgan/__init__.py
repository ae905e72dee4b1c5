"""The JAX package's examples/dcgan example, ported."""
