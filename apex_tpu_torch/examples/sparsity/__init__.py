"""The JAX package's examples/sparsity example, ported."""
