"""Indexed 2-D multiply, OpenFold's hot op (counterpart of
apex_tpu/contrib/index_mul_2d.py; ref: apex.contrib.index_mul_2d).

``out[i, :] = in1[idx[i], :] * in2[i, :]``: a gather and a multiply in
plain torch (the JAX package leaves them to XLA, with no Pallas kernel).
Autograd gives the backward (a scatter-add into ``in1``) and, with
``create_graph=True``, the double backward that the reference writes by
hand."""

__all__ = ["index_mul_2d"]


def index_mul_2d(in1, in2, idx1):
    """in1: (M, H), in2: (N, H), idx1: (N,) int; returns (N, H)."""
    if in1.dim() != 2 or in2.dim() != 2:
        raise ValueError("in1 and in2 must be 2-dimensional")
    if idx1.dim() != 1 or idx1.shape[0] != in2.shape[0]:
        raise ValueError("idx1 must be 1-D with len(idx1) == in2.shape[0]")
    return in1.index_select(0, idx1.long()) * in2
