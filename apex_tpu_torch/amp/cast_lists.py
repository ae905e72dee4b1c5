"""Per-op cast lists for the O1 policy (counterpart of
apex_tpu/amp/cast_lists.py; the reference Apex's own lists are
apex/amp/lists/torch_overrides.py and functional_overrides.py).

- ``FP16_FUNCS``: tensor-core math (GEMMs and convolutions) runs in half;
- ``FP32_FUNCS``: the exp/log/trig/pow family and the reductions run in
  fp32;
- ``PROMOTE_FUNCS``: mixed half and fp32 inputs are promoted to fp32;
- ``SEQUENCE_CASTS``: the same for a sequence argument (``cat``,
  ``stack``).

Each entry is ``(namespace, name)``. The engine (``cast_engine``) runs
under a ``torch.overrides.TorchFunctionMode``, which sees a Tensor
method and an operator as functions of their own (``x.sum()`` is
``torch.Tensor.sum``, ``x @ w`` is ``torch.Tensor.__matmul__``), so a
list entry names its function, method and operator forms. In-place
forms (``add_``, ``__iadd__``) are not listed: a cast copy would take
the write.

``F.linear`` and the convolutions include the bias, so a layer's output
comes out half with no layer-level wrapper: the JAX package's
``FP16_MODULE_CALLS`` (flax layers whose bias add runs after the patched
dot) has no torch counterpart.
"""

import torch
import torch.nn.functional as F

T = torch.Tensor

FP16_FUNCS = [
    (F, "linear"),
    (F, "conv1d"), (F, "conv2d"), (F, "conv3d"),
    (F, "conv_transpose1d"), (F, "conv_transpose2d"), (F, "conv_transpose3d"),
    (torch, "matmul"), (T, "matmul"), (T, "__matmul__"), (T, "__rmatmul__"),
    (torch, "mm"), (T, "mm"),
    (torch, "bmm"), (T, "bmm"),
    (torch, "addmm"), (T, "addmm"),
    (torch, "baddbmm"), (T, "baddbmm"),
    (torch, "mv"), (T, "mv"),
    (torch, "dot"), (T, "dot"),
    (torch, "vdot"), (T, "vdot"),
    (torch, "inner"), (T, "inner"),
    (torch, "outer"), (T, "outer"),
    (torch, "tensordot"),
    (torch, "einsum"),
]

FP32_FUNCS = [
    (torch, "exp"), (T, "exp"),
    (torch, "expm1"), (T, "expm1"),
    (torch, "log"), (T, "log"),
    (torch, "log1p"), (T, "log1p"),
    (torch, "log2"), (T, "log2"),
    (torch, "log10"), (T, "log10"),
    (torch, "cosh"), (T, "cosh"),
    (torch, "sinh"), (T, "sinh"),
    (torch, "tan"), (T, "tan"),
    (torch, "acos"), (T, "acos"),
    (torch, "asin"), (T, "asin"),
    (torch, "reciprocal"), (T, "reciprocal"),
    (torch, "pow"), (T, "pow"), (T, "__pow__"), (T, "__rpow__"),
    (torch, "float_power"), (T, "float_power"),
    (torch, "cumprod"), (T, "cumprod"),
    (torch, "cumsum"), (T, "cumsum"),
    (torch, "prod"), (T, "prod"),
    (torch, "sum"), (T, "sum"),
    (torch, "std"), (T, "std"),
    (torch, "var"), (T, "var"),
    (torch, "norm"), (T, "norm"), (torch.linalg, "norm"),
    (torch, "rsqrt"), (T, "rsqrt"),
    (torch, "softmax"), (T, "softmax"), (F, "softmax"),
    (torch, "log_softmax"), (T, "log_softmax"), (F, "log_softmax"),
    (torch, "erfinv"), (T, "erfinv"),
    (torch, "logsumexp"), (T, "logsumexp"),
]

PROMOTE_FUNCS = [
    (torch, "add"), (T, "add"), (T, "__add__"), (T, "__radd__"),
    (torch, "sub"), (T, "sub"), (T, "__sub__"), (T, "__rsub__"),
    (torch, "mul"), (T, "mul"), (T, "__mul__"), (T, "__rmul__"),
    (torch, "div"), (T, "div"), (T, "__truediv__"), (T, "__rtruediv__"),
    (torch, "true_divide"), (T, "true_divide"),
    (torch, "atan2"), (T, "atan2"),
    (torch, "cross"), (T, "cross"), (torch.linalg, "cross"),
    (torch, "eq"), (T, "eq"), (T, "__eq__"),
    (torch, "ne"), (T, "ne"), (T, "__ne__"),
    (torch, "gt"), (T, "gt"), (T, "__gt__"),
    (torch, "ge"), (T, "ge"), (T, "__ge__"),
    (torch, "lt"), (T, "lt"), (T, "__lt__"),
    (torch, "le"), (T, "le"), (T, "__le__"),
    (torch, "maximum"), (T, "maximum"),
    (torch, "minimum"), (T, "minimum"),
    (torch, "where"), (T, "where"),
]

SEQUENCE_CASTS = [
    (torch, "cat"), (torch, "concat"), (torch, "stack"),
    (torch, "hstack"), (torch, "vstack"),
]
