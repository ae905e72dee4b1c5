"""``apex.multi_tensor_apply`` import surface (counterpart of
apex_tpu/multi_tensor_apply.py): ``MultiTensorApply``, a
constructor-compatible class, and ``multi_tensor_applier``, its
module-level instance, as the reference has them (code gates on
``multi_tensor_applier.available``). The ops live in
``ops.multi_tensor``; the chunk size is recorded and sizes nothing: the
ported ops run per leaf or over a flat buffer of their own."""

from apex_tpu_torch.ops.multi_tensor import CHUNK_SIZE
from apex_tpu_torch.ops.multi_tensor import multi_tensor_applier as _apply

__all__ = ["MultiTensorApply", "multi_tensor_applier"]


class MultiTensorApply:
    """``MultiTensorApply(chunk_size)``: calling it applies ``op`` with the
    reference's convention, ``op(noop_flag, tensor_lists, *args)``."""

    available = True

    def __init__(self, chunk_size: int = CHUNK_SIZE):
        self.chunk_size = chunk_size

    def __call__(self, op, noop_flag, tensor_lists, *args):
        return _apply(op, noop_flag, tensor_lists, *args)


multi_tensor_applier = MultiTensorApply(CHUNK_SIZE)
