"""The state of O1's cast engine that the ops read, and the decorators
they wear (``amp.cast_engine`` builds the engine on it).

A leaf: it imports torch and ``utils.pytree`` only, so the ops layer
(``ops.layer_norm``, ``ops.attention``, ``ops.softmax``, ``ops.mlp``)
can wear :func:`casts_disabled` and :func:`half_function` without
importing the amp front end, whose ``GradScaler`` imports the parallel
package, which imports the ops.
"""

import contextlib
import functools
import threading

import torch

from apex_tpu_torch.utils.pytree import map_floats

__all__ = ["HALF_DTYPES", "casts_disabled", "disable_casts",
           "half_function", "state", "to_half"]

HALF_DTYPES = (torch.float16, torch.bfloat16)


class _State:
    """Process-wide: the nesting depth, the ``disable_casts`` count, the
    active half dtype, the patched attributes and the active mode."""

    def __init__(self):
        self.depth = 0
        self.disabled = 0
        self.half_dtype = None
        self.saved = []  # [(namespace, name, original)]
        self.mode = None
        self.lock = threading.RLock()


state = _State()


def to_half(half_dtype, counter=None):
    """The half dtype is bound when the wrapper is made, not read from
    ``state`` at call time, which another thread's exit may clear."""

    def convert(x):
        if x.dtype != torch.float32:
            return x
        if counter is not None:
            counter.casts += 1
        return x.to(half_dtype)

    return convert


def half_function(fn):
    """Decorator: ``fn`` with its floating args cast to the active half
    dtype whenever a context is active (ref amp.py:33-35)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        half_dtype = state.half_dtype
        if state.depth == 0 or half_dtype is None:
            return fn(*args, **kwargs)
        args, kwargs = map_floats(to_half(half_dtype), (args, kwargs))
        return fn(*args, **kwargs)

    wrapper.__wrapped_by_apex_tpu_torch_amp__ = True
    return wrapper


@contextlib.contextmanager
def disable_casts():
    """No casts inside an active region (ref apex.amp.disable_casts); a
    count of its own, so a ``cast_ops`` entered inside neither pushes a
    second mode nor takes the outer region's down on its exit."""
    with state.lock:
        state.disabled += 1
    try:
        yield
    finally:
        with state.lock:
            state.disabled -= 1


def casts_disabled(fn):
    """Decorator: ``fn`` under :func:`disable_casts` when a context is
    active, a plain call otherwise (no context manager on the common
    path)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if state.depth == 0:
            return fn(*args, **kwargs)
        with disable_casts():
            return fn(*args, **kwargs)

    return wrapper
