"""O1's per-op cast engine (counterpart of apex_tpu/amp/cast_engine.py;
ref apex/amp/amp.py and wrap.py).

``cast_ops(half_dtype)`` is a context manager. On its outermost enter it
pushes a ``torch.overrides.TorchFunctionMode`` that casts the arguments
of every function of ``cast_lists`` before the call: fp32 floating
tensors to half for ``FP16_FUNCS``, half tensors to fp32 for
``FP32_FUNCS``, and, for ``PROMOTE_FUNCS`` and ``SEQUENCE_CASTS``, every
half tensor to fp32 when the floating tensors mix half and fp32 (which
torch alone does not do for a 0-d fp32 tensor). Integers, bools and
non-tensors pass through. The mode is not ``torch.autocast``: autocast
has no user registry, and its lists differ between the CPU and CUDA,
where this engine casts the same on both.

Inside a listed call the mode is off (torch runs ``__torch_function__``
with the mode popped), so a layer's own inner ops are not cast again.
Each cast is ``Tensor.to``, whose backward casts back, so every gradient
arrives in its input's dtype. The port's fused ops (``ops.layer_norm``,
``ops.attention.flash_attention``, ``ops.softmax``) run with the casts
disabled inside (:func:`casts_disabled`, which with the engine's state
lives in the leaf module ``apex_tpu_torch._cast_state``, so that the ops
need not import this package), as the JAX package's run as
whole kernels under its patched namespace: their output dtypes do not
depend on whether the CPU or the CUDA path ran.

User registries (:func:`register_half_function` and its two siblings)
name an attribute of any namespace; the attribute is swapped for a
casting wrapper while a context is active and restored on the outermost
exit, as the JAX engine does. The latest registration of a name wins,
and a registration overrides the built-in lists for that function. The
decorators :func:`half_function`, :func:`float_function` and
:func:`promote_function` wrap one callable. :func:`disable_casts` turns
the casts off inside an active region.

The nesting count, the registries and the patches are process-wide, as
in JAX; torch keeps function modes per thread, so the list casts apply
in the thread that entered the outermost context.
"""

import contextlib
import functools
from typing import Callable, Dict

import torch
from torch.overrides import TorchFunctionMode

from apex_tpu_torch._cast_state import HALF_DTYPES as _HALF_DTYPES
from apex_tpu_torch._cast_state import casts_disabled, disable_casts, \
    half_function
from apex_tpu_torch._cast_state import state as _state
from apex_tpu_torch._cast_state import to_half as _to_half
from apex_tpu_torch.amp import cast_lists
from apex_tpu_torch.utils.pytree import map_floats

__all__ = ["cast_ops", "casts_disabled", "disable_casts", "float_function",
           "half_function", "promote_function", "register_float_function",
           "register_half_function", "register_promote_function"]


def _floats(obj, out):
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _floats(v, out)
    elif isinstance(obj, dict):
        for v in obj.values():
            _floats(v, out)
    return out


class _Counter:
    """Tensors cast while a context is active."""

    def __init__(self):
        self.casts = 0


def _to_float(counter=None):
    def convert(x):
        if x.dtype not in _HALF_DTYPES:
            return x
        if counter is not None:
            counter.casts += 1
        return x.float()

    return convert


def _cast_rule(convert):
    def rule(args, kwargs):
        return map_floats(convert, args), map_floats(convert, kwargs)
    return rule


def _promote_rule(counter=None):
    to_float = _to_float(counter)

    def rule(args, kwargs):
        dtypes = {x.dtype for x in _floats((args, kwargs), [])}
        if torch.float32 in dtypes and dtypes & set(_HALF_DTYPES):
            return map_floats(to_float, args), map_floats(to_float, kwargs)
        return args, kwargs

    return rule


class _CastMode(TorchFunctionMode):
    """Casts the arguments of the listed functions; ``table`` maps each
    function object to its rule, ``casts`` counts the tensors cast."""

    def __init__(self, table: Dict[Callable, Callable], counter: _Counter):
        super().__init__()
        self.table = table
        self.counter = counter

    @property
    def casts(self) -> int:
        return self.counter.casts

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = self.table.get(func)
        if rule is not None and not _state.disabled:
            args, kwargs = rule(args, kwargs)
        return func(*args, **kwargs)


# -- user registries (ref amp/amp.py:33-71) --------------------------------

_USER_FP16_REGISTRY = []
_USER_FP32_REGISTRY = []
_USER_PROMOTE_REGISTRY = []


def _make_cast_wrapper(orig, convert):
    """Cast the floating args with ``convert``, call (ref
    wrap.make_cast_wrapper); inactive outside a context or while
    disabled."""

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        if _state.depth == 0 or _state.disabled:
            return orig(*args, **kwargs)
        args, kwargs = map_floats(convert, (args, kwargs))
        return orig(*args, **kwargs)

    wrapper.__wrapped_by_apex_tpu_torch_amp__ = True
    return wrapper


def _make_promote_wrapper(orig):
    rule = _promote_rule()

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        if _state.depth == 0 or _state.disabled:
            return orig(*args, **kwargs)
        args, kwargs = rule(args, kwargs)
        return orig(*args, **kwargs)

    wrapper.__wrapped_by_apex_tpu_torch_amp__ = True
    return wrapper


def _table(half_dtype, counter, skip_ids):
    """The mode's table from the built-in lists, without the functions a
    user registration overrides (``skip_ids``: their ids)."""
    table = {}
    rules = ((cast_lists.FP16_FUNCS, _cast_rule(_to_half(half_dtype,
                                                         counter))),
             (cast_lists.FP32_FUNCS, _cast_rule(_to_float(counter))),
             (cast_lists.PROMOTE_FUNCS + cast_lists.SEQUENCE_CASTS,
              _promote_rule(counter)))
    for entries, rule in rules:
        for ns, name in entries:
            fn = getattr(ns, name, None)
            if fn is not None and id(fn) not in skip_ids:
                table[fn] = rule
    return table


def _patch(half_dtype, counter):
    """Install the user registrations (latest wins, in every registry)
    and build the mode's table around them."""
    to_half = _to_half(half_dtype)
    regs = ([(m, n, lambda o: _make_cast_wrapper(o, to_half))
             for m, n in _USER_FP16_REGISTRY]
            + [(m, n, lambda o: _make_cast_wrapper(o, _to_float()))
               for m, n in _USER_FP32_REGISTRY]
            + [(m, n, _make_promote_wrapper)
               for m, n in _USER_PROMOTE_REGISTRY])
    skip = set()
    try:
        for ns, name, make in regs:
            orig = getattr(ns, name)
            skip.add(id(orig))
            _state.saved.append((ns, name, orig))
            setattr(ns, name, make(orig))
    except Exception:
        # a registered attribute vanished since registration: unwind what
        # was installed, a partial patch must not outlive the context
        _unpatch()
        raise
    return _table(half_dtype, counter, skip)


def _unpatch():
    for ns, name, orig in reversed(_state.saved):
        setattr(ns, name, orig)
    _state.saved.clear()


def _check_has(namespace, name):
    if not hasattr(namespace, name):
        raise ValueError(f"No function named {name} in module {namespace}.")


def _register(registry, namespace, name):
    """Latest registration wins: the name leaves every registry first."""
    _check_has(namespace, name)
    with _state.lock:
        for reg in (_USER_FP16_REGISTRY, _USER_FP32_REGISTRY,
                    _USER_PROMOTE_REGISTRY):
            if (namespace, name) in reg:
                reg.remove((namespace, name))
        registry.append((namespace, name))


def register_half_function(namespace, name):
    """Run ``namespace.name`` in half under O1 (from the next outermost
    enter)."""
    _register(_USER_FP16_REGISTRY, namespace, name)


def register_float_function(namespace, name):
    """Run ``namespace.name`` in fp32 under O1."""
    _register(_USER_FP32_REGISTRY, namespace, name)


def register_promote_function(namespace, name):
    """Promote mixed half and fp32 arguments of ``namespace.name`` to
    fp32 under O1."""
    _register(_USER_PROMOTE_REGISTRY, namespace, name)


def float_function(fn):
    """Decorator: ``fn`` with its half args cast to fp32 under O1."""
    return _make_cast_wrapper(fn, _to_float())


def promote_function(fn):
    """Decorator: mixed half and fp32 args of ``fn`` promoted under O1."""
    return _make_promote_wrapper(fn)


@contextlib.contextmanager
def cast_ops(half_dtype=torch.bfloat16):
    """O1's per-op casts for the body of the ``with``; yields the active
    mode, whose ``casts`` counts the tensors it has cast. Reentrant;
    nested contexts must agree on the half dtype."""
    with _state.lock:
        if _state.depth > 0 and half_dtype != _state.half_dtype:
            raise ValueError(
                f"nested cast_ops with different half dtypes: "
                f"{_state.half_dtype} active, {half_dtype} requested")
        if _state.depth == 0:
            counter = _Counter()
            table = _patch(half_dtype, counter)
            _state.half_dtype = half_dtype
            _state.mode = _CastMode(table, counter)
            try:
                _state.mode.__enter__()
            except BaseException:
                _unpatch()
                _state.mode = _state.half_dtype = None
                raise
        _state.depth += 1
        mode = _state.mode
    try:
        yield mode
    finally:
        with _state.lock:
            _state.depth -= 1
            if _state.depth == 0:
                _state.mode.__exit__(None, None, None)
                _unpatch()
                _state.mode = _state.half_dtype = None
