"""ASP, automatic 2:4 structured sparsity over named parameters
(counterpart of apex_tpu/contrib/sparsity/asp.py; ref:
apex.contrib.sparsity.ASP).

Parameters are dicts of named tensors (``dict(model.named_parameters())``),
and masks are dicts of the same names (ones for an ineligible tensor).
Pruning is one multiply a tensor, and the reference's patch of
``optimizer.step`` is :func:`masked_update`, a transform (the port
optimizers' ``init``/``update`` shape) chained after the optimizer: it
turns each update ``u`` into ``m * u - (1 - m) * p``, so that
``p + u' = m * (p + u)`` and the parameters stay exactly on the masked
subspace.

Layout: the port holds two kinds of GEMM weight. A ``kernel`` (the
port's GPT, BERT and the other flax-named modules) has flax's (in, out)
layout and is pruned along axis -2, as the JAX package prunes it. A
``weight`` has torch's layout, ``nn.Linear``'s (out, in) and a
convolution's (out, in, kh, kw), and is pruned along its input dim: its
mask is computed on the flax layout (``weight.movedim`` to (kh, kw, in,
out) or (in, out)) and moved back, so it equals, mask for mask, the JAX
package's mask of the weight that ``models.convert`` makes of it.
Eligible (the reference's Linear/Conv whitelist): a floating tensor of
at least 2 dims named ``kernel`` or ``weight``, outside any ``embed``
scope, whose pruned dim divides by 4 and holds at least 32.
"""

import warnings
from typing import Any, Callable, Dict, NamedTuple

import torch

from apex_tpu_torch.contrib.sparsity.sparse_masklib import create_mask
from apex_tpu_torch.optimizers.transform import Transform, chain

__all__ = ["ASP", "MaskedState", "compute_sparse_masks",
           "default_eligibility", "masked_update", "prune", "replace_masks"]

Tensors = Dict[str, torch.Tensor]


class MaskedState(NamedTuple):
    """The state of :func:`masked_update`: the masks, kept as data so that
    recomputed masks enter through :func:`replace_masks`."""

    masks: Any


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def _to_kernel_layout(t):
    """A torch-layout weight as flax's kernel: (out, in, *k) -> (*k, in,
    out)."""
    return t.movedim(0, -1).movedim(0, -2)


def _from_kernel_layout(t):
    return t.movedim(-2, 0).movedim(-1, 0)


def default_eligibility(name: str, tensor) -> bool:
    """A GEMM weight the reference would prune; see the module
    docstring."""
    if tensor.dim() < 2 or not tensor.is_floating_point():
        return False
    if _leaf(name) not in ("kernel", "weight"):
        return False
    if any("embed" in part.lower() for part in name.split(".")):
        return False
    red = tensor.shape[-2] if _leaf(name) == "kernel" else tensor.shape[1]
    return red % 4 == 0 and red >= 32


def compute_sparse_masks(params: Tensors, mask_calculator: str = "m4n2_1d",
                         eligibility: Callable = default_eligibility
                         ) -> Tensors:
    """Masks by name, ones where ``eligibility(name, tensor)`` is False
    (ref: ASP.compute_sparse_masks)."""

    def one(name, t):
        if not eligibility(name, t):
            return torch.ones_like(t)
        if _leaf(name) == "kernel":
            return create_mask(t, mask_calculator, axis=-2)
        return _from_kernel_layout(create_mask(
            _to_kernel_layout(t), mask_calculator, axis=-2))

    with torch.no_grad():
        return {n: one(n, t) for n, t in params.items()}


def prune(params: Tensors, masks: Tensors) -> Tensors:
    """``params * masks`` by name (ref: the in-place ``p.mul_(mask)``)."""
    with torch.no_grad():
        return {n: p * masks[n] for n, p in params.items()}


def masked_update(masks) -> Transform:
    """A transform to chain AFTER the optimizer: ``chain(optimizer,
    masked_update(masks))``, after which ``p + u'`` stays exactly masked
    (ref: ASP.init_optimizer_for_pruning's patched ``step``).

    ``masks``: a dict, a zero-argument callable returning one, or None
    (all ones), resolved at ``init`` into the state; masks computed after
    ``init`` enter through :func:`replace_masks`."""

    def init(params):
        m = masks() if callable(masks) else masks
        if m is None:
            m = {n: torch.ones_like(p) for n, p in params.items()}
        return MaskedState(masks=m)

    @torch.no_grad()
    def update(updates, state, params=None):
        if params is None:
            raise ValueError("masked_update requires params")
        m = state.masks
        return {n: m[n] * u - (1.0 - m[n]) * params[n]
                for n, u in updates.items()}, state

    return Transform(init, update)


def replace_masks(opt_state: Any, masks: Tensors) -> Any:
    """``opt_state`` with every :class:`MaskedState` holding ``masks``."""
    if isinstance(opt_state, MaskedState):
        return MaskedState(masks=masks)
    if isinstance(opt_state, tuple):
        items = [replace_masks(s, masks) for s in opt_state]
        if hasattr(opt_state, "_fields"):
            return type(opt_state)(*items)
        return tuple(items)
    return opt_state


class ASP:
    """The reference's class API (asp.py:28) over the functions above.
    The order of calls is the JAX class's: masks computed before
    ``init`` reach the optimizer's state; after it, the live state must
    be passed to :meth:`compute_sparse_masks` (or
    :meth:`prune_trained_model`), which returns it refreshed, or the call
    raises rather than let training stay dense."""

    def __init__(self):
        self._masks = None
        self._computed = False
        self._dense_init = False  # init ran on the placeholder masks
        self._calculator = "m4n2_1d"
        self._eligibility = default_eligibility

    def _masks_for_init(self):
        if not self._computed:
            self._dense_init = True
            warnings.warn(
                "ASP: optimizer state initialized before masks were "
                "computed; fine for the dense-train-then-prune recipe: pass "
                "this opt_state to compute_sparse_masks / "
                "prune_trained_model later (it returns the refreshed "
                "state). Until then training runs dense on the all-ones "
                "placeholder masks.", stacklevel=3)
        else:
            self._dense_init = False
        return self._masks

    def init_model_for_pruning(self, params: Tensors,
                               mask_calculator: str = "m4n2_1d",
                               eligibility: Callable = None) -> None:
        """All-ones masks (ref asp.py:40), filled by
        :meth:`compute_sparse_masks`."""
        self._calculator = mask_calculator
        if eligibility is not None:
            self._eligibility = eligibility
        self._masks = {n: torch.ones_like(p) for n, p in params.items()}
        self._computed = False

    def compute_sparse_masks(self, params: Tensors, opt_state: Any = None):
        """Fills the masks (ref asp.py:213); returns them, or ``(masks,
        refreshed opt_state)`` when ``opt_state`` is passed."""
        if self._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        if self._dense_init and opt_state is None:
            raise RuntimeError(
                "ASP: the optimizer state was initialized before "
                "compute_sparse_masks and still carries all-ones "
                "placeholder masks; training would silently stay dense. "
                "Pass it in: masks, opt_state = "
                "asp.compute_sparse_masks(params, opt_state).")
        self._masks = compute_sparse_masks(params, self._calculator,
                                           self._eligibility)
        self._computed = True
        if opt_state is not None:
            self._dense_init = False
            return self._masks, replace_masks(opt_state, self._masks)
        return self._masks

    def init_optimizer_for_pruning(self, optimizer: Transform) -> Transform:
        """``chain(optimizer, masked_update(...))`` with the masks bound
        when ``init`` runs."""
        if self._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        return chain(optimizer, masked_update(self._masks_for_init))

    def refresh_opt_state(self, opt_state: Any) -> Any:
        """Pushes the current masks into a live optimizer state."""
        if self._masks is None:
            raise RuntimeError("call init_model_for_pruning first")
        if self._computed:
            self._dense_init = False
        return replace_masks(opt_state, self._masks)

    def prune_trained_model(self, params: Tensors, opt_state: Any = None):
        """One-shot recipe (ref asp.py:292): compute the masks and prune;
        with ``opt_state``, returns ``(pruned params, refreshed
        opt_state)``."""
        if self._masks is None:
            self.init_model_for_pruning(params)
        if opt_state is not None:
            _, new_state = self.compute_sparse_masks(params, opt_state)
            return prune(params, self._masks), new_state
        self.compute_sparse_masks(params)
        return prune(params, self._masks)

    @property
    def masks(self):
        return self._masks

    def is_sparsity_enabled(self) -> bool:
        return self._masks is not None
