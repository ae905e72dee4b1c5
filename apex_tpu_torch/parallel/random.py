"""Parallel RNG seeds (counterpart of apex_tpu/parallel/random.py).

The JAX package folds ranks into pure PRNG keys; here the same seed math
gives explicit ``torch.Generator`` objects, which the dropout modules are
handed (``transformer.layer.seed_dropout``), so no mask comes from a
hidden global RNG:

- model-parallel regions (attention dropout on tp-sharded heads, and
  the initialisation of tp-sharded weights, the JAX ``tp_rank_init``'s
  ``fold_in(2718)`` and then the tp rank) draw from ``seed + 2718 +
  tp_rank`` (:func:`model_parallel_seed`);
- data-parallel regions (hidden and embedding dropout, replicated
  weights) draw from ``seed``, the same on every tp rank;
- :func:`shard_aware_generator` folds the rank of each named axis in:
  the tp rank (hidden dropout under sequence parallelism, where the tp
  ranks hold different slices of the sequence) and the cp rank (different
  chunks of one sequence) go into a generator of its own, seeded from one
  draw of the shared generator. A model-parallel region's generator
  already carries the tp rank in its seed, so its dropout names no axis
  to fold for tp (``transformer.layer.ShardAwareDropout``).

Torch's generators give other numbers than ``jax.random`` from the same
seed, so no draw is bit-equal to JAX's; the parity tests load JAX's
weights instead.

Activation checkpointing (:func:`checkpoint`, JAX's ``jax.checkpoint``)
runs a region's forward without keeping its intermediates and runs it
again in the backward. JAX's keys are values, so its recompute draws the
same dropout masks by construction. Torch's checkpoint restores only the
default CPU and CUDA generators, and the dropout modules draw from
generators of their own, so every draw goes through :func:`note_draw`:
inside an open region it records the generator's state before the
region's first draw from it. The recompute sets each recorded generator
back to that state, and when it ends puts each one back where it was
before the recompute, so the forward's masks are drawn again and no
generator advances twice.
"""

import contextlib
from typing import Callable, Optional, Sequence

import torch
import torch.utils.checkpoint

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["checkpoint", "checkpoint_distributed", "data_parallel_generator",
           "distribute_saved_activations_policy", "is_recomputing",
           "model_parallel_generator", "model_parallel_seed", "note_draw",
           "shard_aware_generator"]

_MODEL_PARALLEL_OFFSET = 2718  # the reference's seed offset


def model_parallel_seed(seed: int, tp_rank: int) -> int:
    """The seed of tp rank ``tp_rank``'s model-parallel region."""
    return seed + _MODEL_PARALLEL_OFFSET + tp_rank


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def model_parallel_generator(seed: int, tp_rank: int = 0,
                             device="cpu") -> torch.Generator:
    """A generator for model-parallel regions: distinct per tp rank."""
    return _generator(model_parallel_seed(seed, tp_rank), device)


def data_parallel_generator(seed: int, device="cpu") -> torch.Generator:
    """A generator for data-parallel regions: the same on every tp rank."""
    return _generator(seed, device)


def shard_aware_generator(generator: torch.Generator,
                          axis_names: Sequence[str] = ()) -> torch.Generator:
    """``generator`` with the rank of every bound axis of ``axis_names``
    folded in, as JAX's ``fold_in`` of each axis index makes the masks
    differ. For ``"tp"`` and ``"cp"`` at a size above one: one 48-bit draw
    from ``generator`` (the same draw on every rank, which keeps their
    shared generators in step) and the ranks, folded in that order into
    one seed (``(draw * tp + tp_rank) * cp + cp_rank``), seed a new
    generator on its device, so every (tp, cp) rank's mask differs. An
    axis of size one, or none named, hands ``generator`` back (the JAX
    function skips unbound axes the same way). The fold costs a draw and
    a host read, so a caller folds once and draws from the result
    (``transformer.layer.ShardAwareDropout`` does)."""
    folds = [(size, rank) for axis, size, rank in (
        ("tp", ps.get_tensor_model_parallel_world_size(),
         ps.get_tensor_model_parallel_rank()),
        ("cp", ps.get_context_parallel_world_size(),
         ps.get_context_parallel_rank())) if axis in axis_names and size > 1]
    if not folds:
        return generator
    note_draw(generator)
    seed = int(torch.randint(0, 2 ** 48, (1,), generator=generator,
                             device=generator.device))
    for size, rank in folds:
        seed = seed * size + rank
    return _generator(seed % 2 ** 63, generator.device)


# -- activation checkpointing ------------------------------------------------

# the generator records of the checkpoint regions whose forward is open,
# innermost last: {id(generator): (generator, state before its first draw)}
_TAPES: list = []
_RECOMPUTING = [0]  # recomputes under way in this process


def note_draw(generator: torch.Generator) -> None:
    """Records ``generator``'s state in every open checkpoint region that
    has not seen it yet; called before each draw of a region's dropout
    (``transformer.layer.keep_mask``, :func:`shard_aware_generator`)."""
    for tape in _TAPES:
        if id(generator) not in tape:
            tape[id(generator)] = (generator, generator.get_state())


def is_recomputing() -> bool:
    """True while a checkpoint region's forward runs again in a backward
    (a module keeps no per-call record of a recompute, e.g. MoE's aux
    loss)."""
    return _RECOMPUTING[0] > 0


class _Record:
    """The forward's context: opens the region's generator record."""

    def __init__(self, tape: dict):
        self.tape = tape

    def __enter__(self):
        _TAPES.append(self.tape)

    def __exit__(self, *exc):
        _TAPES.pop()  # regions close innermost first


class _Replay:
    """The recompute's context, entered once for every backward that
    recomputes the region: sets every recorded generator to its state at
    the region's first draw, and on exit back to its state at entry."""

    def __init__(self, tape: dict):
        self.tape = tape
        self.saved = []

    def __enter__(self):
        self.saved.append([(g, g.get_state()) for g, _ in self.tape.values()])
        for g, state in self.tape.values():
            g.set_state(state)
        _RECOMPUTING[0] += 1

    def __exit__(self, *exc):
        _RECOMPUTING[0] -= 1
        for g, state in self.saved.pop():
            g.set_state(state)


# aten's matrix products: the outputs JAX's ``dots_saveable`` keeps
_DOTS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "_scaled_mm")


def _dots_saveable(ctx, op, *args, **kwargs):
    aten = torch.ops.aten
    if any(op is getattr(aten, name).default for name in _DOTS
           if hasattr(aten, name)):
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def distribute_saved_activations_policy():
    """The policy JAX's function returns, ``dots_saveable``: keep the
    matrix products' outputs, recompute the elementwise ops (the
    sequence-sharded saving comes from :func:`checkpoint_distributed`)."""
    return "dots_saveable"


class _Chain:
    """Enters its context managers in order at each entry and leaves them
    in reverse."""

    def __init__(self, *cms):
        self.cms, self.stacks = cms, []

    def __enter__(self):
        stack = contextlib.ExitStack()
        for cm in self.cms:
            stack.enter_context(cm)
        self.stacks.append(stack)

    def __exit__(self, *exc):
        return self.stacks.pop().__exit__(*exc)


def _contexts(policy):
    tape = {}
    record, replay = _Record(tape), _Replay(tape)
    if policy is None:
        return record, replay
    if policy == "dots_saveable":
        policy = _dots_saveable
    if not callable(policy):
        raise ValueError(f"unknown checkpoint policy {policy!r}: None, "
                         "'dots_saveable' or a selective-checkpoint "
                         "policy function")
    keep, rerun = torch.utils.checkpoint.create_selective_checkpoint_contexts(
        policy)
    return _Chain(record, keep), _Chain(replay, rerun)


def checkpoint(fn: Optional[Callable] = None, *, policy=None,
               prevent_cse: bool = True):
    """Activation checkpointing, JAX's ``checkpoint`` (a decorator or a
    wrapper: ``checkpoint(fn)(*args)``): ``torch.utils.checkpoint``'s
    non-reentrant form, which keeps the region's inputs and runs ``fn``
    again when the backward needs what it made (also under
    ``torch.autograd.grad`` and ``backward(inputs=...)``, and once for
    every backward that walks the region). The default generators are
    restored as torch does, and the dropout generators as the module
    docstring says, so the recompute gives the forward's values and masks.

    ``policy``: None recomputes everything. ``"dots_saveable"`` (what
    :func:`distribute_saved_activations_policy` returns, JAX's
    ``jax.checkpoint_policies.dots_saveable``) keeps the outputs of
    aten's matrix products (mm, bmm, addmm, baddbmm, _scaled_mm) and
    recomputes the rest, through torch's selective checkpoint; unlike
    JAX's it sees aten ops only, so the hand-written kernels' outputs
    (norms, flash attention) are recomputed, and a region under it may
    be walked by one backward only. A callable is taken as a torch
    selective-checkpoint policy. ``prevent_cse`` is JAX's compiler hint;
    eager torch has no common-subexpression pass, so it changes
    nothing."""
    del prevent_cse
    if fn is None:
        return lambda f: checkpoint(f, policy=policy)

    def wrapped(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: _contexts(policy), **kwargs)

    return wrapped


def checkpoint_distributed(fn: Callable, axis_name: str = "tp"):
    """Checkpoint with the saved first argument split over ``axis_name``'s
    group (ref random.py:246-266, ``distribute_saved_activations``):
    ``fn``'s first argument, sequence-major and replicated over the
    group, is scattered along dim 0 outside the region and gathered back
    inside it, so the region keeps only this rank's 1/n of it. The
    gather's backward keeps this rank's slice, and the scatter's
    all-gathers it, so the gradients are those of ``fn``. Dim 0 must
    divide by the group's size."""
    from apex_tpu_torch.parallel.mappings import (
        gather_from_sequence_parallel_region,
        scatter_to_sequence_parallel_region,
    )

    def inner(shard, *args):
        return fn(gather_from_sequence_parallel_region(
            shard, ps.get_group(axis_name), to_model_parallel=False), *args)

    def wrapped(x, *args):
        group = ps.get_group(axis_name)
        n = ps.group_size(group)
        if x.shape[0] % n != 0:
            raise ValueError(
                f"checkpoint_distributed: leading dim ({x.shape[0]}) not "
                f"divisible by {axis_name} size ({n}); the split would "
                "silently drop rows")
        if n == 1:
            return checkpoint(fn)(x, *args)
        return checkpoint(inner)(
            scatter_to_sequence_parallel_region(x, group), *args)

    return wrapped
