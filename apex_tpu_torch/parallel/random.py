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
  the tp rank is already in the model-parallel generator's seed, and the
  cp rank (the ranks hold different chunks of one sequence) goes into a
  generator of its own, seeded from one draw of the shared generator.

Torch's generators give other numbers than ``jax.random`` from the same
seed, so no draw is bit-equal to JAX's; the parity tests load JAX's
weights instead.

``checkpoint`` and ``checkpoint_distributed`` come with recompute.
"""

from typing import Sequence

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["data_parallel_generator", "model_parallel_generator",
           "model_parallel_seed", "shard_aware_generator"]

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
    folded in. The tp rank is folded in when the model-parallel generator
    is seeded. For ``"cp"`` at cp > 1: one 48-bit draw from ``generator``
    (the same draw on every cp rank, which keeps their shared generators
    in step) and the cp rank seed a new generator on its device, so each
    rank's mask differs, as JAX's ``fold_in`` of the axis index makes it.
    An axis of size one, or none named, hands ``generator`` back (the JAX
    function skips unbound axes the same way). The fold costs a draw and a
    host read, so a caller folds once and draws from the result
    (``transformer.layer.ShardAwareDropout`` does)."""
    cp = ps.get_context_parallel_world_size()
    if "cp" not in axis_names or cp == 1:
        return generator
    draw = int(torch.randint(0, 2 ** 48, (1,), generator=generator,
                             device=generator.device))
    return _generator(draw * cp + ps.get_context_parallel_rank(),
                      generator.device)
