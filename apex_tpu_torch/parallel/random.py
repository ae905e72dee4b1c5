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
- :func:`shard_aware_generator` folds the rank of each named axis in; the
  tp rank is already in the model-parallel generator's seed, and the
  other axes (cp) are not ported, so it hands the generator back
  unchanged.

Torch's generators give other numbers than ``jax.random`` from the same
seed, so no draw is bit-equal to JAX's; the parity tests load JAX's
weights instead.

``checkpoint`` and ``checkpoint_distributed`` come with recompute.
"""

from typing import Sequence

import torch

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
    folded in: the identity, since the tp rank is folded in when the
    model-parallel generator is seeded and no other axis is ported (the
    JAX function skips unbound axes the same way)."""
    del axis_names
    return generator
