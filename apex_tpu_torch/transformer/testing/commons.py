"""Harness helpers (counterpart of apex_tpu/transformer/testing/commons.py;
ref: apex/transformer/testing/commons.py).

``initialize_distributed`` starts the ``torch.distributed`` world that the
JAX function's mesh stands for, and builds ``parallel_state``'s groups
over it; :mod:`~apex_tpu_torch.transformer.testing.distributed_test_base`
spawns such worlds for tests.
"""

import os
import random
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import parallel_state
from apex_tpu_torch.transformer.testing import global_vars

__all__ = ["TEST_SUCCESS_MESSAGE", "initialize_distributed",
           "print_separator", "set_random_seed"]

TEST_SUCCESS_MESSAGE = ">> passed the test :-)"


def set_random_seed(seed: int) -> torch.Generator:
    """Seeds Python's, numpy's and torch's global generators (ref
    commons.py:242) and returns a CPU generator of ``seed`` (the JAX
    function returns the PRNG key); the model-parallel streams are
    ``parallel.random``'s."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def initialize_distributed(backend: str = "nccl",
                           init_method: str = "env://",
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           tensor_model_parallel_size: Optional[int] = None
                           ) -> Tuple[int, int]:
    """Starts this process's rank of the world (ref commons.py:250) and
    returns ``(world_size, rank)``.

    ``backend`` is ``"nccl"`` (the default) or ``"gloo"``; a backend that
    fails to start raises, and none is tried in its place. The world's
    size and this rank come from the arguments or from the environment
    ``torch.distributed.run`` sets (``WORLD_SIZE``, ``RANK``); under NCCL
    the process takes the card ``LOCAL_RANK`` (modulo the cards it sees).
    Then ``parallel_state`` is initialized with ``tensor_model_parallel_size``
    or the global args' (1 without either)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected nccl or "
                         "gloo")
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
    if tensor_model_parallel_size is None:
        try:
            tensor_model_parallel_size = \
                global_vars.get_args().tensor_model_parallel_size
        except AssertionError:  # no global args
            tensor_model_parallel_size = 1
    parallel_state.initialize_model_parallel(tensor_model_parallel_size)
    return world_size, rank


def print_separator(message: str) -> None:
    filler = "-" * ((78 - len(message)) // 2)
    print("\n" + filler + f" {message} " + filler, flush=True)
