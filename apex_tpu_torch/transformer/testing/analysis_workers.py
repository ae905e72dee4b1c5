"""Rank functions of the analysis checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_analysis_passes.py``).

:func:`collective_fixtures_worker` runs three small steps whose
collectives the collective pass must flag, each the twin of a JAX step
the test traces: a reduce over a one-rank group, a point-to-point
pattern whose edges have a duplicate source, and a pipeline chain with a
missing link. Then the analysis CLI's trace half over its four tiny
targets (``analysis.__main__.audit_worker``). Returns this rank's
findings by case.
"""

from typing import Dict, List

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["collective_fixtures_worker"]


def _dead_reduce(x):
    # tp = 1: the tp group holds this rank alone
    return ps.all_reduce(x, ps.get_tensor_model_parallel_group())


def _duplicate_source(x):
    """pp = 4: rank 0 sends to ranks 1 and 2 under one tag."""
    group, r = ps.get_pipeline_model_parallel_group(), \
        ps.get_pipeline_model_parallel_rank()
    if r == 0:
        ps.p2p(group, [(x, 1, 0), (x, 2, 0)])
    elif r in (1, 2):
        ps.p2p(group, (), [(x, 0, 0)])
    ps.wait_sends()


def _broken_chain(x):
    """pp = 4: the chain 0 -> 1, 2 -> 3, stage 1 sending nothing."""
    group, r = ps.get_pipeline_model_parallel_group(), \
        ps.get_pipeline_model_parallel_rank()
    if r in (0, 2):
        ps.p2p(group, [(x, r + 1, 0)])
    else:
        ps.p2p(group, (), [(x, r - 1, 0)])
    ps.wait_sends()


def collective_fixtures_worker(rank: int, world_size: int,
                               targets: List[str]) -> Dict[str, list]:
    from apex_tpu_torch.analysis.__main__ import audit_worker
    from apex_tpu_torch.analysis.passes import StepTarget, run_passes
    from apex_tpu_torch.analysis.targets import layout_axes

    out = {}
    x = torch.ones(4)
    for name, layout, fn in (
            ("dead", dict(), _dead_reduce),
            ("duplicate_source", dict(pipeline_model_parallel_size=4),
             _duplicate_source),
            ("broken_chain", dict(pipeline_model_parallel_size=4),
             _broken_chain)):
        ps.initialize_model_parallel(**layout)
        target = StepTarget(name, fn, (x,), axes=layout_axes())
        out[name] = run_passes(target, passes=["collective"])
        ps.destroy_model_parallel()
    out["targets"] = audit_worker(rank, world_size, targets, "cpu")
    return out
