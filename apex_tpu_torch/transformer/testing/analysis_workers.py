"""Rank functions of the analysis checks, for
:func:`~apex_tpu_torch.transformer.testing.distributed_test_base.spawn`
(``tests/test_torch_analysis_passes.py``).

:func:`collective_fixtures_worker` runs three small steps whose
collectives the collective pass must flag, each the twin of a JAX step
the test traces: a reduce over a one-rank group, a point-to-point
pattern whose edges have a duplicate source, and a pipeline chain with a
missing link. Then the analysis CLI's trace half over its four tiny
targets (``analysis.__main__.audit_worker``). Returns this rank's
findings by case. :func:`site_probe_worker` audits one promotion.
:func:`hlo_audits_worker` and :func:`autofix_worker`
run the recorded-step audits and autofix over the tiny targets
(``tests/test_torch_hlo_audits.py``, ``tests/test_torch_autofix.py``).
"""

from typing import Dict, List

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = ["autofix_worker", "collective_fixtures_worker", "hlo_audits_worker",
           "site_probe_worker"]


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


def _bare_all_reduce(x):
    """A step with one collective through parallel_state (ledgered) and
    one bare ``dist.all_reduce`` (not): the latter is unpredicted."""
    import torch.distributed as dist

    group = ps.get_data_parallel_group()
    y = ps.all_reduce(x, group)
    dist.all_reduce(y, group=group)  # the seeded bare collective
    return y


def hlo_audits_worker(rank: int, world_size: int) -> Dict[str, object]:
    """The recorded-step audits on a gloo world of 4 (CPU): the tiny GPT
    at dp 2 x tp 2 under hlo-comms and hlo-memory, a step with a bare
    ``dist.all_reduce``, the int8 target, and the naive ZeRO target under
    hlo-sharding; this rank's findings by case, and the GPT step's
    dispatched collectives as (kind, axis, elements)."""
    import inspect

    from apex_tpu_torch.analysis import targets as tg
    from apex_tpu_torch.analysis.hlo import attribution
    from apex_tpu_torch.analysis.passes import (
        StepContext,
        StepTarget,
        run_passes,
    )

    out: Dict[str, object] = {}
    gpt = tg.gpt_step_target("cpu")
    ctx = StepContext(gpt)
    mod = ctx.recording.module
    parts = attribution.mesh_axis_partitions(ctx.mesh)
    out["gpt_collectives"] = sorted(
        (c.kind, attribution.axis_of_collective(ctx.mesh, c, parts),
         c.elements) for c in mod.collectives)
    out["gpt_staged"] = len(mod.staged)
    from apex_tpu_torch.analysis.hlo import comms_diff, memory_diff

    out["gpt_comms"] = comms_diff.hlo_comms_pass(ctx)
    out["gpt_memory"] = memory_diff.hlo_memory_pass(ctx)
    ps.destroy_model_parallel()

    ps.initialize_model_parallel(tensor_model_parallel_size=2)
    bare = StepTarget("bare", _bare_all_reduce, (torch.ones(4),),
                      axes=tg.layout_axes())
    out["bare"] = run_passes(bare, passes=["hlo-comms"])
    lines, first = inspect.getsourcelines(_bare_all_reduce)
    out["bare_line"] = first + next(i for i, ln in enumerate(lines)
                                    if "dist.all_reduce(y" in ln)
    ps.destroy_model_parallel()

    out["int8"] = run_passes(tg.gpt_compressed_step_target("cpu"),
                             passes=["hlo-comms"])
    ps.destroy_model_parallel()
    out["naive"] = run_passes(tg.gpt_zero_naive_step_target("cpu"),
                              passes=["hlo-sharding", "donation"])
    ps.destroy_model_parallel()
    return out


def autofix_worker(rank: int, world_size: int) -> Dict[str, object]:
    """Autofix over the naive ZeRO target on a gloo world of 4 (CPU): the
    seeded target's derived prescriptions, the fix's report, a second
    apply over the fixed target, and the conflicting-spec refusal."""
    from apex_tpu_torch.analysis import targets as tg
    from apex_tpu_torch.analysis.allowlist import repo_allowlist
    from apex_tpu_torch.analysis.autofix import (
        KIND_SPEC,
        Patch,
        apply_fixes,
        derive_patches,
    )
    from apex_tpu_torch.analysis.autofix.apply import (
        _merge_overrides,
        _run_suite,
    )

    def summary(p):
        return (p.kind, p.argnum, p.leaf, None if p.spec is None
                else tuple(p.spec), p.axis, p.slot, p.wire_delta,
                p.hbm_delta)

    allow = repo_allowlist()
    out: Dict[str, object] = {}
    target = tg.gpt_zero_naive_step_target("cpu")
    kept, ctx, ledger = _run_suite(target, None, allow)
    out["prescriptions"] = sorted(summary(p) for p in derive_patches(
        target, kept, module=ctx.recording.module, mesh=target.mesh,
        ledger=ledger))
    mk = lambda spec: Patch(kind=KIND_SPEC, target=target.name,  # noqa: E731
                            argnum=1, leaf="m", spec=spec, slot="state_spec")
    out["conflict"] = _merge_overrides(target, [mk(("dp",)),
                                                mk(("tp",))])[2]
    ps.destroy_model_parallel()
    target = tg.gpt_zero_naive_step_target("cpu")
    rep = apply_fixes(target, allowlist=allow)
    out["report"] = {
        "rounds": rep.rounds, "idempotent": rep.idempotent, "ok": rep.ok,
        "refused": rep.refused, "manual": len(rep.manual),
        "applied": sorted(summary(p) for p in rep.applied),
        "axis": rep.axis, "before": rep.ledger_before,
        "after": rep.ledger_after,
        "overrides": rep.final_target.build_overrides,
        "residual": [f.rule for f in rep.findings_after
                     if f.severity != "info"]}
    again = apply_fixes(rep.final_target, allowlist=allow)
    out["again"] = {"applied": len(again.applied), "rounds": again.rounds,
                    "ok": again.ok, "same": again.final_target
                    is rep.final_target}
    ps.destroy_model_parallel()
    return out


def _promote(x):
    return (x.float() * 2).to(torch.bfloat16)


def site_probe_worker(rank: int, world_size: int) -> list:
    """The precision pass over a one-promotion step defined in this file
    (``_promote``): this rank's findings, whose site names this file
    whatever sys.path entry the rank imported the package through."""
    from apex_tpu_torch.analysis.passes import StepTarget, run_passes

    return run_passes(StepTarget("probe", _promote,
                                 (torch.ones(4, dtype=torch.bfloat16),)),
                      passes=["precision"])
