"""``python -m apex_tpu_torch.resilience.remediation`` — selftest,
supervise, campaign (counterpart of ``python -m
apex_tpu.resilience.remediation``).

Modes:

- ``--selftest`` (default): the exit-nonzero gate proving the closed
  loop end to end, in one spawned world of 4 gloo ranks (JAX's 8 -> 4
  -> 8 devices, here 4 -> 2 -> 4 ranks):

  1. a clean reference sequence completes with ZERO remediation cases
     (the periodic canary audit replays every segment clean);
  2. an injected silent bit flip — the SDC the sentinel misses — is
     detected by the canary audit, confirmed, quarantined (4 -> 2, the
     corrupt checkpoints moved aside, restart from the clean anchor),
     ridden through probation on the reduced layout, and readmitted
     (2 -> 4), with exactly ONE terminal ``kind="remediation"`` verdict
     and the final loss within 5e-2 of the uninterrupted reference;
  3. a straggler flag whose canary replays clean closes ``cleared``
     with zero restarts (the false-positive path);
  4. the DELIBERATELY BROKEN policy (quarantine without canary
     verification) is caught by the campaign's invariant checker;
  5. the fleet edge cases (zero-MAD outlier, <3 hosts) flow through the
     ``LiveFleetMonitor`` -> controller hand-off soundly;
  6. the supervisor turns exit codes into bounded relaunches (an
     injected runner — no subprocesses in the gate).

- ``--supervise --save DIR --devices N -- <command...>``: run a training
  command under remediation restarts (supervisor.py), launched as a
  ``torch.distributed.run`` world of the incarnation's device count
  (``--launcher none`` runs it as it is, ``{devices}`` substituted).

- ``--campaign N``: N seeded randomized fault sequences plus the clean
  reference through the invariant checker, in one spawned world of 4.

The model runs on the card (4 ranks over gloo on ``cuda:0``) unless
``--device cpu``; without a card those modes exit nonzero.
"""

import argparse
import importlib
import json
import os
import sys
import tempfile

from apex_tpu_torch.resilience.exit_codes import ExitCode

WORLD = 4
STEPS = 8
MODULE = "apex_tpu_torch.resilience.remediation.__main__"


def _check(failures, ok, label):
    print(f"  [{'ok' if ok else 'FAIL'}] {label}", flush=True)
    if not ok:
        failures.append(label)


def selftest_rank(rank: int, world: int, directory: str, device: str,
                  steps: int = STEPS, overrides=None, flip_step: int = 3,
                  probation: int = 3, clear_segments=None) -> dict:
    """One rank of the selftest's world: the clean reference, the bitflip
    (after step ``flip_step``) sequence and the false-positive clear
    (checks 1-3), under the campaign's policy with ``probation`` clean
    steps. Rank 0 returns the sequences' results and the clear's
    records; ``overrides`` change the campaign's config (the card runs
    GPT-2 small's width) and ``clear_segments`` bounds the segments the
    clear's canary replays (None: every one, as JAX's)."""
    import torch

    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.router import make_record
    from apex_tpu_torch.resilience.remediation.campaign import (
        FaultEvent,
        TrainingCache,
        campaign_config,
        campaign_corpus,
        run_sequence,
    )
    from apex_tpu_torch.resilience.remediation.canary import GPTCanary
    from apex_tpu_torch.resilience.remediation.controller import (
        RemediationController,
    )
    from apex_tpu_torch.resilience.remediation.policy import (
        RemediationPolicy,
    )
    from apex_tpu_torch.resilience.replay.journal import journal_path

    if device == "cuda":
        torch.cuda.set_device(0)
    cfg = campaign_config(**(overrides or {}))
    cache = TrainingCache(cfg, device)
    lm, corpus = campaign_corpus(cfg, steps)
    policy = RemediationPolicy(probation_steps=probation,
                               clean_steps_to_close=2, max_restarts=6)
    ref_dir = os.path.join(directory, "reference")
    reference = run_sequence([], ref_dir, cache, lm, corpus, policy=policy,
                             steps=steps)
    result = run_sequence([FaultEvent("bitflip", flip_step)],
                          os.path.join(directory, "bitflip"), cache, lm,
                          corpus, policy=policy, steps=steps)
    # 3) false positive: a straggler flag over the reference's journal,
    # replayed clean by the canary on the full layout
    _, training = cache.get(world)
    router = MetricRouter([MemorySink()])
    ctrl = RemediationController(
        policy=RemediationPolicy(), router=router, save_dir=None,
        world_devices=world,
        canary_fn=GPTCanary(journal_path(ref_dir), ref_dir,
                            training=training, lm=lm,
                            max_segments_per_call=clear_segments))
    ctrl.observe(make_record("fleet", 6, check="straggler",
                             flagged_host=2, median_step_s=9.9, z=11.0))
    decision = ctrl.process(6)
    router.close()
    if rank != 0:
        return {}
    return {"reference": reference, "result": result,
            "clear": {"decision": decision, "records": ctrl.records,
                      "open_cases": len(ctrl.open_cases),
                      "excluded": list(ctrl.state.excluded)},
            "builds": cache.builds}


def loop_checks(failures, out: dict, world: int = WORLD,
                steps: int = STEPS) -> None:
    """Checks 1-3 on rank 0's results (shared with the card's phase)."""
    from apex_tpu_torch.monitor.goodput.accountant import account
    from apex_tpu_torch.resilience.remediation.campaign import (
        check_invariants,
    )

    reference, result = out["reference"], out["result"]
    half = world // 2
    _check(failures, reference.outcome == "completed",
           "clean reference sequence completes")
    _check(failures, not reference.remediation,
           "clean reference opens ZERO remediation cases (audits clean)")
    _check(failures, len(reference.incarnations) == 1,
           "clean reference needs one incarnation")
    _check(failures, result.outcome == "completed",
           "bitflip sequence completes with zero human intervention")
    devices_seq = [i["devices"] for i in result.incarnations]
    _check(failures, half in devices_seq and devices_seq[0] == world
           and devices_seq[-1] == world,
           f"quarantine reduced {world}->{half} and readmitted "
           f"{half}->{world} (incarnation topologies {devices_seq})")
    terminals = result.terminals
    _check(failures, len(terminals) == 1
           and terminals[0].get("finding") == "sdc"
           and terminals[0].get("verdict") == "readmitted",
           f"exactly one terminal verdict, (sdc, readmitted) (got "
           f"{[(t.get('finding'), t.get('verdict')) for t in terminals]})")
    quarantines = [r for r in result.remediation
                   if r.get("action") == "quarantine"]
    _check(failures, len(quarantines) == 1
           and quarantines[0].get("tombstoned")
           and quarantines[0].get("restore_step") is not None
           and quarantines[0].get("excluded"),
           "quarantine record carries excluded devices + tombstoned "
           "checkpoints + clean-anchor restore step")
    opens = [r for r in result.remediation if r.get("action") == "open"
             and r.get("finding") == "sdc"]
    exact_leaf = bool(opens) and any(
        isinstance(ev, dict) and len(ev.get("leaves") or []) == 1
        for ev in (opens[0].get("evidence") or []))
    _check(failures, exact_leaf,
           "canary evidence pins the EXACT flipped leaf (boundary "
           "corruption, one differing crc)")
    violations = check_invariants(
        result, reference_losses=reference.losses, final_step=steps - 1)
    _check(failures, violations == [],
           f"invariant checker passes the healed sequence (violations: "
           f"{violations})")
    rep = account(result.records, run_id=result.run_id)
    _check(failures, rep.incarnations == len(result.incarnations)
           and rep.badput_s.get("remediation", 0.0) > 0.0,
           "goodput: every incarnation accounted, canary/audit time "
           "booked as remediation badput")
    clear = out["clear"]
    _check(failures, clear["decision"] is None
           and any(r.get("action") == "clear"
                   and r.get("verdict") == "cleared"
                   for r in clear["records"]),
           "straggler flag + clean canary replay -> verdict=cleared, no "
           "restart (false-positive path)")
    _check(failures, not clear["open_cases"] and not clear["excluded"],
           "cleared case leaves no open case and no exclusion")


def host_checks(failures, directory: str, world: int = WORLD) -> None:
    """Checks 4-6: host only (no model)."""
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.goodput import LiveFleetMonitor
    from apex_tpu_torch.monitor.router import make_record
    from apex_tpu_torch.resilience.remediation.campaign import (
        FaultEvent,
        SequenceResult,
        check_invariants,
    )
    from apex_tpu_torch.resilience.remediation.controller import (
        RemediationController,
    )
    from apex_tpu_torch.resilience.remediation.policy import (
        RemediationPolicy,
    )
    from apex_tpu_torch.resilience.remediation.state import (
        RemediationState,
    )
    from apex_tpu_torch.resilience.remediation.supervisor import (
        DEVICES_ENV,
        LAUNCHER,
        supervise,
        torchrun_command,
    )

    # 4) the deliberately broken policy is caught by the invariants
    broken_dir = os.path.join(directory, "broken")
    os.makedirs(broken_dir, exist_ok=True)
    ctrl_b = RemediationController(
        policy=RemediationPolicy(verify_before_quarantine=False),
        save_dir=broken_dir, world_devices=world)
    ctrl_b.observe(make_record("fleet", 6, check="straggler",
                               flagged_host=2, median_step_s=9.9, z=11.0))
    decision_b = ctrl_b.process(6)
    _check(failures, decision_b is not None
           and decision_b.action == "restart"
           and decision_b.exit_code == int(ExitCode.REMEDIATION_RESTART),
           "broken policy DOES quarantine the unverified straggler (the "
           "failure shape under test)")
    fake = SequenceResult(
        faults=[FaultEvent("slow", 6)], run_id="broken",
        outcome="completed", incarnations=[], records=ctrl_b.records,
        remediation=ctrl_b.records, losses={})
    broken_violations = check_invariants(fake)
    _check(failures, any("WITHOUT canary verification" in v
                         for v in broken_violations),
           f"invariant checker catches the unverified quarantine "
           f"(violations: {broken_violations})")

    # 5) fleet edge cases through the LiveFleetMonitor hand-off
    def fleet_window(n_hosts, slow_host=None):
        recs = []
        for h in range(n_hosts):
            for s in range(4):
                dur = 5.0 if h == slow_host else 0.1
                recs.append({"kind": "span", "phase": "step", "step": s,
                             "host": h, "start": float(s), "dur_s": dur})
        return recs

    window = MemorySink()
    for r in fleet_window(4, slow_host=3):
        window.emit(r)
    router5 = MetricRouter([MemorySink()])
    mon = LiveFleetMonitor(router5, window, interval_steps=1)
    mon.maybe_check(0)  # anchors the cadence
    report = mon.maybe_check(1)
    stub_ctrl = RemediationController(
        policy=RemediationPolicy(), router=router5, world_devices=world,
        canary_fn=lambda: {"ok": True, "audited": [[0, 2]]})
    touched = stub_ctrl.observe_fleet(report, 1)
    stub_ctrl.process(1)
    _check(failures, report is not None and not report.ok
           and len(touched) == 1
           and any(r.get("verdict") == "cleared"
                   for r in stub_ctrl.records),
           "zero-MAD straggler (robust z=inf) flows monitor -> controller "
           "-> canary -> cleared")
    window2 = MemorySink()
    for r in fleet_window(2, slow_host=1):
        window2.emit(r)
    mon2 = LiveFleetMonitor(router5, window2, interval_steps=1)
    mon2.maybe_check(0)
    report2 = mon2.maybe_check(1)
    ctrl2 = RemediationController(policy=RemediationPolicy(),
                                  world_devices=world)
    touched2 = ctrl2.observe_fleet(report2, 1)
    _check(failures, report2 is not None and report2.ok
           and touched2 == [] and not ctrl2.open_cases,
           "<3 hosts: straggler math refuses, controller opens nothing")
    router5.close()

    # 6) the supervisor: exit codes -> bounded relaunches (injected
    # runner, no subprocesses)
    sup_dir = os.path.join(directory, "supervisor")
    os.makedirs(sup_dir, exist_ok=True)
    codes = [int(ExitCode.INCIDENT), int(ExitCode.REMEDIATION_RESTART),
             int(ExitCode.OK)]
    seen = []

    def runner(argv, env):
        seen.append((argv, env.get(DEVICES_ENV)))
        return codes.pop(0)

    rep6 = supervise(torchrun_command(["-m", "train"]), sup_dir, world,
                     runner=runner)
    _check(failures, rep6.ok and len(rep6.incarnations) == 3,
           "supervisor relaunches on 43/44 and stops on 0")
    pending = RemediationState.load(sup_dir).pending
    _check(failures, pending is not None
           and pending.get("exit_code") == int(ExitCode.INCIDENT),
           "supervisor wrote the incident adoption note")
    _check(failures, all(
        f"--nproc-per-node={world}" in argv and LAUNCHER in argv
        and env == str(world) for argv, env in seen),
        "supervisor launches each incarnation as a torch.distributed.run "
        "world of the persisted device count")
    rep7 = supervise(lambda n: ["train"], sup_dir, world,
                     runner=lambda a, e: int(ExitCode.REMEDIATION_HALT))
    _check(failures, rep7.outcome == "halted"
           and len(rep7.incarnations) == 1,
           "supervisor stops immediately on escalate-to-halt (45)")


def selftest(directory=None, device="cuda", timeout=900.0) -> int:
    from apex_tpu_torch._kernels import resolve_device
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )

    device = resolve_device(device).type
    directory = directory or tempfile.mkdtemp(
        prefix="apex_torch_remediation_")
    failures = []
    print(f"remediation selftest (dir {directory}, {WORLD} ranks, "
          f"{device})", flush=True)
    # the rank function by its module's own name: a spawned child does
    # not re-import a package's __main__
    rank_fn = importlib.import_module(MODULE).selftest_rank
    outs = spawn(rank_fn, WORLD, args=(directory, device),
                 timeout=timeout)
    loop_checks(failures, outs[0])
    host_checks(failures, directory)
    if failures:
        print(f"remediation selftest: {len(failures)} check(s) FAILED:",
              flush=True)
        for f in failures:
            print(f"  - {f}", flush=True)
        return int(ExitCode.FAILURE)
    print("remediation selftest: all checks passed", flush=True)
    return int(ExitCode.OK)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.resilience.remediation",
        description="auto-remediation selftest / supervisor / campaign")
    parser.add_argument("--selftest", action="store_true",
                        help="end-to-end closed-loop gate (the default "
                             "mode); exit nonzero on any failed check")
    parser.add_argument("--dir", default=None,
                        help="scratch dir (default: a temp dir, kept for "
                             "inspection)")
    parser.add_argument("--campaign", type=int, default=None, metavar="N",
                        help="run N seeded randomized fault sequences "
                             "through the invariant checker")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--supervise", action="store_true",
                        help="run a command under remediation restarts: "
                             "--supervise --save DIR --devices N -- cmd...")
    parser.add_argument("--save", default=None)
    parser.add_argument("--devices", type=int, default=None)
    parser.add_argument("--max-incarnations", type=int, default=8)
    parser.add_argument("--launcher", default="torchrun",
                        choices=["torchrun", "none"],
                        help="--supervise: launch the command as a "
                             "torch.distributed.run world of N ranks, or "
                             "as it is")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (cuda unless cpu is "
                             "asked for)")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.supervise:
        from apex_tpu_torch.resilience.remediation.supervisor import (
            command_for_launcher,
            supervise,
        )

        if not args.save or not args.devices:
            parser.error("--supervise needs --save and --devices")
        command = [c for c in args.command if c != "--"]
        if not command:
            parser.error("--supervise needs a command after --")
        report = supervise(command_for_launcher(command, args.launcher),
                           args.save, args.devices,
                           max_incarnations=args.max_incarnations)
        print(report.summary(), flush=True)
        return report.final_exit_code

    if args.campaign:
        from apex_tpu_torch._kernels import resolve_device
        from apex_tpu_torch.transformer.testing.distributed_test_base import (
            spawn,
        )

        device = resolve_device(args.device).type
        workroot = args.dir or tempfile.mkdtemp(prefix="apex_torch_campaign_")
        from apex_tpu_torch.transformer.testing.elastic_workers import (
            campaign_worker,
        )

        report = spawn(campaign_worker, WORLD,
                       args=(workroot, args.campaign, args.seed, device),
                       timeout=600.0 * max(1, args.campaign))[0]
        print(json.dumps(
            {k: v for k, v in report.items() if k != "reference_losses"},
            indent=1), flush=True)
        print(f"campaign: {report['passed']} passed, "
              f"{report['failed']} failed", flush=True)
        return int(ExitCode.OK if report["failed"] == 0
                   else ExitCode.FAILURE)

    return selftest(args.dir, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
