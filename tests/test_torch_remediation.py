"""apex_tpu_torch's self-healing loop against the JAX package's: the
remediation controller, its persisted state, the supervisor, the
campaign's draws and judgments, and the gate.

The host-only modules get the same inputs in both packages on an
injected clock (``time.time`` counts up from 0 for each package's run):
the controllers' ``kind="remediation"`` records, decisions, exit codes
and persisted state are compared exactly; ``random_sequence`` for seeds
0-19; ``check_invariants`` and ``minimize_failing`` on the same inputs;
the supervisor over an injected runner; ``quarantine_checkpoints`` on the
same directories. The loop itself (the gate's checks 1-3: the clean
reference, the bit flip detected by the canary, quarantined 4 -> 2 and
readmitted 2 -> 4, and the false-positive clear) runs once, in one
spawned world of 4 gloo ranks at the campaign's tiny GPT; its checks
4-6 run here on the host.
"""

import dataclasses
import os
import subprocess
import time

import pytest

from apex_tpu.monitor import router as jax_router
from apex_tpu.resilience.remediation import campaign as jcampaign
from apex_tpu.resilience.remediation import controller as jcontroller
from apex_tpu.resilience.remediation import policy as jpolicy
from apex_tpu.resilience.remediation import state as jstate
from apex_tpu.resilience.remediation import supervisor as jsupervisor
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.resilience.exit_codes import ExitCode
from apex_tpu_torch.resilience.remediation import campaign, controller
from apex_tpu_torch.resilience.remediation import policy, state, supervisor
from apex_tpu_torch.resilience.remediation.__main__ import (
    host_checks,
    loop_checks,
    selftest_rank,
)
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn

PORT = dict(controller=controller, policy=policy, state=state,
            router=port_router, supervisor=supervisor, campaign=campaign)
JAX = dict(controller=jcontroller, policy=jpolicy, state=jstate,
           router=jax_router, supervisor=jsupervisor, campaign=jcampaign)


@pytest.fixture
def clock(monkeypatch):
    """An injected clock: ``time.time`` counts up by 1 from 0; reset it
    between the packages' runs."""
    ticks = [0.0]

    def now():
        ticks[0] += 1.0
        return ticks[0]

    monkeypatch.setattr(time, "time", now)
    return lambda: ticks.__setitem__(0, 0.0)


def _step_dirs(root, steps):
    os.makedirs(root, exist_ok=True)
    for s in steps:
        os.makedirs(os.path.join(root, f"step_{s}"))
        with open(os.path.join(root, f"step_{s}", "tree.pt"), "w") as f:
            f.write("x")


def _decision(d):
    return None if d is None else dataclasses.asdict(d)


def _scenario(pkg, name, root):
    """One controller scenario with ``pkg``'s modules: (records, the
    decisions in order, the persisted state's fields)."""
    C, P, S = pkg["controller"], pkg["policy"], pkg["state"]
    rec = pkg["router"].make_record
    decisions, earlier = [], []
    clean = lambda: {"ok": True, "audited": [[0, 2]],  # noqa: E731
                     "evidence": {"kind": "canary", "audited": [[0, 2]]}}
    dirty = lambda: {"ok": False, "clean_anchor": 2,  # noqa: E731
                     "dirty_anchor": 4,
                     "evidence": {"kind": "canary", "clean_anchor": 2,
                                  "leaves": ["[0]['w']"]}}
    pol = P.RemediationPolicy(probation_steps=2, clean_steps_to_close=2,
                              max_restarts=3)
    save = None
    if name in ("quarantine_readmit", "budget"):
        save = os.path.join(root, name)
        _step_dirs(save, [2, 4, 6])
    ctrl = C.RemediationController(
        policy=pol, save_dir=save, world_devices=4,
        canary_fn={"clear": clean, "quarantine_readmit": dirty,
                   "budget": dirty, "slo": clean}.get(name))
    straggler = rec("fleet", 5, check="straggler", flagged_host=3,
                    median_step_s=9.0, z=12.0)
    if name == "clear":
        ctrl.observe(straggler)
        decisions.append(ctrl.process(5))
    elif name == "quarantine_readmit":
        ctrl.observe(straggler)
        decisions.append(ctrl.process(5))
        # the reduced incarnation adopts the quarantine into probation
        nxt = C.RemediationController(policy=pol, save_dir=save,
                                      world_devices=4, canary_fn=clean)
        nxt.adopt_pending(2)
        for s in (2, 3):
            nxt.on_clean_step(s)
        decisions.append(nxt.poll())
        earlier, ctrl = ctrl.records, nxt
    elif name == "budget":
        ctrl.state.restarts = 3
        ctrl.observe(straggler)
        decisions.append(ctrl.process(5))
    elif name == "no_canary":
        ctrl.observe(rec("stall", 4, elapsed_s=9.0))
        decisions.append(ctrl.process(4))
        for s in (5, 6):
            ctrl.on_clean_step(s)
    elif name == "sentinel":
        ctrl.observe(rec("skip", 3, loss=9.0))
        ctrl.observe(rec("rollback", 4, to_step=2))
        decisions.append(ctrl.process(4))
        ctrl.on_clean_step(5)
        ctrl.run_end(6)
    elif name == "halt":
        ctrl.observe(rec("halt", 7, good_step=6))
        decisions.append(ctrl.process(7))
    elif name == "preemption":
        decisions.append(ctrl.on_preemption(3))
        nxt = C.RemediationController(policy=pol, world_devices=4,
                                      state=ctrl.state)
        nxt.adopt_pending(4)
        nxt.on_clean_step(4)
        nxt.run_end(5)
        earlier, ctrl = ctrl.records, nxt
    elif name == "incident":
        ctrl.state.pending = {"kind": "incident", "exit_code": 43,
                              "incarnation": 0}
        ctrl.adopt_pending(2)
        ctrl.on_clean_step(2)
        ctrl.on_clean_step(3)
    elif name == "slo":
        ctrl.observe(rec("slo", 1, alert=False))
        ctrl.observe(rec("slo", 2, alert=True, burn=14.0))
        ctrl.observe(rec("memory", 2, headroom_breach=True))
        decisions.append(ctrl.process(2))
        for s in (3, 4):
            ctrl.on_clean_step(s)
    fields = {k: getattr(ctrl.state, k) for k in
              ("excluded", "restarts", "cases", "pending", "case_seq",
               "history")}
    moved = (sorted(os.listdir(save)) if save else None)
    return (earlier + ctrl.records, [_decision(d) for d in decisions],
            fields, moved)


SCENARIOS = ["clear", "quarantine_readmit", "budget", "no_canary",
             "sentinel", "halt", "preemption", "incident", "slo"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controller_records_and_decisions_match_jax(name, clock, tmp_path):
    want = _scenario(JAX, name, str(tmp_path / "jax"))
    clock()
    got = _scenario(PORT, name, str(tmp_path / "port"))
    assert got == want
    assert got[0], "the scenario emitted no remediation record"


def test_exit_codes_of_the_decisions(clock, tmp_path):
    records, decisions, _, moved = _scenario(
        PORT, "quarantine_readmit", str(tmp_path))
    assert [d["exit_code"] for d in decisions] == [
        int(ExitCode.REMEDIATION_RESTART)] * 2
    assert [d["device_count"] for d in decisions] == [2, 4]
    assert decisions[0]["restore_step"] == 2
    assert moved == ["quarantined-case-1", "remediation-state.json",
                     "step_2"]
    halt = _scenario(PORT, "halt", str(tmp_path / "h"))[1]
    assert halt[0]["exit_code"] == int(ExitCode.REMEDIATION_HALT)
    assert [r["action"] for r in records] == [
        "open", "verify", "quarantine", "probation", "readmit"]


@pytest.mark.parametrize("seed", range(20))
def test_random_sequence_matches_jax(seed):
    assert campaign.random_sequence(seed) == [
        campaign.FaultEvent(e.kind, e.step)
        for e in jcampaign.random_sequence(seed)]
    assert campaign.random_sequence(seed, steps=6, max_faults=2) == [
        campaign.FaultEvent(e.kind, e.step)
        for e in jcampaign.random_sequence(seed, steps=6, max_faults=2)]


def _supervise(pkg, root, codes):
    seen = []

    def runner(argv, env):
        seen.append(list(argv))
        return codes.pop(0)

    st = pkg["state"].RemediationState.load(root)
    st.excluded = [3]
    st.save()
    rep = pkg["supervisor"].supervise(
        lambda n: ["train", f"--devices={n}"], root, 4, runner=runner,
        max_incarnations=4, env_for=lambda n: {})
    return (rep.outcome, rep.final_exit_code,
            [(i.index, i.device_count, i.exit_code)
             for i in rep.incarnations], seen,
            pkg["state"].RemediationState.load(root).pending)


@pytest.mark.parametrize("codes", [[43, 44, 0], [44, 45], [1],
                                   [44, 44, 44, 44, 44]])
def test_supervisor_matches_jax(codes, tmp_path):
    want = _supervise(JAX, str(tmp_path / "jax"), list(codes))
    got = _supervise(PORT, str(tmp_path / "port"), list(codes))
    assert got == want


def test_torchrun_command_launches_the_device_count():
    argv = supervisor.torchrun_command(["-m", "pkg", "--n={devices}"])(2)
    assert argv[1:5] == ["-m", supervisor.LAUNCHER, "--standalone",
                         "--nproc-per-node=2"]
    assert argv[-1] == "--n=2"
    env = supervisor.default_env_for(3)
    assert env[supervisor.DEVICES_ENV] == "3"


def test_launcher_exits_with_the_failed_rank_code():
    """``torch.distributed.run`` itself ends with 1 when a rank exits 44;
    the supervisor's launcher ends with the rank's 44 (rank 0, still
    running, is ended by the agent)."""
    argv = supervisor.torchrun_command(
        ["--no-python", "sh", "-c",
         'if [ "$RANK" = 1 ]; then exit 44; fi; sleep 30'])(2)
    t0 = time.monotonic()
    rc = subprocess.run(argv, capture_output=True, timeout=120,
                        cwd=os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__)))).returncode
    assert rc == 44
    assert time.monotonic() - t0 < 30


def test_quarantine_and_state_files_match_jax(tmp_path):
    out = []
    for pkg, name in ((JAX, "jax"), (PORT, "port")):
        root = str(tmp_path / name)
        _step_dirs(root, [1, 2, 3, 5])
        moved = pkg["state"].quarantine_checkpoints(root, 2, "case-9")
        st = pkg["state"].RemediationState.load(root)
        st.excluded, st.restarts = [2, 3], 1
        st.cases = [{"id": "case-9", "state": "quarantined"}]
        st.save()
        with open(pkg["state"].state_path(root)) as f:
            text = f.read()
        out.append((moved, sorted(os.listdir(root)),
                    sorted(os.listdir(os.path.join(root,
                                                   "quarantined-case-9"))),
                    text, st.device_count(4), st.next_case_id()))
    assert out[0] == out[1]
    assert out[1][0] == [3, 5]


def test_minimize_failing_matches_jax():
    faults = [campaign.FaultEvent(k, s) for k, s in
              (("nan", 1), ("slow", 2), ("hang", 3), ("bitflip", 5))]

    def check(candidate):
        kinds = {f.kind for f in candidate}
        return ["hang and bitflip together"] if {"hang", "bitflip"} <= \
            kinds else []

    got = campaign.minimize_failing(faults, check)
    want = jcampaign.minimize_failing(
        [jcampaign.FaultEvent(f.kind, f.step) for f in faults], check)
    assert [(f.kind, f.step) for f in got[0]] == [
        (f.kind, f.step) for f in want[0]] == [("hang", 3), ("bitflip", 5)]
    assert got[1] == want[1]


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The gate's checks 1-3 in one spawned world of 4 (rank 0's
    results)."""
    directory = str(tmp_path_factory.mktemp("loop"))
    return spawn(selftest_rank, 4, args=(directory, "cpu"),
                 timeout=300.0)[0]


def test_the_loop_heals_a_silent_bit_flip_4_2_4(loop):
    failures = []
    loop_checks(failures, loop)
    assert failures == []
    assert [i["devices"] for i in loop["result"].incarnations] == [4, 2, 4]


def _mutations(result):
    """The healed sequence, and two broken copies: one terminal verdict
    dropped, one unverified quarantine added."""
    terms = [r for r in result.remediation if r.get("terminal")]
    dropped = [r for r in result.remediation if r is not terms[0]]
    fake = dict(result.remediation[0], case="case-99", action="quarantine",
                finding="straggler", evidence=[])
    return {"healed": result.remediation, "dropped": dropped,
            "unverified": result.remediation + [fake]}


@pytest.mark.parametrize("mutation", ["healed", "dropped", "unverified"])
def test_check_invariants_matches_jax(loop, mutation):
    reference, result = loop["reference"], loop["result"]
    remediation = _mutations(result)[mutation]
    others = [r for r in result.records if r.get("kind") != "remediation"]
    faults = [(f.kind, f.step) for f in result.faults]
    verdicts = []
    for pkg in (JAX, PORT):
        c = pkg["campaign"]
        seq = c.SequenceResult(
            faults=[c.FaultEvent(k, s) for k, s in faults],
            run_id=result.run_id, outcome=result.outcome,
            incarnations=result.incarnations,
            records=others + remediation, remediation=remediation,
            losses=result.losses)
        verdicts.append(c.check_invariants(
            seq, reference_losses=reference.losses, final_step=7))
    assert verdicts[0] == verdicts[1]
    assert bool(verdicts[1]) == (mutation != "healed")


def test_host_checks_of_the_gate_pass(tmp_path):
    failures = []
    host_checks(failures, str(tmp_path))
    assert failures == []
