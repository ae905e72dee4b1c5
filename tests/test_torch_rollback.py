"""apex_tpu_torch's rollback ladder against the JAX package's: the
``ResilienceManager``'s actions, records and LR dampening on the same
verdict streams, the snapshot ring's backoff, and the aliasing trap (a
snapshot of parameters the optimizer updates in place).

Host values (actions, steps, fields) are compared exactly; a restored
tensor equals its snapshot bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from apex_tpu.resilience import rollback as jrb
from apex_tpu_torch.resilience import rollback as rb
from apex_tpu_torch.resilience.replay import (
    GPTTargetConfig,
    build_gpt_training,
)
from apex_tpu_torch.resilience.sentinel import (
    VERDICT_HALT,
    VERDICT_OK,
    VERDICT_ROLLBACK,
    VERDICT_SKIP,
)

OK, SKIP, RB, HALT = VERDICT_OK, VERDICT_SKIP, VERDICT_ROLLBACK, VERDICT_HALT

STREAMS = {
    # a skip, then a rollback to the newest snapshot
    "skip_then_rollback": [OK, OK, SKIP, OK, RB, OK, OK, OK],
    # repeated rollbacks back off through history, then exhaust the budget
    "repeated_rollbacks": [OK, OK, OK, OK, RB, RB, OK, RB, RB, OK],
    # the sentinel's own halt verdict
    "halt": [OK, SKIP, SKIP, HALT],
    # a rollback before any cadence snapshot but the seeded one
    "early_rollback": [RB, OK, RB, OK],
}


def _drive(mod, verdicts, max_rollbacks, interval, log_path, state_of):
    """The example's host loop over a verdict stream: returns the actions
    taken, the step after each, the manager's records (without their
    wall time) and its final lr_scale and rollbacks."""
    mgr = mod.ResilienceManager(
        buffer=mod.RollbackBuffer(capacity=2, interval=interval),
        policy=mod.EscalationPolicy(max_rollbacks=max_rollbacks,
                                    lr_dampen=0.5),
        log_path=str(log_path))
    mgr.buffer.snapshot(0, state_of(0))
    trace, step = [], 0
    for i, v in enumerate(verdicts):
        action = mgr.resolve(step, v, loss=float(i))
        if action == "halt":
            trace.append((action, step))
            break
        if action == "rollback":
            step, restored = mgr.do_rollback()
            trace.append((action, step, float(np.asarray(restored["w"])[0])))
            continue
        if action == "ok":
            mgr.observe_good(step + 1, state_of(step + 1))
        trace.append((action, step))
        step += 1
    events = [{k: v for k, v in e.items() if k != "t"} for e in mgr.events]
    logged = [{k: v for k, v in json.loads(line).items() if k != "t"}
              for line in open(log_path)]
    assert logged == events
    return trace, events, mgr.lr_scale, mgr.rollbacks_used


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("max_rollbacks,interval", [(3, 1), (1, 2)])
def test_manager_actions_match_jax(tmp_path, name, max_rollbacks, interval):
    verdicts = STREAMS[name]
    want = _drive(jrb, verdicts, max_rollbacks, interval,
                  tmp_path / "jax.jsonl",
                  lambda s: {"w": np.full(3, s, np.float32)})
    got = _drive(rb, verdicts, max_rollbacks, interval,
                 tmp_path / "port.jsonl",
                 lambda s: {"w": torch.full((3,), float(s))})
    assert got == want


def test_snapshot_survives_an_in_place_adam_step_on_the_cpu():
    """The aliasing trap: on the CPU ``.cpu()`` is the same storage, and
    the step updates the model's parameters in place. A snapshot clones;
    a rollback writes the snapshot back into the SAME parameter objects
    (the model keeps training them) and the optimizer state."""
    tr = build_gpt_training(GPTTargetConfig(
        vocab=64, seq_len=16, layers=1, hidden=32, heads=2, micro_batch=2,
        global_batch=4), device="cpu")
    state = tr.init_state()
    x = np.arange(64).reshape(4, 16) % 64
    state, *_ = tr.train_step(state, *tr.reshape_batch(x, np.roll(x, -1, 1)))
    buf = rb.RollbackBuffer(capacity=2)
    buf.snapshot(1, state.as_tuple())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    m_before = {n: t.clone() for n, t in state.opt.exp_avg.items()}
    ids = {n: id(p) for n, p in state.params.items()}
    state, *_ = tr.train_step(state, *tr.reshape_batch(x, np.roll(x, -1, 1)))
    moved = [n for n, p in state.params.items()
             if not torch.equal(p, before[n])]
    assert moved, "the Adam step did not move the parameters"
    step, restored = buf.rollback(into=state.as_tuple())
    assert step == 1 and restored[0] is state.params
    for n, p in state.params.items():
        assert id(p) == ids[n] and torch.equal(p, before[n]), n
        assert torch.equal(state.opt.exp_avg[n], m_before[n]), n
    assert int(state.opt.step) == 1
    model = dict(tr.model.named_parameters())
    assert all(model[n] is p for n, p in state.params.items())
    # without a target, fresh tensors on the snapshot's devices
    _, fresh = buf.rollback()
    assert fresh[0]["embedding.position_embeddings"] is not (
        state.params["embedding.position_embeddings"])


def test_rollback_restores_the_snapshot_devices_and_pops_on_request():
    buf = rb.RollbackBuffer(capacity=2, interval=2)
    assert not buf.maybe_snapshot(1, {"w": torch.zeros(2)})
    assert buf.maybe_snapshot(2, {"w": torch.ones(2)})
    buf.snapshot(4, {"w": torch.full((2,), 4.0)})
    buf.snapshot(6, {"w": torch.full((2,), 6.0)})
    assert buf.steps == [4, 6]
    step, st = buf.rollback(pop=True)
    assert step == 4 and st["w"].tolist() == [4.0, 4.0]
    with pytest.raises(ValueError):
        rb.RollbackBuffer(capacity=0)
    buf.clear()
    with pytest.raises(RuntimeError, match="no snapshots"):
        buf.rollback()
