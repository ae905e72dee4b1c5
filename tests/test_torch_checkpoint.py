"""apex_tpu_torch's checkpoints against the JAX package's: the per-leaf
fingerprint, the verified walk over saves, tears and corruption, the
retention sweep, the retry schedule, AutoResume's deadline decision and
resume, and the refusal of a restore across a change of layout.

Inputs come from seeded numpy RNGs. Every comparison here is of host
values (crc32s, step lists, decisions, sleeps): exact.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import GPTModel as JaxGPT
from apex_tpu.resilience import chaos as jchaos
from apex_tpu.resilience import integrity as jint
from apex_tpu.resilience import retry as jretry
from apex_tpu.transformer import TransformerConfig as JaxConfig
from apex_tpu.utils import autoresume as jar
from apex_tpu.utils import checkpoint as jckpt
from apex_tpu_torch.models import gpt_params_from_jax
from apex_tpu_torch.monitor import MemorySink, MetricRouter
from apex_tpu_torch.resilience import chaos, integrity, retry
from apex_tpu_torch.resilience.elastic import (
    ElasticRestoreError,
    live_mesh,
    topology_block,
)
from apex_tpu_torch.resilience.replay import (
    GPTTargetConfig,
    build_gpt_training,
)
from apex_tpu_torch.utils import checkpoint as ckpt
from apex_tpu_torch.utils.autoresume import AutoResume
from apex_tpu_torch.utils.timers import (
    Timers,
    annotate,
    step_annotation,
    trace,
)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    handler = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, handler)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree(seed=0):
    """A small state: nested dicts of fp32, bf16 and int32 leaves."""
    rs = np.random.RandomState(seed)
    return {"layer_0": {"kernel": rs.randn(4, 3).astype(np.float32),
                        "bias": rs.randn(3).astype(np.float32)},
            "step": np.asarray(seed, np.int32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


# -- the fingerprint ---------------------------------------------------------

def test_fingerprint_of_the_gpt_parameters_equals_jax():
    """The JAX GPT's parameters carried across: every leaf's path, dtype,
    shape and crc32, and the structure hash, equal the JAX package's."""
    cfg = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
               vocab_size=128, max_position_embeddings=32)
    jmodel = JaxGPT(config=JaxConfig(compute_dtype=jnp.float32, **cfg))
    params = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((2, 16), jnp.int32))["params"])
    want = jint.tree_fingerprint(params)
    got = integrity.tree_fingerprint(gpt_params_from_jax(params))
    assert got == want
    assert len(got["leaves"]) > 20
    # bf16 and int leaves read their raw bytes too
    tree = {"a": np.arange(6, dtype=np.int32),
            "b": jnp.asarray(np.linspace(-2, 2, 7), jnp.bfloat16)}
    port = {"a": torch.arange(6, dtype=torch.int32),
            "b": torch.from_numpy(np.array(tree["b"]).view(np.int16)
                                  ).view(torch.bfloat16)}
    assert integrity.tree_fingerprint(port) == jint.tree_fingerprint(tree)


def test_state_classes_are_paths_as_jax_names_fields():
    """A state tuple's dataclass fields read ``.field``, as JAX's
    registered dataclasses do; the topology block joins on those paths."""
    tr = build_gpt_training(GPTTargetConfig(
        vocab=64, seq_len=16, layers=1, hidden=32, heads=2, micro_batch=2,
        global_batch=4), device="cpu")
    state = tr.init_state().as_tuple()
    paths = [leaf["path"] for leaf in
             integrity.tree_fingerprint(state)["leaves"]]
    assert paths[0] == "[0]['embedding']['position_embeddings']"
    assert "[1].step" in paths and "[2].scale" in paths
    assert "[3].anomalies" in paths
    block = topology_block(state)
    assert [leaf["path"] for leaf in block["leaves"]] == paths
    assert block["mesh"] == live_mesh() == {
        "axes": {"dp": 1, "pp": 1, "cp": 1, "tp": 1}, "devices": 1}


# -- saves, tears, corruption and retention ----------------------------------

def _scenario(pkg, directory):
    """The same sequence on each package's own directory; returns what
    each step of it observed."""
    mod_int, mod_ckpt, mod_chaos, marker, wrap = pkg
    seen = {}
    for s in range(1, 7):
        mod_int.save_checkpoint_verified(directory, s, wrap(_tree(s)))
    # step 6 uncommitted (its manifest never landed), step 5 bit-flipped,
    # step 4 truncated; step 7 an empty dir, step 8 a file, step 9 an
    # interrupted save's temporary dir
    os.remove(mod_int.manifest_path(os.path.join(directory, "step_6")))
    mod_chaos.corrupt_checkpoint(os.path.join(directory, "step_5"),
                                 mode="bitflip")
    mod_chaos.corrupt_checkpoint(os.path.join(directory, "step_4"),
                                 mode="truncate")
    os.makedirs(os.path.join(directory, "step_7"))
    open(os.path.join(directory, "step_8"), "w").close()
    os.makedirs(os.path.join(directory, f"step_9{marker}123"))
    seen["finalized"] = mod_ckpt.finalized_steps(directory)
    seen["latest"] = mod_ckpt.latest_step(directory)
    seen["shallow"] = mod_int.verified_steps(directory, deep=False)
    seen["deep"] = mod_int.verified_steps(directory, deep=True)
    seen["verified_latest"] = mod_int.verified_latest_step(directory)
    seen["restored"] = mod_int.load_checkpoint_verified(directory)[0]
    seen["restored_legacy"] = mod_int.load_checkpoint_verified(
        directory, allow_unverified=True)[0]
    seen["reasons"] = [
        mod_int.verify_checkpoint(os.path.join(directory, f"step_{s}"))[0]
        for s in range(1, 7)]
    seen["deleted"] = mod_int.apply_retention(directory, keep_last_n=2)
    seen["kept"] = mod_ckpt.finalized_steps(directory)
    seen["tmp_left"] = sorted(n for n in os.listdir(directory)
                              if marker in n)
    # a tombstoned save is skipped by every walk, legacy-tolerant too
    mod_int.write_abandoned_marker(os.path.join(directory, "step_6"))
    seen["after_tombstone"] = mod_int.load_checkpoint_verified(
        directory, allow_unverified=True)[0]
    return seen


def test_saves_tears_corruption_and_retention_match_jax(tmp_path):
    jax_pkg = (jint, jckpt, jchaos, jckpt.ORBAX_TMP_MARKER, lambda t: t)
    port_pkg = (integrity, ckpt, chaos, ckpt.TMP_MARKER, _torch)
    want = _scenario(jax_pkg, str(tmp_path / "jax"))
    got = _scenario(port_pkg, str(tmp_path / "port"))
    assert got == want
    assert got["finalized"] == [1, 2, 3, 4, 5, 6]
    assert got["shallow"] == [1, 2, 3, 5] and got["deep"] == [1, 2, 3]
    assert (got["restored"], got["restored_legacy"]) == (3, 6)
    assert got["deleted"] == [1, 2, 4] and got["kept"] == [3, 5, 6]
    assert got["after_tombstone"] == 3


def test_restore_copies_into_the_target_and_refuses_other_layouts(tmp_path):
    tree = _torch(_tree(1))
    integrity.save_checkpoint_verified(str(tmp_path), 3, tree)
    live = _torch(_tree(2))
    kernel = live["layer_0"]["kernel"]
    ar = AutoResume(str(tmp_path), install_handlers=False)
    step, state = ar.restore(live)
    assert step == 3 and state is live
    assert state["layer_0"]["kernel"] is kernel  # written in place
    assert torch.equal(kernel, tree["layer_0"]["kernel"])
    # a manifest from a world of 2 (dp = 2) whose leaves keep their
    # global shapes: resharded onto this world of one, not refused
    path = integrity.manifest_path(str(tmp_path / "step_3"))
    integrity.write_manifest(
        str(tmp_path / "step_3"), tree,
        topology=topology_block(tree, {"axes": {"dp": 2, "tp": 1, "pp": 1},
                                       "devices": 2}))
    assert os.path.exists(path)
    fresh = _torch(_tree(4))
    step, state = ar.restore(fresh)
    assert step == 3 and torch.equal(fresh["layer_0"]["kernel"],
                                     tree["layer_0"]["kernel"])
    # one whose leaf had another global shape there (not a ZeRO buffer):
    # refused with the resharder's reason, nothing loaded
    topo = topology_block(tree, {"axes": {"dp": 2, "tp": 1, "pp": 1},
                                 "devices": 2})
    leaf = next(l for l in topo["leaves"]
                if l["path"] == "['layer_0']['kernel']")
    leaf["shape"] = [leaf["shape"][0] * 2] + leaf["shape"][1:]
    integrity.write_manifest(str(tmp_path / "step_3"), tree, topology=topo)
    fresh = _torch(_tree(4))
    with pytest.raises(ElasticRestoreError, match="manifest disagree"):
        ar.restore(fresh)
    with pytest.raises(ElasticRestoreError):
        integrity.load_checkpoint_verified(str(tmp_path), target=fresh)
    assert torch.equal(fresh["layer_0"]["kernel"],
                       _torch(_tree(4))["layer_0"]["kernel"])
    # another structure is a ValueError from the payload, never a load
    with pytest.raises(ValueError, match="structure differs"):
        ckpt.load_checkpoint(str(tmp_path), 3, target={"x": fresh})
    ar.close()


# -- AutoResume ----------------------------------------------------------------

@pytest.mark.parametrize("grace,save_ema,fin_ema,pending,elapsed", [
    (None, None, None, False, 0.0),
    (10.0, None, None, True, 1.0),
    (10.0, 4.0, 1.0, True, 1.0),
    (10.0, 8.0, 1.0, True, 1.0),
    (10.0, 8.0, 9.0, True, 1.0),
    (10.0, 8.0, None, True, 3.0),
    (10.0, 8.0, 1.0, False, 1.0),
    (2.0, 8.0, 1.0, True, 0.5),
])
def test_emergency_decision_matches_jax(grace, save_ema, fin_ema, pending,
                                        elapsed):
    """The deadline decision is a pure function of the budget, the
    signal's arrival, the save EMAs and the pending save: the port's
    equals JAX's at each point."""
    out = []
    for cls in (jar.AutoResume, AutoResume):
        ar = cls("/nonexistent", install_handlers=False, grace_s=grace)
        ar._save_ema, ar._finalize_ema = save_ema, fin_ema
        ar._pending = {"step": 7} if pending else None
        ar._sigterm_t = 100.0
        out.append(ar._emergency_decision(now=100.0 + elapsed))
    assert out[0] == out[1]


def test_autoresume_interval_sigterm_resume_and_incident(tmp_path):
    """Interval saves commit in the background, a SIGTERM saves the
    current step durably, a rerun resumes from it, and the incident
    hook tombstones an uncommitted save (exactly the JAX package's
    semantics)."""
    d = str(tmp_path)
    state = _torch(_tree(0))
    mem = MemorySink()
    router = MetricRouter([mem])
    from apex_tpu_torch.monitor.goodput import spans

    spans.set_router(router)
    try:
        ar = AutoResume(d, interval=2, keep_last_n=2)
        for s in range(1, 6):
            state["step"].fill_(s)
            if s == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            if ar.step(s, state):
                break
        assert (s, ar.termination_decision) == (4, "save")
        ar.close()
        assert integrity.verified_steps(d, deep=True) == [2, 4]
        assert integrity.read_manifest(os.path.join(d, "step_4"))[
            "autoresume"]["save_ema_s"] is not None
        preemption = [r for r in mem.records if r["kind"] == "preemption"]
        assert preemption[0]["decision"] == "save"
        assert {r["phase"] for r in mem.records
                if r["kind"] == "span"} >= {"ckpt_save"}
        # the rerun resumes from step 4 and inherits the save EMA
        live = _torch(_tree(9))
        ar2 = AutoResume(d, interval=2, background_finalize=False)
        step, _ = ar2.restore(live)
        assert step == 4 and int(live["step"]) == 4
        assert ar2._save_ema is not None
        # an interval save left uncommitted, then the incident exit
        live["step"].fill_(6)
        ar2.step(6, live)
        assert ar2.prepare_incident_exit() == 6
        ar2._writer.wait()  # the write itself still lands
        ok, reason = integrity.verify_checkpoint(os.path.join(d, "step_6"))
        assert not ok and "abandoned" in reason
        assert integrity.load_checkpoint_verified(
            d, allow_unverified=True)[0] == 4
        ar2.close()
    finally:
        spans.set_router(None)
        router.close()


def test_async_writer_snapshot_is_a_copy(tmp_path):
    """The writer's host copy is taken before ``save`` returns, so an
    in-place update right after it does not reach the file."""
    state = _torch(_tree(0))
    before = state["layer_0"]["kernel"].clone()
    with ckpt.AsyncCheckpointWriter() as w:
        w.save(str(tmp_path), 1, state)
        state["layer_0"]["kernel"].add_(1.0)
    saved = ckpt.load_checkpoint(str(tmp_path), 1, target=state)
    assert torch.equal(saved["layer_0"]["kernel"], before)
    assert saved["layer_0"]["kernel"] is not state["layer_0"]["kernel"]


# -- retry and timers ----------------------------------------------------------

def test_retry_schedule_and_records_match_jax():
    """Jittered backoff from the same seeded draws, the same give-up,
    and the same ``kind="retry"`` fields."""
    import random

    out = []
    for mod in (jretry, retry):
        calls, sleeps = [], []

        class Router:
            def __init__(self):
                self.events = []

            def event(self, kind, step, **fields):
                self.events.append((kind, step, fields))

        router = Router()

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError(f"flaky {len(calls)}")
            return "done"

        res = mod.retry_with_backoff(
            flaky, retries=4, backoff=0.1, jitter=0.25, what="save",
            router=router, rng=random.Random(5), sleep=sleeps.append)
        with pytest.raises(OSError):
            mod.retry_with_backoff(
                lambda: (_ for _ in ()).throw(OSError("down")), retries=1,
                router=router, sleep=sleeps.append)
        out.append((res, len(calls), sleeps, router.events))
    assert out[0] == out[1]


def test_timers_write_interval_records_and_annotations(tmp_path):
    """Interval timer records, and the step and named ranges in a
    profiler trace under the names ``torch.profiler`` splits on."""
    import json

    mem = MemorySink()
    router = MetricRouter([mem])
    timers = Timers(write_fn=router.timer_write_fn)
    with trace(str(tmp_path)):
        for step in range(3):
            with step_annotation(step), annotate("fwd"):
                timers("step").start()
                torch.ones(4).sum()
                timers("step").stop(barrier_on=True)
    names = {e.get("name") for e in json.load(
        open(tmp_path / "trace.json"))["traceEvents"]}
    assert {"ProfilerStep#0", "ProfilerStep#2", "fwd"} <= names
    timers.write(["step"], 2, normalizer=3)
    (rec,) = [r for r in mem.records if r["kind"] == "timer"]
    assert rec["name"] == "step-time" and rec["step"] == 2
    assert 0.0 <= rec["seconds"] < 1.0
    assert timers("step").elapsed() == 0.0  # reset by the write
    router.close()
