"""apex_tpu_torch's flight recorder, replayer and bisector against the JAX
package's, and the recovery drills through the port's GPT example on the
CPU at the JAX drill's sizes (``tests/test_replay.py``'s ``_DRILL``).

Journals, crc32s, exit codes, steps and leaf paths are compared exactly.
The drills compare losses bit for bit within one process (the same step
from the same state on the same device), and across two processes by
every fingerprint.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu.resilience.replay import journal as jjournal
from apex_tpu.resilience.replay import replayer as jreplayer
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.monitor.goodput import spans as port_spans
from apex_tpu_torch.resilience import integrity
from apex_tpu_torch.resilience.replay import (
    FlightRecorder,
    batch_crc,
    compare_journals,
    determinism_guard,
    load_journal,
    numerics_flags_kept,
)
from apex_tpu_torch.resilience.replay.__main__ import main as replay_main
from apex_tpu_torch.utils.checkpoint import finalized_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRILL = ["--device", "cpu", "--steps", "8", "--layers", "2", "--hidden",
          "64", "--heads", "4", "--seq-len", "32", "--micro-batch", "1",
          "--global-batch", "16", "--log-interval", "2", "--save-interval",
          "2"]


@pytest.fixture(autouse=True)
def _restore_process_state():
    """The example's routers install a SIGTERM flush and flush hooks, and
    its AutoResume a SIGTERM latch: put them back after each test. The
    in-process drills' tiny steps run on one intra-op thread: beside the
    other test workers' processes, torch's default of one thread a core
    made them 5-8 times slower (152 s against 29 s for
    ``test_nan_rollback_sigterm_resume_and_corrupt_latest`` beside six
    busy processes on 8 cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    handler = signal.getsignal(signal.SIGTERM)
    hooks = list(port_router._FLUSH_HOOKS)
    cudnn = torch.backends.cudnn
    flags = (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
             cudnn.benchmark, cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    yield
    signal.signal(signal.SIGTERM, handler)
    port_router._FLUSH_HOOKS[:] = hooks
    port_spans.set_router(None)
    (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32,
     cudnn.benchmark, cudnn.deterministic) = flags[:4]
    torch.use_deterministic_algorithms(flags[4])
    if env is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    torch.set_num_threads(threads)


def _losses(records):
    """The loss of each step, the last run of a step winning (a rolled
    back step runs again)."""
    return {r["step"]: r["loss"] for r in records}


# -- the journal ---------------------------------------------------------------

def _record(recorder_cls, path):
    rs = np.random.RandomState(0)
    x = rs.randint(0, 64, (4, 16)).astype(np.int32)
    rec = recorder_cls(path)
    rec.header("run-x", "gpt", config={"vocab": 64}, devices=1,
               platform="cpu")
    rec.anchor(0, init=True)
    for step in range(3):
        rec.step(step, batch=[4 * step, 4 * step + 4],
                 batch_crc=batch_crc(x + step, x), inject_nan=0.0,
                 lr_scale=1.0, loss=1.0 / (step + 3), verdict=0,
                 layer_rms=np.asarray([0.5, 0.25 + step], np.float32))
    rec.event(1, "bitflip_injected", path="['w']", element=3)
    rec.anchor(2)
    rec.close()


def test_each_package_reads_the_others_journal(tmp_path):
    """The same record schema: JAX's loader reads the port's journal and
    the port's JAX's, to the same steps, anchors and events."""
    ports, jaxs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    _record(FlightRecorder, ports)
    _record(jjournal.FlightRecorder, jaxs)

    def view(j):
        strip = (lambda r: {k: v for k, v in r.items() if k != "t"})
        return ({s: strip(r) for s, r in j.steps.items()},
                {s: strip(r) for s, r in j.anchors.items()},
                [strip(e) for e in j.events], strip(j.header),
                j.step_range())

    assert view(jjournal.load_journal(ports)) == view(load_journal(ports))
    assert view(load_journal(jaxs)) == view(load_journal(ports))
    assert view(jjournal.load_journal(jaxs)) == view(load_journal(jaxs))
    # the fingerprint diff of two journals is JAX's
    a, b = load_journal(ports), load_journal(jaxs)
    b.steps[2] = dict(b.steps[2], loss=0.5)
    got, want = compare_journals(a, b), jreplayer.compare_journals(a, b)
    assert (got.ok, got.divergences, got.compared) == (
        want.ok, want.divergences, want.compared)
    assert [d["field"] for d in got.divergences] == ["loss"]


def test_batch_crc_equals_jax_on_arrays_and_tensors():
    rs = np.random.RandomState(1)
    x = rs.randint(0, 50257, (16, 1024)).astype(np.int32)
    y = np.roll(x, -1, 1)
    want = jjournal.batch_crc(x, y)
    assert batch_crc(x, y) == want
    assert batch_crc(torch.from_numpy(x), torch.from_numpy(y)) == want


def test_bitflip_names_the_leaf_as_jax_does():
    """The flip event's path is the one the bisect reads off the
    manifest: over the JAX GPT's parameters carried across, the port
    flips the leaf, element and bit JAX's ``bitflip_leaf`` does, with the
    same values before and after (exact)."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.models import GPTModel as JaxGPT
    from apex_tpu.resilience.chaos import bitflip_leaf as jax_bitflip
    from apex_tpu.transformer import TransformerConfig as JaxConfig
    from apex_tpu_torch.models import gpt_params_from_jax
    from apex_tpu_torch.resilience.chaos import bitflip_leaf

    jmodel = JaxGPT(config=JaxConfig(
        compute_dtype=jnp.float32, num_layers=2, hidden_size=32,
        num_attention_heads=4, vocab_size=64, max_position_embeddings=16))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port = gpt_params_from_jax(params)
    for seed, path_filter in [(0, None), (1, "['layer_1']"), (5, "kernel")]:
        _, want = jax_bitflip(params, seed=seed, path_filter=path_filter)
        flipped, got = bitflip_leaf(port, seed=seed, path_filter=path_filter)
        assert got == want
        name = ".".join(k.strip("[]'") for k in got["path"].split("]["))
        assert flipped[name] is not port[name]
        assert all(flipped[n] is t for n, t in port.items() if n != name)


def test_determinism_guard_records_pins_and_applies():
    torch.backends.cuda.matmul.allow_tf32 = True
    with numerics_flags_kept():
        recorded = determinism_guard(pin=False, device="cpu")
        assert recorded["matmul_tf32"] is True  # recorded, not changed
        assert torch.backends.cuda.matmul.allow_tf32
        assert recorded["platform"] == "cpu" and "torch_version" in recorded
        pinned = determinism_guard(pin=True, device="cpu")
        assert pinned["matmul_tf32"] is False and pinned["cudnn_deterministic"]
        determinism_guard(header=dict(recorded), device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32  # the header's value
        determinism_guard(pin=True, device="cpu")
    # the block hands back the flags it found
    assert determinism_guard(pin=False, device="cpu") == recorded


# -- the drills through the example --------------------------------------------

def test_gpt_replay_bitflip_drill(tmp_path):
    """A bit flipped into one parameter after step 3 passes the sentinel
    and the run completes; the clean run replays bitwise with zero
    divergence (exit 0), the flipped one diverges (exit 2), and the
    bisect names step 4, exactly the flipped leaf, and anchors 2 and 4."""
    clean, flip = str(tmp_path / "clean"), str(tmp_path / "flip")
    pretrain_gpt.main(_DRILL + ["--save", clean])
    records = pretrain_gpt.main(_DRILL + ["--save", flip,
                                          "--chaos-bitflip-step", "3"])
    assert [r["verdict"] for r in records] == ["ok"] * 8
    fj = load_journal(flip)
    (flip_event,) = [e for e in fj.events
                     if e["event"] == "bitflip_injected"]
    assert flip_event["step"] == 3
    assert replay_main([clean, "--device", "cpu"]) == 0
    assert replay_main([flip, "--device", "cpu"]) == 2
    forensics = str(tmp_path / "forensics.jsonl")
    assert replay_main([flip, "--bisect", "--device", "cpu",
                        "--json", forensics]) == 0
    out = [json.loads(line) for line in open(forensics)]
    (div,) = [r for r in out if r["kind"] == "divergence"]
    assert div["found"] is True and div["step"] == 4
    assert div["exact_leaves"] is True
    assert div["leaves"] == ["[0]" + flip_event["path"]]
    assert div["clean_anchor"] == 2 and div["dirty_anchor"] == 4
    assert {r["phase"] for r in out if r["kind"] == "span"} >= {
        "ckpt_restore", "step"}


def test_nan_rollback_sigterm_resume_and_corrupt_latest(tmp_path):
    """The JAX suite's chaos story (tests/test_resilience.py
    TestChaosEndToEnd) through the example: a NaN at step 3 with no skip
    budget rolls back to the step-2 snapshot (lr dampening 1.0, so the
    replayed trajectory is the baseline's) and a SIGTERM after step 5
    saves step 6 and exits; the newest checkpoint is then bit-flipped on
    disk, and the rerun resumes from step 4 and completes. Every loss
    equals the unbroken run's bit for bit."""
    base = _losses(pretrain_gpt.main(_DRILL))
    d = str(tmp_path / "ck")
    a = pretrain_gpt.main(_DRILL + [
        "--save", d, "--keep-last-n", "3", "--chaos-nan-steps", "3",
        "--skip-budget", "0", "--snapshot-interval", "2", "--lr-dampen",
        "1.0", "--chaos-sigterm-step", "5"])
    ladder = [(json.loads(line)["kind"], json.loads(line)["step"])
              for line in open(os.path.join(d, "anomalies.jsonl"))]
    assert ladder == [("rollback", 3), ("rollback_restore", 2)]
    assert [r["step"] for r in a] == [0, 1, 2, 3, 2, 3, 4, 5]
    assert np.isnan(a[3]["loss"])
    assert _losses(a) == {s: base[s] for s in range(6)}
    assert integrity.verified_latest_step(d) == 6
    assert len(finalized_steps(d)) <= 3
    # the newest checkpoint bit-flipped: the rerun falls back to step 4
    b = pretrain_gpt.main(_DRILL + ["--save", d, "--chaos-corrupt-latest",
                                    "bitflip"])
    assert [r["step"] for r in b] == [4, 5, 6, 7]
    assert _losses(b) == {s: base[s] for s in range(4, 8)}
    journal = load_journal(d)
    assert [e["event"] for e in journal.events] == ["rollback"]
    assert len(journal.headers) == 2 and journal.anchors[4]


def test_journal_and_replay_hand_back_the_numerics_flags(tmp_path):
    """An explicit --journal pins TF32 off for its run, and a replay
    applies the journal's flags; each puts the caller's flags back when
    it returns."""
    matmul = torch.backends.cuda.matmul
    matmul.allow_tf32 = True
    d = str(tmp_path / "ck")
    pretrain_gpt.main(_DRILL + ["--steps", "2", "--save", d, "--journal"])
    assert matmul.allow_tf32
    assert load_journal(d).header["matmul_tf32"] is False
    assert replay_main([d, "--device", "cpu"]) == 0
    assert replay_main([d, "--bisect", "--device", "cpu"]) == 0
    assert matmul.allow_tf32


def test_the_stream_is_sized_from_the_run(tmp_path, monkeypatch):
    """A run that reads more batches than the shortest stream holds gets
    a longer one (its steps and the data skip budget, exactly), begun
    with the same tokens; the journal header records its length and the
    replay regenerates it."""
    from apex_tpu_torch.resilience.replay import synthetic_corpus

    monkeypatch.setattr(pretrain_gpt, "CORPUS_TOKENS", 2_000)
    d = str(tmp_path / "ck")
    records = pretrain_gpt.main(_DRILL + ["--save", d])
    assert [r["step"] for r in records] == list(range(8))
    n_tokens = (8 + 16) * 16 * 32 + 1  # (steps + skip budget) batches
    assert load_journal(d).header["corpus"]["synthetic"] == {
        "vocab": 512, "n_tokens": n_tokens}
    from apex_tpu_torch.data import IndexedTokenDataset

    np.testing.assert_array_equal(
        IndexedTokenDataset(synthetic_corpus(512, n_tokens)).tokens[:2_000],
        IndexedTokenDataset(synthetic_corpus(512, 2_000)).tokens)
    assert replay_main([d, "--device", "cpu"]) == 0


def test_replay_selftest_passes_on_the_cpu(tmp_path):
    assert replay_main(["--selftest", "--device", "cpu",
                        "--dir", str(tmp_path)]) == 0


_DETERMINISM_CHILD = r"""
import json
import numpy as np
from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
from apex_tpu_torch.resilience import integrity
from apex_tpu_torch.resilience.replay import (
    GPTTargetConfig, build_gpt_training, determinism_guard, synthetic_corpus)

determinism_guard(device="cpu")
cfg = GPTTargetConfig(vocab=64, seq_len=16, layers=2, hidden=32, heads=4,
                      micro_batch=1, global_batch=8, collect_layer_rms=True)
training = build_gpt_training(cfg, device="cpu")
lm = LMDataset(IndexedTokenDataset(synthetic_corpus(64, 4_000)), 16)
state = training.init_state()
steps = []
for step in range(5):
    x, y = training.reshape_batch(*lm.batch(range(8 * step, 8 * step + 8)))
    state, loss, verdict, _, rms = training.train_step(state, x, y)
    steps.append([loss, verdict, rms])
fp = integrity.tree_fingerprint(state.as_tuple())
print("FINGERPRINTS " + json.dumps(
    {"steps": steps, "state": fp["structure_hash"],
     "crcs": [leaf["crc32"] for leaf in fp["leaves"]]}))
"""


def test_cross_process_determinism():
    """Two fresh processes running the same 5 steps give the same
    per-step fingerprints and the same crc32 of every state leaf."""
    results = []
    for _ in range(2):
        # one intra-op thread, as the drills above (the fixture's reason)
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO
                   + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run(
            [sys.executable, "-c", _DETERMINISM_CHILD], capture_output=True,
            text=True, cwd=REPO, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-1500:]
        (line,) = [line for line in proc.stdout.splitlines()
                   if line.startswith("FINGERPRINTS ")]
        results.append(json.loads(line[len("FINGERPRINTS "):]))
    assert results[0] == results[1]
    assert len(results[0]["crcs"]) > 20
