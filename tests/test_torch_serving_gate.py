"""``python -m apex_tpu_torch.serving --selftest [--fleet]`` on the CPU
(the serving gate's counterpart of the JAX package's), and the x-ray
command line over a stream the engine wrote."""

import json
import signal

import numpy as np
import pytest
import torch

from apex_tpu_torch.models import GPTModel
from apex_tpu_torch.monitor import JsonlSink, MetricRouter
from apex_tpu_torch.monitor import router as port_router
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.serving.__main__ import main, tiny_config
from apex_tpu_torch.serving.trace.__main__ import main as trace_main


@pytest.fixture(autouse=True)
def _restore_process_state():
    handler = signal.getsignal(signal.SIGTERM)
    hooks = list(port_router._FLUSH_HOOKS)
    yield
    signal.signal(signal.SIGTERM, handler)
    port_router._FLUSH_HOOKS[:] = hooks


@pytest.mark.parametrize("argv", [
    ["--selftest", "--device", "cpu"],
    ["--selftest", "--fleet", "--device", "cpu"],
])
def test_serving_gate_passes_on_the_cpu(argv, capsys):
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "all checks passed" in out and "FAIL" not in out


def test_trace_cli_gates_an_engine_stream(tmp_path, capsys):
    """The x-ray passes on a stream the engine wrote to jsonl and fails
    on one with no trace records."""
    path = tmp_path / "serving.jsonl"
    router = MetricRouter([JsonlSink(str(path))])
    eng = ServingEngine(GPTModel(tiny_config(), device="cpu", seed=0),
                        ServingConfig(lanes=2, block_size=8, num_blocks=8,
                                      max_seq_len=32),
                        device="cpu", router=router)
    rs = np.random.RandomState(0)
    for n in (5, 9, 12, 0):
        eng.submit(rs.randint(0, 61, size=n), max_new_tokens=4)
    while not eng.idle:
        eng.tick()
    eng.drain()
    router.close()
    out_json = tmp_path / "decomp.jsonl"
    assert trace_main([str(path), "--json", str(out_json), "-v"]) == 0
    decomps = [json.loads(line) for line in out_json.read_text().splitlines()]
    assert len(decomps) == 4 and all(d["kind"] == "trace_decomp"
                                     for d in decomps)
    bare = tmp_path / "bare.jsonl"
    bare.write_text(json.dumps({"kind": "metrics", "step": 0}) + "\n")
    assert trace_main([str(bare)]) == 1
    assert "no trace records" in capsys.readouterr().out
