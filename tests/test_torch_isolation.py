"""apex_tpu_torch stands alone: it imports no JAX, no flax and nothing of
the JAX package, and its entry points never carry on quietly on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import apex_tpu_torch
from apex_tpu_torch import _kernels
from apex_tpu_torch.models import GPTModel, generate
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.transformer import TransformerConfig

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "apex_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "apex_tpu")
TINY = TransformerConfig(num_layers=1, hidden_size=32, num_attention_heads=2,
                         vocab_size=16, max_position_embeddings=16,
                         hidden_dropout=0.0, attention_dropout=0.0)


def _forbidden(module: str) -> bool:
    # exact name or a submodule: "apex_tpu_torch" shares the prefix
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_package_imports_with_jax_flax_and_apex_tpu_poisoned():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'flax', 'apex_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import apex_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    apex_tpu_torch.__path__, 'apex_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
    + ["chip_smoke.py"])
def test_no_forbidden_import(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_forbidden_name_match_is_exact():
    assert _forbidden("apex_tpu") and _forbidden("apex_tpu.ops")
    assert _forbidden("jax.numpy") and _forbidden("flax")
    assert not _forbidden("apex_tpu_torch")
    assert not _forbidden("apex_tpu_torch.ops.attention")


def test_entry_points_refuse_a_host_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTModel(TINY)
    model = GPTModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(model, [[1, 2]], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, ServingConfig(max_seq_len=16, block_size=4,
                                           num_blocks=4))
    assert generate(model, [[1, 2]], 2, device="cpu").shape == (1, 4)
    # the fleet's engine factory and the serving gate run on the card too
    from apex_tpu_torch.serving.__main__ import main as serving_main
    from apex_tpu_torch.serving.fleet import (
        FleetConfig,
        FleetRouter,
        engine_factory,
    )

    cfg = ServingConfig(max_seq_len=16, block_size=4, num_blocks=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetRouter(engine_factory(model, cfg), FleetConfig(replicas=1))
    FleetRouter(engine_factory(model, cfg, device="cpu"),
                FleetConfig(replicas=1))
    for argv in (["--selftest"], ["--selftest", "--fleet"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving_main(argv)
    # the serving example, beam search and the bag too; the example's
    # SIGTERM latch is given back when it raises
    import signal

    from apex_tpu_torch.examples.serving.serve_gpt import main as serve_main
    from apex_tpu_torch.models import beam_search
    from apex_tpu_torch.monitor import metric_bag

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main([])
    assert signal.getsignal(signal.SIGTERM) == before
    with pytest.raises(RuntimeError, match="device='cpu'"):
        beam_search(model, [[1, 2]], 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metric_bag({"loss": "mean"})
    assert beam_search(model, [[1, 2]], 2, 2, device="cpu")[0].shape == (
        1, 2, 4)


def test_kernel_wrapper_raises_and_counts_only_launches(monkeypatch):
    """A nonzero cudaError_t raises and is not counted; a clean launch
    counts once."""
    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda: Stream())
    k = _kernels.Kernel("layer_norm", "layer_norm_fwd", [])
    k._fn = lambda *args: 2
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        k()
    assert k.launches == 0
    k._fn = lambda *args: 0
    k()
    assert k.launches == 1


def test_kernels_take_fp32_and_bf16_only():
    assert _kernels.dtype_code(torch.zeros(1)) == 0
    assert _kernels.dtype_code(torch.zeros(1, dtype=torch.bfloat16)) == 1
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _kernels.dtype_code(torch.zeros(1, dtype=torch.float16))


def test_every_kernel_source_exists():
    for k in _kernels.KERNELS.values():
        assert (PACKAGE / "csrc" / f"{k.source}.cu").is_file()
    assert apex_tpu_torch.__version__


def test_amp_slice_entry_points_refuse_a_host_without_cuda(monkeypatch):
    """The amp slice's modules and examples run on the card by default
    and on the CPU only when told."""
    from apex_tpu_torch.examples.dcgan import main_amp as dcgan
    from apex_tpu_torch.examples.imagenet import main_amp as imagenet
    from apex_tpu_torch.examples.simple import amp_mlp_train
    from apex_tpu_torch.fused_dense import FusedDense, FusedDenseGeluDense
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.ops.mlp import mlp_init

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    makers = [
        lambda d: mlp_init(0, [4, 2], device=d),
        lambda d: MLP([4, 2], device=d),
        lambda d: FusedDense(4, 2, device=d),
        lambda d: FusedDenseGeluDense(4, 8, 2, device=d),
        lambda d: FusedLayerNorm(4, device=d),
        lambda d: FusedRMSNorm(4, device=d),
        lambda d: dcgan.build_models(32, 8, device=d),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make("cuda")
        make("cpu")
    for module, argv in (
            (amp_mlp_train, ["--steps", "1"]),
            (dcgan, ["--steps", "1", "--batch-size", "2", "--nz", "4"]),
            (imagenet, ["--steps", "1", "--batch-size", "2",
                        "--image-size", "32"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.train(module.parse_args(argv), log=lambda s: None)
    amp_mlp_train.train(amp_mlp_train.parse_args(
        ["--steps", "1", "--device", "cpu"]), log=lambda s: None)
