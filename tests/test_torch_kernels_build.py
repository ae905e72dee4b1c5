"""The kernel build's cache key and command, on the CPU (no ``nvcc``).

A library under ``build/apex_tpu_torch/`` is named by a hash of its
source, of every shared header ``csrc/*.cuh`` and of the flags, so that
editing a header rebuilds every source that may include it instead of
reusing a stale library. These tests work on a copy of ``csrc`` in a
temporary directory and start no compiler.
"""

import shutil

import pytest

from apex_tpu_torch import _kernels

SOURCE = "flash_attention_bwd"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that ``_kernels`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, copy)
    monkeypatch.setattr(_kernels, "_CSRC", copy)
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "build")
    return copy


def test_the_flash_backward_includes_a_shared_header():
    text = (_kernels._CSRC / f"{SOURCE}.cu").read_text()
    assert '#include "flash_mma.cuh"' in text
    assert (_kernels._CSRC / "flash_mma.cuh").exists()


def test_the_flash_forward_includes_the_shared_header():
    """The forward's tensor-core kernels use the backward's helpers
    (cp.async, ldmatrix, mma.sync, the tile loader and the mask rules) from
    flash_mma.cuh, not copies of them."""
    text = (_kernels._CSRC / "flash_attention.cu").read_text()
    assert '#include "flash_mma.cuh"' in text
    header = (_kernels._CSRC / "flash_mma.cuh").read_text()
    for helper in ("load_tile_bf16", "key_band", "attends", "allow_smem"):
        assert helper in header
        assert f"void {helper}(" not in text and f"int {helper}(" not in text


def test_library_path_is_stable(csrc):
    first = _kernels._library_path(SOURCE)
    assert first == _kernels._library_path(SOURCE)
    assert first.parent == _kernels._BUILD
    assert first.name.startswith(f"lib{SOURCE}-") and first.suffix == ".so"


@pytest.mark.parametrize("edited", [f"{SOURCE}.cu", "flash_mma.cuh"])
def test_editing_the_source_or_a_header_changes_the_library(csrc, edited):
    before = _kernels._library_path(SOURCE)
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert _kernels._library_path(SOURCE) != before


def test_a_new_header_changes_every_library(csrc):
    sources = sorted({k.source for k in _kernels.KERNELS.values()})
    before = {s: _kernels._library_path(s) for s in sources}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_kernels._library_path(s) != before[s] for s in sources)


def test_editing_another_source_keeps_the_library(csrc):
    before = _kernels._library_path(SOURCE)
    with open(csrc / "adam.cu", "a") as f:
        f.write("\n// edited\n")
    assert _kernels._library_path(SOURCE) == before


def test_nvcc_is_given_the_headers_directory(csrc, monkeypatch):
    started = []

    class FakePopen:
        def __init__(self, cmd, **kwargs):
            started.append(cmd)

    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", FakePopen)
    proc = _kernels._start_build(SOURCE)
    assert isinstance(proc, FakePopen) and len(started) == 1
    cmd = started[0]
    assert cmd[cmd.index("-I") + 1] == str(csrc)
    assert cmd[-1] == str(csrc / f"{SOURCE}.cu")
    assert proc.out == _kernels._library_path(SOURCE)
