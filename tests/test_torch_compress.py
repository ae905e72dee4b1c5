"""apex_tpu_torch's compressed gradient collectives
(``parallel.compress``) and the compressed DDP gradient sync against the
JAX package's.

On one process: ``quantize_blockwise`` and ``dequantize_blockwise`` are
bit-equal to JAX's in int8 and fp8 (payload bits, scales and the
dequantized values), ragged tails, zero blocks and NaN and Inf blocks
included; ``predicted_psum_wire_bytes`` is JAX's number; the refusals
are JAX's.

Over a spawned world of 4 gloo ranks against JAX's functions under
``shard_map`` (``check_vma=False``) on as many devices of the CPU mesh:
``quantized_psum`` (with the transmitted value), ``quantized_psum_scatter``
and ``quantized_all_gather`` at n = 2 and 4, int8 and fp8, at 1e-6
relative (the phase 1 sum of the dequantized rows is taken in rank order
on both sides; every code comes from one rank's own data and is
bit-equal with JAX's eager ``quantize_blockwise``; what a rank sent and
its residual agree to 1e-6 of their scale, since JAX's compiled step
rounds the scale and ``acc - code * scale`` otherwise than its eager
functions by an fp32 ulp), and digit for digit on scale-exact integer
data; error
feedback telescopes (the sum of what a rank sent plus its last residual
is the sum of its gradients, to fp32 rounding); ``all_reduce_gradients``
with compression, with and without the residual, over 3 steps: the
gradients at 1e-6 relative and the residuals as what a rank sent; and
its refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.parallel import compress as jc
from apex_tpu.parallel.ddp import all_reduce_gradients as jax_all_reduce
from apex_tpu_torch.parallel import compress as tc
from apex_tpu_torch.parallel.ddp import all_reduce_gradients
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    jobs_worker,
    spawn,
)

WORKERS = "apex_tpu_torch.transformer.testing.compress_workers"

WORLD = 4
DTYPES = ("int8", "fp8")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _jcfg(**kw):
    return jc.CompressionConfig(**kw)


def _quantize_cases():
    rs = np.random.RandomState(0)
    cases = {}
    for n in (1, 5, 128, 129, 300, 1000):
        cases[f"randn {n}"] = (rs.randn(n) * 3).astype(np.float32)
    x = rs.randn(400).astype(np.float32)
    x[:128] = 0.0  # a zero block
    x[200] = np.nan
    x[390] = np.inf  # in the ragged last block
    cases["zero, NaN and Inf blocks"] = x
    cases["tiny and huge"] = np.concatenate([
        rs.randn(128) * 1e-30, rs.randn(128) * 1e30,
        rs.randn(77) * 1e-3]).astype(np.float32)
    return cases


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block", [128, 32])
def test_quantize_and_dequantize_are_bit_equal_to_jax(dtype, block):
    jcfg, tcfg = _jcfg(dtype=dtype, block_size=block), \
        tc.CompressionConfig(dtype=dtype, block_size=block)
    for name, x in _quantize_cases().items():
        jp, js = jc.quantize_blockwise(jnp.asarray(x), jcfg)
        tp, ts = tc.quantize_blockwise(torch.from_numpy(x), tcfg)
        assert tp.dtype == tcfg.wire_dtype and ts.dtype == torch.float32
        np.testing.assert_array_equal(_bits(jp), tp.view(torch.uint8).numpy(),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(js), ts.numpy(),
                                      err_msg=name)
        jd = np.asarray(jc.dequantize_blockwise(jp, js, jcfg))
        td = tc.dequantize_blockwise(tp, ts, tcfg).numpy()
        np.testing.assert_array_equal(jd, td, err_msg=name)
        if "NaN" in name:  # both poisoned blocks dequantize to NaN
            nan_at, inf_at = 200 // block * block, 390 // block * block
            assert np.isnan(td[nan_at:nan_at + block]).all()
            assert np.isnan(td[inf_at:inf_at + block]).all()
            assert np.isfinite(td[:nan_at]).all() and (td[:128] == 0).all()


def test_wire_bytes_and_config_match_jax():
    for dtype in DTYPES:
        for size, n, block in ((1000, 4, 128), (7, 4, 128), (4096, 2, 32),
                               (62_717_952, 2, 128), (1, 1, 128)):
            assert tc.predicted_psum_wire_bytes(
                size, n, tc.CompressionConfig(dtype=dtype, block_size=block)
            ) == jc.predicted_psum_wire_bytes(
                size, n, _jcfg(dtype=dtype, block_size=block))
        assert tc.CompressionConfig(dtype=dtype).qmax == \
            _jcfg(dtype=dtype).qmax
    with pytest.raises(ValueError, match="not one of"):
        tc.CompressionConfig(dtype="int4")
    with pytest.raises(ValueError, match="block_size"):
        tc.CompressionConfig(block_size=0)
    with pytest.raises(ValueError, match="ef_state without compression"):
        all_reduce_gradients({"a": torch.ones(3)},
                             ef_state={"a": torch.zeros(3)})


def test_world_of_one_is_the_identity_with_a_zero_residual():
    g = {"a": torch.randn(40), "b": torch.randn(3, 5)}
    cfg = tc.CompressionConfig()
    red, ef = all_reduce_gradients(g, compression=cfg,
                                   ef_state=tc.ef_init(g))
    for k in g:
        assert torch.equal(red[k], g[k]) and not ef[k].any()
    assert torch.equal(tc.quantized_psum_scatter(g["a"], None, cfg), g["a"])


# -- the collectives over a world of 4 -----------------------------------------

def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("dp",))


def _per_rank(fn, n, n_out):
    return jax.jit(shard_map(fn, mesh=_mesh(n), in_specs=(P("dp"),),
                             out_specs=(P("dp"),) * n_out, check_vma=False))


def _collective_cases():
    """{name: (case for the port, JAX's outputs stacked by rank)}."""
    rs = np.random.RandomState(1)
    cases, refs = {}, {}
    for dtype in DTYPES:
        for n in (2, 4):
            jcfg = _jcfg(dtype=dtype)
            config = dict(dtype=dtype)
            # a ragged leaf (not a multiple of n or of the block) and a
            # leaf under min_elements; in int8, JAX's scale-exact data
            # (tests/test_compress.py): the same even integers on every
            # rank with 254 planted in every block, so phase 1 runs at
            # scale 2 and phase 2 at scale 2n, each value a whole code
            ragged = (rs.randn(n, 1001) * 2).astype(np.float32)
            small = rs.randn(n, 7).astype(np.float32)
            row = 2 * rs.randint(-63, 64, size=256 * n).astype(np.float32)
            row[::128] = 254.0
            leaves = [("ragged", ragged), ("small", small)]
            if dtype == "int8":
                leaves.append(("scale-exact",
                               np.broadcast_to(row, (n, row.size)).copy()))
            for label, x in leaves:
                name = f"psum {dtype} n={n} {label}"
                y, sent = _per_rank(
                    lambda a, c=jcfg: tuple(
                        t[None] for t in jc.quantized_psum(
                            a[0], "dp", c, return_transmitted=True)),
                    n, 2)(jnp.asarray(x))
                cases[name] = dict(kind="psum", n=n, config=config, x=x)
                refs[name] = dict(y=np.asarray(y), sent=np.asarray(sent),
                                  exact=x.sum(0))
            flat = (rs.randn(n, 640 * n) * 0.1).astype(np.float32)
            name = f"scatter {dtype} n={n}"
            y, sent = _per_rank(
                lambda a, c=jcfg: tuple(
                    t[None] for t in jc.quantized_psum_scatter(
                        a[0], "dp", c, return_transmitted=True)),
                n, 2)(jnp.asarray(flat))
            cases[name] = dict(kind="scatter", n=n, config=config, x=flat)
            refs[name] = dict(y=np.asarray(y), sent=np.asarray(sent))
            shard = rs.randn(n, 333).astype(np.float32)
            name = f"gather {dtype} n={n}"
            (y,) = _per_rank(
                lambda a, c=jcfg: (jc.quantized_all_gather(a[0], "dp",
                                                           c)[None],),
                n, 1)(jnp.asarray(shard))
            cases[name] = dict(kind="gather", n=n, config=config, x=shard)
            refs[name] = dict(y=np.asarray(y))
    series = (rs.randn(6, WORLD, 515) * 0.3).astype(np.float32)
    cases["telescope"] = dict(kind="telescope", n=WORLD,
                              config=dict(dtype="int8"), x=series)
    return cases, refs


DDP_CASES = {
    "ef int8": dict(config=dict(dtype="int8"), ef=True),
    "ef fp8 block 64": dict(config=dict(dtype="fp8", block_size=64), ef=True),
    "no ef, predivide 2, sum": dict(config=dict(dtype="int8"), ef=False,
                                    gradient_predivide_factor=2.0,
                                    gradient_average=False),
}
DDP_STEPS = 3


def _ddp_cases():
    rs = np.random.RandomState(2)
    shapes = {"w": (24, 40), "b": (40,), "tiny": (5,)}
    cases, refs = {}, {}
    for name, kw in DDP_CASES.items():
        grads = [{k: (rs.randn(WORLD, *s) * 0.5).astype(np.float32)
                  for k, s in shapes.items()} for _ in range(DDP_STEPS)]
        jkw = dict(kw)
        jcfg = _jcfg(**jkw.pop("config"))
        use_ef = jkw.pop("ef")

        def per_device(gs, jcfg=jcfg, use_ef=use_ef, jkw=jkw):
            ef = jc.ef_init(jax.tree_util.tree_map(lambda a: a[0], gs[0]))
            outs = []
            for g in gs:
                g = jax.tree_util.tree_map(lambda a: a[0], g)
                if use_ef:
                    red, ef = jax_all_reduce(g, "dp", compression=jcfg,
                                             ef_state=ef, **jkw)
                    outs.append((red, ef))
                else:
                    outs.append((jax_all_reduce(g, "dp", compression=jcfg,
                                                **jkw), None))
            return jax.tree_util.tree_map(lambda a: a[None], outs)

        out = jax.jit(shard_map(per_device, mesh=_mesh(WORLD),
                                in_specs=(P("dp"),), out_specs=P("dp"),
                                check_vma=False))(grads)
        cases[name] = dict(kw=dict(kw), grads=grads)
        refs[name] = jax.tree_util.tree_map(np.asarray, out)
    return cases, refs


@pytest.fixture(scope="module")
def world():
    cases, refs = _collective_cases()
    ddp_cases, ddp_refs = _ddp_cases()
    ports = spawn(jobs_worker, WORLD, args=([
        (f"{WORKERS}:collectives_worker", (cases,)),
        (f"{WORKERS}:ddp_compressed_worker", (ddp_cases,))],), timeout=240.0)
    return dict(cases=cases, refs=refs, ddp=ddp_refs, ddp_cases=ddp_cases,
                ports=[p[0] for p in ports],
                ddp_ports=[p[1] for p in ports])


def _same_local(got, want, msg, scale=None):
    """A value each rank computes from its own data alone (what it sent, a
    residual) from bit-equal codes: JAX's compiled step rounds it
    otherwise than its eager functions (and the port) by an fp32 ulp of
    its operands (it rounds the scale ``amax / qmax`` otherwise, and
    contracts ``acc - code * scale`` into one fused multiply-add), so
    1e-6 relative of ``scale``, the operands' magnitude (the array's own
    by default; a residual's is the gradient's, of which it is the small
    difference)."""
    _close(got, want, msg, scale=scale)


def _close(got, want, msg, rtol=1e-6, scale=None):
    if scale is None:
        scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=msg)


@pytest.mark.parametrize("kind", ["psum", "scatter", "gather"])
def test_quantized_collectives_match_jax(world, kind):
    for name, c in world["cases"].items():
        if c["kind"] != kind:
            continue
        for r in range(c["n"]):
            got, want = world["ports"][r][name], world["refs"][name]
            if "scale-exact" in name:
                # digit for digit, and the exact sum
                np.testing.assert_array_equal(got["y"], want["y"][r], name)
                np.testing.assert_array_equal(got["y"], want["exact"], name)
            else:
                _close(got["y"], want["y"][r], f"{name} rank {r}")
            if "sent" in want:
                _same_local(got["sent"], want["sent"][r], name)


def test_quantized_psum_stages_its_predicted_payload(world):
    """Over gloo on the CPU nothing is staged; the staged counters move
    only for CUDA tensors (``chip_smoke.py`` holds them on the card).
    Here: the collective count is 4 a compressed leaf (two all-to-alls,
    two all-gathers) and the payload is JAX's hand count."""
    for name, c in world["cases"].items():
        if c["kind"] == "psum":
            assert world["ports"][0][name]["staged"]["collectives"] == 0


def test_error_feedback_telescopes(world):
    """sum(sent) + last residual == sum(grads) on every rank (fp32
    additions of 6 terms: 1e-6 of the scale)."""
    for r in range(WORLD):
        got = world["ports"][r]["telescope"]
        _close(got["sent_sum"] + got["residual"], got["grad_sum"],
               f"rank {r}", rtol=1e-6)
        assert np.abs(got["residual"]).max() > 0


@pytest.mark.parametrize("case", sorted(DDP_CASES))
def test_compressed_ddp_matches_jax_over_three_steps(world, case):
    """The reduced gradients 1e-6 relative (the 5-element leaf takes the
    exact all-reduce, 1e-6 too); the residuals, local to each rank, as
    :func:`_same_local`."""
    want = world["ddp"][case]
    for r in range(WORLD):
        for step, got in enumerate(world["ddp_ports"][r][case]):
            red, ef = want[step]
            for k, w in red.items():
                _close(got["grads"][k], w[r], f"{case} step {step} {k}")
            if ef is not None:
                grads = world["ddp_cases"][case]["grads"]
                for k, w in ef.items():
                    # the compensated gradient: this step's plus the
                    # residual, at most twice the gradients' magnitude
                    scale = 2 * max(float(np.abs(g[k]).max()) for g in grads)
                    _same_local(got["ef"][k], w[r], f"{case} {k}", scale)
                assert not got["ef"]["tiny"].any()  # exact: no error


def test_mismatched_residuals_raise():
    g = {"a": torch.ones(20)}
    with pytest.raises(ValueError, match="ef_state names"):
        all_reduce_gradients(g, compression=tc.CompressionConfig(),
                             ef_state={"b": torch.zeros(20)})
