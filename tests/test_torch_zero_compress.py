"""apex_tpu_torch's ZeRO optimizers' ported options against the JAX
package's: ``distributed_fused_adam`` with a compressed gradient
reduce-scatter (int8 and fp8, error feedback on and off) and with
``store_param_remainders``, and ``distributed_fused_lamb`` exact and
compressed, each over 3 steps at dp = 2, 3 or 4.

The port runs in one spawned world of 4 gloo ranks on the CPU, each case
over the group of ranks ``[0, n)``; JAX's functions run under
``shard_map`` (``check_vma=False``, per-rank gradients) on n devices of
the CPU mesh. Tolerances: ``tests/test_torch_parallel_data.py``'s for
ZeRO Adam (the params, the master and moment shards 1e-6 relative and
1e-7 absolute: the reduced sums in another order); the residual, which
each rank computes from its own data, 1e-6 of the gradients' magnitude
(JAX's compiled step contracts ``acc - code * scale`` into a fused
multiply-add); LAMB's params and master 1e-5 relative and 1e-7 absolute
(its trust ratios divide two norms, each summed in another order).
With remainders the fp32 master rebuilt from (bf16 params, remainder)
is held as the fp32 master, the bf16 params to one bf16 step (a master
that rounds otherwise next to a step may land on either side), and the
state's master takes half the fp32 bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.optimizers import distributed_fused_adam as jax_adam
from apex_tpu.optimizers.distributed_fused_lamb import (
    distributed_fused_lamb as jax_lamb,
)
from apex_tpu.parallel.compress import CompressionConfig as JaxCompression
from apex_tpu_torch.optimizers import (
    DistributedFusedLAMB,
    distributed_fused_adam,
)
from apex_tpu_torch.optimizers.distributed_fused_adam import (
    master_from_remainder,
    split_master,
)
from apex_tpu_torch.optimizers.distributed_fused_lamb import local_segments
from apex_tpu_torch.ops.multi_tensor import flatten_pytree
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    jobs_worker,
    spawn,
)

WORLD = 4
STEPS = 3
INT8 = dict(dtype="int8")
CASES = {
    "adam int8 dp=2": dict(opt="adam", n=2, hyper=dict(
        lr=1e-2, compression=INT8)),
    "adam int8 dp=4 clipped": dict(opt="adam", n=4, hyper=dict(
        lr=1e-2, weight_decay=0.01, max_grad_norm=1.0, compression=INT8)),
    "adam fp8 dp=3 ragged": dict(opt="adam", n=3, hyper=dict(
        lr=1e-2, compression=dict(dtype="fp8", block_size=32))),
    "adam int8 no ef dp=4": dict(opt="adam", n=4, hyper=dict(
        lr=1e-2, compression=dict(dtype="int8", error_feedback=False))),
    "adam remainders dp=2": dict(opt="adam", n=2, bf16=True, hyper=dict(
        lr=1e-2, store_param_remainders=True)),
    "adam remainders dp=4 wd": dict(opt="adam", n=4, bf16=True, hyper=dict(
        lr=3e-3, weight_decay=0.1, store_param_remainders=True)),
    "lamb dp=2": dict(opt="lamb", n=2, hyper=dict(lr=1e-2)),
    "lamb dp=4 nvlamb": dict(opt="lamb", n=4, hyper=dict(
        lr=1e-2, use_nvlamb=True, max_grad_norm=0.5)),
    "lamb int8 dp=4": dict(opt="lamb", n=4, hyper=dict(
        lr=1e-2, compression=INT8)),
    "lamb fp8 dp=3 ragged": dict(opt="lamb", n=3, hyper=dict(
        lr=1e-2, weight_decay=0.0, compression=dict(dtype="fp8"))),
}


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _jax_case(c, params, grads):
    hyper = dict(c["hyper"])
    if hyper.get("compression") is not None:
        hyper["compression"] = JaxCompression(**hyper["compression"])
    make = {"adam": jax_adam, "lamb": jax_lamb}[c["opt"]]
    n = c["n"]
    opt = make(axis_name="dp", axis_size=n, **hyper)
    dtype = jnp.bfloat16 if c.get("bf16") else jnp.float32

    def per_device(p, gs):
        p = jax.tree_util.tree_map(lambda a: a.astype(dtype), p)
        state = opt.init(p)
        for g in gs:
            g = jax.tree_util.tree_map(lambda a: a[0].astype(dtype), g)
            upd, state = opt.update(g, state, p)
            p = jax.tree_util.tree_map(
                lambda a, u: (a.astype(jnp.float32) + u).astype(dtype),
                p, upd)
        master = state.master_shard
        if master.dtype == jnp.uint16:  # the remainders' bits
            master = jax.lax.bitcast_convert_type(master, jnp.int16)
        return (jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32)[None], p), master[None],
            state.exp_avg[None], state.ef_residual[None], state.step[None])

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("dp",))
    out = jax.jit(shard_map(per_device, mesh=mesh, in_specs=(P(), P("dp")),
                            out_specs=(P("dp"),) * 5, check_vma=False))(
        params, grads)
    names = ("params", "master_shard", "exp_avg", "ef_residual", "step")
    return dict(zip(names, jax.tree_util.tree_map(np.asarray, out)))


def _cases():
    cases, refs = {}, {}
    for i, (name, c) in enumerate(CASES.items()):
        rs = np.random.RandomState(30 + i)
        n = c["n"]
        params = {"a": rs.randn(4, 5), "b": rs.randn(13) * 0.1,
                  "c": rs.randn(3, 2, 2), "d": rs.randn(300)}
        params = {k: v.astype(np.float32) for k, v in params.items()}
        grads = [{k: (rs.randn(n, *v.shape) * 2).astype(np.float32)
                  for k, v in params.items()} for _ in range(STEPS)]
        if c.get("bf16"):
            params = {k: _bf16(v) for k, v in params.items()}
            grads = [{k: _bf16(v) for k, v in g.items()} for g in grads]
        cases[name] = dict(c, params=params, grads=grads)
        refs[name] = _jax_case(c, params, grads)
    return cases, refs


def _rebuilt(params, bits, rank, n):
    """fp32 master shard of rank ``rank`` from bf16-valued ``params`` (as
    fp32 arrays) and its remainders' int16 ``bits``."""
    flat, _ = flatten_pytree({k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16) for k, v in params.items()}, dtype=torch.bfloat16)
    flat = torch.cat([flat, flat.new_zeros(-flat.shape[0] % n)])
    shard = flat.shape[0] // n
    return master_from_remainder(flat[rank * shard:(rank + 1) * shard],
                                 torch.from_numpy(bits)).numpy()


@pytest.fixture(scope="module")
def both():
    cases, refs = _cases()
    ports = spawn(jobs_worker, WORLD, args=([
        ("apex_tpu_torch.transformer.testing.compress_workers:zero_worker",
         (cases,))],), timeout=240.0)
    return cases, refs, [p[0] for p in ports]


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero_options_match_jax_over_three_steps(both, case):
    cases, refs, ports = both
    c, want = cases[case], refs[case]
    lamb = c["opt"] == "lamb"
    rtol = 1e-5 if lamb else 1e-6
    remainders = c["hyper"].get("store_param_remainders", False)
    for r in range(c["n"]):
        got = ports[r][case]
        assert got["step"] == int(want["step"][r]) == STEPS
        for k, w in want["params"].items():
            if remainders:
                # bf16 params, the masters' high halves: a master that
                # rounds otherwise near a bf16 step may move one step
                np.testing.assert_allclose(got["params"][k], w[r],
                                           rtol=2.0 ** -8, atol=0,
                                           err_msg=f"{case} {k}")
            else:
                np.testing.assert_allclose(got["params"][k], w[r], rtol=rtol,
                                           atol=1e-7, err_msg=f"{case} {k}")
        m, wm = got["master_shard"], want["master_shard"][r]
        assert m.shape == wm.shape
        if remainders:
            # the fp32 masters rebuilt from (params, remainder), held as
            # the fp32 master is
            m, wm = (_rebuilt(p, bits, r, c["n"]) for p, bits in (
                (got["params"], m),
                ({k: w[r] for k, w in want["params"].items()}, wm)))
            np.testing.assert_allclose(m, wm, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{case} rebuilt master")
            assert got["master_bytes"] == 2 * m.size
        else:
            np.testing.assert_allclose(m, wm, rtol=rtol, atol=1e-7,
                                       err_msg=f"{case} rank {r} master")
        np.testing.assert_allclose(got["exp_avg"], want["exp_avg"][r],
                                   rtol=rtol, atol=1e-7, err_msg=case)
        ef, wef = got["ef_residual"], want["ef_residual"][r]
        assert ef.shape == wef.shape
        comp = c["hyper"].get("compression")
        if comp is not None and comp.get("error_feedback", True):
            assert ef.shape == (m.shape[0] * c["n"],) and np.abs(ef).max() > 0
            scale = 2 * max(float(np.abs(g[k]).max()) for g in c["grads"]
                            for k in g)
            np.testing.assert_allclose(ef, wef, rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{case} residual")
        else:
            assert ef.shape == () and float(ef) == 0.0


def test_remainder_split_is_the_truncation_and_rebuilds_exactly():
    rs = np.random.RandomState(5)
    master = torch.from_numpy(np.concatenate([
        rs.randn(1000) * 10.0 ** rs.randint(-30, 30, 1000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40]]).astype(np.float32))
    hi, lo = split_master(master)
    assert hi.dtype == torch.bfloat16 and lo.dtype == torch.int16
    bits = master.view(torch.int32)
    # truncation: the high 16 bits, never the rounding of .to(bfloat16)
    assert torch.equal(hi.view(torch.int16).to(torch.int32) & 0xFFFF,
                       (bits >> 16) & 0xFFFF)
    assert not torch.equal(hi, master.to(torch.bfloat16))
    assert torch.equal(master_from_remainder(hi, lo).view(torch.int32), bits)


def test_remainders_refuse_fp32_params_and_lamb_segments_cover_the_shard():
    opt = distributed_fused_adam(store_param_remainders=True)
    with pytest.raises(ValueError, match="bfloat16"):
        opt.init({"w": torch.zeros(4)})
    lamb = DistributedFusedLAMB(lr=1e-3, dwu_group_size=4)  # knobs ignored
    params = {"a": torch.ones(3, 4), "b": torch.ones(5), "s": torch.ones(())}
    state = lamb.init(params)
    assert state.master_shard.shape[0] == flatten_pytree(
        params, dtype=torch.float32)[1].padded_total
    _, spec = flatten_pytree(params, dtype=torch.float32)
    for n in (1, 2, 3):
        shard = spec.padded_total // n if spec.padded_total % n == 0 else None
        if shard is None:
            continue
        covered = []
        for r in range(n):
            segs = local_segments(spec, r, shard)
            assert segs[0][1] == 0 and segs[-1][2] == shard
            assert all(a < b for _, a, b in segs)
            covered += [(seg, a + r * shard, b + r * shard)
                        for seg, a, b in segs]
        # each tensor's slices, joined over the ranks, are its range
        for i, (off, shape) in enumerate(zip(spec.offsets, spec.shapes)):
            parts = [(a, b) for seg, a, b in covered if seg == i]
            assert parts[0][0] == off
            assert parts[-1][1] == off + torch.Size(shape).numel()
