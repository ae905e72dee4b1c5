"""apex_tpu_torch's pipeline parallelism against the JAX package: the pp
process groups, the stage edges, the micro-batch calculators, the
schedule algebra and the schedules on a toy stage.

The port runs in one spawned world of 4 gloo ranks on the CPU
(``transformer.testing.distributed_test_base.spawn``); the JAX functions
run under ``shard_map`` on 4 devices of the 8-device CPU mesh laid out as
the port's ranks are (device r is port rank r, ``reshape(dp, pp, cp,
tp)``). At pp = 2 the world's two dp replicas run the same inputs.
Inputs are made from a seeded numpy RNG. Checked:

- the tp, dp and pp groups of every rank at (dp, pp, tp) = (1, 2, 2),
  (2, 2, 1) and (1, 4, 1) equal the JAX mesh's axis groups, and the pp
  rank, the stage flags and ``get_group("pp")`` follow; so do all four
  groups, the ranks and the sizes at (dp, pp, cp, tp) = (1, 1, 4, 1),
  (1, 1, 2, 2) and (2, 1, 2, 1), and cp > 1 without a world raises;
- each JAX function of ``p2p.py`` at pp = 2 and 4: bit-equal (data only
  moves); the paired 1F1B operations receive their partner's tensor;
- the micro-batch calculators and the schedule algebra: exact;
- the toy stage ``tanh(x @ w + b)`` with a squared-error loss through
  ``pipeline_forward`` and 1F1B at P = 2 and 4 with M in {1, 3, 4, 8},
  the interleaved schedule (and its forward) at P = 2 and 4 with V = 2
  and M = P and 2P, and the interleaved ``M % P != 0`` error, on every
  rank: outputs 1e-6 absolute (the same fp32 products), the mean loss
  and the per-micro-batch losses 1e-5 relative, every gradient 1e-4
  relative in norm (fp32 sums in another order); the parameters'
  ``.grad`` stay None; the dispatcher returns the schedules JAX's does,
  the zero-bubble one included (``tests/test_torch_zero_bubble.py``
  holds it to JAX);
- the interleaved schedules take any backend at P = 2, where both
  streams run between one pair of ranks: with every message forced to
  one tag (gloo then matches a pair's messages in posting order, as
  NCCL does), the gradients take the pp group's twin and the schedule
  agrees with JAX as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.compat import shard_map
from apex_tpu.parallel import parallel_state as jps
from apex_tpu.parallel.pipeline import algebra as jalgebra
from apex_tpu.parallel.pipeline import microbatches as jmicro
from apex_tpu.parallel.pipeline import p2p as jp2p
from apex_tpu.parallel.pipeline import schedules as jsched
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.pipeline import algebra, microbatches
from apex_tpu_torch.parallel.pipeline import schedules as sched
from apex_tpu_torch.transformer.testing.distributed_test_base import spawn
from apex_tpu_torch.transformer.testing.pipeline_workers import (
    P2P_FUNCTIONS,
    jobs_worker,
)

WORLD = 4
ALL = P(("dp", "pp", "cp", "tp"))  # device r <- row r of a stacked array
LAYOUTS = ((1, 2, 2), (2, 2, 1), (1, 4, 1))
CP_LAYOUTS = ((1, 1, 4, 1), (1, 1, 2, 2), (2, 1, 2, 1))  # (dp, pp, cp, tp)
H, MB = 6, 2  # toy hidden size and micro-batch rows


def _mesh(pp, tp=1):
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        WORLD // (pp * tp), pp, 1, tp), jps.AXIS_ORDER)


# -- the JAX side ------------------------------------------------------------

def _jax_p2p(rs):
    cases, refs = {}, {}
    for pp in (2, 4):
        x = rs.randn(WORLD, 3, 5).astype(np.float32)
        cases[pp] = x
        refs[pp] = {}
        for name in P2P_FUNCTIONS:
            f = shard_map(lambda a, fn=getattr(jp2p, name): fn(a[0])[None],
                          mesh=_mesh(pp), in_specs=ALL, out_specs=ALL,
                          check_vma=False)
            refs[pp][name] = np.asarray(jax.jit(f)(x))
    return cases, refs


def _jax_stage(params, x):
    return jnp.tanh(x @ params["w"] + params["b"])


def _jax_loss(y, t):
    return jnp.mean((y - t) ** 2)


def _toy_params(rs, pp, V):
    lead = (pp,) if V == 1 else (pp, V)
    return dict(w=(0.5 * rs.randn(*lead, H, H)).astype(np.float32),
                b=rs.randn(*lead, H).astype(np.float32))


def _jax_toy(kind, pp, V, params, mbs, targets):
    """The JAX schedule's result on every device of the world, stacked."""
    def run(params, mbs, targets):
        local = jax.tree_util.tree_map(lambda a: a[0], params)
        if kind == "forward":
            return jsched.pipeline_forward(_jax_stage, local, mbs)[None]
        if kind == "interleaved_forward":
            return jsched.pipeline_forward_interleaved(
                _jax_stage, local, mbs, num_model_chunks=V)[None]
        fn = jsched.get_forward_backward_func(
            V if kind == "interleaved" else None, pp)
        loss, losses, grads = fn(_jax_stage, _jax_loss, local, mbs, targets)
        return (loss[None], losses[None],
                jax.tree_util.tree_map(lambda g: g[None], grads))

    spec = jax.tree_util.tree_map(lambda _: P("pp"), params)
    f = shard_map(run, mesh=_mesh(pp), in_specs=(spec, P(), P()),
                  out_specs=ALL, check_vma=False)
    out = jax.jit(f)(params, mbs, targets)
    return jax.tree_util.tree_map(np.asarray, out)


def _toy_cases(rs):
    cases, refs = [], {}

    def add(name, kind, pp, V, M):
        params = _toy_params(rs, pp, V)
        mbs = rs.randn(M, MB, H).astype(np.float32)
        targets = rs.randn(M, MB, H).astype(np.float32)
        by_rank = [{k: v[p] for k, v in params.items()} for p in range(pp)]
        cases.append((name, kind, pp, V, by_rank, mbs, targets))
        if kind != "error":
            refs[name] = _jax_toy(kind, pp, V, params, mbs, targets)

    for pp in (2, 4):
        for M in (1, 3, 4, 8):
            add(f"forward P{pp} M{M}", "forward", pp, 1, M)
            add(f"1f1b P{pp} M{M}", "1f1b", pp, 1, M)
        for M in (pp, 2 * pp):
            add(f"interleaved P{pp} V2 M{M}", "interleaved", pp, 2, M)
            add(f"interleaved_forward P{pp} V2 M{M}", "interleaved_forward",
                pp, 2, M)
    cases.append(("interleaved P2 V2 M3", "interleaved", 2, 2,
                  [{k: v[p] for k, v in _toy_params(rs, 2, 2).items()}
                   for p in range(2)],
                  rs.randn(3, MB, H).astype(np.float32),
                  rs.randn(3, MB, H).astype(np.float32)))
    return cases, refs


UNTAGGED = ("interleaved P2 V2 M2", "interleaved P2 V2 M4")


def _untagged(cases):
    """The interleaved cases where both streams share one pair of ranks."""
    return [c for c in cases if c[0] in UNTAGGED]


@pytest.fixture(scope="module")
def both():
    """(JAX references, the port's results by rank) for the whole module:
    one spawned world runs the groups, the edges and the schedules."""
    rs = np.random.RandomState(0)
    p2p_cases, p2p_refs = _jax_p2p(rs)
    toy_cases, toy_refs = _toy_cases(rs)
    ports = spawn(jobs_worker, WORLD, args=([
        ("groups_worker", (LAYOUTS + CP_LAYOUTS,)),
        ("p2p_worker", (p2p_cases,)),
        ("toy_schedules_worker", (toy_cases,)),
        ("untagged_schedules_worker", (_untagged(toy_cases),))],),
        timeout=240.0)
    return (p2p_cases, p2p_refs, toy_refs), ports


# -- process groups ----------------------------------------------------------

def _jax_axis_groups(dp, pp, tp, cp=1):
    """{axis: {device id: the ids of its group along axis}} of the JAX
    mesh."""
    mesh = jps.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        context_parallel_size=cp, devices=jax.devices()[:WORLD])
    try:
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        assert mesh.shape == {"dp": dp, "pp": pp, "cp": cp, "tp": tp}
    finally:
        jps.destroy_model_parallel()
    out = {}
    for i, axis in enumerate(jps.AXIS_ORDER):
        moved = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
        out[axis] = {int(d): sorted(int(x) for x in row)
                     for row in moved for d in row}
    return out


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=[f"dp{a}_pp{b}_tp{c}" for a, b, c in LAYOUTS])
def test_process_groups_match_the_jax_mesh(both, layout):
    _, ports = both
    dp, pp, tp = layout
    want = _jax_axis_groups(dp, pp, tp)
    for r in range(WORLD):
        got = ports[r][0][layout]
        for axis in ("tp", "dp", "pp"):
            assert sorted(got["groups"][axis]) == want[axis][r], (axis, r)
        assert got["sizes"] == (dp, pp, tp)
        assert got["ranks"] == (r // (pp * tp), r // tp % pp, r % tp)
        assert got["first"] == (r // tp % pp == 0)
        assert got["last"] == (r // tp % pp == pp - 1)
        assert got["pp_group_is_group"]


def test_context_parallelism_still_raises(both):
    """The cp axis is ported: every rank's four groups, ranks and sizes at
    (dp, pp, cp, tp) = (1, 1, 4, 1), (1, 1, 2, 2) and (2, 1, 2, 1) equal
    the JAX mesh's (rank ``((d pp + p) cp + c) tp + t``). What still
    raises is cp > 1 without a world to hold it."""
    _, ports = both
    for layout in CP_LAYOUTS:
        dp, pp, cp, tp = layout
        want = _jax_axis_groups(dp, pp, tp, cp)
        for r in range(WORLD):
            got = ports[r][0][layout]
            for axis in ("tp", "dp", "pp", "cp"):
                assert sorted(got["groups"][axis]) == want[axis][r], (
                    layout, axis, r)
            assert got["sizes"] == layout
            assert got["ranks"] == (r // (pp * cp * tp), r // (cp * tp) % pp,
                                    r // tp % cp, r % tp)
    with pytest.raises(RuntimeError, match="world"):
        ps.initialize_model_parallel(context_parallel_size=2)


def test_pp_one_keeps_no_pp_group():
    ps.initialize_model_parallel()
    try:
        assert ps.get_group("pp") is None
        assert ps.get_pipeline_model_parallel_world_size() == 1
        assert ps.is_pipeline_first_stage() and ps.is_pipeline_last_stage()
    finally:
        ps.destroy_model_parallel()


# -- stage edges -------------------------------------------------------------

@pytest.mark.parametrize("pp", [2, 4])
@pytest.mark.parametrize("name", P2P_FUNCTIONS)
def test_p2p_matches_jax_ppermute(both, pp, name):
    (_, refs, _), ports = both
    for r in range(WORLD):
        np.testing.assert_array_equal(ports[r][1][pp][name], refs[pp][name][r],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("pp", [2, 4])
def test_paired_operations_exchange_with_the_partner(both, pp):
    (cases, _, _), ports = both
    x = cases[pp]
    for r in range(WORLD):
        partner = r + 1 if (r % pp) % 2 == 0 else r - 1
        np.testing.assert_array_equal(ports[r][1][pp]["paired"], x[partner])
        if r % pp == pp - 1:
            assert ports[r][1][pp]["last_sfrb"] is None
        if r % pp == 0:
            assert ports[r][1][pp]["first_sbrf"] is None


# -- micro-batch calculators and the algebra ---------------------------------

RAMPUPS = [None, [4, 4, 100], [8, 8, 64], [16, 16, 0]]


@pytest.mark.parametrize("rampup", RAMPUPS, ids=str)
@pytest.mark.parametrize("micro,dp", [(1, 1), (2, 2), (4, 1)])
def test_microbatch_calculators_match_jax(rampup, micro, dp):
    got = microbatches.build_num_microbatches_calculator(
        0, rampup, 64, micro, dp)
    want = jmicro.build_num_microbatches_calculator(0, rampup, 64, micro, dp)
    assert type(got).__name__ == type(want).__name__
    for consumed in (0, 1, 7, 24, 50, 64, 99, 100, 101, 1000):
        got.update(consumed, False)
        want.update(consumed, False)
        assert (got.get(), got.get_current_global_batch_size()) == \
            (want.get(), want.get_current_global_batch_size()), consumed


@pytest.mark.parametrize("gbs,micro,dp", [(100, 2, 4), (64, 3, 1),
                                           (7, 1, 2), (64, 4, 4)])
def test_microbatch_calculator_errors_match_jax(gbs, micro, dp):
    errors = []
    for mod in (microbatches, jmicro):
        try:
            mod.build_num_microbatches_calculator(0, None, gbs, micro, dp)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]


def test_microbatch_registry_matches_jax():
    for mod in (microbatches, jmicro):
        mod.destroy_num_microbatches_calculator()
        with pytest.raises(RuntimeError):
            mod.get_num_microbatches()
        mod.setup_microbatch_calculator(0, [8, 8, 64], 32, 2, 2)
        with pytest.raises(RuntimeError):
            mod.setup_microbatch_calculator(0, None, 32, 2, 2)
    seen = []
    for mod in (microbatches, jmicro):
        row = []
        for consumed in (0, 20, 40, 80):
            mod.update_num_microbatches(consumed)
            row.append((mod.get_num_microbatches(),
                        mod.get_current_global_batch_size()))
        seen.append(row)
        mod.destroy_num_microbatches_calculator()
    assert seen[0] == seen[1]


@pytest.mark.parametrize("P,M,V", [(1, 1, 2), (2, 1, 2), (2, 4, 2),
                                   (4, 8, 2), (4, 6, 3), (8, 32, 4),
                                   (3, 9, 3)])
def test_schedule_algebra_matches_jax(P, M, V):
    got = [vars(c) | {"bubble": c.bubble_fraction}
           for c in algebra.compare(P, M, V)]
    want = [vars(c) | {"bubble": c.bubble_fraction}
            for c in jalgebra.compare(P, M, V)]
    assert got == want
    for name in algebra.SCHEDULES:
        for mod_v in (1, V):
            try:
                w = jalgebra.schedule_cost(name, P, M, mod_v)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)[:30]):
                    algebra.schedule_cost(name, P, M, mod_v)
                continue
            assert vars(algebra.schedule_cost(name, P, M, mod_v)) == vars(w)
    assert algebra.bubble_fraction_1f1b(P, M) == \
        jalgebra.bubble_fraction_1f1b(P, M)


# -- the schedules on the toy stage ------------------------------------------

def _case_names(kind):
    out = []
    for pp in (2, 4):
        if kind in ("forward", "1f1b"):
            out += [f"{kind} P{pp} M{M}" for M in (1, 3, 4, 8)]
        else:
            out += [f"{kind} P{pp} V2 M{M}" for M in (pp, 2 * pp)]
    return out


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("name", _case_names("forward")
                         + _case_names("interleaved_forward"))
def test_forward_schedules_match_jax(both, name):
    (_, _, refs), ports = both
    pp = int(name.split()[1][1:])
    for r in range(WORLD):
        got = ports[r][2][name]
        if r % pp != pp - 1:
            assert got is None  # outputs are valid on the last stage only
            continue
        np.testing.assert_allclose(got, refs[name][r], atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", _case_names("1f1b")
                         + _case_names("interleaved"))
def test_forward_backward_schedules_match_jax(both, name):
    (_, _, refs), ports = both
    loss, losses, grads = refs[name]
    for r in range(WORLD):
        got = ports[r][2][name]
        np.testing.assert_allclose(got["loss"], loss[r], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], losses[r], rtol=1e-5)
        for k in ("w", "b"):
            assert got["grads"][k].shape == grads[k][r].shape
            assert _rel(got["grads"][k], grads[k][r]) < 1e-4, (r, k)
        assert all(got["grad_fields"])  # .grad left as it was (None)


def test_interleaved_requires_m_divisible_by_p(both):
    _, ports = both
    with pytest.raises(ValueError) as jerr:
        _jax_toy("interleaved", 2, 2, _toy_params(np.random.RandomState(1),
                                                  2, 2),
                 np.zeros((3, MB, H), np.float32),
                 np.zeros((3, MB, H), np.float32))
    for r in range(WORLD):
        assert ports[r][2]["interleaved P2 V2 M3"] == {
            "error": str(jerr.value)}


def test_schedule_order_is_one_forward_and_one_backward_per_microbatch():
    for P, M, V, inter in ((2, 1, 1, False), (4, 8, 1, False),
                           (4, 8, 2, True), (2, 2, 3, True)):
        for r in range(P):
            order = sched.schedule_order(P, r, M, V, inter)
            fwd = [(v, m) for k, v, m in order if k == "F"]
            bwd = [(v, m) for k, v, m in order if k == "B"]
            assert sorted(fwd) == sorted(bwd) == sorted(
                (v, m) for v in range(V) for m in range(M))
            # each chunk's backwards follow its forwards in order
            for v in range(V):
                assert [m for c, m in fwd if c == v] == \
                    [m for c, m in bwd if c == v]
            # 1F1B: at most P - r micro-batches in flight on stage r
            if not inter:
                live = peak = 0
                for k, _, _ in order:
                    live += 1 if k == "F" else -1
                    peak = max(peak, live)
                assert peak == min(P - r, M)


@pytest.mark.parametrize("P,V,backend", (
    (2, 2, "nccl"), (2, 3, "nccl"), (2, 2, "gloo"), (2, 1, "nccl"),
    (4, 2, "nccl")))
def test_interleaved_check_takes_any_backend_and_whole_rounds(
        monkeypatch, P, V, backend):
    """The interleaved schedules take every backend at every (P, V): at
    P = 2 the gradients run on the pp group's twin
    (``parallel_state.p2p``; ``test_untagged_interleaved_matches_jax``
    runs it without tags). They still need whole rounds of P
    micro-batches (the group and its backend are stood in for)."""
    group = object()
    monkeypatch.setattr(sched.ps, "get_group", lambda axis: group)
    monkeypatch.setattr(sched.ps, "group_size",
                        lambda g: P if g is group else 1)
    monkeypatch.setattr(sched.dist, "get_backend",
                        lambda g: backend if g is group else "gloo")
    assert sched._check_interleaved(P * 2, V, "pp") is None
    with pytest.raises(ValueError, match="% pipeline size"):
        sched._check_interleaved(P * 2 + 1, V, "pp")


@pytest.mark.parametrize("name", UNTAGGED)
def test_untagged_interleaved_matches_jax(both, name):
    """Every p2p message under one tag, as NCCL matches them: the
    interleaved schedule at P = 2, V = 2 agrees with JAX's as the tagged
    run does (the same tolerances)."""
    (_, _, refs), ports = both
    loss, losses, grads = refs[name]
    for r in range(WORLD):
        got = ports[r][3][name]
        np.testing.assert_allclose(got["loss"], loss[r], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], losses[r], rtol=1e-5)
        for k in ("w", "b"):
            assert _rel(got["grads"][k], grads[k][r]) < 1e-4, (r, k)


def test_dispatcher_matches_jax():
    assert sched.get_forward_backward_func(None, 1) is \
        sched.forward_backward_no_pipelining
    assert sched.get_forward_backward_func(None, 2) is \
        sched.forward_backward_pipelining_without_interleaving
    f = sched.get_forward_backward_func(2, 4)
    assert f.func is sched.forward_backward_pipelining_with_interleaving
    assert f.keywords == {"num_model_chunks": 2}
    for args, kw in (((2, 1), {}), ((2, 4), {"zero_bubble": True})):
        with pytest.raises(ValueError) as jerr:
            jsched.get_forward_backward_func(*args, **kw)
        with pytest.raises(ValueError, match=str(jerr.value)[:40]):
            sched.get_forward_backward_func(*args, **kw)
    # JAX's test_dispatcher_zero_bubble
    assert sched.get_forward_backward_func(None, 4, zero_bubble=True) is \
        sched.forward_backward_zero_bubble
    assert sched.get_forward_backward_func(None, 1, zero_bubble=True) is \
        sched.forward_backward_no_pipelining
    with pytest.raises(ValueError, match="zero_bubble"):
        sched.get_forward_backward_func(2, 4, zero_bubble=True)


def test_build_model_flags_match_jax():
    def provider(pre_process, post_process, tag):
        return (pre_process, post_process, tag)

    for rank, world, v in ((0, 1, None), (0, 4, None), (3, 4, None),
                           (1, 4, 2), (0, 2, 3), (1, 2, 3)):
        assert sched.build_model(provider, rank, world, v, tag=7) == \
            jsched.build_model(provider, rank, world, v, tag=7)


def test_import_surfaces_match_jax():
    import apex_tpu.parallel.pipeline as jpipe
    import apex_tpu.transformer.pipeline_parallel as jpp
    import apex_tpu_torch.parallel.pipeline as pipe
    import apex_tpu_torch.transformer.pipeline_parallel as tpp

    assert set(jpipe.__all__) <= set(pipe.__all__)
    assert set(tpp.__all__) == set(jpp.__all__)
    for name in pipe.__all__:
        assert getattr(pipe, name) is not None
