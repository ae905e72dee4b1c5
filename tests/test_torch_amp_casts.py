"""O1's cast engine in apex_tpu_torch against the JAX package's.

Each behaviour of tests/test_amp_casts.py (half, float, promote, sequence
promote, nesting, registries, decorators, ``disable_casts``, gradients
in the input dtype) runs on the same probe in both engines: the JAX one
under ``apex_tpu.amp.cast_engine.cast_ops`` and the port's
``TorchFunctionMode`` under ``apex_tpu_torch.amp.cast_engine.cast_ops``,
and the output dtypes must be equal. Values are compared only where a
cast decides them (the user override's fp32 precision check); dtypes are
exact. The port's own probe (``amp.probe.o1_probe``: listed, unlisted
and fused ops) is held stage by stage to the JAX ops' dtypes under the
JAX engine, which ``chip_smoke.py`` then holds the card to.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu import amp as jamp
from apex_tpu.amp import cast_engine as jce
from apex_tpu_torch import amp
from apex_tpu_torch.amp import cast_engine as ce
from apex_tpu_torch.amp.probe import o1_probe

# the JAX ops package re-exports functions under its modules' names
jattn = importlib.import_module("apex_tpu.ops.attention")
jln = importlib.import_module("apex_tpu.ops.layer_norm")
jsoftmax = importlib.import_module("apex_tpu.ops.softmax")

HALVES = [(jnp.bfloat16, torch.bfloat16), (jnp.float16, torch.float16)]
JDT = {jnp.dtype(jnp.float32): "float32", jnp.dtype(jnp.bfloat16): "bfloat16",
       jnp.dtype(jnp.float16): "float16", jnp.dtype(jnp.bool_): "bool"}
TDT = {torch.float32: "float32", torch.bfloat16: "bfloat16",
       torch.float16: "float16", torch.bool: "bool"}


@pytest.fixture(autouse=True, scope="module")
def _fresh_jax_caches():
    """The JAX engine patches jnp/lax while a context is active, and a jnp
    function jitted inside one keeps its casts in JAX's caches: clear
    them after this module, so that the tests that a worker runs next
    trace their own."""
    yield
    jax.clear_caches()


def jname(x):
    return JDT[jnp.dtype(x.dtype)]


def tname(x):
    return TDT[x.dtype]


def _jt(shape, dt):
    return jnp.ones(shape, dt)


def _tt(shape, dt):
    return torch.ones(shape, dtype=dt)


# (name, JAX probe, port probe); each probe takes the half dtype
PROBES = [
    ("matmul_f32_in", lambda d: jnp.matmul(_jt((4, 8), jnp.float32),
                                           _jt((8, 4), jnp.float32)),
     lambda d: torch.matmul(_tt((4, 8), torch.float32),
                            _tt((8, 4), torch.float32))),
    ("matmul_half_in", lambda d: jnp.matmul(_jt((4, 8), d), _jt((8, 4), d)),
     lambda d: torch.matmul(_tt((4, 8), d), _tt((8, 4), d))),
    ("dense_layer", lambda d: jax.lax.dot_general(
        _jt((4, 8), jnp.float32), _jt((8, 4), jnp.float32),
        (((1,), (0,)), ((), ()))),
     lambda d: F.linear(_tt((4, 8), torch.float32),
                        _tt((4, 8), torch.float32), _tt((4,), torch.float32))),
    ("einsum", lambda d: jnp.einsum("ij,jk->ik", _jt((2, 3), jnp.float32),
                                    _jt((3, 2), jnp.float32)),
     lambda d: torch.einsum("ij,jk->ik", _tt((2, 3), torch.float32),
                            _tt((3, 2), torch.float32))),
    ("softmax_f32_in", lambda d: jax.nn.softmax(_jt((4, 8), jnp.float32)),
     lambda d: F.softmax(_tt((4, 8), torch.float32), dim=-1)),
    ("softmax_half_in", lambda d: jax.nn.softmax(_jt((4, 8), d)),
     lambda d: torch.softmax(_tt((4, 8), d), dim=-1)),
    ("log_softmax", lambda d: jax.nn.log_softmax(_jt((4, 8), d)),
     lambda d: F.log_softmax(_tt((4, 8), d), dim=-1)),
    ("sum", lambda d: jnp.sum(_jt((4, 8), d)),
     lambda d: torch.sum(_tt((4, 8), d))),
    ("sum_method", lambda d: jnp.sum(_jt((4, 8), d)),
     lambda d: _tt((4, 8), d).sum()),
    ("cumsum", lambda d: jnp.cumsum(_jt((4,), d)),
     lambda d: torch.cumsum(_tt((4,), d), 0)),
    ("pow", lambda d: jnp.power(_jt((4,), d), 2.0),
     lambda d: torch.pow(_tt((4,), d), 2.0)),
    ("exp", lambda d: jnp.exp(_jt((4,), d)),
     lambda d: torch.exp(_tt((4,), d))),
    ("log", lambda d: jnp.log(_jt((4,), d)),
     lambda d: torch.log(_tt((4,), d))),
    ("rsqrt", lambda d: jax.lax.rsqrt(_jt((4,), d)),
     lambda d: torch.rsqrt(_tt((4,), d))),
    ("relu_half", lambda d: jax.nn.relu(_jt((4,), d)),
     lambda d: torch.relu(_tt((4,), d))),
    ("relu_f32", lambda d: jax.nn.relu(_jt((4,), jnp.float32)),
     lambda d: torch.relu(_tt((4,), torch.float32))),
    ("atan2_half_f32", lambda d: jnp.arctan2(_jt((4,), d),
                                             _jt((4,), jnp.float32)),
     lambda d: torch.atan2(_tt((4,), d), _tt((4,), torch.float32))),
    ("atan2_f32_half", lambda d: jnp.arctan2(_jt((4,), jnp.float32),
                                             _jt((4,), d)),
     lambda d: torch.atan2(_tt((4,), torch.float32), _tt((4,), d))),
    ("mul_mixed", lambda d: jnp.multiply(_jt((4,), d),
                                         _jt((4,), jnp.float32)),
     lambda d: torch.mul(_tt((4,), d), _tt((4,), torch.float32))),
    # a 0-d fp32 operand: torch alone keeps the half dtype, the promote
    # list (and jnp, whose 0-d arrays are strongly typed) gives fp32
    ("add_0d_f32", lambda d: jnp.add(_jt((4,), d), jnp.asarray(1.0,
                                                               jnp.float32)),
     lambda d: torch.add(_tt((4,), d), torch.tensor(1.0))),
    ("add_same", lambda d: jnp.add(_jt((4,), d), _jt((4,), d)),
     lambda d: torch.add(_tt((4,), d), _tt((4,), d))),
    ("where_mixed", lambda d: jnp.where(jnp.ones(4, bool), _jt((4,), d),
                                        _jt((4,), jnp.float32)),
     lambda d: torch.where(torch.ones(4, dtype=torch.bool), _tt((4,), d),
                           _tt((4,), torch.float32))),
    ("less_mixed", lambda d: jnp.less(_jt((4,), d), _jt((4,), jnp.float32)),
     lambda d: torch.lt(_tt((4,), d), _tt((4,), torch.float32))),
    ("cat_mixed", lambda d: jnp.concatenate([_jt((4,), d),
                                             _jt((4,), jnp.float32)]),
     lambda d: torch.cat([_tt((4,), d), _tt((4,), torch.float32)])),
    ("stack_mixed", lambda d: jnp.stack([_jt((4,), d),
                                         _jt((4,), jnp.float32)]),
     lambda d: torch.stack([_tt((4,), d), _tt((4,), torch.float32)])),
]


@pytest.mark.parametrize("name", [p[0] for p in PROBES])
@pytest.mark.parametrize("halves", HALVES, ids=["bf16", "fp16"])
def test_list_behaviour_matches_jax(name, halves):
    jh, th = halves
    _, jfn, tfn = next(p for p in PROBES if p[0] == name)
    with jce.cast_ops(jh):
        want = jname(jfn(jh))
    with ce.cast_ops(th):
        got = tname(tfn(th))
    assert got == want, f"{name}: port {got}, JAX {want}"


def test_operators_and_methods_take_the_lists():
    """The mode sees ``x @ w``, ``x.sum()``, ``a * b`` as functions of
    their own (the JAX engine does not see jax.Array operators)."""
    x = torch.ones(4, 8)
    w = torch.ones(8, 4)
    h = torch.ones(4, dtype=torch.bfloat16)
    with amp.cast_ops(torch.bfloat16) as mode:
        assert (x @ w).dtype == torch.bfloat16
        assert x.matmul(w).dtype == torch.bfloat16
        assert h.sum().dtype == torch.float32
        assert (h ** 2).dtype == torch.float32
        assert (h * torch.tensor(2.0)).dtype == torch.float32
        assert (h + torch.tensor(2.0)).dtype == torch.float32
        assert (2.0 * h).dtype == torch.bfloat16  # a Python scalar
        y = h.clone()
        y.add_(torch.tensor(1.0))  # in place: not listed, stays bf16
        assert y.dtype == torch.bfloat16
        assert mode.casts > 0


def test_backward_grads_match_input_dtype():
    for dt in (torch.float32, torch.bfloat16):
        x = torch.ones(4, 8, dtype=dt, requires_grad=True)
        w = torch.ones(8, 4, requires_grad=True)
        with amp.cast_ops(torch.bfloat16):
            y = torch.matmul(x, w).float().sum() + torch.exp(x).sum()
        y.backward()
        assert x.grad.dtype == dt and w.grad.dtype == torch.float32
    jx = jnp.ones((4, 8), jnp.float32)
    jw = jnp.ones((8, 4), jnp.float32)
    with jce.cast_ops(jnp.bfloat16):
        g = jax.grad(lambda a: jnp.matmul(a, jw).astype(jnp.float32).sum())(jx)
    assert jname(g) == "float32"


def test_inactive_outside_and_nesting():
    x = torch.ones(4, 8)
    w = torch.ones(8, 4)
    assert torch.matmul(x, w).dtype == torch.float32
    with amp.cast_ops(torch.bfloat16):
        with amp.cast_ops(torch.bfloat16):
            assert torch.sum(torch.ones(2, dtype=torch.bfloat16)).dtype == \
                torch.float32
        with pytest.raises(ValueError, match="different half dtypes"):
            with amp.cast_ops(torch.float16):
                pass
        assert torch.matmul(x, w).dtype == torch.bfloat16
    assert torch.matmul(x, w).dtype == torch.float32
    assert ce._state.depth == 0 and ce._state.mode is None


def test_disable_casts_and_nested_enter_inside_it():
    x = torch.ones(4, 4)
    with amp.cast_ops(torch.bfloat16):
        assert torch.mm(x, x).dtype == torch.bfloat16
        with amp.disable_casts():
            assert torch.mm(x, x).dtype == torch.float32
            with amp.cast_ops(torch.bfloat16):  # no second mode
                assert torch.mm(x, x).dtype == torch.float32
        assert torch.mm(x, x).dtype == torch.bfloat16
    assert torch.mm(x, x).dtype == torch.float32
    assert not ce._state.saved
    # the JAX engine gives the same three answers
    jx = jnp.ones((4, 4), jnp.float32)
    dot = lambda: jax.lax.dot_general(jx, jx, (((1,), (0,)), ((), ())))
    with jce.cast_ops(jnp.bfloat16):
        assert jname(dot()) == "bfloat16"
        with jamp.disable_casts():
            assert jname(dot()) == "float32"


def test_o1_policy_context():
    assert amp.O1().patch_functions
    assert not amp.O2().patch_functions and not amp.O0().patch_functions
    policy = amp.O1(torch.bfloat16)
    seen = {}

    def apply_fn(x):
        y = torch.matmul(x, torch.ones(8, 4))
        seen["mm"] = y.dtype
        z = torch.sum(y)
        seen["sum"] = z.dtype
        return z

    out = policy.wrap_apply(apply_fn)(torch.ones(2, 8))
    assert seen == {"mm": torch.bfloat16, "sum": torch.float32}
    assert out.dtype == torch.float32
    seen.clear()
    amp.O2(torch.bfloat16).wrap_apply(
        lambda x: seen.setdefault("sum", torch.sum(x).dtype))(torch.ones(2))
    assert seen["sum"] == torch.bfloat16  # no fp32 list under O2


class TestUserRegistries:
    def test_decorators(self):
        @amp.half_function
        def my_matmul(a, b):
            return torch.mm(a, b)

        @amp.float_function
        def my_reduce(x):
            return x.amax()

        @amp.promote_function
        def my_mix(a, b):
            return a * b

        a = torch.ones(4, 4)
        h = torch.ones(4, dtype=torch.bfloat16)
        assert my_matmul(a, a).dtype == torch.float32
        assert my_reduce(h).dtype == torch.bfloat16
        with amp.cast_ops(torch.bfloat16):
            assert my_matmul(a, a).dtype == torch.bfloat16
            assert my_reduce(h).dtype == torch.float32
            assert my_mix(h, torch.ones(4)).dtype == torch.float32

    def test_register_namespace_functions(self):
        ns = types.SimpleNamespace(mm=lambda a, b: torch.mm(a, b),
                                   red=lambda x: x.amax(),
                                   mix=lambda a, b: torch.mul(a, b))
        amp.register_half_function(ns, "mm")
        amp.register_float_function(ns, "red")
        amp.register_promote_function(ns, "mix")
        try:
            a32 = torch.ones(4, 4)
            h = torch.ones(4, dtype=torch.bfloat16)
            with amp.cast_ops(torch.bfloat16):
                assert ns.mm(a32, a32).dtype == torch.bfloat16
                assert ns.red(h).dtype == torch.float32
                assert ns.mix(h, torch.ones(4)).dtype == torch.float32
            assert ns.mm(a32, a32).dtype == torch.float32
            assert ns.red(h).dtype == torch.bfloat16
        finally:
            for reg, entry in ((ce._USER_FP16_REGISTRY, (ns, "mm")),
                               (ce._USER_FP32_REGISTRY, (ns, "red")),
                               (ce._USER_PROMOTE_REGISTRY, (ns, "mix"))):
                reg.remove(entry)

    def test_register_missing_name_raises(self):
        with pytest.raises(ValueError, match="No function named"):
            amp.register_half_function(types.SimpleNamespace(), "nope")

    def test_user_registration_overrides_builtin_list(self):
        """A float registration of a half-listed op keeps fp32 precision
        (1 + 2^-12 survives fp32, rounds to 1.0 in bf16), as in JAX."""
        amp.register_float_function(torch, "einsum")
        jamp.register_float_function(jnp, "einsum")
        try:
            a = torch.full((1, 1), 1.0 + 2.0 ** -12)
            with amp.cast_ops(torch.bfloat16):
                out = torch.einsum("ij,jk->ik", a, a)
            ja = jnp.full((1, 1), 1.0 + 2.0 ** -12, jnp.float32)
            with jce.cast_ops(jnp.bfloat16):
                jout = jnp.einsum("ij,jk->ik", ja, ja)
            assert tname(out) == jname(jout) == "float32"
            assert float(out[0, 0]) > 1.0 and float(jout[0, 0]) > 1.0
        finally:
            ce._USER_FP32_REGISTRY.remove((torch, "einsum"))
            jce._USER_FP32_REGISTRY.remove((jnp, "einsum"))
        with amp.cast_ops(torch.bfloat16):
            assert torch.einsum("ij,jk->ik", a, a).dtype == torch.bfloat16

    def test_patch_failure_unwinds_cleanly(self):
        ns = types.SimpleNamespace(fn=lambda x: x)
        amp.register_half_function(ns, "fn")
        del ns.fn
        try:
            with pytest.raises(AttributeError):
                with amp.cast_ops(torch.bfloat16):
                    pass
            assert ce._state.depth == 0 and not ce._state.saved
            ns.fn = lambda x: x
            with amp.cast_ops(torch.bfloat16):
                x = torch.ones(2, 2)
                assert torch.matmul(x, x).dtype == torch.bfloat16
        finally:
            ce._USER_FP16_REGISTRY.remove((ns, "fn"))

    def test_latest_registration_wins(self):
        ns = types.SimpleNamespace(f=lambda x: x)
        amp.register_half_function(ns, "f")
        amp.register_float_function(ns, "f")
        try:
            with amp.cast_ops(torch.bfloat16):
                assert ns.f(torch.ones(2, dtype=torch.bfloat16)).dtype == \
                    torch.float32
        finally:
            ce._USER_FP32_REGISTRY.remove((ns, "f"))
        assert (ns, "f") not in ce._USER_FP16_REGISTRY


def _jax_probe(x, w, ln_w):
    """The JAX ops of ``amp.probe.o1_probe``, stage by stage."""
    out = {}
    h = jnp.matmul(x, w)
    out["matmul"] = h
    out["linear"] = jax.lax.dot_general(x, w, (((1,), (0,)), ((), ())))
    out["operator_matmul"] = jnp.matmul(x, w)
    out["layer_norm"] = jln.layer_norm(h, ln_w, jnp.zeros_like(ln_w))
    out["rms_norm"] = jln.rms_norm(h, ln_w)
    out["softmax"] = jax.nn.softmax(h, axis=-1)
    out["sum"] = jnp.sum(h)
    out["exp"] = jnp.exp(h)
    out["relu"] = jax.nn.relu(h)
    out["add_0d_fp32"] = jnp.add(h, jnp.asarray(1.0, jnp.float32))
    rows, n = h.shape
    out["cat_mixed"] = jnp.concatenate([h, x[:, :n]])
    q = h.reshape(1, 1, rows, n)
    out["flash_attention"] = jattn.flash_attention(q, q, q, causal=True)
    out["scaled_masked_softmax"] = jsoftmax.scaled_masked_softmax(q, None,
                                                                  0.5)
    return out


@pytest.mark.parametrize("halves", HALVES, ids=["bf16", "fp16"])
def test_probe_dtypes_match_jax_o1(halves):
    """Listed, unlisted and the port's fused ops (run with the casts
    disabled inside, as JAX's kernels run whole) under O1, stage by
    stage, and the values of the first stages against JAX's at one
    half-dtype rounding."""
    jh, th = halves
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    w = rs.randn(16, 8).astype(np.float32)
    g = (1.0 + 0.1 * rs.randn(8)).astype(np.float32)
    with jce.cast_ops(jh):
        want = _jax_probe(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    with amp.cast_ops(th):
        got = o1_probe(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(g))
    assert set(got) == set(want)
    for k in want:
        assert tname(got[k]) == jname(want[k]), k
    np.testing.assert_allclose(got["matmul"].float().numpy(),
                               np.asarray(want["matmul"], np.float32),
                               rtol=1e-2, atol=5e-2)
