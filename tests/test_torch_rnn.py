"""apex_tpu_torch.rnn (and ``RNN``) against the JAX package's.

Every cell (one step) and every model (stacked, bidirectional where the
reference has it) from the JAX parameters through
``rnn_params_from_jax``, on the same seeded inputs and cotangents:
outputs, final carries, the input gradient and every parameter
gradient. Tolerance 1e-5 (fp32: the same gate GEMMs summed in another
order, through up to 2 layers x 7 steps), and the bf16 LSTM to 1.56e-2
(its gate inputs rounded to bf16 at each step). The inter-layer dropout
draws from a ``torch.Generator``; its masks are recomputed from a twin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.RNN as jRNN
import apex_tpu.rnn as jrnn
import apex_tpu_torch.RNN as tRNN
import apex_tpu_torch.rnn as trnn
from apex_tpu_torch.models import rnn_params_from_jax
from apex_tpu_torch.transformer.layer import keep_mask

SEQ, B, IN, HID = 7, 3, 6, 8
TOL = dict(rtol=1e-5, atol=1e-5)
CELLS = ["LSTMCell", "mLSTMCell", "GRUCell", "RNNReLUCell", "RNNTanhCell"]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed(variables, seed):
    """Non-zero biases: every parameter plus 0.1 N(0, 1)."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape) * 0.1, p.dtype),
        variables)


@pytest.mark.parametrize("name", CELLS)
def test_cell_step_and_gradients(name):
    rs = np.random.RandomState(0)
    jcell = getattr(jrnn, name)(hidden_size=HID)
    x = rs.randn(B, IN).astype(np.float32)
    carry = tuple(rs.randn(B, HID).astype(np.float32)
                  for _ in jcell.init_carry(B, HID))
    variables = perturbed(jcell.init(jax.random.PRNGKey(0), carry,
                                     jnp.asarray(x)), 1)
    (jcarry, jy), vjp = jax.vjp(
        lambda v, c, x: jcell.apply(v, c, x), variables,
        tuple(map(jnp.asarray, carry)), jnp.asarray(x))
    ct_y = rs.randn(B, HID).astype(np.float32)
    ct_c = tuple(rs.randn(B, HID).astype(np.float32) for _ in carry)
    gv, gc, gx = vjp((tuple(map(jnp.asarray, ct_c)), jnp.asarray(ct_y)))
    cell = getattr(trnn, name)(IN, HID)
    cell.load_state_dict(rnn_params_from_jax(host(variables["params"])))
    tcarry = tuple(torch.from_numpy(c).requires_grad_(True) for c in carry)
    tx = torch.from_numpy(x).requires_grad_(True)
    new_carry, y = cell(tcarry, tx)
    torch.autograd.backward(
        (y,) + tuple(new_carry),
        (torch.from_numpy(ct_y),) + tuple(map(torch.from_numpy, ct_c)))
    close(y, jy)
    for got, want in zip(new_carry, jcarry):
        close(got, want)
    close(tx.grad, gx)
    for got, want in zip(tcarry, gc):
        close(got.grad, want)
    for pname, p in cell.named_parameters():
        close(p.grad, gv["params"][pname])


MODELS = {
    "LSTM 2 layers bidirectional": ("LSTM", dict(num_layers=2,
                                                 bidirectional=True)),
    "GRU bidirectional": ("GRU", dict(bidirectional=True)),
    "ReLU 2 layers": ("ReLU", dict(num_layers=2)),
    "Tanh no bias": ("Tanh", dict(bias=False)),
    "mLSTM 2 layers": ("mLSTM", dict(num_layers=2)),
}


@pytest.mark.parametrize("case", list(MODELS))
def test_models_match_jax(case):
    factory, kw = MODELS[case]
    rs = np.random.RandomState(1)
    xs = rs.randn(SEQ, B, IN).astype(np.float32)
    jmod = getattr(jRNN, factory)(IN, HID, **kw)
    variables = perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(xs)),
                          2)
    (jh, jfinals), vjp = jax.vjp(lambda v, x: jmod.apply(v, x), variables,
                                 jnp.asarray(xs))
    ct = rs.randn(*jh.shape).astype(np.float32)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, jfinals)
    gv, gx = vjp((jnp.asarray(ct), zeros))
    model = getattr(tRNN, factory)(IN, HID, device="cpu", **kw)
    model.load_state_dict(rnn_params_from_jax(host(variables["params"])))
    tx = torch.from_numpy(xs).requires_grad_(True)
    h, finals = model(tx)
    h.backward(torch.from_numpy(ct))
    close(h, jh)
    got_leaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), finals,
                               is_leaf=lambda t: isinstance(t,
                                                            torch.Tensor)))
    want_leaves = jax.tree_util.tree_leaves(jfinals)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    close(tx.grad, gx)
    grads = dict(rnn_params_from_jax(host(gv["params"])))
    assert set(grads) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        close(p.grad, grads[name])


def test_lstm_bf16():
    rs = np.random.RandomState(2)
    xs = np.asarray(jnp.asarray(rs.randn(SEQ, B, IN), jnp.bfloat16)
                    .astype(jnp.float32))
    jmod = jRNN.LSTM(IN, HID, num_layers=2)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(xs))
    jh, _ = jmod.apply(variables, jnp.asarray(xs, jnp.bfloat16))
    model = tRNN.LSTM(IN, HID, num_layers=2, device="cpu")
    model.load_state_dict(rnn_params_from_jax(host(variables["params"])))
    h, _ = model(torch.from_numpy(np.array(xs)).bfloat16())
    assert h.dtype == torch.bfloat16
    close(h, jh.astype(jnp.float32), rtol=1.56e-2, atol=1.56e-2)


def test_inter_layer_dropout_from_a_generator():
    rs = np.random.RandomState(3)
    xs = torch.from_numpy(rs.randn(SEQ, B, IN).astype(np.float32))
    model = trnn.LSTM(IN, HID, num_layers=2, dropout=0.5, device="cpu")
    got, _ = model(xs, deterministic=False,
                   generator=torch.Generator().manual_seed(4))
    h, _ = model.layer0(xs)
    keep = keep_mask(torch.Generator().manual_seed(4), 0.5, h.shape, "cpu")
    want, _ = model.layer1(torch.where(keep, h / 0.5, 0.0))
    assert torch.equal(got, want)
    assert torch.equal(model(xs)[0], model.layer1(h)[0])  # eval: no dropout
    with pytest.raises(ValueError, match="generator"):
        model(xs, deterministic=False)


def test_rnn_alias_exports():
    assert sorted(tRNN.__all__) == sorted(jRNN.__all__)
    assert sorted(trnn.__all__) == sorted(jrnn.__all__)
    assert tRNN.LSTM is trnn.LSTM and tRNN.models is trnn.models
