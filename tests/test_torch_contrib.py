"""apex_tpu_torch.contrib's plain-torch modules against the JAX package's.

The same seeded numpy inputs go through the JAX function and the port's
on the CPU. Images are NHWC on the JAX side and the port's channels-last
NCHW on the other (``nhwc_to_port``); convolution kernels HWIO and OIHW.
Tolerances:

- fp32 single op: 1e-5 (the same fp32 arithmetic, summed in another
  order: XLA's and oneDNN's convolutions, a focal loss summed over 2,048
  cells relative);
- bf16: 1.56e-2 (the port's bf16 tolerance: one bf16 rounding of an fp32
  result at points that may differ);
- the transducer: the wavefront adds the same two terms at each cell as
  JAX's nested scan, in the same order, so losses and gradients agree to
  2e-6 relative and 1e-6 absolute (the log-softmax and the gather summed
  in another order);
- exact where only data moves (``index_mul_2d``'s gather and the joint's
  broadcast add), and for the dropout masks, which the port draws from a
  ``torch.Generator`` and this file recomputes from a copy of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import apex_tpu.contrib as jc
import apex_tpu_torch.contrib as tc
from apex_tpu.contrib import clip_grad as jclip
from apex_tpu.contrib import cudnn_gbn as jgbn
from apex_tpu.contrib import fmha as jfmha
from apex_tpu.contrib import layer_norm as jln
from apex_tpu.contrib import openfold_triton as jof
from apex_tpu.contrib import optimizers as jopt
from apex_tpu.contrib import peer_memory as jpm
from apex_tpu_torch.contrib import clip_grad as tclip
from apex_tpu_torch.contrib import cudnn_gbn as tgbn
from apex_tpu_torch.contrib import fmha as tfmha
from apex_tpu_torch.contrib import layer_norm as tln
from apex_tpu_torch.contrib import openfold_triton as tof
from apex_tpu_torch.contrib import optimizers as topt
from apex_tpu_torch.contrib import peer_memory as tpm
from apex_tpu_torch.models import gpt_params_from_jax, group_norm_params_from_jax

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1.56e-2, atol=1.56e-2)
TRANSDUCER = dict(rtol=2e-6, atol=1e-6)


def close(got, want, **tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), **tol)


def nhwc_to_port(x):
    """An NHWC array as the port's channels-last NCHW tensor."""
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def port_to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def bf16(a):
    """``a`` rounded to bf16, as fp32 numpy (exact in both packages)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# -- the aliases ---------------------------------------------------------------

@pytest.mark.parametrize("pair", [
    (jc, tc), (jclip, tclip), (jgbn, tgbn), (jfmha, tfmha), (jln, tln),
    (jof, tof), (jopt, topt), (jpm, tpm),
    (jc.sparsity, tc.sparsity)], ids=lambda p: p[0].__name__)
def test_modules_export_the_jax_names(pair):
    jmod, tmod = pair
    assert sorted(tmod.__all__) == sorted(jmod.__all__)
    for name in tmod.__all__:
        assert hasattr(tmod, name), name


def test_aliases_point_at_the_port_modules():
    from apex_tpu_torch.normalization import FusedLayerNorm
    from apex_tpu_torch.ops.attention import flash_attention
    from apex_tpu_torch.optimizers import clip_grad_norm, fused_adam_swa

    assert tfmha.fmha is flash_attention and tof.AttnTri is flash_attention
    assert tln.FastLayerNorm is FusedLayerNorm
    assert tof.LayerNormSmallShapeOptImpl is FusedLayerNorm
    assert tclip.clip_grad_norm_ is clip_grad_norm
    assert tof.FusedAdamSWA.__module__ == fused_adam_swa.__module__
    assert tgbn.GroupBatchNorm2d is tc.GroupBatchNorm2d
    assert tpm.halo_exchange_1d is tc.halo_exchange_1d


# -- xentropy, focal loss, index_mul_2d ---------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_softmax_cross_entropy_zeroes_padding(smoothing):
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 5, 11).astype(np.float32)
    labels = rs.randint(0, 11, (6, 5)).astype(np.int32)
    labels[:, -1] = 3
    want = jc.SoftmaxCrossEntropyLoss.apply(jnp.asarray(logits), labels,
                                            smoothing, 3)
    got = tc.SoftmaxCrossEntropyLoss.apply(torch.from_numpy(logits),
                                           torch.from_numpy(labels),
                                           smoothing, 3)
    close(got, want, **FP32)
    assert bool((got[:, -1] == 0).all())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_focal_loss_and_gradient(smoothing):
    rs = np.random.RandomState(1)
    n, k, num_real = 256, 8, 6
    logits = (rs.randn(n, k) * 2).astype(np.float32)
    targets = rs.randint(-2, num_real, n).astype(np.int32)
    targets[:4] = -2  # ignored anchors
    num_pos = float(max((targets >= 0).sum(), 1))
    args = (num_pos, num_real, 0.25, 2.0, smoothing)
    want, wgrad = jax.value_and_grad(
        lambda x: jc.focal_loss(x, targets, *args))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tc.focal_loss(x, torch.from_numpy(targets), *args)
    got.backward()
    close(got, want, **FP32)
    close(x.grad, wgrad, **FP32)
    # ignored anchors and padded classes get no gradient
    assert bool((x.grad[:4] == 0).all() and (x.grad[:, num_real:] == 0).all())


def test_index_mul_2d_with_double_backward():
    rs = np.random.RandomState(2)
    in1 = rs.randn(7, 5).astype(np.float32)
    in2 = rs.randn(11, 5).astype(np.float32)
    idx = rs.randint(0, 7, 11).astype(np.int32)
    w = rs.randn(11, 5).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jc.index_mul_2d(a, b, idx) * w)

    def jgrad_sq(a, b):  # a function of the first gradient
        ga, gb = jax.grad(jloss, argnums=(0, 1))(a, b)
        return jnp.sum(ga ** 2) + jnp.sum(gb * b)

    want = jc.index_mul_2d(jnp.asarray(in1), jnp.asarray(in2), idx)
    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(in1), jnp.asarray(in2))
    jgg = jax.grad(jgrad_sq, argnums=(0, 1))(jnp.asarray(in1),
                                             jnp.asarray(in2))
    a = torch.from_numpy(in1).requires_grad_(True)
    b = torch.from_numpy(in2).requires_grad_(True)
    out = tc.index_mul_2d(a, b, torch.from_numpy(idx))
    assert torch.equal(out, torch.from_numpy(np.array(want)))
    ga, gb = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (a, b),
                                 create_graph=True)
    close(ga, jg[0], **FP32)
    close(gb, jg[1], **FP32)
    gga, ggb = torch.autograd.grad((ga ** 2).sum() + (gb * b).sum(), (a, b))
    close(gga, jgg[0], **FP32)
    close(ggb, jgg[1], **FP32)
    with pytest.raises(ValueError):
        tc.index_mul_2d(a, b, torch.zeros(3, dtype=torch.long))


# -- group norm ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["", "swish"])
def test_group_norm(dtype, act):
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 6, 5, 12) * 3 + 1).astype(np.float32)
    w = rs.randn(12).astype(np.float32)
    b = rs.randn(12).astype(np.float32)
    if dtype == "bfloat16":
        x = bf16(x)
    jx = jnp.asarray(x, dtype)
    want = jc.group_norm(jx, 4, jnp.asarray(w), jnp.asarray(b), act=act)
    tx = nhwc_to_port(x).to(getattr(torch, dtype))
    got = tc.group_norm(tx, 4, torch.from_numpy(w), torch.from_numpy(b),
                        act=act)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    close(port_to_nhwc(got), want.astype(jnp.float32),
          **(FP32 if dtype == "float32" else BF16))


def test_group_norm_module_gradients_and_refusals():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 4, 8).astype(np.float32)
    ct = rs.randn(2, 4, 4, 8).astype(np.float32)
    jmod = jc.GroupNorm(num_groups=2, num_channels=8, act="silu")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.randn(*p.shape), jnp.float32),
        variables)
    want, vjp = jax.vjp(jmod.apply, params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    mod = tc.GroupNorm(2, 8, act="silu", device="cpu")
    mod.load_state_dict(group_norm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    tx = nhwc_to_port(x).requires_grad_(True)
    got = mod(tx)
    got.backward(nhwc_to_port(ct))
    close(port_to_nhwc(got), want, **FP32)
    close(port_to_nhwc(tx.grad), gx, **FP32)
    close(mod.scale.grad, gp["params"]["scale"], **FP32)
    close(mod.bias.grad, gp["params"]["bias"], **FP32)
    with pytest.raises(ValueError, match="not divisible"):
        tc.group_norm(tx, 3)
    with pytest.raises(ValueError, match="unsupported act"):
        tc.group_norm(tx, 2, act="gelu")


# -- convolution epilogues ----------------------------------------------------

def _conv_case(rs):
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    w = (rs.randn(3, 3, 4, 6) * 0.3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("variant", ["conv_bias", "conv_bias_relu",
                                     "conv_bias_mask_relu",
                                     "conv_frozen_scale_bias_relu"])
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_conv_variants(variant, stride, padding):
    rs = np.random.RandomState(5)
    x, w = _conv_case(rs)
    bias = rs.randn(6).astype(np.float32)
    scale = rs.rand(6).astype(np.float32) + 0.5
    ho = (9 + 2 * padding - 3) // stride + 1
    mask = (rs.rand(2, ho, ho, 6) > 0.3).astype(np.float32)
    ct = rs.randn(2, ho, ho, 6).astype(np.float32)

    def jcall(x, w, bias, scale):
        f = getattr(jc, variant)
        if variant == "conv_bias_mask_relu":
            return f(x, w, bias, jnp.asarray(mask), padding, stride)
        if variant == "conv_frozen_scale_bias_relu":
            return f(x, w, scale, bias, padding, stride)
        return f(x, w, bias, padding, stride)

    want, vjp = jax.vjp(jcall, *map(jnp.asarray, (x, w, bias, scale)))
    jgx, jgw, jgb, jgs = vjp(jnp.asarray(ct))
    tx = nhwc_to_port(x).requires_grad_(True)
    tw = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous() \
        .requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    f = getattr(tc, variant)
    if variant == "conv_bias_mask_relu":
        got = f(tx, tw, tb, nhwc_to_port(mask), padding, stride)
    elif variant == "conv_frozen_scale_bias_relu":
        got = f(tx, tw, ts, tb, padding, stride)
    else:
        got = f(tx, tw, tb, padding, stride)
    got.backward(nhwc_to_port(ct))
    close(port_to_nhwc(got), want, **FP32)
    close(port_to_nhwc(tx.grad), jgx, **FP32)
    close(tw.grad.permute(2, 3, 1, 0), jgw, **FP32)
    if variant == "conv_frozen_scale_bias_relu":
        assert tb.grad is None and ts.grad is None  # stop_gradient
    else:
        close(tb.grad, jgb, **FP32)


def test_conv_bias_relu_bf16():
    rs = np.random.RandomState(6)
    x, w = _conv_case(rs)
    x, w = bf16(x), bf16(w)
    bias = rs.randn(6).astype(np.float32)
    want = jc.conv_bias_relu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(bias), 1, 1)
    got = tc.conv_bias_relu(nhwc_to_port(x).bfloat16(),
                            torch.from_numpy(w).permute(3, 2, 0, 1),
                            torch.from_numpy(bias), 1, 1)
    assert got.dtype == torch.bfloat16
    close(port_to_nhwc(got), want.astype(jnp.float32), **BF16)


# -- GroupBatchNorm2d -----------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_group_batch_norm(train, residual):
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 3, 3, 8) * 2 + 1).astype(np.float32)
    z = rs.randn(4, 3, 3, 8).astype(np.float32)
    jmod = jc.GroupBatchNorm2d(num_features=8, fuse_relu=True,
                               axis_names=())
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(rs.rand(*p.shape), jnp.float32),
        variables)
    args = (jnp.asarray(x), jnp.asarray(z) if residual else None)
    want, mutated = jmod.apply(variables, *args, train=train,
                               mutable=["batch_stats"])
    mod = tc.GroupBatchNorm2d(8, fuse_relu=True, axis_names=(),
                              device="cpu")
    host = jax.tree_util.tree_map(np.asarray, variables)
    mod.load_state_dict({**gpt_params_from_jax(host["params"]),
                         **gpt_params_from_jax(host["batch_stats"])})
    got = mod(nhwc_to_port(x), nhwc_to_port(z) if residual else None,
              train=train)
    close(port_to_nhwc(got), want, **FP32)
    close(mod.bn.mean, mutated["batch_stats"]["bn"]["mean"], **FP32)
    close(mod.bn.var, mutated["batch_stats"]["bn"]["var"], **FP32)
    plain = tc.GroupBatchNorm2d(8, fuse_relu=False, axis_names=(),
                                device="cpu")
    with pytest.raises(AssertionError, match="fuse_relu"):
        plain(nhwc_to_port(x), nhwc_to_port(z), train=train)


# -- transducer -----------------------------------------------------------------

def test_transducer_joint_masks_and_relu():
    rs = np.random.RandomState(8)
    f = rs.randn(3, 6, 5).astype(np.float32)
    g = rs.randn(3, 4, 5).astype(np.float32)
    f_len = np.array([6, 4, 1], np.int32)
    g_len = np.array([4, 2, 3], np.int32)
    want = jc.transducer_joint(jnp.asarray(f), jnp.asarray(g), f_len, g_len,
                               relu=True)
    got = tc.TransducerJoint(relu=True)(torch.from_numpy(f),
                                        torch.from_numpy(g),
                                        torch.from_numpy(f_len),
                                        torch.from_numpy(g_len))
    assert got.shape == (3, 6, 4, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transducer_joint_dropout_from_a_generator():
    from apex_tpu_torch.transformer.layer import keep_mask

    rs = np.random.RandomState(9)
    f = torch.from_numpy(rs.randn(2, 3, 4).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 5, 4).astype(np.float32))
    gen = torch.Generator().manual_seed(11)
    twin = torch.Generator().manual_seed(11)
    got = tc.TransducerJoint(dropout=True, dropout_prob=0.25)(
        f, g, generator=gen)
    keep = keep_mask(twin, 0.75, (2, 3, 5, 4), "cpu")
    want = torch.where(keep, (f[:, :, None] + g[:, None]) / 0.75, 0.0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        tc.transducer_joint(f, g, dropout_prob=0.25)
    with pytest.raises(NotImplementedError):
        tc.TransducerJoint(pack_output=True)
    with pytest.raises(NotImplementedError):
        tc.TransducerLoss(packed_input=True)


@pytest.mark.parametrize("blank_idx", [0, 6])
def test_transducer_loss_and_gradient_at_unequal_lengths(blank_idx):
    rs = np.random.RandomState(10)
    b, t, u, v = 4, 9, 6, 7
    x = (rs.randn(b, t, u, v) * 2).astype(np.float32)
    label = rs.randint(0, v, (b, u - 1)).astype(np.int32)
    f_len = np.array([9, 6, 3, 1], np.int32)
    y_len = np.array([5, 2, 0, 3], np.int32)
    ct = rs.rand(b).astype(np.float32)
    want, vjp = jax.vjp(
        lambda x: jc.transducer_loss(x, label, f_len, y_len, blank_idx),
        jnp.asarray(x))
    (wgrad,) = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tc.TransducerLoss()(tx, torch.from_numpy(label),
                              torch.from_numpy(f_len),
                              torch.from_numpy(y_len), blank_idx)
    got.backward(torch.from_numpy(ct))
    close(got, want, **TRANSDUCER)
    close(tx.grad, wgrad, **TRANSDUCER)
    # cells past (f_len, y_len) get no gradient
    for i in range(b):
        assert bool((tx.grad[i, f_len[i]:] == 0).all())
        assert bool((tx.grad[i, :, y_len[i] + 1:] == 0).all())
