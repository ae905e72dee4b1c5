"""GPT-2's transformers import and export in apex_tpu_torch against the
JAX package's (``models/hf_import.py``) and against transformers itself.

A randomly initialized ``transformers.GPT2LMHeadModel`` (nothing is
downloaded) at ``tests/test_hf_parity.py``'s size (3 layers, width 48, 4
heads, vocab 128, 64 positions). Held:

- the port's ``params_from_hf_gpt2`` equals JAX's tensor for tensor,
  path for path (the per-head qkv regrouping included), exactly;
- the port's model's logits match the transformers model's at JAX's
  tolerance (atol 2e-5, fp32 both sides), and its next-token loss
  JAX's (rtol 1e-5);
- the export round trip is exact: weights moved off the import by a
  cosine ramp, exported into a copy of the model, read back equal bit
  for bit, and the copy's logits match the port's (atol 3e-5);
- the regrouping and its inverse are exact on any width (no
  transformers needed).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import hf_import as jax_hf
from apex_tpu_torch.models import hf_import as hf


@pytest.fixture(scope="module")
def hf_model():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=48, n_layer=3, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    model = transformers.GPT2LMHeadModel(cfg)
    model.eval()
    return model


def _jax_flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_jax_flat(v, f"{prefix}.{k}" if prefix else k))
    return out


def test_import_equals_jax_tensor_for_tensor(hf_model):
    """Tolerance: none (the same fp32 numbers)."""
    want = _jax_flat(jax_hf.params_from_hf_gpt2(hf_model))
    got = hf.params_from_hf_gpt2(hf_model.state_dict(), hf_model.config)
    assert sorted(got) == sorted(want)
    for name, a in want.items():
        np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)


def test_logits_and_loss_match_transformers(hf_model):
    model = hf.gpt2_from_hf(hf_model, device="cpu")
    tokens = np.random.RandomState(0).randint(0, 128, size=(2, 32))
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        ref = hf_model(t).logits.numpy()
        ours = model(t).numpy()
        ref_loss = float(hf_model(t, labels=t).loss)
        losses = model(t, labels=torch.roll(t, -1, dims=1))
    # fp32 both sides; JAX's tolerance (tests/test_hf_parity.py)
    np.testing.assert_allclose(ours, ref, atol=2e-5)
    # transformers' shift drops each row's last position
    assert float(losses[:, :-1].mean()) == pytest.approx(ref_loss, rel=1e-5)


def test_export_round_trip_is_exact(hf_model):
    params = {n: v + 0.01 * torch.cos(torch.arange(v.numel(),
                                                   dtype=torch.float32)
                                      ).reshape(v.shape)
              for n, v in hf.params_from_hf_gpt2(
                  hf_model.state_dict(), hf_model.config).items()}
    hf2 = copy.deepcopy(hf_model)
    hf.params_to_hf_gpt2(params, hf2)
    back = hf.params_from_hf_gpt2(hf2.state_dict(), hf2.config)
    for name, v in params.items():
        assert torch.equal(back[name], v), name
    model = hf.gpt2_from_hf(hf2, device="cpu")
    tokens = torch.from_numpy(
        np.random.RandomState(6).randint(0, 128, size=(2, 24)))
    with torch.no_grad():
        np.testing.assert_allclose(model(tokens).numpy(),
                                   hf2(tokens).logits.numpy(), atol=3e-5)


@pytest.mark.parametrize("lead,heads,hn", [((), 4, 3), ((5,), 2, 8),
                                           ((2, 3), 1, 4)])
def test_qkv_regroup_matches_jax_and_inverts(lead, heads, hn):
    """Tolerance: none."""
    w = np.random.RandomState(1).randn(*lead, 3 * heads * hn).astype(
        np.float32)
    got = hf._regroup_qkv(torch.from_numpy(w), heads)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_hf._regroup_qkv(w, heads))
    assert torch.equal(hf._ungroup_qkv(got, heads), torch.from_numpy(w))
    np.testing.assert_array_equal(
        hf._ungroup_qkv(got, heads).numpy(),
        jax_hf._ungroup_qkv(np.asarray(got.numpy()), heads))


def test_config_maps_gpt2_and_refuses_other_activations(hf_model):
    cfg = hf.config_from_hf_gpt2(hf_model.config)
    jcfg = jax_hf.config_from_hf_gpt2(hf_model.config)
    for f in ("num_layers", "hidden_size", "num_attention_heads",
              "vocab_size", "max_position_embeddings", "layernorm_epsilon",
              "activation", "position_embedding_type",
              "share_embeddings_and_output_weights"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    bad = copy.deepcopy(hf_model.config)
    bad.activation_function = "relu"
    with pytest.raises(ValueError, match="tanh-gelu"):
        hf.config_from_hf_gpt2(bad)
    with pytest.raises(ValueError, match="tanh-gelu"):
        jax_hf.config_from_hf_gpt2(bad)
    assert cfg.compute_dtype == torch.float32
    assert jnp.dtype(jcfg.compute_dtype) == jnp.float32
