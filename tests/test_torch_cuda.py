"""The CUDA kernels on the card against their plain PyTorch versions.

Marked ``cuda``; every test skips where there is no CUDA device (as on
a CPU-only host). On the card, run them without the JAX suite's conftest
(this file imports no JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: fp32 1e-5 (norm) and 2e-5 (attention), the same arithmetic
summed in another order; bf16 2e-2, one bf16 rounding of the output (and,
in attention, of P before P.V) at different points; the forward's lse
1e-4 (fp32 sums of the same scores in another order). Backward kernels:
fp32 1e-4 (longer sums), bf16 2e-2 on dx/dq/dk/dv (one bf16 rounding of
the output, and of p and ds before the products); LayerNorm dgamma/dbeta
1e-3 absolute (fp32 sums over up to 300 rows in another order). The Adam
kernel rounds every operation as its plain version does: bit-equal.
RMSNorm as LayerNorm (dgamma over up to 1000 rows: 1e-3 absolute). The
sum of squares against an fp64 sum on the card: 1e-5 relative (fp32
partial sums of a few thousand terms each). Every kernel's repeat call
on the same inputs is bit-equal (fixed summation orders, no atomics).
The collectives and the point-to-point messages of CUDA tensors under
gloo, staged through host memory, equal the same operations on host
tensors bit for bit. Recompute with dropout on the card gives no
recompute's gradients and generator states bit for bit; ``MoEMLP`` and
``fp8_dense`` in fp32 on the card agree with the CPU to 1e-5 relative
in norm (``fp8_dense``'s gradients 1e-3: they pass an e4m3 cast), and
``quantize`` bit for bit; the compressed collectives' block quantizer
equals the CPU's bit for bit, and the ZeRO remainders' split and rebuild
are exact. fp32 beam search on the card gives the CPU's tokens, its
scores within 1e-4; the memory report and the OOM guard read the card's
allocator exactly. The GPT step (GPT-2 small's widths at 2 layers) gives
the same bits twice from one state, by every leaf's crc32; a checkpoint
round trip on the card keeps every leaf's crc32; and an async save
issued just before an in-place Adam step writes the pre-step bytes. A
ZeRO state's checkpoint written through the multi-rank layout at a world
of one (its one rank the whole global tree) restores through the
resharder with every leaf's crc32 its manifest's, and
``zero_regroup_flat`` on the card equals it on the CPU bit for bit. The
native host library builds and loads on the card's host, and a token
file's batches equal numpy's rows; the Llama example at TinyLlama's
width (2 layers) saved and resumed gives the uninterrupted run's losses
and every leaf's crc32. The contrib MHA modules through the LayerNorm and
flash kernels agree with their plain path on the CPU to 1e-4 (fp32, a
fully padded key row included), the transducer's loss and gradient on
the card with the CPU's to 1e-5, and ASP's masks on the card equal the
CPU's.
"""

import math

import numpy as np
import pytest
import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch.models import (
    BertModel,
    GPTModel,
    generate,
    gpt_loss_fn,
    tinyllama_1_1b_config,
)
from apex_tpu_torch.ops import attention as at
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.optimizers import _fused_kernels as fk
from apex_tpu_torch.serving import ServingConfig, ServingEngine
from apex_tpu_torch.transformer import TransformerConfig

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on the card run: python -m pytest "
                    "--noconftest tests/test_torch_cuda.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


# GPT-2's serving and training shapes take the register-resident row (3
# vectors a lane at 768 bf16); 770 is not a multiple of the 16-byte vector
# and takes the loop.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(1, 768), (300, 768), (77, 1000),
                                         (8, 768), (768, 768), (8192, 768),
                                         (77, 770), (2048, 1024),
                                         (16384, 1024)])
def test_layer_norm_kernel(gen, dtype, rows, hidden):
    x = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    w = torch.randn(hidden, generator=gen, device="cuda")
    b = torch.randn(hidden, generator=gen, device="cuda")
    before = _kernels.LAYER_NORM_FWD.launches
    out = ln.layer_norm(x, w, b)
    assert _kernels.LAYER_NORM_FWD.launches == before + 1
    ref = ln._ln_ref(x, w, b, 1e-5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _unaligned(x):
    """The same values as ``x``, in a view 2 or 4 bytes off a 16-byte line,
    which the norm kernels take through their loop."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


# The forwards' two routes compute the same arithmetic in the same order:
# the register-resident row is bit-equal to the loop kernel on the same
# input, with and without the affine parameters.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rms,rows,hidden", [
    (False, 8192, 768), (False, 768, 768), (False, 8, 768), (False, 5, 4096),
    (True, 300, 2048), (True, 8, 2048), (True, 5, 4096)])
def test_norm_forward_row_is_bit_equal_to_the_loop(gen, dtype, rms, rows,
                                                   hidden):
    x = (torch.randn(rows, hidden, generator=gen, device="cuda") * 3 + 1) \
        .to(dtype)
    w = torch.randn(hidden, generator=gen, device="cuda")
    b = torch.randn(hidden, generator=gen, device="cuda")
    for wt, bt in ((w, b), (w, None), (None, b), (None, None)):
        if rms and bt is not None:
            continue
        row = ln.rms_norm(x, wt) if rms else ln.layer_norm(x, wt, bt)
        assert torch.equal(row, ln._norm_fwd_loop(x, wt, bt, 1e-5, rms))


CASES = {
    "prefill": dict(b=1, h=12, h_kv=12, sq=200, sk=200, causal=True),
    "gqa_window": dict(b=2, h=12, h_kv=4, sq=130, sk=130, causal=True,
                       window=50),
    "decode": dict(b=8, h=12, h_kv=12, sq=1, sk=300, causal=False,
                   kpm=True),
    # the bf16 decode kernel: Llama's GQA 32/4 split over 8 blocks (with a
    # dead and a full lane), sk a multiple of neither 64 nor the split, and
    # a sliding window at sq = 1
    "decode_gqa_split": dict(b=8, h=32, h_kv=4, sq=1, sk=2048, causal=False,
                             kpm=True, splits=8),
    "decode_ragged": dict(b=4, h=32, h_kv=4, sq=1, sk=1000, causal=False,
                          kpm=True, splits=8),
    "decode_window": dict(b=3, h=8, h_kv=2, sq=1, sk=700, causal=True,
                          window=130, kpm=True, splits=6),
    # a group of 32 query heads: two 16-row blocks a (batch, kv head) pair
    "decode_group32": dict(b=2, h=32, h_kv=1, sq=1, sk=500, causal=False,
                           kpm=True, splits=8),
    # d = 36, not a multiple of 8: element-wise loads instead of cp.async
    "prefill_hd36": dict(b=1, h=4, h_kv=2, sq=150, sk=150, causal=True,
                         d=36),
    # the prefill kernel's wider instantiation (d = 80 zero-padded to 128)
    # and the window with causal at sq != sk
    "prefill_hd80": dict(b=2, h=12, h_kv=12, sq=300, sk=300, causal=True,
                         d=80),
    "prefill_hd128": dict(b=2, h=16, h_kv=2, sq=200, sk=200, causal=True,
                          d=128),
    "window_rect": dict(b=1, h=4, h_kv=2, sq=77, sk=300, causal=True,
                        window=100),
    # the widest instantiation, d = 256, and d = 160 zero-padded to it: a
    # GQA prefill, a windowed one, the split decode (8 splits) and the
    # unsplit one (800 blocks fill the card)
    "prefill_hd256": dict(b=2, h=8, h_kv=2, sq=200, sk=200, causal=True,
                          d=256),
    "prefill_hd160": dict(b=1, h=4, h_kv=4, sq=150, sk=150, causal=True,
                          window=60, d=160),
    "decode_hd256_split": dict(b=4, h=8, h_kv=8, sq=1, sk=1000,
                               causal=False, kpm=True, splits=8, d=256),
    "decode_hd160": dict(b=400, h=2, h_kv=2, sq=1, sk=300, causal=False,
                         kpm=True, splits=1, d=160),
    # batch * heads past the grid's y limit of 65535
    "bh65600": dict(b=4100, h=16, h_kv=16, sq=20, sk=20, causal=True),
    "bh65600_hd256": dict(b=4100, h=16, h_kv=4, sq=9, sk=9, causal=False,
                          d=256),
    "decode_bh65600": dict(b=4100, h=16, h_kv=4, sq=1, sk=40, causal=False,
                           kpm=True, splits=1),
    # BERT-345M's attention: non-causal (4,16,512,64), without and with a
    # key-padding row whose last row keeps a single key
    "bert": dict(b=4, h=16, h_kv=16, sq=512, sk=512, causal=False),
    "bert_kpm": dict(b=4, h=16, h_kv=16, sq=512, sk=512, causal=False,
                     kpm_lens=(512, 400, 137, 1)),
    # BERT-345M serving's batch: 32 rows of lengths 64-512 drawn by
    # RandomState(0), as chip_smoke.py's bert_serving draws them
    "bert_serving": dict(b=32, h=16, h_kv=16, sq=512, sk=512, causal=False,
                         kpm_lens=tuple(int(n) for n in np.random.RandomState(
                             0).randint(64, 513, 32))),
}


def _lens_kpm(c):
    """The (b, sk) key-padding mask of a case's ``kpm_lens``."""
    lens = torch.tensor(c["kpm_lens"], device="cuda")
    return torch.arange(c["sk"], device="cuda")[None] >= lens[:, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_kernel(gen, dtype, case):
    c = CASES[case]
    d = c.get("d", 64)
    q = torch.randn(c["b"], c["h"], c["sq"], d, generator=gen, device="cuda")
    k, v = (torch.randn(c["b"], c["h_kv"], c["sk"], d, generator=gen,
                        device="cuda") for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    kpm = _lens_kpm(c) if "kpm_lens" in c else None
    if c.get("kpm"):
        lens = torch.randint(1, c["sk"] + 1, (c["b"],), generator=gen,
                             device="cuda")
        lens[0] = 0  # a dead row
        lens[1] = c["sk"]  # a full lane
        kpm = torch.arange(c["sk"], device="cuda")[None] >= lens[:, None]
    if dtype == torch.bfloat16 and "splits" in c:
        assert at._decode_splits(q, k) == c["splits"]
    scale = 1 / math.sqrt(d)
    before = _kernels.FLASH_FWD.launches
    out, lse = at._flash_kernel(q, k, v, scale, c["causal"], kpm,
                                c.get("window"))
    assert _kernels.FLASH_FWD.launches == before + 1
    ref, ref_lse = at._flash_fwd_ref(q, k, v, scale, c["causal"], kpm,
                                     c.get("window"))
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # lse in natural-log units, as the backward reads it (fp32 sums of the
    # same scores in another order, exp by ex2.approx in bf16)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    if c.get("kpm"):
        assert torch.count_nonzero(out[0]) == 0
        assert bool((lse[0] == 1e30).all())
    assert torch.isfinite(lse[1:]).all()
    again = at._flash_kernel(q, k, v, scale, c["causal"], kpm,
                             c.get("window"))
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


def test_engine_goes_through_both_kernels(gen):
    cfg = TransformerConfig(num_layers=2, hidden_size=256,
                            num_attention_heads=4, vocab_size=512,
                            max_position_embeddings=128, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            compute_dtype=torch.float32)
    model = GPTModel(cfg, seed=0)
    eng = ServingEngine(model, ServingConfig(lanes=3, block_size=16,
                                             num_blocks=32, max_seq_len=128))
    prompts = [torch.randint(0, 512, (n,), generator=gen, device="cuda")
               .cpu().numpy() for n in (5, 40, 17, 60)]
    _kernels.reset_launch_counts()
    reqs = [eng.submit(p, 8) for p in prompts]
    while not eng.idle:
        eng.tick()
    counts = _kernels.launch_counts()
    # serving runs the forward kernels only
    assert counts["layer_norm_fwd"] > 0 and counts["flash_fwd"] > 0
    for r in reqs:
        want = generate(model, r.prompt[None], 8)[0, r.prompt_len:]
        assert r.tokens_out == want.tolist()



@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_extract_adopt_on_the_card_resumes_bit_identically(gen, dtype):
    """A request handed off mid-decode (``extract``: one device-to-host
    copy a side; ``adopt``: the blocks written in place) finishes with
    the tokens of the same request served on one engine, bit for bit;
    the adopter's pool keeps its storage and no kernel loads after
    ``start()``."""
    cfg = TransformerConfig(num_layers=2, hidden_size=256,
                            num_attention_heads=4, vocab_size=512,
                            max_position_embeddings=128, hidden_dropout=0.0,
                            attention_dropout=0.0, compute_dtype=dtype)
    model = GPTModel(cfg, seed=0)
    scfg = ServingConfig(lanes=2, block_size=16, num_blocks=16,
                         max_seq_len=128)
    prompt = torch.randint(0, 512, (37,), generator=gen,
                           device="cuda").cpu().numpy()
    alone = ServingEngine(model, scfg).start()
    ref = alone.submit(prompt, 20)
    while not alone.idle:
        alone.tick()
    src = ServingEngine(model, scfg).start()
    dst = ServingEngine(model, scfg).start()
    ptrs = (dst.k_pool.data_ptr(), dst.v_pool.data_ptr())
    req = src.submit(prompt, 20)
    for _ in range(6):
        src.tick()
    payload = src.extract(req.rid)
    assert payload["kv"]["k"].device.type == "cpu"
    assert payload["bytes"] == (payload["n_blocks"] * 2 * 2 * 4 * 16 * 64
                                * torch.finfo(dtype).bits // 8)
    assert dst.adopt(payload)
    while not dst.idle:
        dst.tick()
    assert req.state == "completed" and req.tokens_out == ref.tokens_out
    assert (dst.k_pool.data_ptr(), dst.v_pool.data_ptr()) == ptrs
    assert src.steady_state_compiles == dst.steady_state_compiles == 0


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(1, 768), (300, 768), (77, 1000)])
def test_layer_norm_backward_kernel(gen, dtype, rows, hidden):
    x = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    w = torch.randn(hidden, generator=gen, device="cuda")
    before = _kernels.LAYER_NORM_BWD.launches
    dx, dg, db = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    assert _kernels.LAYER_NORM_BWD.launches == before + 1
    rdx, rdg, rdb = ln._ln_bwd_ref(x, w, dy, 1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), atol=BWD_TOL[dtype],
                               rtol=BWD_TOL[dtype])
    torch.testing.assert_close(dg, rdg, atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(db, rdb, atol=1e-3, rtol=1e-4)
    again = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(again, (dx, dg, db)))
    # no affine weight: w = 1
    dx, dg, db = ln._ln_bwd_kernel(x, None, dy, 1e-5)
    rdx, rdg, rdb = ln._ln_bwd_ref(x, None, dy, 1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), atol=BWD_TOL[dtype],
                               rtol=BWD_TOL[dtype])
    torch.testing.assert_close(dg, rdg, atol=1e-3, rtol=1e-4)


# The register-resident rows take hidden 768 (GPT-2: 3 vectors a lane in
# bf16), 1024 (BERT-large), 1600 (GPT-2 XL; 13 vectors a lane in fp32, so
# there the loop) and 2048; 1001 (not a multiple of the vector) and an
# unaligned view take the loop. Both against the plain version, and the
# rows against the loop kernel on the same inputs; dgamma and dbeta over
# up to 8192 rows to chip_smoke.py's 2e-3 absolute.
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(8192, 768), (1000, 1024), (77, 1600),
                                         (1, 2048), (300, 1001),
                                         (300, "unaligned"), (2048, 1024)])
def test_layer_norm_backward_rows_and_loop(gen, dtype, rows, hidden,
                                           weighted):
    if hidden == "unaligned":  # 2 or 4 bytes off a 16-byte line
        hidden = 768
        x = torch.randn(rows * hidden + 1, generator=gen,
                        device="cuda").to(dtype)[1:].view(rows, hidden)
    else:
        x = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    w = torch.randn(hidden, generator=gen, device="cuda") if weighted \
        else None
    before = _kernels.LAYER_NORM_BWD.launches
    got = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    loop = ln._ln_bwd_kernel(x, w, dy, 1e-5, loop=True)
    assert _kernels.LAYER_NORM_BWD.launches == before + 1
    for want in (ln._ln_bwd_ref(x, w, dy, 1e-5), loop):
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])
        for g, r in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, r, atol=2e-3, rtol=1e-4)
    again = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_layer_norm_autograd_on_the_card(gen):
    x = torch.randn(5, 64, generator=gen, device="cuda", requires_grad=True)
    w = torch.randn(64, generator=gen, device="cuda", requires_grad=True)
    b = torch.zeros(64, device="cuda", requires_grad=True)
    ln.layer_norm(x, w, b).square().sum().backward()
    xc, wc, bc = (t.detach().cpu().requires_grad_(True) for t in (x, w, b))
    ln.layer_norm(xc, wc, bc).square().sum().backward()
    for t, c in ((x, xc), (w, wc), (b, bc)):
        torch.testing.assert_close(t.grad.cpu(), c.grad, atol=1e-4,
                                   rtol=1e-4)


BWD_CASES = dict(
    CASES, rect=dict(b=1, h=4, h_kv=4, sq=77, sk=200, causal=True),
    ragged=dict(b=2, h=2, h_kv=2, sq=100, sk=100, causal=False),
    hd32=dict(b=1, h=4, h_kv=2, sq=70, sk=70, causal=True, d=32),
    hd128=dict(b=1, h=4, h_kv=1, sq=130, sk=130, causal=True, d=128,
               window=40),
    # the bf16 kernels' fragment paths: a GQA group of 8 at a ragged
    # length, d = 80 (zero-padded to 128, five 16-wide steps) and d = 36
    # (not a multiple of 8: element-wise loads instead of cp.async)
    gqa8_ragged=dict(b=1, h=16, h_kv=2, sq=200, sk=200, causal=True),
    hd80=dict(b=2, h=4, h_kv=2, sq=150, sk=150, causal=True, d=80),
    hd36=dict(b=1, h=2, h_kv=1, sq=90, sk=90, causal=False, d=36),
    # d = 256 with a window over sq != sk, and d = 160 (zero-padded to 256)
    hd256_rect=dict(b=1, h=4, h_kv=2, sq=77, sk=200, causal=True, d=256,
                    window=60),
    hd160=dict(b=2, h=2, h_kv=1, sq=100, sk=100, causal=False, d=160))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_backward_kernels(gen, dtype, case):
    c = BWD_CASES[case]
    d = c.get("d", 64)
    q = torch.randn(c["b"], c["h"], c["sq"], d, generator=gen, device="cuda")
    k, v = (torch.randn(c["b"], c["h_kv"], c["sk"], d, generator=gen,
                        device="cuda") for _ in range(2))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kpm = _lens_kpm(c) if "kpm_lens" in c else None
    if c.get("kpm"):
        kpm = torch.zeros(c["b"], c["sk"], dtype=torch.bool, device="cuda")
        kpm[0] = True  # a dead row
        kpm[1, c["sk"] // 2:] = True
    scale = 1 / math.sqrt(d)
    args = (scale, c["causal"], kpm, c.get("window"))
    o, lse = at._flash_kernel(q, k, v, *args)
    delta = (do.float() * o.float()).sum(-1)
    before = _kernels.FLASH_BWD_DQ.launches, _kernels.FLASH_BWD_DKV.launches
    got = at._flash_bwd_kernel(q, k, v, do, lse, delta, *args)
    assert (_kernels.FLASH_BWD_DQ.launches, _kernels.FLASH_BWD_DKV.launches) \
        == (before[0] + 1, before[1] + 1)
    ref = at._flash_bwd_ref(q, k, v, do, lse, delta, *args)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        torch.testing.assert_close(g.float(), r.float(), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])
    if c.get("kpm"):
        assert torch.count_nonzero(got[0][0]) == 0
    again = at._flash_bwd_kernel(q, k, v, do, lse, delta, *args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("adam_w_mode,weight_decay",
                         [(True, 0.01), (False, 0.01), (True, 0.0)])
@pytest.mark.parametrize("n", [1 << 20, 1000003])
def test_adam_kernel_bit_equal(gen, adam_w_mode, weight_decay, n):
    g, p, m = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    v = torch.rand(n, generator=gen, device="cuda")
    step = torch.tensor(10.0, device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=weight_decay, adam_w_mode=adam_w_mode)
    before = _kernels.ADAM.launches
    got = fk._adam_kernel(g, p, m, v, bc1, bc2, **kw)
    assert _kernels.ADAM.launches == before + 1
    ref = fk._adam_flat_ref(g, p, m, v, bc1, bc2, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_every_gpt_parameter_gets_a_gradient_on_the_card(gen):
    cfg = TransformerConfig(num_layers=2, hidden_size=128,
                            num_attention_heads=2, vocab_size=512,
                            max_position_embeddings=64, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            compute_dtype=torch.float32)
    model = GPTModel(cfg, seed=0)
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, 512, (2, 64), generator=gen, device="cuda")
    labels = torch.randint(0, 512, (2, 64), generator=gen, device="cuda")
    _kernels.reset_launch_counts()
    loss = gpt_loss_fn(model(tokens, labels=labels))
    loss.backward()
    counts = _kernels.launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] > 0, name
    gpt_loss_fn(cpu(tokens.cpu(), labels=labels.cpu())).backward()
    named = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad.cpu(), named[name].grad,
                                   atol=1e-5, rtol=1e-3)


# hidden 1000, 2048 and 4096 take the forward's register-resident row (4,
# 8 and 16 vectors a lane in bf16), 770 and 5120 its loop (not a multiple of
# the vector; beyond the register budget). The backward's rows take up to
# 8 vectors a lane: 1000 and 2048 (TinyLlama's, at its fine-tuning rows)
# take them, 770, 4096 and 5120 its loop.
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,hidden", [(1, 2048), (300, 2048), (77, 1000),
                                         (8, 4096), (5, 5120), (8192, 2048),
                                         (77, 770)])
def test_rms_norm_kernels(gen, dtype, rows, hidden, weighted):
    x = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    w = torch.randn(hidden, generator=gen, device="cuda") if weighted else None
    before = _kernels.RMS_NORM_FWD.launches, _kernels.RMS_NORM_BWD.launches
    out = ln.rms_norm(x, w)
    dx, dg = ln._rms_bwd_kernel(x, w, dy, 1e-5)
    assert (_kernels.RMS_NORM_FWD.launches, _kernels.RMS_NORM_BWD.launches) \
        == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out.float(), ln._rms_ref(x, w, 1e-5).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    rdx, rdg = ln._rms_bwd_ref(x, w, dy, 1e-5)
    torch.testing.assert_close(dx.float(), rdx.float(), atol=BWD_TOL[dtype],
                               rtol=BWD_TOL[dtype])
    torch.testing.assert_close(dg, rdg, atol=1e-3, rtol=1e-4)
    assert torch.equal(ln.rms_norm(x, w), out)
    again = ln._rms_bwd_kernel(x, w, dy, 1e-5)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_forward_unaligned_input(gen, dtype):
    """An input 2 or 4 bytes off a 16-byte line takes the forward's loop."""
    buf = torch.randn(300 * 2048 + 1, generator=gen, device="cuda").to(dtype)
    x = buf[1:].view(300, 2048)
    w = torch.randn(2048, generator=gen, device="cuda")
    torch.testing.assert_close(ln.rms_norm(x, w).float(),
                               ln._rms_ref(x, w, 1e-5).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_forward_unaligned_input(gen, dtype):
    """An input 2 or 4 bytes off a 16-byte line takes the forward's loop."""
    x = (torch.randn(300, 768, generator=gen, device="cuda") * 3 + 1).to(dtype)
    w = torch.randn(768, generator=gen, device="cuda")
    b = torch.randn(768, generator=gen, device="cuda")
    xu = _unaligned(x)
    torch.testing.assert_close(ln.layer_norm(xu, w, b).float(),
                               ln._ln_ref(x, w, b, 1e-5).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_unaligned_input(gen, dtype):
    """Unaligned x or dy take the backward's loop; it agrees with the
    plain version and with the register-resident rows on aligned copies."""
    x = torch.randn(300, 2048, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(300, 2048, generator=gen, device="cuda").to(dtype)
    w = torch.randn(2048, generator=gen, device="cuda")
    rdx, rdg = ln._rms_bwd_ref(x, w, dy, 1e-5)
    row = ln._rms_bwd_kernel(x, w, dy, 1e-5)
    for xs, dys in ((_unaligned(x), dy), (x, _unaligned(dy))):
        dx, dg = ln._rms_bwd_kernel(xs, w, dys, 1e-5)
        torch.testing.assert_close(dx.float(), rdx.float(),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])
        torch.testing.assert_close(dg, rdg, atol=1e-3, rtol=1e-4)
        torch.testing.assert_close(dx.float(), row[0].float(),
                                   atol=BWD_TOL[dtype], rtol=BWD_TOL[dtype])


def test_rms_norm_autograd_on_the_card(gen):
    x = torch.randn(5, 64, generator=gen, device="cuda", requires_grad=True)
    w = torch.randn(64, generator=gen, device="cuda", requires_grad=True)
    ln.rms_norm(x, w).square().sum().backward()
    xc, wc = (t.detach().cpu().requires_grad_(True) for t in (x, w))
    ln.rms_norm(xc, wc).square().sum().backward()
    for t, c in ((x, xc), (w, wc)):
        torch.testing.assert_close(t.grad.cpu(), c.grad, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("n", [1, 1023, 1_000_003, 1 << 24])
def test_sumsq_kernel(gen, n):
    x = torch.randn(n, generator=gen, device="cuda")
    before = _kernels.SUMSQ_FLAT.launches
    got = fk.sumsq_flat(x)
    assert _kernels.SUMSQ_FLAT.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ()
    ref = (x.double() ** 2).sum()
    assert abs(float(got) - float(ref)) <= 1e-5 * float(ref)
    torch.testing.assert_close(got, fk._sumsq_flat_ref(x), atol=0, rtol=1e-5)
    assert torch.equal(fk.sumsq_flat(x), got)
    # an unaligned view takes the scalar path
    assert abs(float(fk.sumsq_flat(x[1:])) - float(ref - x[0].double() ** 2)) \
        <= 1e-5 * float(ref) + 1e-6


def test_llama_layer_goes_through_the_kernels(gen):
    """A small Llama on the card against the same weights on the CPU:
    logits and every gradient, with RMSNorm, rope and GQA on the path."""
    cfg = tinyllama_1_1b_config(num_layers=2, hidden_size=256,
                                num_attention_heads=8, num_query_groups=2,
                                ffn_hidden_size=320, vocab_size=512,
                                max_position_embeddings=64,
                                compute_dtype=torch.float32)
    model = GPTModel(cfg, seed=0)
    cpu = GPTModel(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens = torch.randint(0, 512, (2, 64), generator=gen, device="cuda")
    labels = torch.roll(tokens, -1, dims=1)
    _kernels.reset_launch_counts()
    gpt_loss_fn(model(tokens, labels=labels)).backward()
    counts = _kernels.launch_counts()
    for name in ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] > 0, name
    gpt_loss_fn(cpu(tokens.cpu(), labels=labels.cpu())).backward()
    named = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad.cpu(), named[name].grad,
                                   atol=1e-5, rtol=1e-3)


def _bert_inputs(gen, vocab=512, b=2, s=64):
    """Tokens, attention_mask (lengths s and s - 24) and tokentype_ids."""
    tokens = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    lens = torch.tensor([s, s - 24], device="cuda")[:, None]
    pos = torch.arange(s, device="cuda")[None]
    mask = (pos < lens).long()
    types = ((pos >= lens // 2) & (pos < lens)).long()
    labels = torch.randint(0, vocab, (b, s), generator=gen, device="cuda")
    return tokens, mask, types, labels


BERT_SMALL = dict(num_layers=2, hidden_size=256, num_attention_heads=4,
                  vocab_size=512, max_position_embeddings=64,
                  compute_dtype=torch.float32)


def test_bert_goes_through_the_kernels(gen):
    """A small padded BERT on the card against the same weights on the
    CPU: logits, NSP logits, losses and every gradient, through the
    LayerNorm and flash kernels (key padding, non-causal)."""
    cfg = TransformerConfig(hidden_dropout=0.0, attention_dropout=0.0,
                            **BERT_SMALL)
    model = BertModel(cfg, seed=0)
    cpu = BertModel(cfg, device="cpu", seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    tokens, mask, types, labels = _bert_inputs(gen)
    _kernels.reset_launch_counts()
    losses, nsp = model(tokens, mask, types, lm_labels=labels)
    ((losses * mask).sum() / mask.sum() + nsp.sum()).backward()
    counts = _kernels.launch_counts()
    for name in ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] > 0, name
    lc, nc = cpu(tokens.cpu(), mask.cpu(), types.cpu(), lm_labels=labels.cpu())
    ((lc * mask.cpu()).sum() / mask.sum().cpu() + nc.sum()).backward()
    torch.testing.assert_close(losses.detach().cpu(), lc.detach(), atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(nsp.detach().cpu(), nc.detach(), atol=1e-4,
                               rtol=1e-4)
    named = dict(cpu.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        torch.testing.assert_close(p.grad.cpu(), named[name].grad,
                                   atol=1e-5, rtol=1e-3)


def test_bert_dropout_takes_core_attention_on_the_card(gen):
    """Train mode with attention dropout: the dense extended mask through
    CoreAttention, no flash launch; one seed gives bit-equal forwards; the
    kept share of 2^22 elements within 4 sigma of 0.9."""
    cfg = TransformerConfig(**BERT_SMALL)
    a, b = BertModel(cfg, seed=3), BertModel(cfg, seed=3)
    tokens, mask, types, labels = _bert_inputs(gen)
    _kernels.reset_launch_counts()
    la, na = a(tokens, mask, types, lm_labels=labels)
    la.mean().backward()
    counts = _kernels.launch_counts()
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == 0
    assert counts["layer_norm_fwd"] > 0 and counts["layer_norm_bwd"] > 0
    lb, nb = b(tokens, mask, types, lm_labels=labels)
    assert torch.equal(la, lb) and torch.equal(na, nb)
    assert torch.isfinite(la).all()
    n = 1 << 22
    kept = a.embedding.dropout(torch.ones(n, device="cuda")) != 0
    sigma = math.sqrt(0.1 * 0.9 / n)
    assert abs(kept.float().mean().item() - 0.9) < 4 * sigma



def test_gloo_collectives_of_cuda_tensors_go_through_host_memory(gen):
    """Two ranks on this card over gloo: every ``parallel_state``
    collective of a CUDA tensor equals the same collective of the tensor
    on the CPU, and each was staged once: 5 collectives moving 1,008
    bytes between the card and the host (two 96-byte in-place
    all-reduces and a broadcast, both ways; the gather's 96 in and 192
    out; the reduce-scatter's 96 in and 48 out)."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )
    from apex_tpu_torch.transformer.testing.parallel_workers import (
        staged_collectives_worker,
    )

    for out, staged in spawn(staged_collectives_worker, 2, timeout=120.0):
        assert len(out["cuda"]) == len(out["cpu"]) == 5
        for got, want in zip(out["cuda"], out["cpu"]):
            np.testing.assert_array_equal(got, want)
        assert staged == {"collectives": 5, "bytes": 1008, "p2p": 0,
                          "p2p_bytes": 0}


def test_gloo_p2p_of_cuda_tensors_goes_through_host_memory(gen):
    """Two ranks on this card over gloo, each sending an fp32 (3, 5) and
    a bf16 (4,) tensor to the other under two tags and receiving the
    other's: ``parallel_state.p2p`` of CUDA tensors gives the same values
    as of host tensors, on the card, and each rank stages its 2 sends and
    2 receives once (60 + 8 bytes each way: 136 bytes)."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        spawn,
    )
    from apex_tpu_torch.transformer.testing.pipeline_workers import (
        staged_p2p_worker,
    )

    for out, staged in spawn(staged_p2p_worker, 2, timeout=120.0):
        assert out["cuda"][2:] == ["cuda", "cuda"]
        assert out["cpu"][2:] == ["cpu", "cpu"]
        for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
            np.testing.assert_array_equal(got, want)
        assert staged == {"collectives": 0, "bytes": 0, "p2p": 4,
                          "p2p_bytes": 136}


def test_o1_probe_dtypes_on_the_card_equal_the_cpu(gen):
    """O1's cast engine on CUDA tensors: every stage of the probe (the
    fused ops launch their kernels) has the CPU's dtype, and the bf16
    values agree within one bf16 rounding."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp.probe import o1_probe

    x = torch.randn(8, 16, generator=gen, device="cuda")
    w = torch.randn(16, 8, generator=gen, device="cuda")
    g = 1.0 + 0.1 * torch.randn(8, generator=gen, device="cuda")
    _kernels.reset_launch_counts()
    with amp.cast_ops(torch.bfloat16):
        card = o1_probe(x, w, g)
        cpu = o1_probe(x.cpu(), w.cpu(), g.cpu())
    counts = _kernels.launch_counts()
    assert counts["layer_norm_fwd"] >= 1 and counts["flash_fwd"] >= 1
    for k in cpu:
        assert card[k].dtype == cpu[k].dtype, k
    torch.testing.assert_close(card["matmul"].cpu().float(),
                               cpu["matmul"].float(), rtol=2e-2, atol=2e-2)


def test_amp_optimizer_skip_on_the_card(gen):
    """An overflowed step on the card leaves the parameters, the fp32
    masters and the Adam state bit-unchanged and halves the scale; a
    clean step launches the Adam kernel."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import fused_adam

    p = {"w": torch.randn(64, 32, generator=gen, device="cuda").half()}
    _, opt, _ = amp.initialize(None, fused_adam(lr=1e-2), "O2", torch.float16)
    state = opt.init(p)
    g = {"w": torch.randn(64, 32, generator=gen, device="cuda").half()}
    _kernels.reset_launch_counts()
    p, state, info = opt.step(g, state, p)
    assert not bool(info["skipped"])
    assert _kernels.launch_counts()["adam_update"] == 1
    before = (p["w"].clone(), state.master["w"].clone(),
              state.inner.exp_avg["w"].clone(), float(state.scaler.scale))
    bad = {"w": g["w"].clone()}
    bad["w"][3, 4] = float("inf")
    p, state, info = opt.step(bad, state, p)
    assert bool(info["skipped"]) and bool(info["found_inf"])
    assert torch.equal(p["w"], before[0])
    assert torch.equal(state.master["w"], before[1])
    assert torch.equal(state.inner.exp_avg["w"], before[2])
    assert float(state.scaler.scale) == before[3] / 2
    assert _kernels.launch_counts()["adam_update"] == 1


def test_normalization_modules_launch_the_norm_kernels(gen):
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm

    x = torch.randn(4, 8, 256, generator=gen, device="cuda",
                    requires_grad=True)
    _kernels.reset_launch_counts()
    for cls in (FusedLayerNorm, FusedRMSNorm):
        for me in (False, True):
            m = cls((8, 256), memory_efficient=me)
            m(x).sum().backward()
    c = _kernels.launch_counts()
    assert c["layer_norm_fwd"] >= 2 and c["layer_norm_bwd"] >= 2
    assert c["rms_norm_fwd"] >= 2 and c["rms_norm_bwd"] >= 2


def _dropout_gpt_run(granularity, steps=2):
    """A small GPT with hidden and attention dropout 0.1 trained two SGD
    steps on the card at ``granularity``: losses, gradients by step, the
    dropout generators' states after the steps, and the launch counts."""
    from apex_tpu_torch.transformer.layer import ShardAwareDropout

    _kernels.reset_launch_counts()
    cfg = TransformerConfig(num_layers=2, hidden_size=128,
                            num_attention_heads=2, vocab_size=256,
                            max_position_embeddings=64, hidden_dropout=0.1,
                            attention_dropout=0.1,
                            recompute_granularity=granularity)
    model = GPTModel(cfg, device="cuda", seed=0).train()
    toks = torch.randint(0, 256, (2, 64), generator=torch.Generator()
                         .manual_seed(1)).cuda()
    losses, grads = [], []
    for _ in range(steps):
        for p in model.parameters():
            p.grad = None
        loss = gpt_loss_fn(model(toks, labels=torch.roll(toks, -1, 1)))
        loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
        with torch.no_grad():
            for p in model.parameters():
                p.sub_(0.1 * p.grad)
    states = [m.generator.get_state() for m in model.modules()
              if isinstance(m, ShardAwareDropout)]
    return losses, grads, states, _kernels.launch_counts()


@pytest.mark.parametrize("granularity", ["selective", "full"])
def test_recompute_replays_dropout_on_the_card(gen, granularity):
    """Recompute with dropout 0.1 on the card: the losses, every gradient
    and the generators' states after two steps equal to no recompute's,
    bit for bit; "full" runs the LayerNorm forward kernel again in the
    backward."""
    ref = _dropout_gpt_run(None)
    got = _dropout_gpt_run(granularity)
    assert got[0] == ref[0]
    for a, b in zip(got[1], ref[1]):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
    if granularity == "full":
        assert got[3]["layer_norm_fwd"] > ref[3]["layer_norm_fwd"]


def test_moe_mlp_on_the_card_matches_the_cpu(gen):
    """``MoEMLP`` (8 experts, top-2) in fp32 on the card against the CPU
    from the same weights: output, aux loss and every gradient 1e-5
    relative in norm (fp32 products summed in another order)."""
    from apex_tpu_torch.transformer.moe import MoEMLP

    cfg = TransformerConfig(num_layers=1, hidden_size=64,
                            num_attention_heads=2, ffn_hidden_size=256,
                            compute_dtype=torch.float32)
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(2))
    out, weights = {}, None
    for dev in ("cpu", "cuda"):
        mod = MoEMLP(cfg, num_experts=8, top_k=2, expert_axis=None,
                     device=dev, seed=3)
        if weights is None:  # the CPU's draw, on both sides
            weights = mod.state_dict()
        mod.load_state_dict(weights)
        xt = x.to(dev, copy=True).requires_grad_()
        y, aux = mod(xt)
        (y.square().sum() + 0.01 * aux).backward()
        out[dev] = [t.detach().cpu() for t in (
            y, aux, xt.grad, mod.router.grad, mod.w_in.grad, mod.w_out.grad)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).norm() / b.norm()) < 1e-5


def test_fp8_dense_on_the_card_matches_the_cpu(gen):
    """``quantize`` bit-equal on the card and the CPU in both formats;
    ``fp8_dense`` (fp32 compute) output 1e-5 and gradients 1e-3 relative
    in norm (the gradient passes the e4m3 cast: a product rounded
    otherwise can land an element across an e4m3 midpoint, one e4m3 step
    off), its returned states equal."""
    from apex_tpu_torch.amp import fp8

    g = torch.Generator().manual_seed(4)
    x = torch.randn(256, 128, generator=g) * 5
    w = torch.randn(128, 64, generator=g) / 11
    for fmt in ("e4m3", "e5m2"):
        scale = torch.tensor(fp8.FP8_MAX[fmt]) / x.abs().max()
        assert torch.equal(
            fp8.quantize(x.cuda(), scale.cuda(), fmt).view(torch.uint8).cpu(),
            fp8.quantize(x, scale, fmt).view(torch.uint8))
    out = {}
    for dev in ("cuda", "cpu"):
        sx = fp8.update_fp8_state(fp8.init_fp8_state(4, dev), 20.0)
        sw = fp8.update_fp8_state(fp8.init_fp8_state(4, dev), 0.5)
        xt, wt = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        y, (nsx, nsw) = fp8.fp8_dense(xt, wt, sx, sw)
        y.square().sum().backward()
        out[dev] = ([t.detach().cpu() for t in (y, xt.grad, wt.grad)],
                    [t.cpu() for t in (nsx.amax_history, nsx.scale,
                                       nsw.amax_history, nsw.scale)])
    for a, b, tol in zip(out["cuda"][0], out["cpu"][0], (1e-5, 1e-3, 1e-3)):
        assert float((a - b).norm() / b.norm()) < tol
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][1],
                                                   out["cpu"][1]))


def test_quantize_blockwise_on_the_card_equals_the_cpu(gen):
    """``parallel.compress``'s block quantizer on the card: payload bits,
    scales and the dequantized values equal the CPU's in int8 and fp8,
    ragged tail, zero block and NaN block included."""
    from apex_tpu_torch.parallel import compress

    x = torch.randn(1000, generator=torch.Generator().manual_seed(5)) * 3
    x[:128] = 0.0
    x[300] = float("nan")
    for dtype in ("int8", "fp8"):
        cfg = compress.CompressionConfig(dtype=dtype)
        pc, sc = compress.quantize_blockwise(x.cuda(), cfg)
        p, s = compress.quantize_blockwise(x, cfg)
        assert torch.equal(pc.view(torch.uint8).cpu(), p.view(torch.uint8))
        sh = sc.cpu()
        assert bool(((sh == s) | (sh.isnan() & s.isnan())).all())
        # payload and scales both on the card, as the collectives hold them
        dc = compress.dequantize_blockwise(pc, sc, cfg).cpu()
        d = compress.dequantize_blockwise(p, s, cfg)
        assert bool(((dc == d) | (dc.isnan() & d.isnan())).all())


def test_param_remainders_round_trip_on_the_card(gen):
    """``store_param_remainders``' split and rebuild on the card: the bf16
    half is the master's truncation, and (bf16, remainder) rebuilds the
    fp32 master bit for bit."""
    from apex_tpu_torch.optimizers.distributed_fused_adam import (
        master_from_remainder,
        split_master,
    )

    m = torch.randn(100_003, device="cuda") * 7
    hi, lo = split_master(m)
    assert torch.equal(hi.view(torch.int16).to(torch.int32) & 0xFFFF,
                       (m.view(torch.int32) >> 16) & 0xFFFF)
    assert torch.equal(master_from_remainder(hi, lo).view(torch.int32),
                       m.view(torch.int32))


def test_beam_search_on_the_card_equals_the_cpu(gen):
    """fp32 beam search through the card's kernels (prefill and split-KV
    decode at b x k rows, the cache reordered by ``index_select``) gives
    the CPU's plain path's tokens from the same weights, and its scores
    within 1e-4 (two paths' fp32 sums in another order)."""
    from apex_tpu_torch.models import beam_search

    cfg = TransformerConfig(num_layers=2, hidden_size=128,
                            num_attention_heads=4, vocab_size=512,
                            max_position_embeddings=96, hidden_dropout=0.0,
                            attention_dropout=0.0,
                            compute_dtype=torch.float32)
    card = GPTModel(cfg, device="cuda", seed=0)
    cpu = GPTModel(cfg, device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    prompt = np.random.RandomState(0).randint(0, 512, (2, 24))
    _kernels.reset_launch_counts()
    tc, sc = beam_search(card, prompt, 16, 4)
    counts = _kernels.launch_counts()
    tp, sp = beam_search(cpu, prompt, 16, 4, device="cpu")
    assert counts["layer_norm_fwd"] > 0 and counts["flash_fwd"] > 0
    assert torch.equal(tc.cpu(), tp)
    assert float((sc.cpu() - sp).abs().max()) <= 1e-4


def test_memory_report_reads_a_known_allocation(gen):
    """``memory_report`` on the card: the arguments are what was allocated
    before, the output what the call left resident, the temporaries the
    peak above it, and the total the allocator's peak."""
    from apex_tpu_torch.monitor.xray import hbm

    x = torch.zeros(1 << 20, device="cuda")  # 4 MiB argument

    def fn(x):
        tmp = torch.ones(1 << 21, device="cuda")  # 8 MiB, freed inside
        return x + tmp[: x.numel()]  # 4 MiB output

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    r = hbm.memory_report(fn, x)
    assert r.argument_bytes == base
    assert r.output_bytes == 4 << 20
    assert r.temp_bytes == 8 << 20
    assert r.generated_code_bytes == 0
    assert r.total_bytes == base + (12 << 20)
    assert r.device_memory_bytes == torch.cuda.mem_get_info()[1]
    assert 0 < r.headroom_bytes < r.device_memory_bytes


def test_oom_guard_on_the_card(gen):
    """An allocation larger than the card raises
    ``torch.cuda.OutOfMemoryError`` through ``oom_guard``, which emits one
    ``kind="oom"`` record with the prediction's components first."""
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.xray import hbm

    mem = MemorySink()
    router = MetricRouter([mem])
    pred = hbm.predict_serving_memory(num_layers=12, num_kv_heads=12,
                                      head_dim=64, num_blocks=512,
                                      block_size=16)
    total = torch.cuda.mem_get_info()[1]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with hbm.oom_guard(router, 5, breakdown=pred, capacity_bytes=total):
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
    router.close()
    (rec,) = [r for r in mem.records if r["kind"] == "oom"]
    assert rec["step"] == 5 and rec["capacity_bytes"] == total
    assert rec["components"] == {"kv_pool": 512 * 589_824}
    assert rec["suggestions"][0]["knob"] == "num_blocks"
    torch.cuda.empty_cache()


RESILIENCE_TARGET = dict(vocab=50257, seq_len=1024, layers=2, hidden=768,
                         heads=12, micro_batch=8, global_batch=16)


def _gpt_training_on_the_card(**overrides):
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
        synthetic_corpus,
    )

    tr = build_gpt_training(GPTTargetConfig(**RESILIENCE_TARGET,
                                            **overrides), device="cuda")
    lm = LMDataset(IndexedTokenDataset(synthetic_corpus(50257)), 1024)
    return tr, tr.init_state(), tr.reshape_batch(*lm.batch(range(16)))


def _crcs(tree):
    from apex_tpu_torch.resilience import tree_fingerprint

    return [(leaf["path"], leaf["crc32"])
            for leaf in tree_fingerprint(tree)["leaves"]]


def test_gpt_step_twice_from_one_state_is_bit_equal(gen):
    """Two runs of one GPT step from one state give the same loss and the
    same bits in every leaf of the state (crc32): the step a bitwise
    replay rests on."""
    from apex_tpu_torch.utils.checkpoint import host_snapshot
    from apex_tpu_torch.utils.pytree import tree_copy_

    tr, state, (x, y) = _gpt_training_on_the_card()
    start = host_snapshot(state.as_tuple())
    state, loss1, _, _ = tr.train_step(state, x, y)
    after1 = _crcs(state.as_tuple())
    tree_copy_(state.as_tuple(), start)
    assert _crcs(state.as_tuple()) == _crcs(start)
    state, loss2, _, _ = tr.train_step(state, x, y)
    assert loss1 == loss2
    assert _crcs(state.as_tuple()) == after1


def test_checkpoint_round_trip_on_the_card_keeps_every_crc(gen, tmp_path):
    """A verified save and restore of the GPT state on the card: the
    manifest's per-leaf crc32s are the live state's, and the restored
    leaves (on the card) carry the same."""
    from apex_tpu_torch.resilience import (
        load_checkpoint_verified,
        read_manifest,
        save_checkpoint_verified,
    )

    tr, state, (x, y) = _gpt_training_on_the_card()
    state, *_ = tr.train_step(state, x, y)
    want = _crcs(state.as_tuple())
    path = save_checkpoint_verified(str(tmp_path), 1, state.as_tuple())
    manifest = read_manifest(path)
    assert [(leaf["path"], leaf["crc32"])
            for leaf in manifest["fingerprint"]["leaves"]] == want
    state, *_ = tr.train_step(state, x, y)
    assert _crcs(state.as_tuple()) != want
    step, restored = load_checkpoint_verified(str(tmp_path),
                                              target=state.as_tuple())
    assert step == 1 and _crcs(restored) == want
    assert restored[0]["embedding.word_embeddings.embedding"].is_cuda


def test_async_save_before_an_in_place_step_writes_the_pre_step_bytes(
        gen, tmp_path):
    """``AsyncCheckpointWriter.save`` returns with its host copy complete:
    the Adam step issued right after it updates the parameters in place,
    and the file still holds the state before the step."""
    from apex_tpu_torch.utils.checkpoint import (
        AsyncCheckpointWriter,
        load_checkpoint,
    )

    tr, state, (x, y) = _gpt_training_on_the_card()
    state, *_ = tr.train_step(state, x, y)
    before = _crcs(state.as_tuple())
    writer = AsyncCheckpointWriter()
    writer.save(str(tmp_path), 1, state.as_tuple())
    state, *_ = tr.train_step(state, x, y)
    writer.close()
    assert _crcs(state.as_tuple()) != before
    saved = load_checkpoint(str(tmp_path), 1, target=state.as_tuple())
    assert _crcs(saved) == before


def test_layout_checkpoint_restores_through_the_resharder_by_every_crc(
        gen, tmp_path):
    """The GPT state under ZeRO, saved through ``elastic.layout`` (the
    multi-rank path's gather, at a world of one the whole tree) and the
    manifest's topology block, restores through ``restore_resharded``
    onto the card with every leaf's crc32 the manifest's."""
    from apex_tpu_torch.resilience import read_manifest
    from apex_tpu_torch.resilience.elastic import restore_resharded
    from apex_tpu_torch.resilience.elastic.layout import StateLayout
    from apex_tpu_torch.resilience.elastic.topology import topology_block
    from apex_tpu_torch.resilience.integrity import write_manifest
    from apex_tpu_torch.utils.checkpoint import write_host_tree

    tr, state, (x, y) = _gpt_training_on_the_card(zero=True)
    state, *_ = tr.train_step(state, x, y)
    tree = state.as_tuple()
    want = _crcs(tree)
    layout = StateLayout(tree)
    host = layout.gather(tree)
    path = write_host_tree(str(tmp_path), 1, host)
    write_manifest(path, host, topology=topology_block(tree, layout=layout))
    manifest = read_manifest(path)
    assert [(leaf["path"], leaf["crc32"])
            for leaf in manifest["fingerprint"]["leaves"]] == want
    assert sum(leaf["zero_shard_axis"] == "dp"
               for leaf in manifest["topology"]["leaves"]) == 3
    state, *_ = tr.train_step(state, x, y)
    step, restored = restore_resharded(str(tmp_path), state.as_tuple())
    assert step == 1 and _crcs(restored) == want
    assert restored[1].master_shard.is_cuda


def test_zero_regroup_flat_on_the_card_equals_the_cpu(gen):
    from apex_tpu_torch.optimizers import zero_regroup_flat

    flat = torch.zeros(65538, device="cuda")
    flat[:65000] = torch.randn(65000, generator=gen, device="cuda")
    for n in (65536, 65538, 65540):
        got = zero_regroup_flat(flat, n)
        assert got.is_cuda and torch.equal(
            got.cpu(), zero_regroup_flat(flat.cpu(), n))
    with pytest.raises(ValueError, match="nonzero"):
        zero_regroup_flat(flat, 64000)


def test_native_library_and_token_file_batches_on_the_card_host(gen):
    """The native host library builds and loads on the card's host, and a
    token file's batches through ``LMDataset`` (the library's gather,
    below and above its threading threshold) equal numpy's fancy index
    of the same rows; they reach the card as the step's input unchanged."""
    from apex_tpu_torch import _native
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.resilience.replay import synthetic_corpus

    _native.library()
    lm = LMDataset(IndexedTokenDataset(synthetic_corpus(50257, 2_200_000)),
                   2048)
    tokens = np.asarray(lm.ds.tokens)
    for ids in (range(4), range(1024)):  # 33 kB; 8.4 MB, threaded
        x, y = lm.batch(ids)
        rows = tokens[np.asarray(lm.offsets[list(ids)])[:, None]
                      + np.arange(2049)]
        assert np.array_equal(x, rows[:, :-1])
        assert np.array_equal(y, rows[:, 1:])
        assert torch.equal(torch.as_tensor(x).cuda().cpu(),
                           torch.as_tensor(rows[:, :-1]))
    assert np.array_equal(np.sort(lm.epoch_permutation(3)),
                          np.arange(len(lm)))


def test_llama_example_resume_on_the_card_is_bit_equal(gen, tmp_path):
    """The Llama example at TinyLlama's width (2 layers): 2 steps saved and
    2 resumed give the 4 uninterrupted steps' losses and every leaf's
    crc32 of the parameters and the ZeRO state."""
    from apex_tpu_torch.examples.llama import finetune_llama

    def run(argv):
        model = GPTModel(tinyllama_1_1b_config(num_layers=2), device="cuda",
                         seed=0)
        recs = finetune_llama.main(["--batch", "2", "--seq-len", "512",
                                    *argv], model=model)
        return ({r["step"]: r["loss"] for r in recs},
                _crcs(recs.finetune.checkpoint_state()))

    whole, want = run(["--steps", "4"])
    first, _ = run(["--steps", "2", "--save", str(tmp_path)])
    rest, got = run(["--steps", "2", "--save", str(tmp_path)])
    assert {**first, **rest} == whole
    assert got == want


def _grads_close(card, cpu, rtol, atol):
    """Every parameter gradient of ``card`` against ``cpu``'s."""
    named = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        torch.testing.assert_close(p.grad.cpu(), named[name].grad,
                                   rtol=rtol, atol=atol, msg=name)


@pytest.mark.parametrize("encdec", [False, True])
def test_multihead_attn_through_the_kernels_matches_the_plain_path(
        gen, encdec):
    """The contrib MHA (norm-add, biases, key padding with a fully padded
    row) in fp32 on the card, through LayerNorm #1/#2 and flash #5/#6/#7,
    against the same module's plain path on the CPU from the same
    weights: output, input and parameter gradients to 1e-4 (fp32 sums
    through a LayerNorm and attention in another order)."""
    from apex_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn

    cls = EncdecMultiheadAttn if encdec else SelfMultiheadAttn
    card = cls(256, 4, bias=True, include_norm_add=True, device="cuda")
    cpu = cls(256, 4, bias=True, include_norm_add=True, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    sq, sk, b = 64, 48 if encdec else 64, 3
    q = torch.randn(sq, b, 256, generator=gen, device="cuda")
    kv = torch.randn(sk, b, 256, generator=gen, device="cuda")
    kpm = torch.zeros(b, sk, dtype=torch.bool, device="cuda")
    kpm[1] = True
    kpm[2, -7:] = True
    ct = torch.randn(sq, b, 256, generator=gen, device="cuda")
    names = ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
             "flash_bwd_dq", "flash_bwd_dkv")
    before = _kernels.launch_counts()
    outs = []
    for mod, dev in ((card, "cuda"), (cpu, "cpu")):
        xs = [t.to(dev).detach().requires_grad_(True)
              for t in ((q, kv) if encdec else (q,))]
        y = mod(*xs, key_padding_mask=kpm.to(dev))
        y.backward(ct.to(dev))
        outs.append((y, [x.grad for x in xs]))
    after = _kernels.launch_counts()
    assert all(after[n] > before[n] for n in names)
    (yg, gg), (yc, gc) = outs
    torch.testing.assert_close(yg.cpu(), yc.detach(), rtol=1e-4, atol=1e-4)
    for a, c in zip(gg, gc):
        torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-4)
    _grads_close(card, cpu, 1e-4, 1e-4)


def test_transducer_loss_on_the_card_matches_the_cpu(gen):
    """Loss and gradient of the wavefront at unequal lengths, card against
    CPU, 1e-5 relative (the same fp32 recursion; the log-softmax summed
    in another order)."""
    from apex_tpu_torch.contrib import transducer_loss

    b, t, u, v = 4, 64, 16, 128
    x = torch.randn(b, t, u, v, generator=gen, device="cuda")
    label = torch.randint(1, v, (b, u - 1), generator=gen, device="cuda")
    f_len = torch.tensor([64, 40, 7, 1], device="cuda")
    y_len = torch.tensor([15, 9, 0, 4], device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).detach().requires_grad_(True)
        loss = transducer_loss(xd, label.to(dev), f_len.to(dev),
                               y_len.to(dev), 0)
        loss.sum().backward()
        grads.append((loss.detach(), xd.grad))
    (lg, gg), (lc, gc) = grads
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gg.cpu(), gc, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pattern", ["m4n2_1d", "m4n2_2d_best"])
def test_asp_masks_on_the_card_equal_the_cpu(gen, pattern):
    """ASP's masks of torch-layout and flax-layout weights, on the card
    and on the CPU: equal, and exactly 2:4."""
    from apex_tpu_torch.contrib.sparsity import compute_sparse_masks

    params = {"fc.weight": torch.randn(96, 128, generator=gen,
                                       device="cuda"),
              "conv.weight": torch.randn(32, 64, 3, 3, generator=gen,
                                         device="cuda"),
              "mlp.kernel": torch.randn(128, 64, generator=gen,
                                        device="cuda")}
    card = compute_sparse_masks(params, pattern)
    cpu = compute_sparse_masks({k: v.cpu() for k, v in params.items()},
                               pattern)
    for name, m in card.items():
        assert m.is_cuda and torch.equal(m.cpu(), cpu[name]), name
    assert bool((card["fc.weight"].reshape(-1, 4).sum(1) == 2).all())
