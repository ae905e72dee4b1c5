"""Context parallelism: ring attention and Ulysses attention over the cp
group (counterpart of apex_tpu/parallel/ring_attention.py).

Each rank of the cp group (``parallel_state``) holds one chunk of every
sequence; both strategies compute exact attention over the whole
sequence from those chunks:

- **Ring** (:func:`ring_attention`): every rank keeps its queries, and
  the K/V chunks (with their key-padding rows) travel the ring of the cp
  group, one rank on per step, over ``p2p.permute`` along
  ``p2p.ring_edges``. Step 0 uses the resident chunk, so a pass makes
  P - 1 rotations. Each visiting chunk streams through an online softmax
  in ``block_size`` slices (:func:`_online_chunk_update`: fp32
  accumulators, scores of the operands' values in fp32, P rounded to
  V's dtype before P.V, as the JAX function keeps bf16 operands with
  fp32 accumulation; a bf16 product is exact in fp32). The backward is a
  torch.autograd.Function (:class:`_RingFn`), JAX's custom VJP: a second
  ring pass recomputes P from the saved log-sum-exp, the dK/dV
  accumulators travel with their chunks, and one homing rotation brings
  them to their owners. Autograd through the forward loop would keep
  every rotated chunk.
- **Ulysses** (:func:`ulysses_attention`): an all-to-all turns
  sequence-sharded q, k, v into head-sharded full sequences, the port's
  ``flash_attention`` runs (the flash kernels on CUDA tensors), and an
  all-to-all turns the output back; the key-padding mask is all-gathered
  over cp. The all-to-alls are autograd Functions whose backward is the
  inverse all-to-all.
- :func:`cp_decode_attention` merges one decode token's per-rank partial
  softmax statistics with one all-reduce of the maximum and two sums.

Causal masks, sliding windows and the chunk skipping come from GLOBAL
positions (:func:`_positions`), contiguous or zigzag (:func:`zigzag_shard`
puts sequence pieces r and 2P-1-r on rank r, which evens the causal work
out). Whether a visiting chunk can reach the local queries depends only
on ranks and the step, so it is decided on the host and a chunk that
cannot is skipped. A visiting chunk whose keys are all padded is skipped
too: that takes the mask's ``any()`` to the host, one synchronisation a
visiting chunk when a key-padding mask is given (computing it under the
mask instead gives the same values: its P is exactly zero).

The JAX module's ``xlax.scaled``, ``pvary_params`` and ``pcast_varying``
keep its communication ledger and the shard_map type system's varying
axes; they have no meaning for torch and are left out. The ring's chunk
update is plain torch, as JAX's is plain jnp (no Pallas kernel); each
call runs inside a ``torch.profiler`` span named :data:`CHUNK_SPAN`,
which a profile reads to find the ring's share of a step.
"""

import math
from typing import Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.pipeline import p2p

__all__ = ["CHUNK_SPAN", "cp_decode_attention", "ring_attention",
           "ulysses_attention", "zigzag_shard", "zigzag_unshard"]

_NEG_INF = -1e30
CHUNK_SPAN = "cp_ring_chunk_update"


def _axis(axis_name: str):
    """(group, size, rank) of the mesh axis ``axis_name``."""
    group = ps.get_group(axis_name)
    rank = 0 if group is None else dist.get_rank(group)
    return group, ps.group_size(group), rank


def _rotate(tensors, axis_name: str):
    """Every tensor one rank on along the ring (rank r -> r+1 mod P)."""
    n = ps.group_size(ps.get_group(axis_name))
    return [p2p.permute(t, p2p.ring_edges(n), axis_name) for t in tensors]


def _positions(src: int, num_ranks: int, s_local: int, zigzag: bool,
               device=None) -> torch.Tensor:
    """(s_local,) GLOBAL sequence positions of rank ``src``'s chunk:
    rows ``[src s, (src + 1) s)`` contiguous, or the zigzag pieces
    ``(src, 2P - 1 - src)`` of half a chunk each."""
    if not zigzag:
        return src * s_local + torch.arange(s_local, device=device)
    half = s_local // 2
    base = torch.arange(half, device=device)
    return torch.cat([src * half + base,
                      (2 * num_ranks - 1 - src) * half + base])


def _band_keep(rows, cols, causal: bool, window=None):
    """Keep-mask (len(rows), len(cols)) from GLOBAL positions, or None when
    nothing is masked."""
    if not causal and window is None:
        return None
    r, c = rows[:, None], cols[None, :]
    keep = torch.ones((len(rows), len(cols)), dtype=torch.bool,
                      device=rows.device)
    if causal:
        keep = keep & (c <= r)
    if window is not None:
        keep = keep & (c > r - window)
    return keep


def _chunk_contributes(rows, cols, causal: bool, window,
                       pieces: int = 1) -> bool:
    """Whether the visiting chunk's band meets the local queries, from
    host positions. ``pieces`` is the number of contiguous position runs
    a chunk holds (1 contiguous, 2 zigzag); the bounds are taken per pair
    of pieces, since one min/max over a zigzag chunk would span nearly
    the whole sequence and never skip."""
    if window is None and not causal:
        return True
    r, c = rows.reshape(pieces, -1), cols.reshape(pieces, -1)
    rmin, rmax = r[:, 0], r[:, -1]
    cmin, cmax = c[:, 0], c[:, -1]
    ok = torch.ones((pieces, pieces), dtype=torch.bool)
    if causal:
        ok = ok & (cmin[None, :] <= rmax[:, None])
    if window is not None:
        ok = ok & (cmax[None, :] > rmin[:, None] - window)
    return bool(ok.any())


def _chunk_block_size(s_local: int, block_size: int) -> int:
    bk = min(block_size, s_local)
    while s_local % bk != 0:
        bk -= 1
    return bk


def _allow_mask(rows, cols_b, causal, window, keep_b):
    """The (sq, bk) band mask and the (b, bk) key-validity mask,
    broadcastable to the grouped score shape (b, G, g, sq, bk); None when
    unmasked."""
    band = _band_keep(rows, cols_b, causal, window)
    allow = None if band is None else band[None, None, None]
    if keep_b is not None:
        kb = keep_b[:, None, None, None, :]
        allow = kb if allow is None else allow & kb
    return allow


def _online_chunk_update(state, q, kc, vc, scale, rows, cols, causal,
                         block_size, window=None, keep=None):
    """Streams one visiting K/V chunk through the online softmax in
    ``block_size`` slices. ``state`` = (acc, m, l) so far, fp32; ``q`` is
    GQA-grouped (b, h_kv, g, sq, d) against ``kc``/``vc`` (b, h_kv, s,
    d); ``rows``/``cols`` the global positions of the queries and the
    visiting keys; ``keep`` the chunk's (b, s) key-validity mask (False =
    padded out)."""
    acc, m, l = state
    s_kv = kc.shape[-2]
    bk = _chunk_block_size(s_kv, block_size)
    qf = q.float()
    with torch.profiler.record_function(CHUNK_SPAN):
        for lo in range(0, s_kv, bk):
            kb = kc[:, :, None, lo:lo + bk].float()
            vb = vc[:, :, None, lo:lo + bk]
            s = torch.matmul(qf, kb.transpose(-1, -2)) * scale
            allow = _allow_mask(
                rows, cols[lo:lo + bk], causal, window,
                None if keep is None else keep[:, lo:lo + bk])
            if allow is not None:
                s = s.masked_fill(~allow, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            if allow is not None:
                p = p.masked_fill(~allow, 0.0)  # exp(-inf - (-inf)) guard
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(vb.dtype).float(), vb.float())
            m = m_new
    return acc, m, l


def _keep_from_bias(kbias):
    """(b, s) float bias (0 valid, _NEG_INF padded) -> bool validity."""
    return None if kbias is None else kbias > 0.5 * _NEG_INF


def _visits(rank: int, num_ranks: int, sq: int, zigzag: bool):
    """The ring's steps t = 1 .. P-1 with the source rank of the chunk
    that visits at each and its host positions."""
    for t in range(1, num_ranks):
        src = (rank - t) % num_ranks
        yield t, _positions(src, num_ranks, sq, zigzag)


def _contributes(rows_h, cols_h, causal, window, zigzag, keep) -> bool:
    """Skip rule of a visiting chunk: out of band, or all keys padded."""
    ok = _chunk_contributes(rows_h, cols_h, causal, window,
                            2 if zigzag else 1)
    if ok and keep is not None:
        ok = bool(keep.any())
    return ok


def _ring_fwd(q, k, v, kbias, axis_name, causal, scale, block_size, window,
              zigzag):
    """(o, lse) of the ring forward; lse is (b, h_kv, g, sq) fp32."""
    _, num_ranks, rank = _axis(axis_name)
    b, h, sq, d = q.shape
    h_kv = k.shape[1]
    q5 = q.reshape(b, h_kv, h // h_kv, sq, d)
    rows_h = _positions(rank, num_ranks, sq, zigzag)
    rows = rows_h.to(q.device)
    state = (torch.zeros(q5.shape, dtype=torch.float32, device=q.device),
             torch.full(q5.shape[:-1], _NEG_INF, dtype=torch.float32,
                        device=q.device),
             torch.zeros(q5.shape[:-1], dtype=torch.float32,
                         device=q.device))
    # step 0 on the resident chunk: no rotation
    state = _online_chunk_update(state, q5, k, v, scale, rows, rows, causal,
                                 block_size, window, _keep_from_bias(kbias))
    chunk = [k, v] + ([] if kbias is None else [kbias])
    for _, cols_h in _visits(rank, num_ranks, sq, zigzag):
        chunk = _rotate(chunk, axis_name)
        keep = _keep_from_bias(chunk[2]) if kbias is not None else None
        if _contributes(rows_h, cols_h, causal, window, zigzag, keep):
            state = _online_chunk_update(
                state, q5, chunk[0], chunk[1], scale, rows,
                cols_h.to(q.device), causal, block_size, window, keep)
    acc, m, l = state
    l = l.clamp_min(1e-30)
    o = (acc / l[..., None]).reshape(b, h, sq, d).to(q.dtype)
    return o, m + torch.log(l)


def _chunk_bwd_update(q, do, delta, lse, kc, vc, dkc, dvc, dq, scale, rows,
                      cols, causal, block_size, window=None, keep=None):
    """One visiting chunk's gradient contributions, blockwise, grouped as
    :func:`_online_chunk_update`; ``dkc``, ``dvc`` (b, h_kv, s, d) and
    ``dq`` accumulate in fp32 (``dkc``/``dvc`` in place)."""
    s_kv = kc.shape[-2]
    bk = _chunk_block_size(s_kv, block_size)
    qf, dof = q.float(), do.float()
    with torch.profiler.record_function(CHUNK_SPAN):
        for lo in range(0, s_kv, bk):
            kb = kc[:, :, None, lo:lo + bk]
            kbf = kb.float()
            vb = vc[:, :, None, lo:lo + bk].float()
            s = torch.matmul(qf, kbf.transpose(-1, -2)) * scale
            allow = _allow_mask(
                rows, cols[lo:lo + bk], causal, window,
                None if keep is None else keep[:, lo:lo + bk])
            if allow is not None:
                s = s.masked_fill(~allow, _NEG_INF)
            p = torch.exp(s - lse[..., None])
            if allow is not None:
                p = p.masked_fill(~allow, 0.0)
            # (b, G, g, bk, d) summed over the query group g
            dv_b = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                                dof).sum(dim=2)
            dp = torch.matmul(dof, vb.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            ds_lo = ds.to(kb.dtype).float()
            dq = dq + torch.matmul(ds_lo, kbf)
            dk_b = torch.matmul(ds_lo.transpose(-1, -2), qf).sum(dim=2)
            dkc[:, :, lo:lo + bk] += dk_b
            dvc[:, :, lo:lo + bk] += dv_b
    return dkc, dvc, dq


def _ring_bwd(q, k, v, kbias, o, lse, do, axis_name, causal, scale,
              block_size, window, zigzag):
    _, num_ranks, rank = _axis(axis_name)
    b, h, sq, d = q.shape
    h_kv = k.shape[1]
    shape5 = (b, h_kv, h // h_kv, sq, d)
    q5, do5, o5 = q.reshape(shape5), do.reshape(shape5), o.reshape(shape5)
    rows_h = _positions(rank, num_ranks, sq, zigzag)
    rows = rows_h.to(q.device)
    delta = (do5.float() * o5.float()).sum(dim=-1)  # (b, h_kv, g, sq)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dq = torch.zeros(shape5, dtype=torch.float32, device=q.device)
    # step 0 on the resident chunk
    dk, dv, dq = _chunk_bwd_update(q5, do5, delta, lse, k, v, dk, dv, dq,
                                   scale, rows, rows, causal, block_size,
                                   window, _keep_from_bias(kbias))
    chunk = [k, v] + ([] if kbias is None else [kbias])
    for _, cols_h in _visits(rank, num_ranks, sq, zigzag):
        # dK/dV ride the ring with their chunks
        *chunk, dk, dv = _rotate(chunk + [dk, dv], axis_name)
        keep = _keep_from_bias(chunk[2]) if kbias is not None else None
        if _contributes(rows_h, cols_h, causal, window, zigzag, keep):
            dk, dv, dq = _chunk_bwd_update(
                q5, do5, delta, lse, chunk[0], chunk[1], dk, dv, dq, scale,
                rows, cols_h.to(q.device), causal, block_size, window, keep)
    if num_ranks > 1:
        # after P-1 rotations the accumulators sit one rank short of their
        # owners
        dk, dv = _rotate([dk, dv], axis_name)
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _RingFn(torch.autograd.Function):
    """The ring forward; its backward is the second ring pass."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, axis_name, causal, scale, block_size,
                window, zigzag):
        cfg = (axis_name, causal, scale, block_size, window, zigzag)
        o, lse = _ring_fwd(q, k, v, kbias, *cfg)
        ctx.save_for_backward(q, k, v, kbias, o, lse)
        ctx.cfg = cfg
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kbias, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd(q, k, v, kbias, o, lse, do.contiguous(),
                               *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None, None


def ring_attention(q, k, v, axis_name: str = "cp", causal: bool = False,
                   scale: Optional[float] = None, block_size: int = 512,
                   window: Optional[int] = None, zigzag: bool = False,
                   key_padding_mask=None):
    """Exact sequence-sharded attention over the ``axis_name`` ring.

    q: (batch, heads, seq_local, head_dim); k, v: (batch, kv_heads,
    seq_local, head_dim) with heads % kv_heads == 0 (the ring rotates the
    grouped K/V): this rank's chunk of a sequence sharded over the group.
    ``block_size`` bounds the keys processed at once. ``window`` (causal
    only) bands attention in global positions. ``key_padding_mask``:
    (batch, seq_local) bool, True = padded-out key, this rank's shard of
    the global mask (zigzag-reordered when ``zigzag``); it travels with
    its chunk. ``zigzag``: inputs prepared with :func:`zigzag_shard`,
    outputs restored with :func:`zigzag_unshard`. Returns the local
    output chunk; the gradients come from a second ring pass."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (mistral semantics)")
    if zigzag and q.shape[-2] % 2:
        raise ValueError("zigzag needs an even per-rank sequence length")
    if q.shape[1] % k.shape[1]:
        raise ValueError(
            f"heads ({q.shape[1]}) not divisible by kv_heads ({k.shape[1]})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kbias = None
    if key_padding_mask is not None:
        if tuple(key_padding_mask.shape) != (q.shape[0], k.shape[2]):
            raise ValueError(
                f"key_padding_mask {tuple(key_padding_mask.shape)} != "
                f"(batch, seq_local) = {(q.shape[0], k.shape[2])}")
        # a float carrier (0 valid, _NEG_INF padded), as JAX's
        kbias = torch.where(key_padding_mask.bool(), _NEG_INF, 0.0).to(
            device=k.device, dtype=torch.float32)
    return _RingFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                         kbias, axis_name, causal, scale, block_size, window,
                         zigzag)


def _zigzag_index(s: int, num_ranks: int) -> torch.Tensor:
    """The permutation that puts pieces (r, 2P-1-r) together for each r:
    the one source of the zigzag order for shard and unshard."""
    if s % (2 * num_ranks):
        raise ValueError(
            f"sequence ({s}) not divisible by 2*cp ({2 * num_ranks})")
    half = s // (2 * num_ranks)
    base = torch.arange(half)
    return torch.cat([torch.cat([r * half + base,
                                 (2 * num_ranks - 1 - r) * half + base])
                      for r in range(num_ranks)])


def zigzag_shard(x, num_ranks: int, axis: int = -2):
    """Reorders a GLOBAL sequence axis so that a contiguous cp shard hands
    rank r the zigzag pieces (r, 2P-1-r); invert with
    :func:`zigzag_unshard`."""
    idx = _zigzag_index(x.shape[axis], num_ranks).to(x.device)
    return x.index_select(axis, idx)


def zigzag_unshard(x, num_ranks: int, axis: int = -2):
    """Inverse of :func:`zigzag_shard` on the same global axis."""
    inv = torch.argsort(_zigzag_index(x.shape[axis], num_ranks))
    return x.index_select(axis, inv.to(x.device))


def _seq_to_heads(x, axis_name):
    """(b, h, s_local, d) -> (b, h/P, P s_local, d): this rank's heads
    over the whole sequence (JAX's tiled all_to_all, split heads, concat
    sequence)."""
    group, n, _ = _axis(axis_name)
    if group is None:
        return x
    b, h, s, d = x.shape
    chunks = x.reshape(b, n, h // n, s, d).transpose(0, 1)
    got = ps.all_to_all(chunks, group)  # got[i]: my heads, rank i's rows
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x, axis_name):
    """The inverse: (b, h/P, P s_local, d) -> (b, h, s_local, d)."""
    group, n, _ = _axis(axis_name)
    if group is None:
        return x
    b, hl, seq, d = x.shape
    chunks = x.reshape(b, hl, n, seq // n, d).permute(2, 0, 1, 3, 4)
    got = ps.all_to_all(chunks, group)  # got[i]: rank i's heads, my rows
    return got.transpose(0, 1).reshape(b, n * hl, seq // n, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _seq_to_heads(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.axis_name), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _heads_to_seq(x, axis_name)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.axis_name), None


def ulysses_attention(q, k, v, axis_name: str = "cp", causal: bool = False,
                      scale: Optional[float] = None,
                      window: Optional[int] = None, attn_fn=None,
                      key_padding_mask=None):
    """DeepSpeed-Ulysses attention: all-to-all from sequence-sharded to
    head-sharded, full-sequence local attention, all-to-all back.

    q: (batch, heads, seq_local, head_dim); k, v may carry fewer (GQA)
    heads; both counts must divide by the cp size (each rank keeps whole
    query groups). ``attn_fn(q, k, v, causal=..., scale=..., [window=...,
    key_padding_mask=...])`` defaults to the port's ``flash_attention``.
    ``key_padding_mask``: (batch, seq_local) bool local shard, True =
    padded; it is all-gathered over cp. The JAX function asserts the
    divisibility; here it raises ``ValueError`` with the same text."""
    if attn_fn is None:
        attn_fn = flash_attention
    group, num_ranks, _ = _axis(axis_name)
    if q.shape[1] % num_ranks:
        raise ValueError(
            f"heads ({q.shape[1]}) not divisible by cp size ({num_ranks}); "
            "use ring_attention for head counts below the cp degree")
    if k.shape[1] % num_ranks:
        raise ValueError(
            f"kv_heads ({k.shape[1]}) not divisible by cp size "
            f"({num_ranks}); use ring_attention for grouped-KV head counts "
            "below the cp degree")
    qh, kh, vh = (_SeqToHeads.apply(t, axis_name) for t in (q, k, v))
    kw = {} if window is None else {"window": window}
    if key_padding_mask is not None:
        kw["key_padding_mask"] = ps.all_gather(
            key_padding_mask.to(torch.uint8), group, dim=1).bool()
    oh = attn_fn(qh, kh, vh, causal=causal, scale=scale, **kw)
    return _HeadsToSeq.apply(oh, axis_name)


def cp_decode_attention(q, k, v, padded, axis_name: str, scale=None):
    """One decode token's attention over a context-parallel KV cache.

    Each rank holds a shard of the cache; the query is the same on every
    rank of ``axis_name``. The per-rank partial softmax statistics merge
    by the log-sum-exp identity: one all-reduce of the maximum, two sums.

    q: (b, h, 1, d); k, v: (b, h_kv, L_local, d), this rank's shard (GQA:
    query head ``q_head // g`` reads kv head ``q_head // g``); padded: (b,
    L_local) bool, True = the slot holds no valid key. Returns (b, h, 1,
    d), the same on every rank. Computed in fp32 in plain torch, as JAX's
    is jnp."""
    b, h, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"cp_decode_attention is single-token (sq={sq})")
    h_kv = k.shape[1]
    if h % h_kv:
        raise ValueError(f"GQA heads {h} not a multiple of kv heads {h_kv}")
    g = h // h_kv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, h_kv, g, d)
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale  # (b,G,g,L)
    pad = padded.bool()[:, None, None, :]
    s = s.masked_fill(pad, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(pad, 0.0)  # all-padded shard: p = 0
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float())  # (b, G, g, d)
    group = ps.get_group(axis_name)
    m_g = ps.all_reduce(m, group, op="max")
    alpha = torch.exp(m - m_g)  # -> 0 for shards far below the maximum
    l_g = ps.all_reduce(l * alpha, group)
    o_g = ps.all_reduce(o * alpha, group) / l_g
    return o_g.reshape(b, h, 1, d).to(q.dtype)
