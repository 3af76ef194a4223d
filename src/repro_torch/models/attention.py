"""GQA, MLA and cross-attention over slot caches and page pools (port of
`repro.models.attention`).

Reads of a resident cache go through
`kernels.flash_attention.ops.attend_partial`, reads of a page pool through
`kernels.paged_attention.ops.paged_attend_partial`: on CUDA tensors the
hand-written Hopper kernels, on CPU tensors their plain PyTorch versions.

KV caches are dicts of tensors:
  {"k": (B, C, Hkv, Dk), "v": (B, C, Hkv, Dv), "slot_pos": (B, C) int32}
`slot_pos` holds the absolute position stored in each slot (-1 = empty);
masking is always against `slot_pos`, so ring caches (sliding window)
stay correct as long as C >= window + the largest written segment.

Paged pools have the same leaves with a page axis:
  {"k": (P, ps, Hkv, Dk), "v": (P, ps, Hkv, Dv), "slot_pos": (P, ps)}
An int8 cache (`quantized=True`, `kv_dtype="int8"`) stores int8 K/V and
adds "k_scale" / "v_scale", f32 of shape (B, C, Hkv) or (P, ps, Hkv):
one symmetric scale per (row, head), the reference's layout. The kernels
read the int8 rows and scales in place; the plain versions read the
reference's dequantized bf16 view (`dequantize_cache`).
A request owns an ordered list of pages; a `page_view` (B, n_view) int32
block table names them, logical column c of request b being row c % ps
of page page_view[b, c // ps]. Unmapped view entries point at a NULL
page whose slot_pos stays -1.

Unlike the reference, whose arrays are immutable, the port writes new
KV rows IN PLACE: into the resident slot pool through `slot_idx`, into a
page pool through the block table, or into a plain batch cache (drafting
snapshots and single-request caches are owned by their caller and never
reused after a step). Reads of a pool go through `slot_idx` or the block
table inside the kernel, without a gathered copy.

MLA (`mla_attention`, DeepSeek-V3's absorbed form) caches only
c_kv ++ k_pe per token, as the reference: "k" is (B, C, 1, kv_lora +
rope) and "v" (B, C, 1, kv_lora), one KV head that every query head
reads, so its reads go to the kernels' latent form (Dk != Dv). Both
leaves are written from the same c_kv, so V is K's first kv_lora
columns: MLA reads pass `k[..., :kv_lora]` as v (`cache_partial`'s
`v_in_k`), which the latent kernel reads out of K's tile.

Cross-attention (`cross_attention`: a VLM's image layers, an
encoder-decoder's decoder) attends non-causally over frontend or encoder
states. Given them (`kv_src`), it projects K/V, attends over those fresh
projections and writes them into its cross cache (columns 0..S-1,
slot_pos = arange(S)); without them it reads the cross cache in place
(through `slot_idx` on a slot pool), which stays slot-indexed on a paged
cache too and is never int8. Its reads and the encoder's bidirectional
self-attention go to kernel 1 with `causal=False`.

Every self-contained read (a cache-less forward's self-attention, MLA's
too, the encoder's, and cross-attention over given states) goes through
`blocked_attention`, which under autograd takes the flash-attention
kernel's differentiable form (`fa.attention`): training has a gradient
through kernel 1's forward on the card. Cache reads have none, and
their kernels refuse an input that asks for one.
"""
from __future__ import annotations

import torch

from repro_torch.config import MLAConfig, ModelConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models.layers import apply_rope, dense_init, rms_norm_headwise
from repro_torch.models.quantize import _promote, qdot

NEG_INF = -1e30
RING_MARGIN = 128  # extra ring slots beyond the window (max verify segment)


# =====================================================================
# blocked online-softmax attention primitive
# =====================================================================

def attend_partial(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                   extra_mask=None, block=None, slot_idx=None, k_scale=None,
                   v_scale=None):
    """Online-softmax partials (m, l, acc) — the kernel's wrapper.

    q: (B, T, Hkv, G, Dk); k: (P, S, Hkv, Dk); v: (P, S, Hkv, Dv);
    q_pos: (B, T); k_pos: (P, S) (-1 empty); extra_mask: (B, T, S) bool;
    slot_idx: (B,) rows of a pool (P > B) read in place, or None (P = B);
    block: the plain version's key tile (None: one tile);
    k_scale, v_scale: (P, S, Hkv) f32 scales of int8 k, v (or None).
    Returns (B,T,Hkv,G), (B,T,Hkv,G), (B,T,Hkv,G,Dv), all f32."""
    return fa.attend_partial(q, k, v, q_pos, k_pos, scale=scale,
                             causal=causal, window=window, mask=extra_mask,
                             slot_idx=slot_idx, block=block, k_scale=k_scale,
                             v_scale=v_scale)


def finalize_partial(partial, out_dtype):
    """acc / l with fully masked rows (l = 0) giving 0."""
    return fa.finalize(partial).to(out_dtype)


def blocked_attention(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                      extra_mask=None, block=None):
    """Self-contained attention of q over (k, v) (P = B), normalised.
    Under grad mode with an input that requires a gradient it takes
    `fa.attention` (the same forward, with a gradient), else the
    partials' wrapper: bitwise the same output either way."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return fa.attention(q, k, v, q_pos, k_pos, scale=scale,
                            causal=causal, window=window, mask=extra_mask,
                            block=block)
    return finalize_partial(
        attend_partial(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                       window=window, extra_mask=extra_mask, block=block),
        q.dtype)


def cache_partial(q, cache, q_pos, *, scale, window=0, block=None,
                  slot_idx=None, page_view=None, v_in_k=False):
    """Causal partials of q over a cache, read in place: a page pool
    through `page_view` by the paged kernel, else a resident cache
    (through `slot_idx` when given) by the flash-attention kernel; an
    int8 cache with its scales, by the kernels' int8 K/V form. `v_in_k`
    (MLA's latent caches, whose "v" equals K's first columns): pass
    `cache["k"][..., :Dv]` as v."""
    scales = dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    v = cache["v"]
    if v_in_k:
        v = cache["k"][..., : v.shape[-1]]
    if page_view is not None:
        return pa.paged_attend_partial(
            q, cache["k"], v, q_pos, cache["slot_pos"], page_view,
            scale=scale, window=window, block=block, **scales)
    return attend_partial(q, cache["k"], v, q_pos, cache["slot_pos"],
                          scale=scale, causal=True, window=window,
                          block=block, slot_idx=slot_idx, **scales)


# =====================================================================
# KV cache helpers
# =====================================================================

def make_kv_cache(batch, capacity, n_kv, dk, dv=None, dtype=torch.bfloat16,
                  quantized=False, device=None):
    """Empty cache: zero K/V (finite, so masked keys add exactly 0) and
    slot_pos -1; `quantized` stores int8 K/V whatever `dtype`, with zero
    f32 scales per (row, head). A page pool is the same with (n_pages,
    page_size) leading."""
    dv = dv or dk
    store = torch.int8 if quantized else dtype
    c = {
        "k": torch.zeros((batch, capacity, n_kv, dk), dtype=store,
                         device=device),
        "v": torch.zeros((batch, capacity, n_kv, dv), dtype=store,
                         device=device),
        "slot_pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                               device=device),
    }
    if quantized:
        for key in ("k_scale", "v_scale"):
            c[key] = torch.zeros((batch, capacity, n_kv),
                                 dtype=torch.float32, device=device)
    return c


def _quantize(x):
    """Symmetric per-(token, head) int8 quantization of x (B, T, H, D):
    the reference's arithmetic (scale = max|x| / 127 clamped to 1e-8,
    round half to even, clip to +-127). Returns (int8, f32 scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_cache(cache):
    """The (k, v) the plain versions read: an int8 cache's bf16 view
    bf16(f32(k8) * scale), as the reference builds it; a plain cache's
    own K/V."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    return (fa.dequantize_kv(cache["k"], cache["k_scale"]),
            fa.dequantize_kv(cache["v"], cache["v_scale"]))


def cache_capacity(cfg: ModelConfig, max_len: int, layer_window: int) -> int:
    if layer_window:
        return min(max_len, layer_window + RING_MARGIN)
    return max_len


def kv_rows(cache, k_new, v_new, positions):
    """New-token KV rows in storage form (quantized or cast as the
    cache stores them): {"k", "v", "slot_pos"[, "k_scale", "v_scale"]}
    with leading (B, T)."""
    rows = {"slot_pos": positions.to(torch.int32)}
    if "k_scale" in cache:
        rows["k"], rows["k_scale"] = _quantize(k_new)
        rows["v"], rows["v_scale"] = _quantize(v_new)
    else:
        rows["k"] = k_new.to(cache["k"].dtype)
        rows["v"] = v_new.to(cache["v"].dtype)
    return rows


def set_rows(cache, rows, positions, slot_idx=None, page_view=None):
    """Write `kv_rows` in place at column = position % capacity of cache
    row slot_idx[b] (or b). On a page pool (`page_view`) the capacity is
    n_view * ps and column c lands on row c % ps of physical page
    page_view[b, c // ps]; the caller maps every page a write touches
    first (padded batch rows map to the scratch page). Duplicate rows
    (scratch padding) resolve arbitrarily; no request reads them."""
    if page_view is not None:
        ps = cache["slot_pos"].shape[1]
        col = (positions % (page_view.shape[1] * ps)).long()   # (B, T)
        phys = page_view.long().gather(1, col // ps) * ps + col % ps
        for key, val in rows.items():
            t = cache[key]
            t.view((-1,) + tuple(t.shape[2:]))[phys] = val
        return cache
    C = cache["slot_pos"].shape[1]
    col = (positions % C).long()                             # (B, T)
    if slot_idx is None:
        bidx = torch.arange(positions.shape[0], device=col.device)[:, None]
    else:
        bidx = slot_idx.long()[:, None]
    for key, val in rows.items():
        cache[key][bidx, col] = val
    return cache


def take_rows(cache, slot_idx, page_view=None):
    """Gathered copy of the active rows of a resident cache, or of the
    view's pages of a page pool as a (B, n_view * ps, ...) resident-layout
    cache. Speculative snapshots use it; the attention path itself reads
    pools in place."""
    if page_view is not None:
        return {k: pa.gather_view(v, page_view) for k, v in cache.items()}
    if slot_idx is None:
        return cache
    idx = slot_idx.long()
    return {k: v.index_select(0, idx) for k, v in cache.items()}


def _attend_cached(qg, k_new, v_new, cache, positions, *, scale, window,
                   block, seg_mask, slot_idx, write, token_mask=None,
                   page_view=None, v_in_k=False):
    """Cache-backed attention core.

    Plain decode/extend (write, no seg_mask): the new rows are written in
    place, then the queries attend over the written cache. No-commit
    scoring or tree masks: the queries attend over the cache as it was
    (fully causal) merged with the fresh segment under its mask (read by
    the flash-attention kernel: its keys are not in the cache); a write
    asked for alongside a seg_mask lands after that read.

    token_mask: (B, T) bool — suffix shape-padding rows (False) are
    written with slot_pos = -1 at their real columns: invisible to every
    read and overwritten by the next real tokens there.
    page_view: (B, n_view) int32 — `cache` is a page pool, read and
    written through this block table.
    v_in_k: the cache's "v" is K's first Dv columns (MLA): reads pass
    them as v (`cache_partial`).
    Returns (out, cache | None)."""
    B, T = positions.shape
    k_pos = (positions if token_mask is None
             else torch.where(token_mask, positions,
                              torch.full_like(positions, -1)))
    kw = dict(scale=scale, window=window, block=block, slot_idx=slot_idx,
              page_view=page_view, v_in_k=v_in_k)
    if write and seg_mask is None:
        set_rows(cache, kv_rows(cache, k_new, v_new, k_pos), positions,
                 slot_idx, page_view)
        out = finalize_partial(cache_partial(qg, cache, positions, **kw),
                               qg.dtype)
        return out, cache
    mask_s = seg_mask
    if mask_s is None:
        mask_s = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                       device=positions.device)
                            ).expand(B, T, T)
    history = cache_partial(qg, cache, positions, **kw)
    fresh = attend_partial(qg, k_new, v_new, positions, k_pos, scale=scale,
                           causal=True, window=window, extra_mask=mask_s)
    out = finalize_partial(fa.merge_two(history, fresh), qg.dtype)
    if write:
        set_rows(cache, kv_rows(cache, k_new, v_new, k_pos), positions,
                 slot_idx, page_view)
        return out, cache
    return out, None


# =====================================================================
# GQA attention layer
# =====================================================================

def gqa_params(gen, cfg: ModelConfig, device):
    """Q, K, V and output projections (+ QKV biases, qk-norm scales): a
    self-attention mixer's, and a cross-attention sub-block's (the
    reference builds both with this function)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, hq * hd), device),
        "wk": dense_init(gen, (d, hkv * hd), device),
        "wv": dense_init(gen, (d, hkv * hd), device),
        "wo": dense_init(gen, (hq * hd, d), device),
    }
    if cfg.qkv_bias:
        p.update(bq=torch.zeros(hq * hd, device=device),
                 bk=torch.zeros(hkv * hd, device=device),
                 bv=torch.zeros(hkv * hd, device=device))
    if cfg.qk_norm:
        p.update(q_norm=torch.ones(hd, device=device),
                 k_norm=torch.ones(hd, device=device))
    return p


def _project_qkv(p, cfg: ModelConfig, x, positions, rope: bool):
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = qdot(x, p["wq"])
    k = qdot(x, p["wk"])
    v = qdot(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm_headwise(p["k_norm"], k, cfg.norm_eps)
    if rope and cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(p, cfg: ModelConfig, x, positions, *, cache=None,
                  seg_mask=None, window=0, block=None, slot_idx=None,
                  write=True, token_mask=None, page_view=None):
    """Self-attention for any mode.

    x: (B, T, d); positions: (B, T) absolute positions of these tokens.
    cache=None  -> self-contained: attends within x only.
    cache=dict  -> decode/verify/prefill with a cache (see _attend_cached).
    seg_mask: (B, T, T) mask among the fresh tokens (tree verification).
    slot_idx: (B,) — cache is a resident slot pool; row b of x lives in
              pool row slot_idx[b]; reads and writes go there in place.
    write=False -> no-commit scoring (returns None for the cache).
    page_view: (B, n_view) — cache is a page pool read and written
              through this block table (slot_idx still names the rows'
              slots, whose lengths live in the model's cache).
    block: the plain version's key tile on the CPU (cache reads default
           to the kernel's tile, so a slot pool and a page pool holding
           the same keys give bitwise equal results).
    Returns (out, cache | None)."""
    B, T, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = hq // hkv
    scale = hd ** -0.5
    q, k, v = _project_qkv(p, cfg, x, positions, rope=True)
    qg = q.reshape(B, T, hkv, g, hd)
    if cache is not None:
        block = block or cfg.decode_block or fa.KEY_TILE

    if cache is None:
        out = blocked_attention(qg, k, v, positions, positions, scale=scale,
                                causal=True, window=window,
                                extra_mask=seg_mask, block=block)
        new_cache = None
    else:
        out, new_cache = _attend_cached(
            qg, k, v, cache, positions, scale=scale, window=window,
            block=block, seg_mask=seg_mask, slot_idx=slot_idx, write=write,
            token_mask=token_mask, page_view=page_view)
    out = out.reshape(B, T, hq * hd)
    return qdot(out, p["wo"]), new_cache


def cross_attention(p, cfg: ModelConfig, x, kv_src=None, cache=None,
                    block=None, slot_idx=None, write=True):
    """Cross-attention to frontend or encoder states, non-causal.

    kv_src: (B, S, d) states: K/V are projected from them, attended over
            as they are (uncast) and, with `write` and a cache, written
            into the cache's columns 0..S-1 in its dtype, slot_pos
            arange(S), in place (rows slot_idx[b] of a slot pool).
    cache:  {"k", "v", "slot_pos"} cross cache: without kv_src its rows
            (slot_idx[b], or b) are read in place; empty rows (slot_pos
            -1, as a request served without a frontend holds) give 0.
    Returns (out, cache | None)."""
    B, T, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = qdot(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    qg = q.reshape(B, T, hkv, hq // hkv, hd)
    # non-causal: the query positions are never compared
    q_pos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
    scale = hd ** -0.5
    if kv_src is not None:
        S = kv_src.shape[1]
        k = qdot(kv_src, p["wk"])
        v = qdot(kv_src, p["wv"])
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = k.reshape(B, S, hkv, hd)
        v = v.reshape(B, S, hkv, hd)
        k_pos = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
        if cache is not None and write:
            rows = (torch.arange(B, device=x.device) if slot_idx is None
                    else slot_idx.long())
            cache["k"][rows, :S] = k.to(cache["k"].dtype)
            cache["v"][rows, :S] = v.to(cache["v"].dtype)
            cache["slot_pos"][rows, :S] = k_pos
        else:
            cache = None
        out = blocked_attention(qg, k, v, q_pos, k_pos, scale=scale,
                                causal=False, block=block)
    else:
        if cache is None:
            raise ValueError("cross_attention needs kv_src or a cross cache")
        out = finalize_partial(attend_partial(
            qg, cache["k"], cache["v"], q_pos, cache["slot_pos"],
            scale=scale, causal=False, block=block or fa.KEY_TILE,
            slot_idx=slot_idx), qg.dtype)
        cache = None                      # a read writes nothing
    out = out.reshape(B, T, hq * hd)
    return qdot(out, p["wo"]), cache


# =====================================================================
# MLA (DeepSeek-V3 multi-head latent attention), absorbed formulation
# =====================================================================

def mla_params(gen, cfg: ModelConfig, device):
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    return {
        "wdq": dense_init(gen, (d, m.q_lora_rank), device),
        "q_norm": torch.ones(m.q_lora_rank, device=device),
        "wuq": dense_init(gen, (m.q_lora_rank, H * m.qk_head_dim), device),
        "wdkv": dense_init(gen, (d, m.kv_lora_rank), device),
        "kv_norm": torch.ones(m.kv_lora_rank, device=device),
        "wkr": dense_init(gen, (d, m.qk_rope_head_dim), device),
        "wuk": dense_init(gen, (m.kv_lora_rank, H * m.qk_nope_head_dim),
                          device),
        "wuv": dense_init(gen, (m.kv_lora_rank, H * m.v_head_dim), device),
        "wo": dense_init(gen, (H * m.v_head_dim, d), device),
    }


def make_mla_cache(batch, capacity, cfg: ModelConfig, dtype=torch.bfloat16,
                   device=None):
    """Latent cache: "k" holds c_kv ++ k_pe (kv_lora + rope values), "v"
    c_kv (kv_lora values), one KV head, as the reference's layout. A page
    pool is the same with (n_pages, page_size) leading (the reference's
    `make_paged_mla_cache`)."""
    m = cfg.mla
    return make_kv_cache(batch, capacity, 1,
                         m.kv_lora_rank + m.qk_rope_head_dim,
                         m.kv_lora_rank, dtype, device=device)


def mla_attention(p, cfg: ModelConfig, x, positions, *, cache=None,
                  seg_mask=None, window=0, block=None, slot_idx=None,
                  write=True, token_mask=None, page_view=None):
    """Absorbed MLA: the cache holds only (c_kv ++ k_pe) per token; W_UK is
    absorbed into the query and W_UV applied to the attention output. This
    is single-latent-head attention (Hkv = 1, G = H, Dk = kv_lora + rope,
    Dv = kv_lora): the kernels' latent form. Arguments and modes as
    `gqa_attention`; products promote as the reference's (bf16
    activations times f32 weights give f32 latents and queries)."""
    m: MLAConfig = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    R, nope = m.kv_lora_rank, m.qk_nope_head_dim
    Dk = R + m.qk_rope_head_dim
    scale = m.qk_head_dim ** -0.5

    # the reference's `_rms` is `rms_norm_headwise`'s arithmetic
    cq = rms_norm_headwise(p["q_norm"], qdot(x, p["wdq"]), cfg.norm_eps)
    q = qdot(cq, p["wuq"]).reshape(B, T, H, m.qk_head_dim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    # absorb W_UK: (B,T,H,nope) @ (R,H,nope) -> (B,T,H,R)
    wuk = p["wuk"].reshape(R, H, nope)
    q_abs = torch.einsum("bthn,rhn->bthr", *_promote(q_nope, wuk))
    q_eff = torch.cat([q_abs, q_pe.to(q_abs.dtype)], dim=-1)   # (B,T,H,Dk)
    qg = q_eff.reshape(B, T, 1, H, Dk)

    ckv = rms_norm_headwise(p["kv_norm"], qdot(x, p["wdkv"]),
                            cfg.norm_eps)                       # (B,T,R)
    kpe = apply_rope(qdot(x, p["wkr"]), positions, cfg.rope_theta)
    k_eff = torch.cat([ckv, kpe.to(ckv.dtype)], dim=-1)[:, :, None, :]
    v_eff = k_eff[..., :R]              # (B,T,1,R): c_kv, read out of K

    if cache is None:
        out_lat = blocked_attention(qg, k_eff, v_eff, positions, positions,
                                    scale=scale, causal=True, window=window,
                                    extra_mask=seg_mask, block=block)
        new_cache = None
    else:
        block = block or cfg.decode_block or fa.key_tile(Dk, R)
        out_lat, new_cache = _attend_cached(
            qg, k_eff, v_eff, cache, positions, scale=scale, window=window,
            block=block, seg_mask=seg_mask, slot_idx=slot_idx, write=write,
            token_mask=token_mask, page_view=page_view, v_in_k=True)
    out_lat = out_lat.reshape(B, T, H, R)
    wuv = p["wuv"].reshape(R, H, m.v_head_dim)
    out = torch.einsum("bthr,rhv->bthv", *_promote(out_lat, wuv))
    return qdot(out.reshape(B, T, H * m.v_head_dim), p["wo"]), new_cache
