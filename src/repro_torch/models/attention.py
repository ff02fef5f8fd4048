"""GQA attention (counterpart of ``repro/models/attention.py``):
projection, masks, the paged plane's chunk attention, and the slot
plane's prefill attention, cached decode attention and sliding-window
ring cache.  The paged plane's plain write (``paged_write_index`` and
``update_paged_cache``) lives in :mod:`repro_torch.kernels.ref`, beside
the kernel that replaces it on the card, and is called through this
module on the model's plain route.

Caches are updated in place — the JAX package returns new arrays; here
a page pool or a slot cache is one tensor that every step writes into,
so a decode step allocates no second copy of it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import (  # noqa: F401  (the plain write)
    paged_gather,
    paged_write_index,
    update_paged_cache,
)
from repro_torch.models.common import apply_rope

NEG_INF = -1e30

# Logical axes of the attention parameters (JAX's ``ATTN_PARAM_AXES``):
# (embed-in, fused-heads-out); the rules shard the fused head dim when
# the head count divides the model axis, else only over fsdp.
ATTN_PARAM_AXES = {
    "wq": ("fsdp", "heads_fused"),
    "wk": ("fsdp", "kv_fused"),
    "wv": ("fsdp", "kv_fused"),
    "wo": ("heads_fused", "fsdp"),
    "bq": ("heads_fused",),
    "bk": ("kv_fused",),
    "bv": ("kv_fused",),
}


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, use_rope: bool = True,
                kv_repeat: int = 1):
    """x: (B, S, d) -> q (B, Hq, S, hd), k/v (B, Hkv * kv_repeat, S, hd).
    ``p`` holds wq/wk/wv as (in, out) and, with qkv_bias, bq/bk/bv; with
    ``kv_repeat`` > 1 each K/V head is repeated that many times in place
    (JAX's ``jnp.repeat`` on the head axis), after RoPE."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if use_rope:
        q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    if kv_repeat > 1:
        k = torch.repeat_interleave(k, kv_repeat, dim=1)
        v = torch.repeat_interleave(v, kv_repeat, dim=1)
    return q, k, v


def _mask(q_pos, kv_pos, kv_len, *, causal: bool, window: int = 0):
    """q_pos: (B, Q), kv_pos: (B, K), kv_len: (B,) -> bool (B, 1, Q, K)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    valid = (kp >= 0) & (kp < kv_len[:, None, None])
    if causal:
        valid = valid & (kp <= qp)
    if window > 0:
        valid = valid & ((qp - kp) < window)
    return valid[:, None, :, :]


def _sdpa(q_blk, k, v, mask, scale):
    """q_blk: (B, Hkv, G, Qc, hd), k/v: (B, Hkv, K, hd), mask:
    (B, 1, Qc, K).  Scores and softmax in f32, the weighted sum in V's
    dtype."""
    scores = torch.matmul(
        q_blk.float(), k.float()[:, :, None].transpose(-1, -2)
    ) * scale
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs.to(v.dtype), v[:, :, None])


def paged_chunk_attention(q, k_pages, v_pages, page_table, *, q_pos,
                          kv_len, causal: bool = True) -> torch.Tensor:
    """Chunk of queries against a paged cache (gather path).

    q: (B, Hq, C, hd); pages: (NP, Hkv, ps, hd); page_table: (B, MP);
    q_pos: (B, C) absolute positions; kv_len: (B,) valid tokens
    (including this chunk).  The logical position of (page i, offset o)
    is i*ps + o, so masking is positional — stale data in reclaimed
    pages sits above q_pos and is masked by causality + kv_len.
    """
    b, hq, c, hd = q.shape
    hkv = k_pages.shape[1]
    g = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    kv_pos = torch.arange(k.shape[2], device=q.device).expand(b, -1)
    m = _mask(q_pos, kv_pos, kv_len, causal=causal)
    out = _sdpa(q.reshape(b, hkv, g, c, hd), k, v, m, scale)
    return out.reshape(b, hq, c, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Slot plane: monolithic prefill, cached decode, sliding-window ring
# ---------------------------------------------------------------------------


def chunked_attention(q, k, v, *, lens, causal: bool, window: int = 0,
                      q_chunk: int = 512) -> torch.Tensor:
    """Prefill attention in query chunks, so the (S, S) score matrix is
    never whole (the plain route; ``ops.flash_attention`` is the kernel).

    q: (B, Hq, S, hd); k, v: (B, Hkv, S, hd); lens: (B,) valid lengths.
    With a causal window shorter than S, each chunk reads only the
    ``q_chunk + window`` band of keys that can reach it.  Returns
    (B, Hq, S, hd) in q's dtype.
    """
    b, hq, s, hd = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = 1.0 / (hd ** 0.5)
    qc = min(q_chunk, s)
    n_chunks = -(-s // qc)
    pad = n_chunks * qc - s
    qg = F.pad(q, (0, 0, 0, pad)).reshape(b, hkv, g, n_chunks * qc, hd)
    kv_pos = torch.arange(s, device=q.device).expand(b, s)
    local = causal and 0 < window < s
    if local:
        # padding `window` zeros in front makes k_pad[start : start + band]
        # cover original positions [start - window, start + qc)
        band = qc + window
        k_pad = F.pad(k, (0, 0, window, pad))
        v_pad = F.pad(v, (0, 0, window, pad))
        pos_pad = F.pad(kv_pos, (window, pad), value=-1)
    outs = []
    for i in range(n_chunks):
        start = i * qc
        q_pos = torch.arange(start, start + qc, device=q.device).expand(b, qc)
        if local:
            k_blk = k_pad[:, :, start:start + band]
            v_blk = v_pad[:, :, start:start + band]
            pos_blk = pos_pad[:, start:start + band]
        else:
            k_blk, v_blk, pos_blk = k, v, kv_pos
        m = _mask(q_pos, pos_blk, lens, causal=causal, window=window)
        outs.append(_sdpa(qg[:, :, :, start:start + qc], k_blk, v_blk, m,
                          scale).to(q.dtype))
    out = torch.cat(outs, dim=3).reshape(b, hq, n_chunks * qc, hd)
    return out[:, :, :s]


def decode_attention(q, k_cache, v_cache, *, q_pos, kv_pos, kv_len,
                     causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Hq, 1, hd); caches: (B, Hkv, S, hd); q_pos/kv_len: (B,);
    kv_pos: (B, S) absolute position held in each cache slot (-1 =
    empty).  Masking is by ``kv_pos``, so a ring cache in any order
    works."""
    b, hq, _, hd = q.shape
    hkv = k_cache.shape[1]
    scale = 1.0 / (hd ** 0.5)
    m = _mask(q_pos[:, None], kv_pos, kv_len, causal=causal, window=window)
    out = _sdpa(q.reshape(b, hkv, hq // hkv, 1, hd), k_cache, v_cache, m,
                scale)
    return out.reshape(b, hq, 1, hd).to(q.dtype)


def build_local_cache(k, v, lens, window: int):
    """The last ``window`` valid tokens in ring order: slot i holds the
    latest position p < len with p % window == i (decode writes at
    ``pos % window``); slots with no such position are zero with pos -1.

    k, v: (B, H, S, hd) -> (k, v (B, H, window, hd), pos (B, window)).
    """
    b, h, s, hd = k.shape
    w = window
    i = torch.arange(w, device=k.device)
    last = lens.long()[:, None] - 1
    p = last - torch.remainder(last - i, w)        # (B, W)
    valid = (p >= 0) & (p < lens[:, None]) & (p > last - w)
    idx = p.clamp(0, s - 1)[:, None, :, None].expand(b, h, w, hd)
    keep = valid[:, None, :, None]
    kc = torch.where(keep, torch.gather(k, 2, idx), 0)
    vc = torch.where(keep, torch.gather(v, 2, idx), 0)
    return kc, vc, torch.where(valid, p, -1).to(torch.int32)


def update_cache(cache: dict, k_new, v_new, pos, *, window: int = 0) -> None:
    """Write one token per sequence into a slot cache, in place.

    cache: {"k", "v": (B, H, S, hd), "pos": (B, S)}; k_new/v_new:
    (B, H, 1, hd); pos: (B,) absolute position of the new token.  It
    lands in slot ``pos % window`` of a ring cache, slot ``pos`` of a
    linear one.
    """
    slot = (pos % window if window > 0 else pos).long()
    bidx = torch.arange(pos.shape[0], device=pos.device)
    cache["k"][bidx, :, slot] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][bidx, :, slot] = v_new[:, :, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos.to(cache["pos"].dtype)
