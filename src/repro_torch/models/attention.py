"""GQA attention over a paged KV cache (counterpart of
``repro/models/attention.py``: projection, masks, paged writes and the
chunk attention of the paged plane).

The page pools are updated in place — the JAX package returns new
arrays; here the pool is one tensor that every step writes into.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import paged_gather
from repro_torch.models.common import apply_rope

NEG_INF = -1e30


def project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, use_rope: bool = True):
    """x: (B, S, d) -> q (B, Hq, S, hd), k/v (B, Hkv, S, hd).  ``p``
    holds wq/wk/wv as (in, out) and, with qkv_bias, bq/bk/bv."""
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
    return q, k, v


def _mask(q_pos, kv_pos, kv_len, *, causal: bool):
    """q_pos: (B, Q), kv_pos: (B, K), kv_len: (B,) -> bool (B, 1, Q, K)."""
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    valid = (kp >= 0) & (kp < kv_len[:, None, None])
    if causal:
        valid = valid & (kp <= qp)
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


def paged_write_index(page_table, positions, valid, page_size: int):
    """Where a chunk's new K/V tokens land in the page pool.

    page_table: (B, MP) int32; positions: (B, C) absolute positions;
    valid: (B, C) bool.  Returns ``(rows, phys, off)``: the flat
    ``b * C + c`` index of every token that is written (a valid row
    whose page is allocated), its page id and its in-page offset.  The
    JAX package drops the other writes by scattering out of bounds;
    here they are filtered once per forward pass (one host sync) and
    every layer reuses the result.
    """
    logical = (positions // page_size).clamp(0, page_table.shape[1] - 1)
    phys = torch.gather(page_table, 1, logical.long())
    rows = (valid & (phys >= 0)).flatten().nonzero().squeeze(1)
    return (rows, phys.flatten()[rows].long(),
            (positions % page_size).flatten()[rows].long())


def update_paged_cache(k_pages, v_pages, index, k_new, v_new) -> None:
    """Write a chunk of new K/V tokens into the page pools, in place.

    k_pages/v_pages: (NP, H, ps, hd); index: from
    :func:`paged_write_index`; k_new/v_new: (B, H, C, hd).
    """
    rows, phys, off = index
    b, h, c, hd = k_new.shape
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        flat = new.transpose(1, 2).reshape(b * c, h, hd)
        pages[phys, :, off, :] = flat.index_select(0, rows).to(pages.dtype)


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
