"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (``repro_torch.kernels.ops`` sends it
here), the oracle ``chip_smoke.py`` holds each CUDA kernel against on
the card, and the counterparts of ``repro/kernels/ref.py`` that the CPU
tests compare with the JAX package.

One deliberate difference from the JAX oracle: a row with
``kv_len == 0`` attends to nothing, and both the Pallas kernel and the
CUDA kernel return zeros for it.  The plain versions here follow the
kernels (``repro/kernels/ref.py`` returns the mean of page 0's V), and
they get there without ``-inf`` arithmetic, so no NaN can appear.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """q: (B, H, D); caches: (B, H, S, D); kv_len: (B,) -> (B, H, D).

    Scores and softmax in f32; the probabilities are cast to V's dtype
    for the weighted sum, as the JAX oracle does."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum(
        "bhd,bhkd->bhk", q.float(), k_cache.float()
    ) * scale
    pos = torch.arange(k_cache.shape[2], device=q.device)
    mask = pos[None, :] < kv_len[:, None]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bhkd->bhd", probs.to(v_cache.dtype), v_cache)
    return torch.where((kv_len > 0)[:, None, None], out, 0).to(q.dtype)


def paged_gather(pages, page_table) -> torch.Tensor:
    """Linearize a paged KV pool through a page table.

    pages: (NP, H, ps, D); page_table: (B, MP) int32, -1 = unallocated.
    Returns (B, H, MP*ps, D).  Unallocated entries gather page 0 — the
    caller masks them via kv_len, exactly like right-padding.
    """
    pt = page_table.long().clamp(0, pages.shape[0] - 1)
    g = pages[pt]  # (B, MP, H, ps, D)
    b, mp, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(b, h, mp * ps, d)


def page_gather_ref(pages, page_ids) -> torch.Tensor:
    """Linearize ONE sequence's pages (the P/D export path), for every
    layer at once.

    pages: (L, NP, H, ps, D); page_ids: (M,) int32, -1 = unallocated
    (clamped to page 0; callers slice to the valid token count).
    Returns (L, H, M*ps, D).  ``repro/kernels/ref.py::page_gather_ref``
    is the single-layer case, which the JAX package ``vmap``s over
    layers.
    """
    ids = page_ids.long().clamp(0, pages.shape[1] - 1)
    g = pages[:, ids]  # (L, M, H, ps, D)
    n_l, m, h, ps, d = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(n_l, h, m * ps, d)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                               kv_len) -> torch.Tensor:
    """Gather-then-attend oracle for the paged kernel (GQA-aware:
    pages carry Hkv heads, broadcast to q's Hq after the gather)."""
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    return decode_attention_ref(q, k, v, kv_len)
