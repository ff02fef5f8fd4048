"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (``repro_torch.kernels.ops`` sends it
here), the oracle ``chip_smoke.py`` holds each CUDA kernel against on
the card, and the counterparts of ``repro/kernels/ref.py`` that the CPU
tests compare with the JAX package.

Two deliberate differences from the JAX oracles:

- GQA by index: K/V keep their Hkv heads and query head ``h`` reads KV
  head ``h // (Hq / Hkv)``; the JAX model repeats K/V to Hq before its
  kernels, which the port never does.
- A decode row with ``kv_len == 0`` attends to nothing, and both the
  Pallas kernels and the CUDA kernels return zeros for it.  The plain
  versions here follow the kernels (``repro/kernels/ref.py`` returns the
  mean of V), and they get there without ``-inf`` arithmetic, so no NaN
  can appear.

``ssd_ref`` and ``rmsnorm_ref`` follow their JAX oracles exactly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0 ->
    (B, Hq, S, D) in q's dtype; plain softmax attention.

    Query head ``h`` attends with KV head ``h // (Hq / Hkv)`` (GQA by
    index; the JAX oracle takes K/V already repeated to Hq).  Key ``k``
    is kept for query ``q`` when ``k <= q`` (if causal) and
    ``q - k < window`` (if ``window > 0``).  Scores and softmax in f32,
    the probabilities cast to V's dtype for the weighted sum."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, hq // hkv, s, d)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    qi, ki = pos[:, None], pos[None, :]
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window > 0:
        mask &= (qi - ki) < window
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs.to(v.dtype), v)
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    """q: (B, Hq, D); caches: (B, Hkv, S, D) with Hq % Hkv == 0; kv_len:
    (B,) -> (B, Hq, D).  Positions ``[0, kv_len)`` are attended; query
    head ``h`` reads KV head ``h // (Hq / Hkv)``.

    Scores and softmax in f32; the probabilities are cast to V's dtype
    for the weighted sum, as the JAX oracle does."""
    b, hq, d = q.shape
    hkv = k_cache.shape[1]
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, hq // hkv, d)
    scores = torch.einsum(
        "bhgd,bhkd->bhgk", qg.float(), k_cache.float()
    ) * scale
    pos = torch.arange(k_cache.shape[2], device=q.device)
    mask = pos[None, :] < kv_len[:, None]
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", probs.to(v_cache.dtype), v_cache)
    out = torch.where((kv_len > 0)[:, None, None, None], out, 0)
    return out.reshape(b, hq, d).to(q.dtype)


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
    """Gather-then-attend oracle for the paged kernel (GQA by index:
    pages carry Hkv heads)."""
    k = paged_gather(k_pages, page_table)
    v = paged_gather(v_pages, page_table)
    return decode_attention_ref(q, k, v, kv_len)


def ssd_ref(x, dt, a, b_mat, c_mat) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence, the definitional oracle of the chunked
    kernel (copy of ``repro/kernels/ref.py::ssd_ref``).

    x: (B, S, H, P); dt: (B, S, H) f32; a: (H,) negative f32;
    b_mat, c_mat: (B, S, N), one group broadcast over the heads.  Per
    step ``state = state * exp(dt * a) + dt * x ⊗ B`` and ``y = state · C``,
    in f32.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) f32)."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()                            # (B, H)
        da = torch.exp(dtt * a.float())
        bt = b_mat[:, t].float()                          # (B, N)
        state = state * da[..., None, None] + (
            dtt[..., None, None] * bt[:, None, None, :]
            * x[:, t].float()[..., None])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_mat[:, t].float()))
    y = (torch.stack(ys, dim=1) if ys
         else x.new_zeros((bsz, 0, h, p), dtype=torch.float32))
    return y.to(x.dtype), state


def rmsnorm_ref(x, scale, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x**2) + eps) * (1 + scale)`` over the last axis,
    in f32, returned in x's dtype (copy of
    ``repro/kernels/ref.py::rmsnorm_ref``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
