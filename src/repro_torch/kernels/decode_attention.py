"""Decode attention on the card: wrappers of ``csrc/decode_attention.cu``
(a contiguous cache) and ``csrc/paged_decode_attention.cu`` (a paged
pool), mirroring ``repro/kernels/decode_attention.py``, which holds both
Pallas kernels.

Both kernels replace Pallas TPU kernels of that file
(``decode_attention`` and ``paged_decode_attention``) and are bound by
memory bandwidth: they must read ``sum_b kv_len_b * Hkv * D * 2 *
itemsize`` bytes of K/V, so their least time on an H100 is those bytes
over 3.35 TB/s.  Each cuts every row's cache into chunks, and a second
launch merges the chunks (``csrc/attn_common.cuh``).  The paged kernel
runs one block per (chunk of ``SPLIT_TOKENS`` positions, query head,
row), K/V through registers.  The contiguous kernel runs one block per
(chunk of ``CONTIGUOUS_SPLIT_TOKENS``, KV head, row) that computes all
query heads of the KV head's group, with K/V streamed through a ring of
shared-memory stages by bulk copy; :func:`decode_plan` sizes its grid
and stages from shapes alone.  The source files say how their designs
answer the bound.  Their plain PyTorch versions are
``decode_attention_ref`` and ``paged_decode_attention_ref`` in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks
between kernel and plain version by device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 112, 128, 256)  # the DA_CASEs of decode_attention.cu
PAGED_HEAD_DIMS = (8, 16, 64, 112, 128)  # the PDA_CASEs of paged_decode_attention.cu
SPLIT_TOKENS = 256  # cache positions per block of the paged split-KV grid
# the contiguous kernel's: positions per block of its grid, the most
# query heads one block computes (kMaxG of decode_attention.cu), and the
# tokens of a full stage of its ring (kStageTokens) with the most K bytes
# the stage may take (as many again of V)
CONTIGUOUS_SPLIT_TOKENS = 128
MAX_GROUP = 2
STAGE_TOKENS = 32
STAGE_BYTES = 16384


class DecodePlan(NamedTuple):
    """The contiguous kernel's launch, from shapes alone."""
    n_split: int          # chunks per row: the grid's x
    heads_per_block: int  # query heads one block computes (1 or 2)
    head_blocks: int      # blocks per KV head: the grid's y is Hkv times it
    stage_tokens: int     # cache positions per stage of the ring
    stage_bytes: int      # K and V bytes of one full stage
    workspace: tuple      # the f32 (acc, m, l) rows the merge reads


def decode_plan(b: int, hq: int, hkv: int, s: int, d: int, itemsize: int,
                split_tokens: int = CONTIGUOUS_SPLIT_TOKENS) -> DecodePlan:
    """Grid, ring stages and workspace of the contiguous kernel for q
    (b, hq, d) over caches (b, hkv, s, d) of ``itemsize``-byte elements:
    chunks of ``split_tokens`` positions; a GQA group of ``hq // hkv``
    heads in blocks of ``MAX_GROUP`` heads (1 for MHA); stages of
    ``STAGE_TOKENS`` tokens, fewer where their K would pass
    ``STAGE_BYTES`` (f32 at D 256) or a chunk is shorter."""
    group = hq // hkv
    heads = min(group, MAX_GROUP)
    n_split = max(1, -(-s // split_tokens))
    chunk = max(1, -(-s // n_split))
    stage = min(chunk, STAGE_TOKENS, STAGE_BYTES // (d * itemsize))
    return DecodePlan(n_split, heads, -(-group // heads), stage,
                      2 * stage * d * itemsize, (b, hq, n_split, d + 2))


def _check_gqa(b, hq, hkv, d, head_dims, kv_len):
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len must be (B={b},)")


def _split_workspace(q, positions: int):
    """The paged split-KV grid's chunk count for ``positions`` cache
    positions per row, and its f32 workspace: one (acc, m, l) row per
    (b, head, chunk), written by the kernel before it is read."""
    b, hq, d = q.shape
    n_split = max(1, -(-positions // SPLIT_TOKENS))
    return n_split, torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                                device=q.device)


def decode_attention(q, k_cache, v_cache, kv_len, *, legacy: bool = False,
                     split_tokens: int = CONTIGUOUS_SPLIT_TOKENS
                     ) -> torch.Tensor:
    """q: (B, Hq, D); k/v_cache: (B, Hkv, S, D) with Hq % Hkv == 0;
    kv_len: (B,) int32 (positions ``[0, kv_len)`` are attended, a row of
    0 gives zeros).  Returns (B, Hq, D) in q's dtype.  Launches the CUDA
    kernel on the current stream; raises on anything the kernel does not
    take and on a failed launch.  ``legacy`` runs the split kernel the
    ring kernel replaced (one block per query head, chunks of
    ``SPLIT_TOKENS``) and ``split_tokens`` sets the ring kernel's chunk:
    yardsticks for timing; the model asks for neither."""
    _build.check_operands({"q": q, "k_cache": k_cache, "v_cache": v_cache},
                          {"kv_len": kv_len})
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and caches (B, Hkv, S, D)")
    b, hq, d = q.shape
    b_k, hkv, s, d_k = k_cache.shape
    if v_cache.shape != k_cache.shape or (b_k, d_k) != (b, d):
        raise ValueError(
            f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    _check_gqa(b, hq, hkv, d, HEAD_DIMS, kv_len)
    out = torch.empty_like(q)
    if b == 0 or hq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            kv_len.data_ptr())
    if legacy:
        n_split, ws = _split_workspace(q, s)
        _build.launch(
            "decode_attention", *args, ws.data_ptr(), out.data_ptr(),
            _build.DTYPE_CODE[q.dtype], b, hq, hkv, d, s, n_split, stream,
            entry="decode_attention_split_launch",
        )
        return out
    plan = decode_plan(b, hq, hkv, s, d, q.element_size(), split_tokens)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    _build.launch(
        "decode_attention", *args, ws.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODE[q.dtype], b, hq, hkv, d, s, plan.n_split,
        plan.heads_per_block, plan.stage_tokens, stream,
    )
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table,
                           kv_len) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (NP, Hkv, ps, D) with Hq % Hkv == 0;
    page_table: (B, MP) int32 (-1 = unallocated, clamped); kv_len: (B,)
    int32.  Returns (B, Hq, D) in q's dtype.  Launches the CUDA kernel
    on the current stream; raises on anything the kernel does not take
    and on a failed launch."""
    _build.check_operands({"q": q, "k_pages": k_pages, "v_pages": v_pages},
                          {"page_table": page_table, "kv_len": kv_len})
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and pages (NP, Hkv, ps, D)")
    b, hq, d = q.shape
    n_pages, hkv, ps, d_k = k_pages.shape
    if v_pages.shape != k_pages.shape or d_k != d:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    _check_gqa(b, hq, hkv, d, PAGED_HEAD_DIMS, kv_len)
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B={b}, MP)")
    out = torch.empty_like(q)
    if b == 0 or hq == 0:
        return out
    max_pages = page_table.shape[1]
    n_split, ws = _split_workspace(q, max_pages * ps)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        "paged_decode_attention",
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), ws.data_ptr(),
        out.data_ptr(), _build.DTYPE_CODE[q.dtype], b, hq, hkv, d, n_pages,
        ps, max_pages, n_split, stream,
    )
    return out
