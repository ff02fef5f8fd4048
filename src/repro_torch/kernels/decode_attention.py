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
runs one block per (chunk of whole pages, KV head, row) that computes
the KV head's whole query group on the tensor cores (``mma.sync``),
pages streamed through a ring of shared-memory stages by TMA;
:func:`paged_plan` picks that route or the split kernel (one block per
query head, K/V through registers: f32, the smoke widths) and sizes the
grid from shapes alone.  The contiguous kernel runs one block per
(chunk of ``CONTIGUOUS_SPLIT_TOKENS``, KV head, row) that computes
query heads of the KV head's group in pairs, with K/V streamed through
a ring of shared-memory stages by bulk copy; :func:`decode_plan` sizes
its grid and stages from shapes alone.  The source files say how their
designs answer the bound.  Their plain PyTorch versions are
``decode_attention_ref`` and ``paged_decode_attention_ref`` in
:mod:`repro_torch.kernels.ref`; :mod:`repro_torch.kernels.ops` picks
between kernel and plain version by device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 112, 128, 256)  # the DA_CASEs of decode_attention.cu
PAGED_HEAD_DIMS = (8, 16, 64, 112, 128)  # the PDA_CASEs of paged_decode_attention.cu
SPLIT_TOKENS = 256  # cache positions per block of the paged split-KV grid
# the paged group kernel's (namespace group of paged_decode_attention.cu):
# its head dims (PG_CASEs), the largest query group (kMaxG: mma's 16 M
# rows), the positions per chunk and tokens per ring stage it aims at
# (the fastest of the variants timed on the card, PERF.md), and the most
# tokens a stage and pages a chunk take (kMaxStageTokens, kMaxChunkPages)
GROUP_HEAD_DIMS = (64, 112, 128)
MAX_QUERY_GROUP = 16
PAGED_SPLIT_TOKENS = 512
PAGED_STAGE_TOKENS = 64
MAX_STAGE_TOKENS = 128
MAX_CHUNK_PAGES = 64
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


class PagedPlan(NamedTuple):
    """The paged kernel's launch, from shapes and dtype alone."""
    route: str        # "group" (tensor cores, a block per KV head) or "split"
    n_split: int      # chunks per row: the grid's x
    chunk_pages: int  # pages of a chunk (group route; 0 on the split route)
    stage_pages: int  # pages of a ring stage (group route; 0 on the split)
    grid: tuple       # (n_split, Hkv or Hq, B)
    workspace: tuple  # the f32 (acc, m, l) rows the merge reads


def paged_plan(b: int, hq: int, hkv: int, max_pages: int, ps: int, d: int,
               dtype, *, legacy: bool = False) -> PagedPlan:
    """Route, grid, stages and workspace of the paged kernel for q
    (b, hq, d) over pages of ``ps`` tokens and a (b, max_pages) table.

    The group kernel takes bf16 at a head dim of ``GROUP_HEAD_DIMS``, a
    query group of at most ``MAX_QUERY_GROUP`` heads (MHA too), and a
    page size that is a multiple of 8 (each page's TMA box starts on a
    1024-byte atom of the 128-byte swizzle) whose stage fits: a stage is
    the fewest whole pages that make a multiple of 16 tokens (mma's
    slices), times as many as reach ``PAGED_STAGE_TOKENS``, at most
    ``MAX_STAGE_TOKENS``; a chunk is whole stages near
    ``PAGED_SPLIT_TOKENS`` positions.  Everything else, and ``legacy``,
    takes the split kernel: chunks of ``SPLIT_TOKENS`` positions, a
    block per query head."""
    group = hq // hkv
    unit = 16 // math.gcd(ps, 16)  # pages of the shortest whole stage
    takes = (not legacy and dtype == torch.bfloat16
             and d in GROUP_HEAD_DIMS
             and group <= MAX_QUERY_GROUP
             and ps % 8 == 0 and unit * ps <= MAX_STAGE_TOKENS)
    if not takes:
        n_split = max(1, -(-(max_pages * ps) // SPLIT_TOKENS))
        return PagedPlan("split", n_split, 0, 0, (n_split, hq, b),
                         (b, hq, n_split, d + 2))
    stage = unit * max(1, PAGED_STAGE_TOKENS // (unit * ps))
    stages = max(1, min(round(PAGED_SPLIT_TOKENS / (stage * ps)),
                        MAX_CHUNK_PAGES // stage))
    chunk = stage * stages
    n_split = max(1, -(-max_pages // chunk))
    return PagedPlan("group", n_split, chunk, stage, (n_split, hkv, b),
                     (b, hq, n_split, d + 2))


def _check_gqa(b, hq, hkv, d, head_dims, kv_len):
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not in {head_dims}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len must be (B={b},)")


def _split_workspace(q, positions: int):
    """The split kernel's chunk count for ``positions`` cache positions
    per row (the contiguous kernel's yardstick; the paged one's is in
    :func:`paged_plan`), and its f32 workspace: one (acc, m, l) row per
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
            entry="decode_attention_split_launch", on=q,
        )
        return out
    plan = decode_plan(b, hq, hkv, s, d, q.element_size(), split_tokens)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    _build.launch(
        "decode_attention", *args, ws.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODE[q.dtype], b, hq, hkv, d, s, plan.n_split,
        plan.heads_per_block, plan.stage_tokens, stream, on=q,
    )
    return out


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len, *,
                           legacy: bool = False) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (NP, Hkv, ps, D) with Hq % Hkv == 0;
    page_table: (B, MP) int32 (-1 = unallocated, clamped); kv_len: (B,)
    int32.  Returns (B, Hq, D) in q's dtype.  Launches the kernel that
    :func:`paged_plan` routes to on the current stream; raises on
    anything the kernels do not take and on a failed launch.
    ``legacy`` runs the split kernel at any shape: the yardstick for
    timing; the model never asks for it."""
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
    plan = paged_plan(b, hq, hkv, max_pages, ps, d, q.dtype, legacy=legacy)
    ws = torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), kv_len.data_ptr(), ws.data_ptr(),
            out.data_ptr(), _build.DTYPE_CODE[q.dtype], b, hq, hkv, d,
            n_pages, ps, max_pages, plan.n_split)
    if plan.route == "split":
        _build.launch("paged_decode_attention", *args, stream,
                      entry="paged_decode_attention_split_launch", on=q)
    else:
        _build.launch("paged_decode_attention", *args, plan.chunk_pages,
                      plan.stage_pages, stream, on=q)
    return out
