"""Dispatch between the CUDA kernels and their plain PyTorch versions.

A tensor on the CPU goes to the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the kernel, whose
wrapper launches it or raises — there is no fallback from one to the
other.  Each kernel's launch count is kept in
:mod:`repro_torch.kernels._build`, where the kernel is launched, so a
run can show that its main path went through the kernels
(``reset_launch_counts`` before, ``launch_counts`` after).
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import page_gather as _gather
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts", "flash_attention",
           "decode_attention", "paged_decode_attention", "page_gather", "ssd",
           "rmsnorm"]


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B, Hq, S, D) prefill attention of every query against the keys
    of its own sequence; see ``ref.flash_attention_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, kv_len):
    """(B, Hq, D) attention of one query token per sequence over a
    contiguous cache; see ``ref.decode_attention_ref``."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_len)
    return _decode.decode_attention(q, k_cache, v_cache, kv_len)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len):
    """(B, Hq, D) attention of one query token per sequence over a
    paged pool; see ``ref.paged_decode_attention_ref``."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, page_table, kv_len
        )
    return _decode.paged_decode_attention(
        q, k_pages, v_pages, page_table, kv_len
    )


def page_gather(pages, page_ids):
    """(L, NP, H, ps, D) pool -> (L, H, M*ps, D) for one sequence's
    pages; see ``ref.page_gather_ref``."""
    if pages.device.type == "cpu":
        return ref.page_gather_ref(pages, page_ids)
    return _gather.page_gather(pages, page_ids)


def ssd(x, dt, a, b_mat, c_mat, *, chunk: int = 256):
    """Chunked Mamba-2 SSD of one B/C group: (y, final state); see
    ``ref.ssd_ref``, the sequential recurrence the CPU runs (as the JAX
    package's ``ops.ssd`` does on its "jnp" backend)."""
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a, b_mat, c_mat)
    return _ssd.ssd(x, dt, a, b_mat, c_mat, chunk=chunk)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """RMSNorm with the ``(1 + scale)`` affine over the last axis; see
    ``ref.rmsnorm_ref``."""
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    return _rmsnorm.rmsnorm(x, scale, eps=eps)
