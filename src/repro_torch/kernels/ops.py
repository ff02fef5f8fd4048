"""Dispatch between the CUDA kernels and their plain PyTorch versions.

A tensor on the CPU goes to the plain version in
:mod:`repro_torch.kernels.ref`; a CUDA tensor goes to the kernel, whose
wrapper launches it or raises — there is no fallback from one to the
other.  Each kernel's launch count is kept in
:mod:`repro_torch.kernels._build`, where the kernel is launched, so a
run can show that its main path went through the kernels
(``reset_launch_counts`` before, ``launch_counts`` after).

No kernel has a backward (neither has any of the JAX package's Pallas
kernels), and a kernel's output is a fresh tensor with no graph behind
it.  So every wrapper raises when gradients are on and an input
requires one — on either device, so that a model built with
``use_kernels=True`` cannot train on the CPU and then quietly cut its
projections out of the gradient on the card.  Training builds the model
with ``use_kernels=False`` (the plain routes), as the JAX package's
trainer does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import page_gather as _gather
from repro_torch.kernels import paged_kv_write as _kv_write
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts", "flash_attention",
           "decode_attention", "paged_decode_attention", "page_gather", "ssd",
           "rmsnorm", "paged_kv_write"]


def _no_backward(name: str, *tensors) -> None:
    """Raise if a graph would be recorded through kernel ``name``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad(), or "
            f"train a model built with use_kernels=False")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """(B, Hq, S, D) prefill attention of every query against the keys
    of its own sequence; see ``ref.flash_attention_ref``."""
    _no_backward("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, kv_len):
    """(B, Hq, D) attention of one query token per sequence over a
    contiguous cache; see ``ref.decode_attention_ref``."""
    _no_backward("decode_attention", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_len)
    return _decode.decode_attention(q, k_cache, v_cache, kv_len)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_len):
    """(B, Hq, D) attention of one query token per sequence over a
    paged pool; see ``ref.paged_decode_attention_ref``."""
    _no_backward("paged_decode_attention", q, k_pages, v_pages)
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
    _no_backward("page_gather", pages)
    if pages.device.type == "cpu":
        return ref.page_gather_ref(pages, page_ids)
    return _gather.page_gather(pages, page_ids)


def ssd(x, dt, a, b_mat, c_mat, *, chunk: int = 256):
    """Chunked Mamba-2 SSD of one B/C group: (y, final state); see
    ``ref.ssd_ref``, the sequential recurrence the CPU runs (as the JAX
    package's ``ops.ssd`` does on its "jnp" backend)."""
    _no_backward("ssd", x, dt, a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ref.ssd_ref(x, dt, a, b_mat, c_mat)
    return _ssd.ssd(x, dt, a, b_mat, c_mat, chunk=chunk)


def rmsnorm(x, scale, *, eps: float = 1e-5):
    """RMSNorm with the ``(1 + scale)`` affine over the last axis; see
    ``ref.rmsnorm_ref``."""
    _no_backward("rmsnorm", x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps=eps)
    return _rmsnorm.rmsnorm(x, scale, eps=eps)


def paged_kv_write(k_pages, v_pages, k_new, v_new, page_table, start, lens):
    """Write a chunk's (B, H, C, D) new K/V into (NP, H, ps, D) page
    pools in place: lanes ``c < lens[b]`` at position ``start[b] + c``
    whose page is allocated; see ``ref.paged_kv_write_ref``."""
    _no_backward("paged_kv_write", k_new, v_new)
    if k_pages.device.type == "cpu":
        return ref.paged_kv_write_ref(k_pages, v_pages, k_new, v_new,
                                      page_table, start, lens)
    return _kv_write.paged_kv_write(k_pages, v_pages, k_new, v_new,
                                    page_table, start, lens)
