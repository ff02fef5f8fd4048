"""Paged KV write on the card: wrapper of ``csrc/paged_kv_write.cu``.

Replaces no Pallas kernel: the JAX package writes a chunk's K/V into
the page pools with a scatter that drops out-of-bounds indices
(``repro/models/attention.py::update_paged_cache``).  PyTorch has no
such scatter, and the port's plain version
(``repro_torch.kernels.ref.paged_kv_write_ref``) filters the lanes to
write with ``nonzero()`` on the host: a sync with the card and a shape
known only after it, which a CUDA graph cannot capture.  The kernel
decides each lane on the card, K and V in one launch.  It is a copy,
bound by memory bandwidth: ``4 * lanes * H * D * itemsize`` bytes for
the lanes it writes, so its least time on an H100 is those bytes over
3.35 TB/s.  ``repro_torch.kernels.ops`` picks between the kernel and
the plain version by device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def paged_kv_write(k_pages, v_pages, k_new, v_new, page_table, start,
                   lens) -> None:
    """Write a chunk's new K/V into the pools, in place.

    k_pages/v_pages: (NP, H, ps, D) contiguous; k_new/v_new: (B, H, C,
    D) in the pools' dtype, any strides but a contiguous last axis;
    page_table: (B, MP), start / lens: (B,), all int32.  Lane (b, c)
    with c < lens[b] lands at page ``page_table[b, (start[b] + c) //
    ps]`` (the logical page clamped into the table), offset ``(start[b]
    + c) % ps``, unless that page is -1.  Launches the CUDA kernel on the
    current stream; raises on anything the kernel does not take and on a
    failed launch."""
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_new", k_new), ("v_new", v_new),
                    ("page_table", page_table), ("start", start),
                    ("lens", lens)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != k_pages.device:
            raise ValueError(f"{name} is on {t.device}, not {k_pages.device}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("start", start),
                    ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("page_table", page_table), ("start", start),
                    ("lens", lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"pools must be two (NP, H, ps, D), got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    n_pages, h, ps, d = k_pages.shape
    if k_new.dim() != 4 or k_new.shape != v_new.shape or \
            k_new.shape[1] != h or k_new.shape[3] != d:
        raise ValueError(f"k_new / v_new {tuple(k_new.shape)} / "
                         f"{tuple(v_new.shape)} do not match pools "
                         f"{tuple(k_pages.shape)}")
    dtypes = {k_pages.dtype, v_pages.dtype, k_new.dtype, v_new.dtype}
    if len(dtypes) != 1:
        raise TypeError(f"pools and new K/V must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    if k_new.stride(3) != 1 or v_new.stride(3) != 1:
        raise ValueError("k_new / v_new must be contiguous on the last axis")
    b, _, c, _ = k_new.shape
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            start.shape != (b,) or lens.shape != (b,):
        raise ValueError(f"page_table must be (B={b}, MP), start and lens "
                         f"(B,)")
    if b == 0 or c == 0 or h == 0 or page_table.shape[1] == 0:
        return
    if n_pages == 0:
        raise ValueError("the pools hold no page to write into")
    size = k_new.element_size()
    stream = torch.cuda.current_stream(k_pages.device).cuda_stream
    _build.launch(
        "paged_kv_write",
        k_new.data_ptr(), v_new.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), page_table.data_ptr(), start.data_ptr(),
        lens.data_ptr(), b, c, h, ps, page_table.shape[1], n_pages,
        d * size, *(s * size for s in k_new.stride()[:3]),
        *(s * size for s in v_new.stride()[:3]), stream,
        on=k_pages,
    )
