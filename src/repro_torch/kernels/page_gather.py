"""Page gather on the card: wrapper of ``csrc/page_gather.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/page_gather.py::page_gather``
together with the ``vmap`` over layers that calls it
(``repro/serving/kv_manager.py::_gather_pages_leaf``): one launch
linearizes a sequence's pages for every layer.  It is a pure copy,
bound by memory bandwidth: ``2 * L * M * H * ps * D * itemsize`` bytes,
so its least time on an H100 is those bytes over 3.35 TB/s.  The plain
PyTorch version is ``repro_torch.kernels.ref.page_gather_ref``;
``repro_torch.kernels.ops`` picks between the two by device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def page_gather(pages, page_ids) -> torch.Tensor:
    """pages: (L, NP, H, ps, D); page_ids: (M,) int32 (-1 = unallocated,
    clamped to page 0).  Returns (L, H, M*ps, D).  Launches the CUDA
    kernel on the current stream; raises on anything the kernel does not
    take and on a failed launch."""
    for name, t in (("pages", pages), ("page_ids", page_ids)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_ids.device != pages.device:
        raise ValueError("pages and page_ids must be on one device")
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1:
        raise TypeError("page_ids must be a 1-D int32 tensor")
    if pages.dim() != 5:
        raise ValueError(
            f"pages must be (L, NP, H, ps, D), got {tuple(pages.shape)}"
        )
    n_l, n_pages, h, ps, d = pages.shape
    m = page_ids.shape[0]
    out = torch.empty((n_l, h, m * ps, d), dtype=pages.dtype,
                      device=pages.device)
    if out.numel() == 0:
        return out
    if n_pages == 0:
        raise ValueError("pages holds no page to gather from")
    stream = torch.cuda.current_stream(pages.device).cuda_stream
    _build.launch(
        "page_gather",
        pages.data_ptr(), page_ids.data_ptr(), out.data_ptr(),
        n_l, n_pages, h, m, ps * d * pages.element_size(), stream,
    )
    return out
