"""Paged decode attention on the card: wrapper of
``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::paged_decode_attention``.  The
kernel is bound by memory bandwidth: it must read
``sum_b kv_len_b * Hkv * D * 2 * itemsize`` bytes of K/V, so its least
time on an H100 is those bytes over 3.35 TB/s.  The source file says how
its design answers that.  Its plain PyTorch version is
``repro_torch.kernels.ref.paged_decode_attention_ref``;
``repro_torch.kernels.ops`` picks between the two by device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (8, 16, 64, 128)  # the PDA_CASEs of the .cu source
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_attention(q, k_pages, v_pages, page_table,
                           kv_len) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (NP, Hkv, ps, D) with Hq % Hkv == 0;
    page_table: (B, MP) int32 (-1 = unallocated, clamped); kv_len: (B,)
    int32.  Returns (B, Hq, D) in q's dtype.  Launches the CUDA kernel
    on the current stream; raises on anything the kernel does not take
    and on a failed launch."""
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "page_table": page_table, "kv_len": kv_len}
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q, k_pages and v_pages must share one dtype")
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("page_table and kv_len must be int32")
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("q must be (B, Hq, D) and pages (NP, Hkv, ps, D)")
    b, hq, d = q.shape
    n_pages, hkv, ps, d_k = k_pages.shape
    if v_pages.shape != k_pages.shape or d_k != d:
        raise ValueError(
            f"pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table must be (B={b}, MP)")
    if kv_len.shape != (b,):
        raise ValueError(f"kv_len must be (B={b},)")
    for name in ("q", "k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or hq == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        "paged_decode_attention",
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], b, hq, hkv, d, n_pages, ps,
        page_table.shape[1], stream,
    )
    return out
