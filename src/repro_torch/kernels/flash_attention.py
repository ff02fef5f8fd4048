"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The kernel is
bound by operations: ``4 * B * Hq * D`` flops per unmasked (query, key)
pair, so its least time on an H100 is those flops over 989 TFLOP/s
(bf16 tensor cores).  The C entry point picks the instance: bf16 at
D 64, 112, 128 and 256 runs on the tensor cores (wgmma, TMA), every
other (dtype, D) on the CUDA cores in f32; the source file says what
bounds each.  Its plain PyTorch version is
``repro_torch.kernels.ref.flash_attention_ref``;
:mod:`repro_torch.kernels.ops` picks between the two by device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 112, 128, 256)  # the FA_CASEs of flash_attention.cu


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    fma: bool = False) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) with Hq % Hkv == 0, any S.
    Key ``k`` is kept for query ``q`` when ``k <= q`` (if causal) and
    ``q - k < window`` (if ``window > 0``).  Returns (B, Hq, S, D) in
    q's dtype.  Launches the CUDA kernel on the current stream; raises on
    anything the kernel does not take and on a failed launch.  ``fma``
    runs the CUDA-core instance whatever the dtype (a yardstick for the
    tensor-core one; the model never asks for it)."""
    _build.check_operands({"q": q, "k": k, "v": v}, {})
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, Hq, S, D) and k/v (B, Hkv, S, D)")
    b, hq, s, d = q.shape
    b_k, hkv, s_k, d_k = k.shape
    if v.shape != k.shape or (b_k, s_k, d_k) != (b, s, d):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.launch(
        "flash_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.DTYPE_CODE[q.dtype], b, hq, hkv, s, d, int(bool(causal)),
        int(window), stream,
        entry="flash_attention_fma_launch" if fma else None,
    )
    return out
