"""Fused RMSNorm on the card: wrapper of ``csrc/rmsnorm.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``.
Bound by memory: one read and one write of ``x``, so its least time on
an H100 is ``2 * x.numel() * itemsize`` bytes over 3.35 TB/s.  Its plain
PyTorch version is ``repro_torch.kernels.ref.rmsnorm_ref``;
:mod:`repro_torch.kernels.ops` picks between the two by device.  The
JAX model never calls the Pallas kernel, so the port's model does not
call this one either.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm(x, scale, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) of any float dtype (read as f32).
    Returns ``x * rsqrt(mean(x**2) + eps) * (1 + scale)`` in x's dtype.
    D must be a whole number of 16-byte words (a multiple of 4 in f32,
    8 in bf16).  Launches the CUDA kernel on the current stream; raises
    on anything the kernel does not take and on a failed launch."""
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, not {x.device}")
    scale = scale.float()
    _build.check_operands({"x": x}, {}, {"scale": scale})
    d = x.shape[-1] if x.dim() else 0
    if scale.shape != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if d % (16 // x.element_size()):
        raise ValueError(f"D={d} is not a whole number of 16-byte words")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("rmsnorm", x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                  _build.DTYPE_CODE[x.dtype], rows, d, float(eps), stream)
    return out
