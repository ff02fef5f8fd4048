"""Mamba-2 SSD scan on the card: wrapper of ``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py::ssd``: the
chunked SSD of one B/C group, carrying the (P, N) state from chunk to
chunk.  Bound by operations (the two causal (Q, Q) products per chunk,
``C . state`` and the state update), so its least time on an H100 is
those flops over 989 TFLOP/s; the first kernel computes on the CUDA
cores in f32, and the source file says what that costs.  Its plain
PyTorch version is ``repro_torch.kernels.ref.ssd_ref`` (the sequential
recurrence); :mod:`repro_torch.kernels.ops` picks between the two by
device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the (head_dim, d_state) pairs ssd.cu is built for
DIMS = ((64, 128), (64, 64), (8, 16), (16, 32), (32, 64))


def ssd(x, dt, a, b_mat, c_mat, *, chunk: int = 256):
    """x: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32 (negative);
    b_mat, c_mat: (B, S, N) in x's dtype; ``S % chunk == 0`` and
    ``chunk % 16 == 0``.  Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, P, N) f32).  Launches the CUDA kernel on the current
    stream; raises on anything the kernel does not take and on a failed
    launch."""
    _build.check_operands({"x": x, "b_mat": b_mat, "c_mat": c_mat}, {},
                          {"dt": dt, "a": a})
    if x.dim() != 4 or b_mat.dim() != 3:
        raise ValueError("x must be (B, S, H, P) and b_mat/c_mat (B, S, N)")
    bsz, s, h, p = x.shape
    n = b_mat.shape[2]
    if c_mat.shape != b_mat.shape or b_mat.shape[:2] != (bsz, s):
        raise ValueError(
            f"b_mat {tuple(b_mat.shape)} / c_mat {tuple(c_mat.shape)} do "
            f"not match x {tuple(x.shape)} (one group only)")
    if dt.shape != (bsz, s, h) or a.shape != (h,):
        raise ValueError(f"dt must be {(bsz, s, h)} and a {(h,)}")
    if (p, n) not in DIMS:
        raise ValueError(f"(head_dim, d_state) {(p, n)} not in {DIMS}")
    if chunk <= 0 or chunk % 16 or s % chunk:
        raise ValueError(
            f"S={s} must be a multiple of the chunk {chunk}, itself a "
            f"multiple of 16")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if bsz == 0 or h == 0:
        return y, state
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch(
        "ssd", x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), y.data_ptr(), state.data_ptr(),
        _build.DTYPE_CODE[x.dtype], bsz, s, h, p, n, chunk, stream,
    )
    return y, state
