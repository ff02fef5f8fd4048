"""Mamba-2 SSD scan on the card: wrapper of ``csrc/ssd.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd.py::ssd``: the
chunked SSD of one B/C group, carrying the (P, N) state from chunk to
chunk.  Bound by bytes at the models' shapes (x, y, B, C and dt cross
device memory once; the least work, ``C B^T`` once per (b, chunk) and
the per-head products, takes less time on the tensor cores).  bf16 at
``TC_DIMS`` (mamba2's and zamba2's head and state) runs the tensor-core
instance (``ssd_tc_launch``: a ``C B^T`` pass into a workspace this
wrapper allocates, then the scan, two CUDA kernels counted as one
launch); every other case the CUDA-core instance (``ssd_launch``).  The
source file says what bounds each.  Its plain PyTorch version is
``repro_torch.kernels.ref.ssd_ref`` (the sequential recurrence);
``ref.ssd_chunk_cb_ref`` and ``ref.ssd_chunk_scan_ref`` state the
tensor-core instance's two passes; :mod:`repro_torch.kernels.ops` picks
between kernel and plain version by device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the (head_dim, d_state) pairs ssd.cu is built for
DIMS = ((64, 128), (64, 64), (8, 16), (16, 32), (32, 64))
TC_DIMS = ((64, 128), (64, 64))   # bf16 on the tensor cores
TC_CHUNK = 64                     # the tensor-core scan's own chunk


def uses_tensor_cores(x, n: int) -> bool:
    """Whether ``ssd`` runs the tensor-core instance for x of this shape
    and dtype with d_state ``n``."""
    return (x.dtype == torch.bfloat16 and (x.shape[3], n) in TC_DIMS
            and x.shape[1] % TC_CHUNK == 0)


def ssd(x, dt, a, b_mat, c_mat, *, chunk: int = 256, fma: bool = False):
    """x: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32 (negative);
    b_mat, c_mat: (B, S, N) in x's dtype; ``S % chunk == 0`` and
    ``chunk % 16 == 0``.  Returns (y (B, S, H, P) in x's dtype, final
    state (B, H, P, N) f32).  Launches the CUDA kernel on the current
    stream; raises on anything the kernel does not take and on a failed
    launch.  ``fma`` runs the CUDA-core instance whatever the dtype (a
    yardstick for the tensor-core one; the model never asks for it)."""
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
    ptrs = (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), y.data_ptr(), state.data_ptr())
    if not fma and uses_tensor_cores(x, n):
        # C B^T of every 64-row chunk, f32, read by every head
        ws = torch.empty(bsz * s * TC_CHUNK, dtype=torch.float32,
                         device=x.device)
        _build.launch("ssd", *ptrs, ws.data_ptr(), bsz, s, h, p, n, stream,
                      entry="ssd_tc_launch")
    else:
        _build.launch("ssd", *ptrs, _build.DTYPE_CODE[x.dtype], bsz, s, h,
                      p, n, chunk, stream)
    return y, state
