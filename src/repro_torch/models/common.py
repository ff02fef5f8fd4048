"""Shared model building blocks (counterpart of ``repro/models/common.py``).

Weights keep the JAX package's ``(in, out)`` layout: a projection is
``x @ w``, and the output head is ``x @ table.T``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` affine, computed in f32."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (
        torch.arange(half, dtype=torch.float32, device=device) / half
    ))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the halves (x[..., :h], x[..., h:]) by position-dependent
    angles, in f32.  x: (..., seq, head_dim); positions broadcastable to
    (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.T.to(x.dtype)


def init_dense(t: torch.Tensor, generator: torch.Generator,
               scale: float = 1.0) -> torch.Tensor:
    """Fill ``t`` in place from the JAX package's init distribution:
    normal with std ``scale / sqrt(fan_in)``, fan_in = shape[-2] (the
    ``in`` axis of an ``(in, out)`` weight), drawn in f32."""
    fan_in = t.shape[-2] if t.dim() >= 2 else t.shape[-1]
    std = scale / (fan_in ** 0.5)
    draw = torch.randn(t.shape, generator=generator, dtype=torch.float32,
                       device=t.device)
    with torch.no_grad():
        t.copy_(draw.mul_(std))
    return t
