"""Mamba-2 (SSD, state-space duality) block of the port (counterpart of
``repro/models/mamba2.py``).

Prefill runs the chunked SSD: the CUDA kernel of
:func:`repro_torch.kernels.ops.ssd` where the JAX package would call its
Pallas kernel (``use_kernels``, one B/C group, no carried state, S a
multiple of the chunk), else the plain chunked scan :func:`ssd_scan`,
which also takes a carried state (chunked prefill on the paged plane).
Decode is the O(1) recurrent update :func:`ssd_decode_step`.  Every
function keeps the JAX package's layouts: x ``(B, S, H, P)``, dt
``(B, S, H)`` f32, B/C ``(B, S, G, N)``, state ``(B, H, P, N)`` f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import rms_norm


def mamba_dims(cfg: ModelConfig):
    """(d_inner, heads, d_state, groups, head_dim, conv_width)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    h = s.n_heads(cfg.d_model)
    return di, h, s.d_state, s.n_groups, s.head_dim, s.conv_width


def mamba_param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, n, g, _, cw = mamba_dims(cfg)
    return {
        "w_z": (d, di),
        "w_x": (d, di),
        "w_bc": (d, 2 * g * n),
        "w_dt": (d, h),
        "dt_bias": (h,),
        "conv_x": (cw, di),
        "conv_bc": (cw, 2 * g * n),
        "A_log": (h,),
        "D": (h,),
        "norm_scale": (di,),
        "w_out": (di, d),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, written as the JAX package writes it."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------


def causal_conv(x, w, state=None):
    """x: (B, S, C), w: (cw, C); state: (B, cw-1, C) history or None.
    Returns (y (B, S, C), new_state (B, cw-1, C))."""
    cw = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], cw - 1, x.shape[-1]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+cw-1, C)
    s = x.shape[1]
    y = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(cw))
    new_state = xp[:, -(cw - 1):, :] if cw > 1 else state
    return y, new_state


def _gather_conv_state(raw, lens, cw: int, prior=None):
    """Last (cw-1) *valid* pre-activation conv inputs per sequence.

    raw: (B, S, C) pre-conv projections; returns (B, cw-1, C).  For a
    continuation chunk, ``prior`` is the previous conv state, so short
    chunks (lens < cw-1) still see earlier tokens."""
    b, _, c = raw.shape
    front = (prior.to(raw.dtype) if prior is not None
             else raw.new_zeros((b, cw - 1, c)))
    xp = torch.cat([front, raw], dim=1)
    idx = lens.long()[:, None] + torch.arange(cw - 1, device=raw.device)
    return torch.gather(xp, 1, idx[:, :, None].expand(b, cw - 1, c))


# ---------------------------------------------------------------------------
# Chunked SSD scan (prefill)
# ---------------------------------------------------------------------------


def ssd_scan(x, dt, a, b_mat, c_mat, *, chunk: int, init_state=None):
    """Chunked SSD, plain PyTorch (copy of ``repro/models/mamba2.py::
    ssd_scan``): S is padded to a multiple of the chunk, the state runs
    from ``init_state`` (zeros if None), B/C have G groups with H % G == 0.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    b_mat/c_mat: (B, S, G, N).  Returns (y (B, S, H, P) in x's dtype,
    final state (B, H, P, N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    hg = h // g
    q = min(chunk, s)
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state.float())
    iq = torch.arange(q, device=x.device)
    tri = (iq[:, None] >= iq[None, :])[None, :, :, None]
    ys = []
    for ci in range(nc):
        sl = slice(ci * q, (ci + 1) * q)
        xq, dtq, bq, cq = x[:, sl], dt[:, sl], b_mat[:, sl], c_mat[:, sl]
        daq = dtq * a                                   # (B, Q, H)
        cum = torch.cumsum(daq, dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, Q, H)
        l_mat = torch.where(tri, torch.exp(diff), 0.0)
        cqh = torch.repeat_interleave(cq, hg, dim=2).float()  # (B, Q, H, N)
        bqh = torch.repeat_interleave(bq, hg, dim=2)
        cb = torch.einsum("bqhn,bkhn->bhqk", cqh, bqh.float())
        m = (cb * l_mat.permute(0, 3, 1, 2)
             * dtq.permute(0, 2, 1)[:, :, None, :])
        y_diag = torch.einsum("bhqk,bkhp->bqhp", m, xq.float())
        y_off = torch.einsum("bqhn,bhpn->bqhp", cqh, state)
        y_off = y_off * torch.exp(cum)[..., None]
        decay_out = torch.exp(cum[:, -1:, :] - cum)
        # sum_k (dt_k decay_k) x_k (x) B_k as one product: the JAX
        # package's broadcast-and-sum, which eager PyTorch would
        # materialize at (B, Q, H, P, N)
        contrib = torch.einsum("bqhp,bqhn->bhpn", xq.float(),
                               (dtq * decay_out)[..., None] * bqh.float())
        state = (state * torch.exp(cum[:, -1, :])[:, :, None, None]
                 + contrib)
        ys.append((y_diag + y_off).to(x.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :s], state


def ssd_decode_step(state, x_t, dt_t, a, b_t, c_t):
    """One-token SSD update.  state: (B, H, P, N) f32; x_t: (B, H, P);
    dt_t: (B, H); b_t/c_t: (B, G, N).  Returns (y (B, H, P), new_state)."""
    h = x_t.shape[1]
    hg = h // b_t.shape[1]
    bh = torch.repeat_interleave(b_t, hg, dim=1).float()  # (B, H, N)
    ch = torch.repeat_interleave(c_t, hg, dim=1).float()
    da = torch.exp(dt_t * a)  # (B, H)
    new_state = state * da[..., None, None] + (
        dt_t[..., None, None] * bh[:, :, None, :]
        * x_t.float()[..., None])
    y = torch.einsum("bhpn,bhn->bhp", new_state, ch)
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------


def mamba_block(p: dict, x, cfg: ModelConfig, *, conv_state=None,
                ssm_state=None, decode: bool = False,
                use_kernels: bool = True, lens=None):
    """x: (B, S, d) -> (y (B, S, d), (conv_x, conv_bc, ssm)).

    ``conv_state`` is the ``(conv_x, conv_bc)`` history pair or None.
    ``lens`` (B,) marks right-padded prompts: pad positions get dt = 0,
    so the SSM state freezes at each sequence's true end, and the conv
    state is gathered from the last ``conv_width - 1`` *valid*
    positions.  The kernel route is taken exactly where the JAX package
    takes its Pallas kernel (``use_kernels``, G == 1, no carried state,
    S a multiple of the chunk)."""
    di, h, n, g, hp, cw = mamba_dims(cfg)
    bsz, s, _ = x.shape
    dt_f = x @ p["w_dt"]
    z = x @ p["w_z"]
    xs_raw = x @ p["w_x"]
    bc_raw = x @ p["w_bc"]
    prior_x, prior_bc = (None, None) if conv_state is None else conv_state
    xs, conv_x = causal_conv(xs_raw, p["conv_x"], prior_x)
    bc, conv_bc = causal_conv(bc_raw, p["conv_bc"], prior_bc)
    xs, bc = silu(xs), silu(bc)
    b_mat = bc[..., :g * n].reshape(bsz, s, g, n)
    c_mat = bc[..., g * n:].reshape(bsz, s, g, n)

    dt = F.softplus(dt_f.float() + p["dt_bias"].float())  # (B, S, H)
    if lens is not None and not decode:
        valid = torch.arange(s, device=x.device)[None, :] < lens[:, None]
        dt = dt * valid[..., None]  # pad positions: no state update
    a = -torch.exp(p["A_log"].float())  # (H,)
    xh = xs.reshape(bsz, s, h, hp)

    if decode:
        y_t, new_ssm = ssd_decode_step(ssm_state, xh[:, 0], dt[:, 0], a,
                                       b_mat[:, 0], c_mat[:, 0])
        y = y_t[:, None]
    elif (use_kernels and g == 1 and ssm_state is None
          and s % cfg.ssm.chunk_size == 0):
        y, new_ssm = ops.ssd(xh, dt, a, b_mat[:, :, 0].contiguous(),
                             c_mat[:, :, 0].contiguous(),
                             chunk=cfg.ssm.chunk_size)
    else:
        y, new_ssm = ssd_scan(xh, dt, a, b_mat, c_mat,
                              chunk=cfg.ssm.chunk_size, init_state=ssm_state)
    d_skip = p["D"].float()[None, None, :, None]
    y = (y.float() + d_skip * xh.float()).to(x.dtype)
    y = rms_norm(y.reshape(bsz, s, di) * silu(z), p["norm_scale"],
                 cfg.norm_eps)
    out = y @ p["w_out"]
    if lens is not None and not decode:
        conv_x = _gather_conv_state(xs_raw, lens, cw, prior_x)
        conv_bc = _gather_conv_state(bc_raw, lens, cw, prior_bc)
    return out, (conv_x, conv_bc, new_ssm)
