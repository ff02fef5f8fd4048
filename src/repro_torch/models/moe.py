"""Top-k mixture-of-experts FFN (counterpart of ``repro/models/moe.py``).

The same function as the JAX package's sort-based dispatch: route every
row of the call (padding lanes and idle slots included) in the input
dtype, take the top-k of the f32 softmax and renormalise the gates;
stable-sort the flattened ``(token, k)`` assignments by expert, give each
its position in its expert's run (index minus run start) and drop those
at or past ``capacity(cfg, rows)``; run the experts as one batched
SwiGLU over the ``(G, E, C, d)`` buffer; combine weighted by gate.

Two choices keep it deterministic on the card, where it runs as torch
ops (the JAX package's expert products are plain einsums, outside any
Pallas kernel):

- the top-k is a stable descending sort, so equal probabilities pick the
  lower expert id first, as ``jax.lax.top_k`` does;
- the buffer is written and read through flat row indices with one spare
  row that takes every dropped assignment (written, never read back:
  its gather reads a zero row), and the combine un-sorts the weighted
  contributions to ``(T, k, d)`` and sums over ``k`` — no
  ``index_add_``, whose atomics would make bf16 sums vary from run to
  run.  JAX adds the contributions into zeros in expert order instead;
  the two orders agree exactly for two experts a token and within f32
  rounding otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def moe_param_shapes(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d = cfg.d_model
    return {
        "w_router": (d, m.num_experts),
        "w_gate": (m.num_experts, d, m.expert_d_ff),
        "w_up": (m.num_experts, d, m.expert_d_ff),
        "w_down": (m.num_experts, m.expert_d_ff, d),
    }

# Logical axes of each parameter (JAX's ``MOE_PARAM_AXES``)
MOE_PARAM_AXES = {
    "w_router": ("fsdp", None),
    "w_gate": ("experts", "fsdp", "ff"),
    "w_up": ("experts", "fsdp", "ff"),
    "w_down": ("experts", "ff", "fsdp"),
}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """The router of :func:`moe_ffn` on x (G, Tg, d): (probs (G, Tg, E)
    f32, renormalised gates (G, Tg, k) f32, selected experts (G, Tg, k)
    int64, in descending probability, the lower id first on a tie)."""
    k = cfg.moe.top_k
    logits = (x @ params["w_router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = gate[..., :k], sel[..., :k]
    return probs, gate / gate.sum(dim=-1, keepdim=True), sel


def dispatch(sel: torch.Tensor, cap: int):
    """Sort-based dispatch of the selections sel (G, Tg, k): the stable
    sort of the flattened assignments by expert (``order``, (G, Tg*k)),
    their experts in that order, each one's position in its expert's
    run (index minus run start) and whether it fits in ``cap``."""
    g, tg, k = sel.shape
    flat_e = sel.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    run_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(tg * k, device=sel.device)[None, :] - run_start
    return order, sorted_e, pos_in_e, pos_in_e < cap


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y (B, S, d), aux: ``lb_loss`` and ``drop_frac``,
    0-d f32 tensors)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    g = m.dispatch_groups if (m.dispatch_groups and
                              t % m.dispatch_groups == 0) else 1
    tg = t // g
    cap = capacity(cfg, tg)
    xg = x.reshape(g, tg, d)
    probs, gate, sel = route(params, xg, cfg)

    # --- sort-based dispatch, per group -------------------------------------
    order, sorted_e, pos_in_e, keep = dispatch(sel, cap)
    tok = order // k
    # flat row of each kept assignment in the (G * E * C) buffer; every
    # dropped one goes to the spare row at the end
    gi = torch.arange(g, device=x.device)[:, None]
    row = torch.where(keep, (gi * e + sorted_e) * cap + pos_in_e, g * e * cap)
    src = xg.gather(1, tok[..., None].expand(-1, -1, d))
    buf = x.new_zeros((g * e * cap + 1, d))
    buf[row.reshape(-1)] = src.reshape(-1, d)
    h = buf[:-1].view(g, e, cap, d)

    # --- expert swiglu ------------------------------------------------------
    wg = params["w_gate"].to(x.dtype)
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    act = F.silu(torch.einsum("gecd,edf->gecf", h, wg))
    act = act * torch.einsum("gecd,edf->gecf", h, wu)
    out = torch.einsum("gecf,efd->gecd", act, wd)

    # --- combine ------------------------------------------------------------
    out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])
    gate_sorted = gate.reshape(g, tg * k).gather(-1, order).to(x.dtype)
    contrib = out[row.reshape(-1)].view(g, tg * k, d) * gate_sorted[..., None]
    # un-sort to (token, k) order, then sum each token's k contributions
    unsorted = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(-1, -1, d), contrib)
    y = unsorted.view(g, tg, k, d).sum(dim=2)

    # --- aux: switch-style load-balance loss + stats ------------------------
    me = probs.reshape(t, e).mean(dim=0)  # mean router prob per expert
    ce = F.one_hot(sel.reshape(t, k), e).sum(dim=1).float().mean(dim=0)
    lb_loss = e * torch.sum(me * ce) / k
    drop_frac = (~keep).sum().float() / (t * k)
    aux = {"lb_loss": lb_loss, "drop_frac": drop_frac}
    return y.reshape(b, s, d), aux
