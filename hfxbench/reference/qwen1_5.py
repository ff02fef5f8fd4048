"""Plain PyTorch forward of the dense Qwen1.5 decoder (transformers'
``Qwen2ForCausalLM``), written from its published description, for
judging what the engine served.

Per layer: ``x += o(attn(rope(q(n1(x))), rope(k(n1(x))), v(n1(x))))``
with biases on Q, K and V, causal attention over every earlier position
with K/V heads shared by groups of query heads (``repeat_kv``), scale
``1/sqrt(head_dim)``; then ``x += down(silu(gate(n2(x))) * up(n2(x)))``.
``n`` is RMSNorm, ``x * rsqrt(mean(x^2) + eps) * w``; the rotary
embedding rotates the halves ``(x[:h], x[h:])`` by
``pos * theta^(-2i/head_dim)``.  Logits are ``norm(x) @ head.T``.

Departures from transformers' layout, none of them in the arithmetic:
matrices are stored ``(in, out)`` and applied as ``x @ w``, and a norm
weight ``w`` is given as ``scale`` with ``w = 1 + scale`` (the
benchmark's weights are drawn so).

Everything runs in float32 with TF32 off; ``precision`` rounds the
inputs of every product to a lower precision instead, for the controls
that the limit is set against.  Work goes layer by layer over all the
sequences at once, upcasting one layer's weights at a time, so a model
whose weights fill the card can be judged beside them.  Imports nothing
of the program under test.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest float8_e4m3fn


def _round(x: torch.Tensor, precision: str, dim: int) -> torch.Tensor:
    """``x`` (f32) as a product's input in ``precision``: ``bf16``
    rounds each element; ``fp8`` scales each slice along ``dim`` to the
    e4m3 range (per token for activations, per output channel for
    weights), rounds and scales back."""
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def _mm(x, w, precision: str):
    return _round(x, precision, -1) @ _round(w, precision, 0)


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + scale)


def rope(x, theta: float):
    """x: (H, S, hd), positions 0 .. S-1."""
    s, hd = x.shape[-2], x.shape[-1]
    half = hd // 2
    inv = theta ** (-torch.arange(0, half, dtype=torch.float64,
                                  device=x.device) * 2 / hd)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, precision: str, q_block: int = 512):
    """Causal attention of (H, S, hd) queries over (Hkv, S, hd) keys and
    values, in blocks of queries."""
    h, s, hd = q.shape
    group = h // k.shape[0]
    k = k.repeat_interleave(group, 0)
    v = v.repeat_interleave(group, 0)
    k, v = _round(k, precision, -1), _round(v, precision, -1)
    out = torch.empty_like(q)
    pos = torch.arange(s, device=q.device)
    for a in range(0, s, q_block):
        b = min(s, a + q_block)
        scores = (_round(q[:, a:b], precision, -1) @ k.transpose(1, 2)
                  ) * hd ** -0.5
        scores.masked_fill_(pos[None, :] > pos[a:b, None], float("-inf"))
        out[:, a:b] = torch.softmax(scores, -1) @ v
    return out


def _layer(x, w: dict, cfg: dict, precision: str):
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg["hidden_size"] // h
    s = x.shape[0]
    n = rms_norm(x, w["ln1"], eps)
    q, k, v = (_mm(n, w["wq"], precision), _mm(n, w["wk"], precision),
               _mm(n, w["wv"], precision))
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.view(s, h, hd).transpose(0, 1), theta)
    k = rope(k.view(s, hkv, hd).transpose(0, 1), theta)
    v = v.view(s, hkv, hd).transpose(0, 1)
    ctx = attention(q, k, v, precision).transpose(0, 1).reshape(s, h * hd)
    x = x + _mm(ctx, w["wo"], precision)
    n = rms_norm(x, w["ln2"], eps)
    act = torch.nn.functional.silu(_mm(n, w["w_gate"], precision))
    return x + _mm(act * _mm(n, w["w_up"], precision), w["w_down"], precision)


@torch.no_grad()
def final_hidden(weights: dict, cfg: dict, seqs: list, precisions: list,
                 device) -> dict:
    """For each precision, the final-normed hidden state (S, d) of every
    sequence of token ids in ``seqs``, from the same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ids = [torch.as_tensor(s, device=device).long() for s in seqs]
    embed = weights["embed"]
    xs = {p: [embed[i].float() for i in ids] for p in precisions}
    names = [n for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "ln1",
                         "ln2", "w_gate", "w_up", "w_down") if n in weights]
    for layer in range(cfg["num_hidden_layers"]):
        w = {n: weights[n][layer].to(device).float() for n in names}
        for p in precisions:
            xs[p] = [_layer(x, w, cfg, p) for x in xs[p]]
        del w
    fn = weights["final_norm"].to(device).float()
    return {p: [rms_norm(x, fn, cfg["rms_norm_eps"]) for x in xs[p]]
            for p in precisions}


def head(weights: dict) -> torch.Tensor:
    return weights.get("head", weights["embed"])


@torch.no_grad()
def logits(weights: dict, hidden: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """Logits (S, V) of hidden states (S, d), in blocks of the vocabulary
    so that only one f32 block of the head is alive at a time."""
    table = head(weights)
    out = torch.empty(hidden.shape[0], table.shape[0], device=hidden.device)
    step = max(1, (1 << 28) // (4 * table.shape[1]))   # 256 MiB of f32
    for a in range(0, table.shape[0], step):
        w = table[a:a + step].to(hidden.device).float()
        out[:, a:a + step] = _mm(hidden, w.T, precision)
    return out
