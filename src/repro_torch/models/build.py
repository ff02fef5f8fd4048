"""Model of the port (counterpart of ``repro/models/build.py``).

:class:`Model` is an ``nn.Module`` for configs whose layers are pre-norm
GQA attention + SwiGLU FFN blocks of kind ``dense``, ``local``
(sliding-window attention) or ``global`` — qwen7b's one dense segment,
and gemma3's 5:1 local:global pattern.  It offers the JAX ``Model``'s
API for both engine planes:

- the paged plane: ``chunk_step`` (chunked prefill and decode over a
  paged KV pool), ``decode_block`` (K fused greedy decode iterations),
  ``init_paged_cache`` / ``paged_cache_axes``;
- the slot plane: ``prefill`` (monolithic prompt prefill returning slot
  caches), ``decode_step``, ``decode_block_slots``, ``init_cache`` /
  ``cache_axes``;
- the ``supports_*`` properties.

Other segment kinds raise ``NotImplementedError`` naming their ROADMAP
item.

Layout: the JAX package stacks per-layer parameters by segment (and by
group and inner kind for gemma3's periodic pattern, see
``repro/models/build.py::build_segments``); the port keeps **one flat
``layers`` list** in execution order with a per-layer window (0, or
``cfg.window`` for ``local``), which is the same sequence of layers.
Weights stay ``(in, out)`` as in the JAX package (``x @ w``); the
output head is ``x @ table.T`` (the embedding table when tied).
:func:`repro_torch.models.convert.params_from_jax` maps the JAX tree
onto ``layers.{i}.…`` without transposes.  Caches are written in place:
the page pools are one tensor per K and V with a leading layer dim,
``(L, NP, Hkv, ps, hd)``; slot caches are one ``{"k", "v", "pos"}`` dict
per layer, because local layers hold ``min(window, max_len)`` positions
in ring order and global layers ``max_len``.

On the card the attention hot spots go through the CUDA kernels of
:mod:`repro_torch.kernels.ops` (their plain versions on the CPU): the
paged decode attention of a C == 1 ``chunk_step``, the flash attention
of every ``prefill`` layer, and the decode attention of ``decode_step``
on ``window == 0`` layers.  With ``use_kernels=False`` they take the
plain routes the JAX model takes by default (paged gather, chunked
prefill attention, masked decode attention).  Local layers' decode
attention over the ring cache is always the plain route, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.common import embed, init_dense, rms_norm, swiglu

# segment kinds the port does not run yet -> the ROADMAP item that adds them
_LATER = {
    "moe": "ROADMAP.md §1 'MoE'",
    "mamba": "ROADMAP.md §1 'Mamba-2 + hybrid'",
    "shared_attn": "ROADMAP.md §1 'Mamba-2 + hybrid'",
    "encoder": "ROADMAP.md §1 'Encoder and frames frontend'",
}
ATTN_KINDS = ("dense", "local", "global")


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DenseBlock(nn.Module):
    """One pre-norm attention + SwiGLU layer; parameters as in the JAX
    tree (``attn``: wq wk wv wo [bq bk bv]; ``ffn``: w_gate w_up w_down;
    ``ln1``/``ln2`` RMSNorm scales)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
        qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
        kw = dict(dtype=dtype, device=device)
        shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                  "wo": (qd, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
        self.attn = nn.ParameterDict(
            {n: _param(*s, **kw) for n, s in shapes.items()})
        self.ffn = nn.ParameterDict({
            "w_gate": _param(d, f, **kw), "w_up": _param(d, f, **kw),
            "w_down": _param(f, d, **kw),
        })
        self.ln1 = _param(d, **kw)
        self.ln2 = _param(d, **kw)


class Model(nn.Module):
    """Attention decoder for both engine planes.  ``device`` defaults to
    CUDA (and raises without a card); tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None, use_kernels: bool = True):
        super().__init__()
        kinds = [k for k, n in cfg.layer_pattern() for _ in range(n)]
        for k in kinds:
            if k not in ATTN_KINDS:
                raise NotImplementedError(
                    f"{cfg.name}: '{k}' segments are not ported yet "
                    f"({_LATER.get(k, 'ROADMAP.md §1')})"
                )
        if cfg.frontend != "token":
            raise NotImplementedError(
                f"{cfg.name}: the '{cfg.frontend}' frontend is not ported "
                f"yet ({_LATER['encoder']})"
            )
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        # per layer, in execution order: its window (0 = full attention)
        self.windows = [cfg.window if k == "local" else 0 for k in kinds]
        kw = dict(dtype=dtype, device=self.device)
        self.embed = _param(cfg.vocab_size, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.head = (None if cfg.tie_embeddings
                     else _param(cfg.vocab_size, cfg.d_model, **kw))
        self.layers = nn.ModuleList(
            DenseBlock(cfg, dtype, self.device) for _ in range(cfg.n_layers))

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from the JAX package's init distribution
        (``repro/models/common.py::init_dense``: normal, std
        1/sqrt(fan_in)); biases and norm scales stay zero.  The numbers
        differ from JAX's for the same seed — tests load JAX's weights
        through ``convert.params_from_jax`` instead."""
        init_dense(self.embed, generator)
        if self.head is not None:
            init_dense(self.head, generator)
        for blk in self.layers:
            for name in ("wq", "wk", "wv", "wo"):
                init_dense(blk.attn[name], generator)
            for w in blk.ffn.values():
                init_dense(w, generator)
        return self

    # -- capability flags (mirror the JAX Model) ------------------------------
    def _kinds(self) -> set:
        return {k for k, _ in self.cfg.layer_pattern()}

    @property
    def supports_chunked(self) -> bool:
        if self.cfg.is_encoder_only or self.cfg.frontend == "frames":
            return False
        return self._kinds() <= {"dense", "moe", "mamba", "global",
                                 "shared_attn"}

    @property
    def supports_prefix_cache(self) -> bool:
        return self.supports_chunked and "mamba" not in self._kinds()

    @property
    def supports_spec_decode(self) -> bool:
        return self.supports_prefix_cache

    # -- forward --------------------------------------------------------------
    def _mlp_out(self, blk: DenseBlock, x, ctx):
        """Attention output projection, residual, then the FFN half."""
        b, s = x.shape[:2]
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        x = x + ctx @ blk.attn["wo"]
        h = rms_norm(x, blk.ln2, self.cfg.norm_eps)
        f = blk.ffn
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])

    def _qkv(self, blk: DenseBlock, x, positions):
        h = rms_norm(x, blk.ln1, self.cfg.norm_eps)
        return attn.project_qkv(blk.attn, h, self.cfg, positions=positions)

    def _paged_layer(self, blk: DenseBlock, x, *, positions, kv_len,
                     k_pages, v_pages, page_table, index):
        cfg = self.cfg
        s = x.shape[1]
        q, k, v = self._qkv(blk, x, positions)
        attn.update_paged_cache(k_pages, v_pages, index, k, v)
        if self.use_kernels and s == 1:
            # GQA is resolved inside the kernel — the pool stays at Hkv
            ctx = ops.paged_decode_attention(
                q[:, :, 0, :].contiguous(), k_pages, v_pages, page_table,
                kv_len,
            )[:, :, None, :]
        else:
            ctx = attn.paged_chunk_attention(
                q, k_pages, v_pages, page_table, q_pos=positions,
                kv_len=kv_len, causal=cfg.causal,
            )
        return self._mlp_out(blk, x, ctx)

    def _prefill_layer(self, blk: DenseBlock, x, window: int, *, positions,
                       lens, cache_len: int):
        """One layer of a monolithic prefill; returns (x, its slot
        cache).  Right padding needs no ``lens`` on the kernel route:
        every layer is causal, so valid rows never see padded keys."""
        cfg = self.cfg
        q, k, v = self._qkv(blk, x, positions)
        if self.use_kernels:
            # the projections come out as transposed views
            ctx = ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=cfg.causal,
                                      window=window)
        else:
            ctx = attn.chunked_attention(q, k, v, lens=lens,
                                         causal=cfg.causal, window=window)
        return self._mlp_out(blk, x, ctx), _build_cache(k, v, lens, window,
                                                         cache_len)

    def _decode_layer(self, blk: DenseBlock, x, window: int, cache: dict, *,
                      pos, lens):
        """One layer of a slot-plane decode step; writes the new token
        into ``cache`` in place."""
        cfg = self.cfg
        q, k, v = self._qkv(blk, x, pos[:, None])
        attn.update_cache(cache, k, v, pos, window=window)
        if self.use_kernels and window == 0:
            # GQA is resolved inside the kernel — the cache stays at Hkv
            ctx = ops.decode_attention(
                q[:, :, 0, :].contiguous(), cache["k"], cache["v"], lens,
            )[:, :, None, :]
        else:
            ctx = attn.decode_attention(
                q, cache["k"], cache["v"], q_pos=pos, kv_pos=cache["pos"],
                kv_len=lens, causal=cfg.causal, window=window,
            )
        return self._mlp_out(blk, x, ctx)

    def _logits(self, x_last):
        table = self.embed if self.head is None else self.head
        return rms_norm(x_last, self.final_norm, self.cfg.norm_eps) @ table.T

    @torch.no_grad()
    def chunk_step(self, caches, page_table, tokens, start, chunk_lens):
        """Unified chunked-prefill / decode step over *paged* caches.

        tokens: (B, C) right-padded chunk tokens; start: (B,) int32
        absolute position of each row's first token; chunk_lens: (B,)
        int32 valid counts — 0 freezes a row (its writes are dropped),
        so idle decode slots ride along.  page_table: (B, MP) int32.
        Returns (logits (B, V) at each row's last valid token, caches);
        the caches are updated in place.  Decode is the C == 1 case.
        """
        b, c = tokens.shape
        x = embed(tokens, self.embed, self.dtype)
        steps = torch.arange(c, dtype=torch.int32, device=tokens.device)
        positions = start[:, None] + steps[None, :]
        valid = steps[None, :] < chunk_lens[:, None]
        pools = caches[0]
        ps = pools["k_pages"].shape[3]
        index = attn.paged_write_index(page_table, positions, valid, ps)
        kv_len = positions[:, 0] + chunk_lens
        for i, blk in enumerate(self.layers):
            x = self._paged_layer(
                blk, x, positions=positions, kv_len=kv_len,
                k_pages=pools["k_pages"][i], v_pages=pools["v_pages"][i],
                page_table=page_table, index=index,
            )
        idx = (chunk_lens - 1).clamp(0, c - 1).long()
        return self._logits(x[torch.arange(b, device=x.device), idx]), caches

    # -- fused decode blocks ---------------------------------------------------
    @staticmethod
    def _decode_block_body(last, pos, alive, rem, eos: int, max_len: int,
                           logits):
        """Post-logits state transition: greedy pick, then the engine's
        stopping predicate (output cap, EOS, or no room for another
        token within max_len) evaluated on the device."""
        nxt = logits.argmax(dim=-1).to(torch.int32)
        step = alive.to(torch.int32)
        tok = torch.where(alive, nxt, last)      # frozen rows keep state
        new_pos = pos + step
        new_rem = rem - step
        done = (new_rem <= 0) | (tok == eos) | (new_pos + 1 >= max_len)
        return tok, new_pos, alive & ~done, new_rem

    @torch.no_grad()
    def decode_block(self, caches, page_table, last, pos, alive, rem,
                     eos: int, max_len: int, *, k: int):
        """K greedy decode iterations over *paged* caches, as a Python
        loop of C == 1 ``chunk_step`` calls with no host round-trip for
        tokens or stopping in between.

        last/pos/rem: (B,) int32; alive: (B,) bool (False rows — idle
        or mid-prefill slots — are frozen: zero chunk length drops
        their writes); eos: -1 disables.  Returns ``(tokens (B, K),
        valid (B, K), last, pos), caches`` — ``valid[b, i]`` marks lanes
        that really emitted a token.
        """
        toks, valids = [], []
        for _ in range(k):
            logits, caches = self.chunk_step(
                caches, page_table, last[:, None], pos,
                alive.to(torch.int32),
            )
            tok, pos, new_alive, rem = self._decode_block_body(
                last, pos, alive, rem, eos, max_len, logits,
            )
            toks.append(tok)
            valids.append(alive)
            last, alive = tok, new_alive
        return (torch.stack(toks, 1), torch.stack(valids, 1), last,
                pos), caches

    # -- slot plane ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens, lens, *, cache_len: Optional[int] = None):
        """Monolithic prefill of right-padded prompts.

        tokens: (B, S); lens: (B,) valid lengths.  Returns (logits (B, V)
        at each row's last valid token, slot caches — one
        ``{"k", "v", "pos"}`` per layer, global layers padded to
        ``cache_len`` positions with pos -1, local layers in ring order).
        """
        b, s = tokens.shape
        cache_len = cache_len or s
        x = embed(tokens, self.embed, self.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        caches = []
        for blk, window in zip(self.layers, self.windows):
            x, cache = self._prefill_layer(blk, x, window, positions=positions,
                                           lens=lens, cache_len=cache_len)
            caches.append(cache)
        idx = (lens - 1).clamp(0, s - 1).long()
        return self._logits(x[torch.arange(b, device=x.device), idx]), caches

    @torch.no_grad()
    def decode_step(self, caches, tokens, pos):
        """tokens: (B,) int32 last sampled; pos: (B,) their positions.
        Returns (logits (B, V), caches); the caches are updated in
        place."""
        x = embed(tokens[:, None], self.embed, self.dtype)
        lens = pos + 1
        for blk, window, cache in zip(self.layers, self.windows, caches):
            x = self._decode_layer(blk, x, window, cache, pos=pos, lens=lens)
        return self._logits(x[:, 0]), caches

    @torch.no_grad()
    def decode_block_slots(self, caches, last, pos, alive, rem, eos: int,
                           max_len: int, *, k: int):
        """Slot-plane twin of :meth:`decode_block`: K ``decode_step``s in
        a Python loop.  The slot plane has no chunk-length freeze, so a
        finished or idle row re-runs its last token at its frozen
        position (an idempotent cache write) and its lanes come back
        invalid; the engine clears the row when it retires."""
        toks, valids = [], []
        for _ in range(k):
            logits, caches = self.decode_step(caches, last, pos)
            tok, pos, new_alive, rem = self._decode_block_body(
                last, pos, alive, rem, eos, max_len, logits,
            )
            toks.append(tok)
            valids.append(alive)
            last, alive = tok, new_alive
        return (torch.stack(toks, 1), torch.stack(valids, 1), last,
                pos), caches

    def init_cache(self, batch_size: int, max_len: int) -> list:
        """Zeroed slot caches, one ``{"k", "v", "pos"}`` per layer: K/V
        (B, Hkv, S, hd) in the model's dtype with S = ``min(window,
        max_len)`` for local layers and ``max_len`` otherwise; pos
        (B, S) int32, -1 = empty."""
        cfg = self.cfg
        kw = dict(dtype=self.dtype, device=self.device)
        out = []
        for window in self.windows:
            slen = min(window, max_len) if window else max_len
            shape = (batch_size, cfg.n_kv_heads, slen, cfg.resolved_head_dim)
            out.append({
                "k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "pos": torch.full((batch_size, slen), -1, dtype=torch.int32,
                                  device=self.device),
            })
        return out

    def cache_axes(self) -> list:
        """Batch axis of each slot-cache leaf (0: one row per slot)."""
        return [{"k": 0, "v": 0, "pos": 0} for _ in self.layers]

    # -- cache allocation -------------------------------------------------------
    def init_paged_cache(self, n_slots: int, max_len: int, page_size: int,
                         n_pages: Optional[int] = None) -> list:
        """Zeroed page pools: ``[{"k_pages", "v_pages"}]``, one entry per
        segment, each pool (L, NP, Hkv, ps, hd) in the model's dtype."""
        if not self.supports_chunked:
            raise ValueError(
                f"{self.cfg.name}: paged caches need chunk-capable layers "
                f"(no local windows); use init_cache")
        cfg = self.cfg
        if n_pages is None:
            n_pages = n_slots * (-(-max_len // page_size))
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                 cfg.resolved_head_dim)
        kw = dict(dtype=self.dtype, device=self.device)
        return [{"k_pages": torch.zeros(shape, **kw),
                 "v_pages": torch.zeros(shape, **kw)}]

    def paged_cache_axes(self) -> list:
        """Batch axis of each cache leaf; page pools have none — the
        page allocator reclaims them, never row surgery."""
        return [{"k_pages": None, "v_pages": None}]


def _build_cache(k, v, lens, window: int, cache_len: int) -> dict:
    """A prefill layer's slot cache: the last ``window`` tokens in ring
    order for a local layer; otherwise every position, with pos -1 past
    each row's length and padded to ``cache_len``."""
    if window > 0:
        kc, vc, pos = attn.build_local_cache(k, v, lens, window)
        return {"k": kc, "v": vc, "pos": pos}
    b, _, s, _ = k.shape
    ar = torch.arange(s, device=k.device)
    pos = torch.where(ar[None, :] < lens[:, None], ar[None, :], -1)
    pos = pos.to(torch.int32).expand(b, s)
    if cache_len > s:
        padw = cache_len - s
        k = F.pad(k, (0, 0, 0, padw))
        v = F.pad(v, (0, 0, 0, padw))
        pos = F.pad(pos, (0, padw), value=-1)
    return {"k": k, "v": v, "pos": pos}
