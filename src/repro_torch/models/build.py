"""Model of the port (counterpart of ``repro/models/build.py``).

:class:`Model` is an ``nn.Module`` for configs whose layers are pre-norm
GQA attention + SwiGLU FFN blocks of kind ``dense``, ``local``
(sliding-window attention) or ``global``, Mamba-2 blocks (``mamba``),
and invocations of one weight-shared attention block (``shared_attn``)
— qwen7b's one dense segment, gemma3's 5:1 local:global pattern,
mamba2's 64 Mamba-2 layers and zamba2's 13 x (5 Mamba-2 + the shared
block) + 3.  It offers the JAX ``Model``'s API for both engine planes:

- the paged plane: ``chunk_step`` (chunked prefill and decode over a
  paged KV pool), ``decode_block`` (K fused greedy decode iterations),
  ``init_paged_cache`` / ``paged_cache_axes``;
- the slot plane: ``prefill`` (monolithic prompt prefill returning slot
  caches), ``decode_step``, ``decode_block_slots``, ``init_cache`` /
  ``cache_axes``;
- the ``supports_*`` properties.

Other segment kinds (``moe``, ``encoder``) raise ``NotImplementedError``
naming their ROADMAP item.

Layout: the JAX package stacks per-layer parameters by segment (and by
group and inner kind for periodic patterns, see
``repro/models/build.py::build_segments``); the port keeps **one flat
``layers`` list** in execution order with a per-layer kind and window
(0, or ``cfg.window`` for ``local``), which is the same sequence of
layers.  A ``shared_attn`` position holds no parameters of its own: it
runs the one :class:`DenseBlock` at ``shared`` (``params["shared"]`` in
JAX), with a cache of its own at each position.  Weights stay
``(in, out)`` as in the JAX package (``x @ w``); the output head is
``x @ table.T`` (the embedding table when tied).
:func:`repro_torch.models.convert.params_from_jax` maps the JAX tree
onto ``layers.{i}.…`` and ``shared.…`` without transposes.

Caches.  Slot caches are one dict per layer: ``{"k", "v", "pos"}`` for
attention (local layers hold ``min(window, max_len)`` positions in ring
order, the others ``max_len``) and ``{"conv_x", "conv_bc", "ssm"}`` for
Mamba-2 (conv histories ``(B, cw-1, ·)`` in the model's dtype, the SSM
state ``(B, H, P, N)`` in f32), batch axis 0.  Paged caches are a list
of at most two entries: the attention layers' page pools
``{"k_pages", "v_pages"}``, each ``(L_attn, NP, Hkv, ps, hd)`` with no
batch axis (the allocator reclaims pages), and the Mamba-2 layers'
slot-resident state ``{"conv_x", "conv_bc", "ssm"}``, each with a
leading ``L_mamba`` dim and the batch on axis 1 — SSM and conv state is
O(1) per sequence and stays in slot rows, as in the JAX package.  Both
are written in place.

On the card the hot spots go through the CUDA kernels of
:mod:`repro_torch.kernels.ops` (their plain versions on the CPU): the
paged decode attention of a C == 1 ``chunk_step``, the flash attention
of every ``prefill`` layer, the decode attention of ``decode_step`` on
``window == 0`` layers, and the SSD scan of a Mamba-2 ``prefill`` layer
whose padded length is a multiple of the chunk (the gate of
``models/mamba2.py::mamba_block``).  With ``use_kernels=False`` they
take the plain routes the JAX model takes by default (paged gather,
chunked prefill attention, masked decode attention, chunked SSD scan).
Local layers' decode attention over the ring cache and the SSD of
chunked prefill and of decode are always plain routes, as in JAX.
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
from repro_torch.models import mamba2
from repro_torch.models.common import embed, init_dense, rms_norm, swiglu

# segment kinds the port does not run yet -> the ROADMAP item that adds them
_LATER = {
    "moe": "ROADMAP.md §1 'MoE'",
    "encoder": "ROADMAP.md §1 'Encoder and frames frontend'",
}
PORTED_KINDS = ("dense", "local", "global", "mamba", "shared_attn")
MAMBA_LEAVES = ("conv_x", "conv_bc", "ssm")  # a Mamba-2 layer's cache


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


class MambaBlock(nn.Module):
    """One pre-norm Mamba-2 layer; parameters as in the JAX tree
    (``mamba``: the shapes of ``mamba2.mamba_param_shapes``; ``ln`` the
    RMSNorm scale)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.mamba = nn.ParameterDict({
            n: _param(*s, **kw)
            for n, s in mamba2.mamba_param_shapes(cfg).items()})
        self.ln = _param(cfg.d_model, **kw)


def _init_mamba(blk: MambaBlock, generator: torch.Generator) -> None:
    """The JAX package's Mamba-2 init (``repro/models/mamba2.py::
    init_mamba``): A_log = log U(1, 16); dt_bias = softplus^-1 of
    U(1e-3, 1e-1); D = 1; norm scales 0; projections and convs normal
    with std 1/sqrt(fan_in)."""

    def uniform(t, lo, hi):
        return (torch.rand(t.shape, generator=generator, device=t.device)
                * (hi - lo) + lo)

    with torch.no_grad():
        for name, t in blk.mamba.items():
            if name == "A_log":
                t.copy_(torch.log(uniform(t, 1.0, 16.0)))
            elif name == "dt_bias":
                dt = uniform(t, 1e-3, 1e-1)
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
            elif name == "D":
                t.fill_(1.0)
            elif name == "norm_scale":
                t.zero_()
            else:
                init_dense(t, generator)


class Model(nn.Module):
    """Decoder for both engine planes.  ``device`` defaults to CUDA (and
    raises without a card); tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None, use_kernels: bool = True):
        super().__init__()
        kinds = [k for k, n in cfg.layer_pattern() for _ in range(n)]
        for k in kinds:
            if k not in PORTED_KINDS:
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
        # per layer, in execution order: its kind, its window (0 = full
        # attention), and its row in the stacked paged caches (the K/V
        # pools of attention layers, the state of Mamba-2 layers)
        self.kinds = kinds
        self.windows = [cfg.window if k == "local" else 0 for k in kinds]
        is_mamba = [k == "mamba" for k in kinds]
        self.cache_row = [sum(m == is_mamba[i] for m in is_mamba[:i])
                          for i in range(len(kinds))]
        self.n_mamba = sum(is_mamba)
        self.n_attn = len(kinds) - self.n_mamba
        kw = dict(dtype=dtype, device=self.device)
        self.embed = _param(cfg.vocab_size, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.head = (None if cfg.tie_embeddings
                     else _param(cfg.vocab_size, cfg.d_model, **kw))
        self.shared = (DenseBlock(cfg, dtype, self.device)
                       if "shared_attn" in kinds else None)
        # a shared_attn position holds no parameters: it runs self.shared
        self.layers = nn.ModuleList(
            MambaBlock(cfg, dtype, self.device) if k == "mamba"
            else nn.Identity() if k == "shared_attn"
            else DenseBlock(cfg, dtype, self.device) for k in kinds)

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
        for blk in [*self.layers, self.shared]:
            if isinstance(blk, MambaBlock):
                _init_mamba(blk, generator)
            elif isinstance(blk, DenseBlock):
                for name in ("wq", "wk", "wv", "wo"):
                    init_dense(blk.attn[name], generator)
                for w in blk.ffn.values():
                    init_dense(w, generator)
        return self

    def blocks(self):
        """(kind, block, window, cache row) of every layer in execution
        order; a ``shared_attn`` layer's block is ``self.shared``."""
        for i, kind in enumerate(self.kinds):
            blk = self.shared if kind == "shared_attn" else self.layers[i]
            yield kind, blk, self.windows[i], self.cache_row[i]

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

    def _mamba_layer(self, blk: MambaBlock, x, *, conv_state=None,
                     ssm_state=None, decode=False, lens=None):
        """One pre-norm Mamba-2 layer; returns (x, (conv_x, conv_bc,
        ssm))."""
        h = rms_norm(x, blk.ln, self.cfg.norm_eps)
        y, state = mamba2.mamba_block(
            blk.mamba, h, self.cfg, conv_state=conv_state,
            ssm_state=ssm_state, decode=decode,
            use_kernels=self.use_kernels, lens=lens)
        return x + y, state

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
        pools, state = _paged_parts(caches)
        if pools is not None:
            ps = pools["k_pages"].shape[3]
            index = attn.paged_write_index(page_table, positions, valid, ps)
        kv_len = positions[:, 0] + chunk_lens
        for kind, blk, _, row in self.blocks():
            if kind == "mamba":
                x, new = self._mamba_layer(
                    blk, x, conv_state=(state["conv_x"][row],
                                        state["conv_bc"][row]),
                    ssm_state=state["ssm"][row], lens=chunk_lens)
                # a row of chunk length 0 comes back exactly as it was
                for name, t in zip(MAMBA_LEAVES, new):
                    state[name][row].copy_(t)
                continue
            x = self._paged_layer(
                blk, x, positions=positions, kv_len=kv_len,
                k_pages=pools["k_pages"][row], v_pages=pools["v_pages"][row],
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
        at each row's last valid token, slot caches — one dict per layer:
        ``{"k", "v", "pos"}`` for attention, global layers padded to
        ``cache_len`` positions with pos -1, local layers in ring order;
        ``{"conv_x", "conv_bc", "ssm"}`` at each row's true end for
        Mamba-2).
        """
        b, s = tokens.shape
        cache_len = cache_len or s
        x = embed(tokens, self.embed, self.dtype)
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        caches = []
        for kind, blk, window, _ in self.blocks():
            if kind == "mamba":
                x, (cx, cbc, ssm) = self._mamba_layer(blk, x, lens=lens)
                cache = {"conv_x": cx, "conv_bc": cbc, "ssm": ssm}
            else:
                x, cache = self._prefill_layer(
                    blk, x, window, positions=positions, lens=lens,
                    cache_len=cache_len)
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
        for (kind, blk, window, _), cache in zip(self.blocks(), caches):
            if kind == "mamba":
                x, new = self._mamba_layer(
                    blk, x, conv_state=(cache["conv_x"], cache["conv_bc"]),
                    ssm_state=cache["ssm"], decode=True)
                cache.update(zip(MAMBA_LEAVES, new))
            else:
                x = self._decode_layer(blk, x, window, cache, pos=pos,
                                       lens=lens)
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
        """Zeroed slot caches, one dict per layer.  Attention: K/V
        (B, Hkv, S, hd) in the model's dtype with S = ``min(window,
        max_len)`` for local layers and ``max_len`` otherwise; pos
        (B, S) int32, -1 = empty.  Mamba-2: ``_mamba_state`` with no
        lead dim."""
        cfg = self.cfg
        kw = dict(dtype=self.dtype, device=self.device)
        out = []
        for kind, window in zip(self.kinds, self.windows):
            if kind == "mamba":
                out.append(self._mamba_state((), batch_size))
                continue
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
        return [dict.fromkeys(MAMBA_LEAVES if k == "mamba"
                              else ("k", "v", "pos"), 0)
                for k in self.kinds]

    def _mamba_state(self, lead: tuple, batch_size: int) -> dict:
        """Zeroed Mamba-2 state with leading dims ``lead``: conv histories
        (…, B, cw-1, d_inner) and (…, B, cw-1, 2GN) in the model's dtype,
        the SSM state (…, B, H, P, N) in f32 (``_mamba_cache`` in JAX)."""
        di, h, n, g, p, cw = mamba2.mamba_dims(self.cfg)
        kw = dict(dtype=self.dtype, device=self.device)
        return {
            "conv_x": torch.zeros(lead + (batch_size, cw - 1, di), **kw),
            "conv_bc": torch.zeros(lead + (batch_size, cw - 1, 2 * g * n),
                                   **kw),
            "ssm": torch.zeros(lead + (batch_size, h, p, n),
                               dtype=torch.float32, device=self.device),
        }

    # -- cache allocation -------------------------------------------------------
    def init_paged_cache(self, n_slots: int, max_len: int, page_size: int,
                         n_pages: Optional[int] = None) -> list:
        """Zeroed paged-plane caches: the attention layers' page pools
        ``{"k_pages", "v_pages"}``, each (L_attn, NP, Hkv, ps, hd) in the
        model's dtype, then the Mamba-2 layers' slot-resident state
        (``_mamba_state`` with lead dim L_mamba, one row per slot); an
        entry whose layers the model lacks is left out."""
        if not self.supports_chunked:
            raise ValueError(
                f"{self.cfg.name}: paged caches need chunk-capable layers "
                f"(no local windows); use init_cache")
        cfg = self.cfg
        if n_pages is None:
            n_pages = n_slots * (-(-max_len // page_size))
        out = []
        if self.n_attn:
            shape = (self.n_attn, n_pages, cfg.n_kv_heads, page_size,
                     cfg.resolved_head_dim)
            kw = dict(dtype=self.dtype, device=self.device)
            out.append({"k_pages": torch.zeros(shape, **kw),
                        "v_pages": torch.zeros(shape, **kw)})
        if self.n_mamba:
            out.append(self._mamba_state((self.n_mamba,), n_slots))
        return out

    def paged_cache_axes(self) -> list:
        """Batch axis of each cache leaf: page pools have none — the
        page allocator reclaims them, never row surgery; Mamba-2 state
        has one row per slot, on axis 1."""
        out = []
        if self.n_attn:
            out.append({"k_pages": None, "v_pages": None})
        if self.n_mamba:
            out.append(dict.fromkeys(MAMBA_LEAVES, 1))
        return out


def _paged_parts(caches) -> tuple:
    """(page pools or None, Mamba-2 state or None) of paged caches."""
    pools = next((c for c in caches if "k_pages" in c), None)
    state = next((c for c in caches if "ssm" in c), None)
    return pools, state


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
