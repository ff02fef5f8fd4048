"""Model of the port (counterpart of ``repro/models/build.py``).

:class:`Model` is an ``nn.Module`` for configs whose layers are pre-norm
GQA attention + SwiGLU FFN blocks of kind ``dense``, ``local``
(sliding-window attention), ``global`` or ``encoder`` (bidirectional,
no cache), pre-norm GQA attention + a top-k mixture-of-experts FFN
(``moe``, :mod:`repro_torch.models.moe`), Mamba-2 blocks (``mamba``),
and invocations of one weight-shared attention block (``shared_attn``)
— the dense decoders' one segment, olmoe's and phi3.5-moe's one MoE
segment, gemma3's 5:1 local:global pattern, mamba2's 64 Mamba-2 layers,
zamba2's 13 x (5 Mamba-2 + the shared block) + 3 and hubert's 48
encoder layers.  The ``token+vq`` frontend (chameleon's VQ image tokens
in the text vocabulary) is the plain token path, as in JAX; the
``frames`` frontend (hubert) takes precomputed frame embeddings
``(B, S, d_model)`` and runs without RoPE.  It offers the JAX
``Model``'s API:

- training: ``forward`` (logits of every position and the summed MoE
  ``lb_loss``) and ``loss`` (masked mean cross-entropy + 0.01 * aux),
  with ``remat`` running each layer under ``torch.utils.checkpoint``;
- the paged plane: ``chunk_step`` (chunked prefill and decode over a
  paged KV pool), ``decode_block`` (K fused greedy decode iterations),
  ``spec_decode_block`` (one speculative verify pass),
  ``init_paged_cache`` / ``paged_cache_axes``;
- the slot plane: ``prefill`` (monolithic prompt prefill returning slot
  caches; none for an encoder-only model), ``decode_step``,
  ``decode_block_slots``, ``init_cache`` / ``cache_axes``;
- the ``supports_*`` properties;
- the sharding plan's knobs, as JAX's ``Model`` takes them (their
  values come from ``distributed.sharding.plan_arch``): ``kv_repeat``
  (K/V heads repeated after projection; caches hold ``n_kv_heads *
  kv_repeat`` heads), ``q_chunk`` (the plain prefill attention's query
  chunk) and ``vocab_pad`` (embedding and head rows that labels never
  index; logits and the loss's logsumexp include them, as in JAX), and
  the logical axes ``param_axes()`` / ``cache_logical_axes()``.

Parameters are built with ``requires_grad=False`` and the serving
methods run under ``torch.no_grad()``: serving never records a graph.
The trainer (:mod:`repro_torch.training.train_loop`) turns gradients on
for the parameters it trains, for the length of one ``loss`` call.

Layout: the JAX package stacks per-layer parameters by segment (and by
group and inner kind for periodic patterns, see
``repro/models/build.py::build_segments``); the port keeps **one flat
``layers`` list** in execution order with a per-layer kind and window
(0, or ``cfg.window`` for ``local``), which is the same sequence of
layers.  A ``shared_attn`` position holds no parameters of its own: it
runs the one :class:`DenseBlock` at ``shared`` (``params["shared"]`` in
JAX), with a cache of its own at each position.  Weights stay
``(in, out)`` as in the JAX package (``x @ w``); the output head is
``x @ table.T`` (the embedding table when tied).  ``embed`` is kept for
a frames model too, as JAX's ``init`` keeps it (no gradient reaches it;
weight decay still moves it).
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
K/V write of every paged ``chunk_step`` (the JAX package's dropping
scatter, which the plain route does with a host-side filter that a CUDA
graph cannot capture), the paged decode attention of a C == 1
``chunk_step``, the flash attention of every ``prefill`` and
``forward`` layer, the decode attention of ``decode_step`` on ``window
== 0`` layers, and the SSD scan of a Mamba-2 ``prefill`` or ``forward``
layer whose padded length is a multiple of the chunk (the gate of
``models/mamba2.py::mamba_block``).  With ``use_kernels=False`` they
take the plain routes the JAX model takes by default (the filtered
paged write, paged gather, chunked prefill attention with ``lens``,
masked decode attention, chunked SSD scan).  Local layers' decode
attention over the ring cache and the SSD of chunked prefill and of
decode are always plain routes, as in JAX.  No kernel has a backward,
in either package: the trainer builds the model with
``use_kernels=False``, JAX's ``build_model(cfg, remat=True)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, moe
from repro_torch.models.common import embed, init_dense, rms_norm, swiglu

MAMBA_LEAVES = ("conv_x", "conv_bc", "ssm")  # a Mamba-2 layer's cache


def _param(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class AttnBlock(nn.Module):
    """The pre-norm attention half of a layer; parameters as in the JAX
    tree (``attn``: wq wk wv wo [bq bk bv]; ``ln1``/``ln2`` RMSNorm
    scales)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
        kw = dict(dtype=dtype, device=device)
        shapes = {"wq": (d, qd), "wk": (d, kvd), "wv": (d, kvd),
                  "wo": (qd, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(qd,), bk=(kvd,), bv=(kvd,))
        self.attn = nn.ParameterDict(
            {n: _param(*s, **kw) for n, s in shapes.items()})
        self.ln1 = _param(d, **kw)
        self.ln2 = _param(d, **kw)


class DenseBlock(AttnBlock):
    """One pre-norm attention + SwiGLU layer (``ffn``: w_gate w_up
    w_down)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        d, f = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.ffn = nn.ParameterDict({
            "w_gate": _param(d, f, **kw), "w_up": _param(d, f, **kw),
            "w_down": _param(f, d, **kw),
        })


class MoEBlock(AttnBlock):
    """One pre-norm attention + mixture-of-experts layer (``moe``:
    w_router w_gate w_up w_down, the shapes of
    ``moe.moe_param_shapes``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__(cfg, dtype, device)
        kw = dict(dtype=dtype, device=device)
        self.moe = nn.ParameterDict({
            n: _param(*s, **kw)
            for n, s in moe.moe_param_shapes(cfg).items()})


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
                 device=None, use_kernels: bool = True, remat: bool = False,
                 kv_repeat: int = 1, q_chunk: int = 512, vocab_pad: int = 0):
        super().__init__()
        kinds = [k for k, n in cfg.layer_pattern() for _ in range(n)]
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        # forward/loss: recompute each layer in the backward pass (JAX's
        # jax.checkpoint(..., nothing_saveable) around each scanned layer)
        self.remat = remat
        # the sharding plan's knobs (see the module docstring)
        self.kv_repeat = kv_repeat
        self.q_chunk = q_chunk
        self.vocab_pad = vocab_pad
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
        v = cfg.vocab_size + vocab_pad
        self.embed = _param(v, cfg.d_model, **kw)
        self.final_norm = _param(cfg.d_model, **kw)
        self.head = (None if cfg.tie_embeddings
                     else _param(v, cfg.d_model, **kw))
        self.shared = (DenseBlock(cfg, dtype, self.device)
                       if "shared_attn" in kinds else None)
        # a shared_attn position holds no parameters: it runs self.shared
        block = {"mamba": MambaBlock, "moe": MoEBlock}
        self.layers = nn.ModuleList(
            nn.Identity() if k == "shared_attn"
            else block.get(k, DenseBlock)(cfg, dtype, self.device)
            for k in kinds)

    # -- init ---------------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from the JAX package's init distribution
        (``repro/models/common.py::init_dense``: normal, std
        1/sqrt(fan_in)); biases and norm scales stay zero.  Each tensor
        is filled in place, through an f32 draw of that tensor alone.  The
        numbers differ from JAX's for the same seed — tests load JAX's
        weights through ``convert.params_from_jax`` instead."""
        init_dense(self.embed, generator)
        if self.head is not None:
            init_dense(self.head, generator)
        for blk in [*self.layers, self.shared]:
            if isinstance(blk, MambaBlock):
                _init_mamba(blk, generator)
            elif isinstance(blk, AttnBlock):
                for name in ("wq", "wk", "wv", "wo"):
                    init_dense(blk.attn[name], generator)
                ffn = blk.moe if isinstance(blk, MoEBlock) else blk.ffn
                for w in ffn.values():
                    init_dense(w, generator)
        return self

    @property
    def n_kv_eff(self) -> int:
        """K/V heads a cache holds: ``n_kv_heads * kv_repeat``."""
        return self.cfg.n_kv_heads * self.kv_repeat

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
    def _mlp_out(self, blk: AttnBlock, x, ctx, *, with_aux: bool = False):
        """Attention output projection, residual, then the FFN half: the
        SwiGLU, or the MoE FFN over every row of the call (padding lanes
        and idle slots route and take capacity, as in JAX).  With
        ``with_aux``, returns (x, the layer's MoE ``lb_loss``, 0 for
        other layers) for ``forward``; the serving paths drop it, as the
        JAX serving paths do."""
        b, s = x.shape[:2]
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        x = x + ctx @ blk.attn["wo"]
        h = rms_norm(x, blk.ln2, self.cfg.norm_eps)
        aux = x.new_zeros((), dtype=torch.float32)
        if isinstance(blk, MoEBlock):
            y, moe_aux = moe.moe_ffn(blk.moe, h, self.cfg)
            aux = moe_aux["lb_loss"]
        else:
            f = blk.ffn
            y = swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
        return (x + y, aux) if with_aux else x + y

    def _qkv(self, blk: AttnBlock, x, positions):
        """Pre-norm Q/K/V; RoPE is off for a frames model, as JAX keys it
        on the frontend (not the kind)."""
        h = rms_norm(x, blk.ln1, self.cfg.norm_eps)
        return attn.project_qkv(blk.attn, h, self.cfg, positions=positions,
                                use_rope=self.cfg.frontend != "frames",
                                kv_repeat=self.kv_repeat)

    def _paged_layer(self, blk: AttnBlock, x, *, positions, kv_len,
                     k_pages, v_pages, page_table, start, chunk_lens, index):
        cfg = self.cfg
        s = x.shape[1]
        q, k, v = self._qkv(blk, x, positions)
        if index is None:
            # the kernel decides each lane on the card: no host sync, so
            # a decode iteration can be captured as a CUDA graph
            ops.paged_kv_write(k_pages, v_pages, k, v, page_table, start,
                               chunk_lens)
        else:
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

    def _seq_attention(self, q, k, v, window: int, lens):
        """Attention of every position of a whole sequence (``prefill``,
        ``forward``): the flash kernel, or the plain chunked attention
        with ``lens``.  The kernel route takes no ``lens``, as JAX's:
        right padding is harmless to a causal layer's valid rows, and a
        bidirectional (encoder) layer's padded keys are masked only on
        the plain route, so its kernel route wants full lengths."""
        if self.use_kernels:
            # the projections come out as transposed views
            return ops.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=self.cfg.causal,
                                       window=window)
        return attn.chunked_attention(q, k, v, lens=lens,
                                      causal=self.cfg.causal, window=window,
                                      q_chunk=self.q_chunk)

    def _prefill_layer(self, blk: AttnBlock, x, window: int, *, positions,
                       lens, cache_len: int):
        """One layer of a monolithic prefill; returns (x, its slot cache,
        None for an encoder-only model)."""
        q, k, v = self._qkv(blk, x, positions)
        ctx = self._seq_attention(q, k, v, window, lens)
        cache = (None if self.cfg.is_encoder_only
                 else _build_cache(k, v, lens, window, cache_len))
        return self._mlp_out(blk, x, ctx), cache

    def _decode_layer(self, blk: AttnBlock, x, window: int, cache: dict, *,
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

    def _embed_in(self, batch: dict):
        """The first layer's input: the token embeddings, or a frames
        model's frame embeddings ``(B, S, d_model)`` in the model's
        dtype (JAX's ``_embed_in``).  Token ids given to a frames model
        raise ``ValueError``, as the JAX model's shapes do."""
        if self.cfg.frontend != "frames":
            return embed(batch["tokens"], self.embed, self.dtype)
        frames = batch["frames"]
        if frames.dim() != 3 or frames.shape[-1] != self.cfg.d_model:
            raise ValueError(
                f"{self.cfg.name}: the frames frontend takes (B, S, "
                f"{self.cfg.d_model}) frame embeddings, got shape "
                f"{tuple(frames.shape)}")
        return frames.to(self.dtype)

    def _forward_layer(self, kind: str, blk, window: int, x, positions,
                       lens):
        """One layer of ``forward``: (x, its MoE ``lb_loss`` or 0).  A
        Mamba-2 layer runs with no ``lens``, as JAX's forward does."""
        if kind == "mamba":
            return (self._mamba_layer(blk, x)[0],
                    x.new_zeros((), dtype=torch.float32))
        q, k, v = self._qkv(blk, x, positions)
        ctx = self._seq_attention(q, k, v, window, lens)
        return self._mlp_out(blk, x, ctx, with_aux=True)

    def forward(self, batch: dict, return_aux: bool = False):
        """Full-sequence forward -> logits (B, S, V) in the model's dtype
        (and, with ``return_aux``, the MoE ``lb_loss`` summed over the
        layers, a 0-d f32 tensor).

        batch: ``tokens`` (B, S) int, or ``frames`` (B, S, d_model) for a
        frames model; optional ``lens`` (B,) valid lengths (default S),
        read by the plain attention route only.  Records a graph when
        gradients are on and a parameter requires them; with ``remat``
        each layer runs under ``torch.utils.checkpoint`` and is
        recomputed in the backward pass."""
        x = self._embed_in(batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device).expand(b, s)
        lens = batch.get("lens")
        if lens is None:
            lens = torch.full((b,), s, dtype=torch.int32, device=x.device)
        aux = x.new_zeros((), dtype=torch.float32)
        for kind, blk, window, _ in self.blocks():
            args = (kind, blk, window, x, positions, lens)
            if self.remat:
                x, a = checkpoint(self._forward_layer, *args,
                                  use_reentrant=False)
            else:
                x, a = self._forward_layer(*args)
            aux = aux + a
        logits = self._logits(x)
        return (logits, aux) if return_aux else logits

    def loss(self, batch: dict) -> torch.Tensor:
        """Next-token (or masked-prediction) cross-entropy + 0.01 x the
        MoE balance aux: the mean over positions of logsumexp - the
        label's logit, in f32, weighted by ``batch["mask"]`` where the
        batch has one (divided by max(sum(mask), 1))."""
        logits, aux = self.forward(batch, return_aux=True)
        logits32 = logits.float()
        lse = torch.logsumexp(logits32, dim=-1)
        ll = logits32.gather(-1, batch["labels"].long()[..., None])[..., 0]
        tok_loss = lse - ll
        mask = batch.get("mask")
        if mask is None:
            ce = tok_loss.mean()
        else:
            mask = mask.float()
            ce = (tok_loss * mask).sum() / mask.sum().clamp(min=1.0)
        return ce + 0.01 * aux

    def _chunk_hidden(self, caches, page_table, tokens, start, chunk_lens):
        """The layers of a chunk over *paged* caches: the hidden states
        (B, C, d) of every lane, before the final norm; the caches are
        written in place (arguments as :meth:`chunk_step`'s)."""
        c = tokens.shape[1]
        x = embed(tokens, self.embed, self.dtype)
        steps = torch.arange(c, dtype=torch.int32, device=tokens.device)
        positions = start[:, None] + steps[None, :]
        valid = steps[None, :] < chunk_lens[:, None]
        pools, state = _paged_parts(caches)
        index = None   # the write kernel's route (kernels, on the card)
        if pools is not None and not (self.use_kernels
                                      and tokens.device.type == "cuda"):
            # the plain route: one host-side filter shared by the layers
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
                page_table=page_table, start=start, chunk_lens=chunk_lens,
                index=index,
            )
        return x

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
        x = self._chunk_hidden(caches, page_table, tokens, start, chunk_lens)
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

    @torch.no_grad()
    def spec_decode_block(self, caches, page_table, last, pos, alive, rem,
                          eos: int, max_len: int, props, prop_lens, *,
                          k: int):
        """One propose-verify-accept speculative dispatch over *paged*
        caches: score ``last`` plus up to ``k`` drafted tokens in one
        forward pass (a C == k + 1 chunk, through plain chunk attention),
        then accept the longest prefix of the proposal that greedy
        decode would have produced itself.

        props: (B, K) int32 drafted continuations; prop_lens: (B,) int32
        valid draft counts (0 rides along as a plain 1-token decode).
        Lane ``i`` holds the token whose KV lands at position ``pos + i``
        and whose logits greedily pick the token for ``pos + i + 1``, so
        ``t[:, i]`` is what ``i`` plain decode steps emit as long as
        every earlier proposal matched.  The stopping predicate of
        :meth:`decode_block` runs per lane, so EOS / l_out / max_len cut
        the accepted span where per-token decode would stop.  Returns
        ``(tokens (B, K+1), valid (B, K+1), last, pos), caches``;
        ``valid`` is prefix-contiguous per row.  Rejected lanes' K/V
        stays in the pages past the returned ``pos`` (the caches are
        written in place): ``kv_len`` masks it, the caller truncates the
        page table to ``pos`` and the next write overwrites it.
        """
        b = last.shape[0]
        dev = last.device
        tokens = torch.cat([last[:, None], props], dim=1)
        chunk_lens = torch.where(alive, 1 + prop_lens,
                                 torch.zeros_like(prop_lens)).to(torch.int32)
        x = self._chunk_hidden(caches, page_table, tokens, pos, chunk_lens)
        t = self._logits(x).argmax(dim=-1).to(torch.int32)   # (B, K+1)
        idx = torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :]
        # lane i+1 is reachable iff proposal i matched the greedy pick
        # of lane i (and was a real draft); lane 0 always is
        match = (props == t[:, :k]) & (idx[:, :k] < prop_lens[:, None])
        ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
        reach = torch.cat(
            [ones, torch.cumprod(match.to(torch.int32), dim=1).bool()],
            dim=1)
        # per-lane stopping, evaluated as if the lane's token had been
        # appended by a plain decode step (mirrors _decode_block_body)
        new_pos_i = pos[:, None] + idx + 1
        new_rem_i = rem[:, None] - (idx + 1)
        done_i = (new_rem_i <= 0) | (t == eos) | (new_pos_i + 1 >= max_len)
        stopped_before = torch.cat(
            [~ones, torch.cumsum(done_i.to(torch.int32), dim=1)[:, :-1] > 0],
            dim=1)
        valid = alive[:, None] & reach & ~stopped_before
        emitted = valid.sum(dim=1, dtype=torch.int32)
        new_pos = pos + emitted
        pick = (emitted - 1).clamp(0, k).long()
        last_tok = torch.take_along_dim(t, pick[:, None], dim=1)[:, 0]
        new_last = torch.where(emitted > 0, last_tok, last)
        return (t, valid, new_last, new_pos), caches

    # -- slot plane ---------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, tokens_or_frames, lens, *,
                cache_len: Optional[int] = None):
        """Monolithic prefill of right-padded prompts.

        tokens_or_frames: (B, S) token ids, or (B, S, d_model) frames for
        a frames model; lens: (B,) valid lengths.  Returns (logits
        (B, V) at each row's last valid token, slot caches — one entry
        per layer: ``{"k", "v", "pos"}`` for attention, global layers
        padded to ``cache_len`` positions with pos -1, local layers in
        ring order; ``{"conv_x", "conv_bc", "ssm"}`` at each row's true
        end for Mamba-2; None for every layer of an encoder-only model,
        which JAX builds no cache for either).
        """
        key = "frames" if self.cfg.frontend == "frames" else "tokens"
        x = self._embed_in({key: tokens_or_frames})
        b, s = x.shape[:2]
        cache_len = cache_len or s
        positions = torch.arange(s, device=x.device).expand(b, s)
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

    def init_cache(self, batch_size: int, max_len: int, device=None) -> list:
        """Zeroed slot caches, one dict per layer, on ``device`` (default:
        the model's; ``"meta"`` gives shapes only).  Attention: K/V
        (B, Hkv, S, hd) in the model's dtype with S = ``min(window,
        max_len)`` for local layers and ``max_len`` otherwise; pos
        (B, S) int32, -1 = empty.  Mamba-2: ``_mamba_state`` with no
        lead dim."""
        cfg = self.cfg
        device = self.device if device is None else device
        kw = dict(dtype=self.dtype, device=device)
        out = []
        for kind, window in zip(self.kinds, self.windows):
            if kind == "mamba":
                out.append(self._mamba_state((), batch_size, device))
                continue
            slen = min(window, max_len) if window else max_len
            shape = (batch_size, self.n_kv_eff, slen, cfg.resolved_head_dim)
            out.append({
                "k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
                "pos": torch.full((batch_size, slen), -1, dtype=torch.int32,
                                  device=device),
            })
        return out

    def cache_axes(self) -> list:
        """Batch axis of each slot-cache leaf (0: one row per slot)."""
        return [dict.fromkeys(MAMBA_LEAVES if k == "mamba"
                              else ("k", "v", "pos"), 0)
                for k in self.kinds]

    def _mamba_state(self, lead: tuple, batch_size: int,
                     device=None) -> dict:
        """Zeroed Mamba-2 state with leading dims ``lead``: conv histories
        (…, B, cw-1, d_inner) and (…, B, cw-1, 2GN) in the model's dtype,
        the SSM state (…, B, H, P, N) in f32 (``_mamba_cache`` in JAX)."""
        di, h, n, g, p, cw = mamba2.mamba_dims(self.cfg)
        device = self.device if device is None else device
        kw = dict(dtype=self.dtype, device=device)
        return {
            "conv_x": torch.zeros(lead + (batch_size, cw - 1, di), **kw),
            "conv_bc": torch.zeros(lead + (batch_size, cw - 1, 2 * g * n),
                                   **kw),
            "ssm": torch.zeros(lead + (batch_size, h, p, n),
                               dtype=torch.float32, device=device),
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
            shape = (self.n_attn, n_pages, self.n_kv_eff, page_size,
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

    # -- logical axes (the sharding plans) ------------------------------------
    def param_axes(self) -> dict:
        """Logical axes of every parameter, by its name in
        ``named_parameters``: JAX's ``Model.param_axes()`` leaf for leaf,
        without the lead ``"layers"`` entries of its stacked leaves (the
        port's layers are a flat list)."""
        out = {"embed": ("vocab", "fsdp"), "final_norm": (None,)}
        if self.head is not None:
            out["head"] = ("vocab", "fsdp")
        if self.shared is not None:
            out.update(_block_axes(self.shared, "shared."))
        for i, blk in enumerate(self.layers):
            out.update(_block_axes(blk, f"layers.{i}."))
        return out

    def cache_logical_axes(self) -> list:
        """Logical axes of every leaf of :meth:`init_cache`'s caches, one
        dict per layer (JAX's ``cache_logical_axes()`` without the lead
        ``"layers"`` entries)."""
        attn_axes = {"k": ("batch", "kv_heads", "cache_seq", None),
                     "v": ("batch", "kv_heads", "cache_seq", None),
                     "pos": ("batch", "cache_seq")}
        mamba_axes = {"conv_x": ("batch", None, "ssm_inner"),
                      "conv_bc": ("batch", None, None),
                      "ssm": ("batch", "ssm_heads", None, None)}
        return [dict(mamba_axes if k == "mamba" else attn_axes)
                for k in self.kinds]


def seeded_model(cfg: ModelConfig, device=None, seed: int = 0, *,
                 dtype=torch.float32) -> Model:
    """``cfg``'s model on ``device`` (resolved as by ``Model``) with the
    weights :meth:`Model.init` draws from a generator seeded with
    ``seed``: what the examples serve, and what an engine-plane
    ``Cluster`` given no ``seed_params`` draws from ``cfg.seed``."""
    model = Model(cfg, dtype=dtype, device=device)
    return model.init(torch.Generator(device=model.device).manual_seed(seed))


def _block_axes(blk: nn.Module, prefix: str) -> dict:
    """Logical axes of one block's parameters, named ``prefix`` + their
    name in the block (JAX's ``_block_axes`` with no lead dim)."""
    table = {"attn": attn.ATTN_PARAM_AXES, "moe": moe.MOE_PARAM_AXES,
             "mamba": mamba2.MAMBA_PARAM_AXES,
             "ffn": {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
                     "w_down": ("ff", "fsdp")}}
    out = {}
    for name, _ in blk.named_parameters():
        part, _, leaf = name.partition(".")
        out[prefix + name] = table[part][leaf] if leaf else (None,)
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
