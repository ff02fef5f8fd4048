"""Model of the port's paged plane (counterpart of ``repro/models/build.py``).

:class:`Model` is an ``nn.Module`` for configs whose layer pattern is
one ``dense`` segment (pre-norm GQA attention + SwiGLU FFN), which is
what the paged serving plane runs for the paper's qwen7b.  It offers
the JAX ``Model``'s paged-plane API: ``chunk_step`` (chunked prefill and
decode over a paged KV pool), ``decode_block`` (K fused greedy decode
iterations), ``init_paged_cache`` / ``paged_cache_axes`` and the
``supports_*`` properties.  Other segment kinds raise
``NotImplementedError`` naming their ROADMAP item.

Layout: weights stay ``(in, out)`` as in the JAX package (``x @ w``);
the output head is ``x @ table.T``; parameter names follow the JAX tree
(``layers.{i}.attn.wq`` is ``segments[0]["attn"]["wq"][i]``), so
:func:`repro_torch.models.convert.params_from_jax` maps one onto the
other without transposes.  The page pools are one tensor per K and V
with a leading layer dim, ``(L, NP, Hkv, ps, hd)``, written in place.

The decode attention of a C == 1 step goes through
:func:`repro_torch.kernels.ops.paged_decode_attention` (the CUDA kernel
on the card, its plain version on the CPU) unless ``use_kernels`` is
False, in which case it takes the plain gather path that prefill
chunks use.
"""

from __future__ import annotations

from typing import Optional

import torch
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
    "local": "ROADMAP.md §1 'Slot plane'",
    "global": "ROADMAP.md §1 'Slot plane'",
    "encoder": "ROADMAP.md §1 'Slot plane'",
}


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
    """Dense decoder on the paged plane.  ``device`` defaults to CUDA
    (and raises without a card); tests pass ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None, use_kernels: bool = True):
        super().__init__()
        kinds = [k for k, _ in cfg.layer_pattern()]
        for k in kinds:
            if k != "dense":
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
    def _attn_block(self, blk: DenseBlock, x, *, positions, kv_len,
                    k_pages, v_pages, page_table, index):
        cfg = self.cfg
        b, s = x.shape[:2]
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = attn.project_qkv(blk.attn, h, cfg, positions=positions)
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
        ctx = ctx.transpose(1, 2).reshape(b, s, -1)
        x = x + ctx @ blk.attn["wo"]
        h = rms_norm(x, blk.ln2, cfg.norm_eps)
        f = blk.ffn
        return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])

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
        cfg = self.cfg
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
            x = self._attn_block(
                blk, x, positions=positions, kv_len=kv_len,
                k_pages=pools["k_pages"][i], v_pages=pools["v_pages"][i],
                page_table=page_table, index=index,
            )
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        idx = (chunk_lens - 1).clamp(0, c - 1).long()
        x_last = x[torch.arange(b, device=x.device), idx]
        table = self.embed if self.head is None else self.head
        return x_last @ table.T, caches

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

    # -- cache allocation -------------------------------------------------------
    def init_paged_cache(self, n_slots: int, max_len: int, page_size: int,
                         n_pages: Optional[int] = None) -> list:
        """Zeroed page pools: ``[{"k_pages", "v_pages"}]``, one entry per
        segment, each pool (L, NP, Hkv, ps, hd) in the model's dtype."""
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

