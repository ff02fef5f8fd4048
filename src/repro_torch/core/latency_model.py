"""Stage latency models (paper Eq. 1, Eq. 2, Appendix A).

    E_p = a + b * sum(l_in) + c * sum(l_in^2)        (prefill batch)
    E_d = a' + b' * sum(l_cur) + c' * B              (one decode step)

Two sources of coefficients:

- :class:`AnalyticLatencyModel` — roofline-derived ground truth for a
  model config on given hardware (used by the event simulator as the
  "real machine").  Prefill is compute-bound (b = 2*N_active / peak),
  decode is memory-bound (a' = weight bytes / HBM bw,
  b' = KV bytes/token / HBM bw).
- :class:`FittedLatencyModel` — least-squares fit from profiled
  (batch, lengths, t_p, t_d) samples, exactly the paper's profiler.
  Schedulers only ever see a *fitted* model, preserving the
  predictor-error structure of the real system.

A copy of ``repro/core/latency_model.py``, kept line for line but for
an added ``H100`` entry (the port imports nothing from the JAX
package).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-chip roofline constants (defaults: TPU v5e)."""

    peak_flops: float = 197e12       # bf16 FLOP/s
    hbm_bw: float = 819e9            # bytes/s
    ici_bw: float = 50e9             # bytes/s per link (D2D)
    disk_bw: float = 3.5e9           # bytes/s (weight loading)
    host_bw: float = 12e9            # bytes/s host->device
    flops_eff: float = 0.55          # achievable fraction of peak (prefill)
    bw_eff: float = 0.75             # achievable fraction of HBM bw
    # per-instance accelerator memory for KV-capacity accounting in the
    # serving simulator (the paper's Ascend NPUs carry 64 GB each)
    hbm_capacity: float = 64e9


TPU_V5E = Hardware()

# Ascend-NPU-calibrated profile for the paper's Table-2 hardware: the
# three published D2D times all imply ~16 GB/s effective per-device-pair
# bandwidth (15.4GB/0.89s, 32.5GB/2.05s, 17.6GB/1.16s).
ASCEND_910 = Hardware(ici_bw=20e9, host_bw=2.5e9, disk_bw=3.7e9)

# NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet: 989 TFLOP/s dense bf16,
# 3.35 TB/s HBM3, 80 GB.  The link, host and disk rates are first guesses
# (NVLink 4 at 450 GB/s a direction, a PCIe Gen5 host copy, an NVMe read):
# the TLManager replaces each with the observed rate once the first
# provision through that transport has run (``observe_weight_load``).
H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9,
                disk_bw=3.5e9, host_bw=25e9, hbm_capacity=80e9)


@dataclasses.dataclass
class LatencyCoeffs:
    a: float   # prefill fixed overhead (s)
    b: float   # prefill per-token (s)
    c: float   # prefill per-token^2 (s)
    a_d: float  # decode fixed per step (s)
    b_d: float  # decode per cached token (s)
    c_d: float  # decode per sequence in batch (s)


class LatencyModel:
    """Eq. 1 / Eq. 2 evaluation given coefficients."""

    def __init__(self, coeffs: LatencyCoeffs):
        self.coeffs = coeffs

    def prefill_time(self, lens: Sequence[int]) -> float:
        if not len(lens):
            return 0.0
        k = self.coeffs
        s1 = float(sum(lens))
        s2 = float(sum(x * x for x in lens))
        return k.a + k.b * s1 + k.c * s2

    def decode_step_time(self, cur_lens: Sequence[int]) -> float:
        if not len(cur_lens):
            return 0.0
        k = self.coeffs
        return k.a_d + k.b_d * float(sum(cur_lens)) + k.c_d * len(cur_lens)

    def spec_step_time(self, cur_lens: Sequence[int],
                       n_spec_tokens: int) -> float:
        """Cost of one propose-verify speculative dispatch: a decode
        step widened by ``n_spec_tokens`` extra verify lanes, each
        priced at the prefill per-token rate (the verify pass is a
        short chunked prefill over the same weights)."""
        return (self.decode_step_time(cur_lens)
                + self.coeffs.b * max(0, int(n_spec_tokens)))

    # Convenience for Eq. 5 (token budget) — a, b of the prefill model.
    @property
    def a(self) -> float:
        return self.coeffs.a

    @property
    def b(self) -> float:
        return self.coeffs.b


class AnalyticLatencyModel(LatencyModel):
    """Ground-truth coefficients from the model/hardware roofline."""

    def __init__(self, cfg: ModelConfig, hw: Hardware = TPU_V5E,
                 tp: int = 1, dtype_bytes: int = 2):
        n_active = cfg.active_param_count()
        flops_rate = hw.peak_flops * hw.flops_eff * tp
        bw = hw.hbm_bw * hw.bw_eff * tp

        b = 2.0 * n_active / flops_rate
        # quadratic attention term per token^2 (4*L*H*hd flops / token^2)
        hd = cfg.resolved_head_dim
        n_attn_layers = sum(
            cnt for kind, cnt in cfg.layer_pattern()
            if kind not in ("mamba",)
        )
        c = 4.0 * n_attn_layers * cfg.n_heads * hd / flops_rate

        weight_bytes = cfg.active_param_count() * dtype_bytes
        a_d = weight_bytes / bw
        kv_bytes_per_tok = self._kv_bytes_per_token(cfg, dtype_bytes)
        b_d = kv_bytes_per_tok / bw
        # c' (per-sequence step overhead: sampling, batch bookkeeping,
        # kernel launches) ~1 ms/seq — this is what makes E_d grow with
        # batch size on the paper's NPUs and TPOT bind under load.
        super().__init__(LatencyCoeffs(
            a=0.003, b=b, c=c, a_d=a_d, b_d=b_d, c_d=1e-3,
        ))
        self.cfg = cfg
        self.hw = hw
        self.tp = tp

    @staticmethod
    def _kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int) -> float:
        hd = cfg.resolved_head_dim
        total = 0.0
        for kind, cnt in cfg.layer_pattern():
            if kind == "mamba":
                continue  # O(1) state: no per-token KV growth
            total += cnt * 2 * cfg.n_kv_heads * hd * dtype_bytes
        return total


class FittedLatencyModel(LatencyModel):
    """Least-squares fit from profiled samples (Appendix A)."""

    def __init__(self):
        super().__init__(LatencyCoeffs(0.0, 1e-4, 0.0, 0.0, 1e-6, 0.0))
        self._p_samples: list[tuple[float, float, float]] = []
        self._d_samples: list[tuple[float, float, float]] = []
        self.fitted = False

    def n_samples(self) -> int:
        """Total profiled observations (prefill + decode) — lets
        callers skip refitting when nothing new landed without reaching
        into the sample storage."""
        return len(self._p_samples) + len(self._d_samples)

    def observe_prefill(self, lens: Sequence[int], t: float) -> None:
        s1 = float(sum(lens))
        s2 = float(sum(x * x for x in lens))
        self._p_samples.append((s1, s2, t))

    def observe_decode(self, cur_lens: Sequence[int], t: float) -> None:
        self._d_samples.append(
            (float(sum(cur_lens)), float(len(cur_lens)), t)
        )

    def observe_decode_block(self, lens_per_iter: Sequence[Sequence[int]],
                             t: float) -> None:
        """Attribute one fused K-iteration decode block (wall time
        ``t``) as K per-iteration Eq. 2 samples of ``t / K`` each, so
        the fit stays comparable with per-token stepping.

        Wall time is attributed to *emitted* tokens only: trailing
        all-empty iterations (every row finished — or, under
        speculation, every lane past the accepted prefix was rejected)
        are trimmed before dividing ``t``, so rejected speculative
        lanes never dilute the per-iteration cost and bias the Eq. 5
        decode fit low (which would make admission over-promise).
        Interior empty iterations still carry no sample — their share
        of the wall time is engine overhead the intercept absorbs."""
        k = len(lens_per_iter)
        while k > 0 and not lens_per_iter[k - 1]:
            k -= 1
        if k == 0:
            return
        per = t / k
        for lens in lens_per_iter[:k]:
            if lens:
                self.observe_decode(lens, per)

    def fit(self, min_samples: int = 8) -> bool:
        ok = True
        if len(self._p_samples) >= min_samples:
            arr = np.asarray(self._p_samples)
            x = np.stack(
                [np.ones(len(arr)), arr[:, 0], arr[:, 1]], axis=1
            )
            # minimize squared *relative* error (paper App. A): weight rows
            w = 1.0 / np.maximum(arr[:, 2], 1e-6)
            sol, *_ = np.linalg.lstsq(
                x * w[:, None], arr[:, 2] * w, rcond=None
            )
            a, b, c = [max(0.0, float(v)) for v in sol]
            self.coeffs.a, self.coeffs.b, self.coeffs.c = a, b, c
        else:
            ok = False
        if len(self._d_samples) >= min_samples:
            arr = np.asarray(self._d_samples)
            x = np.stack(
                [np.ones(len(arr)), arr[:, 0], arr[:, 1]], axis=1
            )
            w = 1.0 / np.maximum(arr[:, 2], 1e-6)
            sol, *_ = np.linalg.lstsq(
                x * w[:, None], arr[:, 2] * w, rcond=None
            )
            a_d, b_d, c_d = [max(0.0, float(v)) for v in sol]
            self.coeffs.a_d, self.coeffs.b_d, self.coeffs.c_d = (
                a_d, b_d, c_d
            )
        else:
            ok = False
        self.fitted = ok
        return ok

    @classmethod
    def from_profile(cls, truth: LatencyModel, rng,
                     batch_sizes: Iterable[int] = (1, 2, 4, 8, 16, 32, 64,
                                                   96, 128, 160, 192),
                     input_lens: Iterable[int] = (4, 8, 16, 32, 48, 64, 96,
                                                  128, 192, 256, 284, 512,
                                                  768, 1024, 1536, 2020),
                     noise: float = 0.03) -> "FittedLatencyModel":
        """Paper App. A profiling sweep against a ground-truth model."""
        m = cls()
        for bs in batch_sizes:
            for li in input_lens:
                lens = [li] * bs
                tp = truth.prefill_time(lens) * rng.lognormal(0.0, noise)
                m.observe_prefill(lens, tp)
                td = truth.decode_step_time(lens) * rng.lognormal(0.0, noise)
                m.observe_decode(lens, td)
        m.fit()
        return m
