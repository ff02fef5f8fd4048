"""TransferLink Manager (paper §4, §6 "Fast Scaling").

Responsibilities, mapped from Ascend/HCCL onto TPU/ICI semantics:

- **P/D links**: KV caches move prefill→decode over device-to-device
  links.  Links are *proactively* established when workers join (the
  Mooncake comparison in §6) — a lazily created link pays a setup cost
  on first transfer.
- **Fast Scaling**: a new instance pulls weights from a live instance's
  WeightManager over D2D instead of disk, with fall back to disk on
  failure.  In JAX the transport is `jax.device_put`/resharding over
  ICI; here the manager computes transfer times from link bandwidth and
  also performs *real* small-scale transfers in the engine examples.

All times are deterministic functions of bytes and per-pair bandwidth so
the event simulator and the scaler agree.

A copy of ``repro/core/tlmanager.py``, kept line for line
(the port imports nothing from the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.latency_model import Hardware, TPU_V5E


@dataclasses.dataclass(frozen=True)
class TransferCosts:
    link_setup: float = 0.150      # s, communication-domain establishment
    d2d_eff: float = 0.80          # achievable fraction of ICI bw
    runtime_warmup: float = 0.35   # s, CPU runtime init when not warm


def kv_bytes(cfg: ModelConfig, tokens: int, dtype_bytes: int = 2) -> float:
    """KV-cache footprint of `tokens` cached tokens (SSM: fixed state)."""
    hd = cfg.resolved_head_dim
    total = 0.0
    for kind, cnt in cfg.layer_pattern():
        if kind == "mamba":
            if cfg.ssm is not None:
                s = cfg.ssm
                di = s.d_inner(cfg.d_model)
                h = s.n_heads(cfg.d_model)
                # fixed-size state: conv tail + SSM state (f32)
                total += cnt * (
                    (s.conv_width - 1) * (di + 2 * s.n_groups * s.d_state)
                    * dtype_bytes
                    + h * s.head_dim * s.d_state * 4
                )
        else:
            total += cnt * 2 * cfg.n_kv_heads * hd * tokens * dtype_bytes
    return total


class TLManager:
    def __init__(self, hw: Hardware = TPU_V5E,
                 costs: TransferCosts = TransferCosts(),
                 proactive_links: bool = True):
        self.hw = hw
        self.costs = costs
        self.proactive_links = proactive_links
        self._links: set[tuple[int, int]] = set()
        self.kv_bytes_moved = 0.0
        # weight-provisioning accounting: total plus a host-vs-ICI
        # split ("d2d" rides the device interconnect; "cpu" and "disk"
        # both cross the host link — the bench reports both)
        self.weight_bytes_moved = 0.0
        self.weight_bytes_ici = 0.0
        self.weight_bytes_host = 0.0
        self.n_kv_transfers = 0
        self.n_weight_loads = 0
        # measured transfer model: EWMA bytes/s per strategy, fed by
        # real provisions (WeightManager) — once observed, it replaces
        # the analytic bandwidth in weight_load_time, so the Scaler
        # costs scale-outs from what this host actually sustains
        self._weight_bw: dict[str, float] = {}

    # -- links ---------------------------------------------------------------
    def establish_link(self, a: int, b: int) -> float:
        """Returns the setup latency paid *now* (0 if already linked)."""
        key = (min(a, b), max(a, b))
        if key in self._links:
            return 0.0
        self._links.add(key)
        return self.costs.link_setup

    def ensure_links(self, new_worker: int, peers) -> None:
        """Proactive link establishment at scale-out (§6)."""
        for p in peers:
            self._links.add((min(new_worker, p), max(new_worker, p)))

    def has_link(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) in self._links

    # -- KV migration ----------------------------------------------------------
    def kv_transfer_time(self, cfg: ModelConfig, tokens: int,
                         src: int, dst: int, tp: int = 1,
                         nbytes: Optional[float] = None) -> float:
        """Transfer latency for a KV hand-off.  ``nbytes`` overrides
        the analytic per-token estimate with the *measured* payload
        size (engine plane: what export_kv actually materializes)."""
        if nbytes is None:
            nbytes = kv_bytes(cfg, tokens)
        bw = self.hw.ici_bw * self.costs.d2d_eff * tp
        t = nbytes / bw
        if not self.proactive_links and not self.has_link(src, dst):
            t += self.establish_link(src, dst)
        self.kv_bytes_moved += nbytes
        self.n_kv_transfers += 1
        return t

    # -- weight provisioning (Fast Scaling, Table 2) ----------------------------
    def observe_weight_load(self, strategy: str, nbytes: float,
                            seconds: float) -> None:
        """Feed one *measured* provision (WeightManager) into the
        transfer model.  The EWMA bandwidth replaces the analytic
        figure in subsequent ``weight_load_time`` predictions."""
        if seconds <= 0 or nbytes <= 0:
            return
        bw = nbytes / seconds
        prev = self._weight_bw.get(strategy)
        self._weight_bw[strategy] = (bw if prev is None
                                     else 0.5 * prev + 0.5 * bw)
        self.n_weight_loads += 1

    def measured_weight_bw(self, strategy: str) -> Optional[float]:
        return self._weight_bw.get(strategy)

    def weight_load_time(self, cfg: ModelConfig, strategy: str,
                         tp: int = 1, dtype_bytes: int = 2,
                         warm: bool = True, record: bool = True,
                         nbytes: Optional[float] = None) -> float:
        """Cold-start weight provisioning latency.

        strategy: "d2d" (Fast Scaling — pull from a live instance's
        WeightManager over ICI), "cpu" (host-offloaded copy), "disk".
        TP shards load in parallel across the tp device group.  Once a
        strategy has measured samples (``observe_weight_load``) its
        observed bandwidth wins over the analytic figure.  ``record``
        books the moved bytes (every strategy moves the full tree —
        set False for cost *probes* that commit no transfer).
        """
        if nbytes is None:
            nbytes = cfg.param_count() * dtype_bytes
        per_dev = nbytes / tp
        if strategy not in ("d2d", "cpu", "disk"):
            raise ValueError(strategy)
        measured = self._weight_bw.get(strategy)
        if measured is not None:
            # measured wall time already amortizes link setup / file
            # open overheads into the observed bandwidth
            t = (nbytes if strategy == "disk" else per_dev) / measured
        elif strategy == "d2d":
            t = self.costs.link_setup + per_dev / (
                self.hw.ici_bw * self.costs.d2d_eff
            )
        elif strategy == "cpu":
            t = per_dev / self.hw.host_bw
        else:  # disk — shared disk: parallel readers contend
            t = nbytes / self.hw.disk_bw
        if record:
            self.weight_bytes_moved += nbytes
            if strategy == "d2d":
                self.weight_bytes_ici += nbytes
            else:
                self.weight_bytes_host += nbytes
        if not warm:
            t += self.costs.runtime_warmup
        return t
