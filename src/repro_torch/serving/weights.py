"""Per-replica weight ownership + real provisioning transports (§6).

The torch counterpart of ``repro/serving/weights.py``, with its API.
The paper's Fast Scaling claim (Table 2) is that a scaled-out instance
pulls weights **device-to-device from a live replica** instead of
re-reading them from disk.  For that claim to be testable on the engine
plane, replicas cannot alias one shared set of tensors — each
:class:`~repro_torch.serving.engine.InferenceEngine` runs a ``Model``
that *owns* its weights, and scale-out moves bytes through the selected
transport.

:class:`WeightManager` is that ownership registry plus the three
Table-2 transports, each producing a ``state_dict``-shaped dict of
tensors on the replica's device that shares no storage with its source:

- ``d2d``  — a copy from a live donor replica's tensors: on the device
  (``torch.empty_like`` + ``copy_``) when the donor lies there, else
  ``.to(device)``, card to card (a peer copy where the cards have one)
  or between a card and the host.
- ``cpu``  — a copy from the host offload of the seed weights made at
  init (page-locked when a replica may live on a card, so the copy runs
  at the host link's rate).
- ``disk`` — a load of the seed checkpoint written at init through
  :mod:`repro_torch.distributed.checkpoint` (the scale-from-zero path:
  it needs no live donor and no warm host copy).

Placement is JAX's: replica ``wid`` lands on ``devices[wid %
len(devices)]`` (JAX's ``jax.devices()``; here the manager's
``devices``, by default the seed's device alone, so one device holds
every replica).  JAX's other branch, a replica spanning a group of
devices under a sharding-rules context, has no counterpart: JAX's
``Cluster`` never enters one.

Every provision is timed on the wall clock between synchronizations of
the donor's and the target's cards (``block_until_ready`` in JAX) and
reported to the :class:`~repro_torch.core.tlmanager.TLManager`, whose
``weight_load_time`` then predicts from *observed* bandwidth — the
Scaler's Algorithm-3 tick picks the provisioning path from measured,
not analytic, costs.
"""

from __future__ import annotations

import tempfile
import time
from typing import Mapping, Optional, Sequence

import torch

from repro_torch.distributed.checkpoint import (
    checkpoint_nbytes,
    load_checkpoint,
    save_checkpoint,
)

STRATEGIES = ("d2d", "cpu", "disk")

Params = dict[str, torch.Tensor]


def _owned_copy(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` with ``x``'s values and storage of its
    own: ``.to``/``.cpu()`` return ``x`` itself when it already lies
    there, which would alias the source."""
    if x.device != device:
        return x.to(device)
    return torch.empty_like(x).copy_(x)


def _synchronize(*devices: torch.device) -> None:
    """Wait for the work queued on each card among ``devices``."""
    for dev in set(devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class WeightManager:
    """Owns the per-replica weights of one served model.

    ``seed_params`` is retained only as provisioning *source* material
    (host offload + disk checkpoint) — replicas never alias it; every
    ``provision``/``adopt`` hands a replica its own tensors, and
    ``release`` drops them (scale-in reclaims the copy's memory).
    ``devices`` lists where replicas may land (:meth:`placement`); by
    default the seed's device alone.
    """

    def __init__(self, seed_params: Mapping[str, torch.Tensor], tl=None,
                 ckpt_dir: Optional[str] = None,
                 devices: Optional[Sequence[torch.device]] = None):
        self._owned: dict[int, Params] = {}
        self.tl = tl
        self.device = next(iter(seed_params.values())).device
        self.devices = ([torch.device(d) for d in devices] if devices
                        else [self.device])
        # "cpu" source: host-resident offload of the seed.  A real copy
        # into fresh host memory — ``tensor.cpu()`` of a CPU tensor is
        # the tensor itself, and the "offload" would alias the seed
        pin = any(d.type == "cuda" for d in self.devices)
        self.host: Params = {
            k: torch.empty(v.shape, dtype=v.dtype, device="cpu",
                           pin_memory=pin).copy_(v)
            for k, v in seed_params.items()
        }
        self.nbytes = float(sum(t.numel() * t.element_size()
                                for t in self.host.values()))
        # "disk" source: a real checkpoint written through the same
        # atomic-write path training restores from (scale-from-zero
        # needs neither a donor nor a warm host copy — only this file)
        self._tmp = None
        if ckpt_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="hfx-weights-")
            ckpt_dir = self._tmp.name
        self.ckpt_dir = ckpt_dir
        save_checkpoint(self.ckpt_dir, 0, self.host)
        assert checkpoint_nbytes(self.ckpt_dir, 0) == self.nbytes

    # -- ownership registry ----------------------------------------------------
    def owns(self, wid: int) -> bool:
        return wid in self._owned

    def params_of(self, wid: int) -> Params:
        return self._owned[wid]

    def donors(self) -> list[int]:
        """Replicas a ``d2d`` provision could pull from right now."""
        return sorted(self._owned)

    def adopt(self, wid: int, params: Params) -> None:
        """Register externally materialized weights (e.g. the seed
        replica constructed before this manager existed)."""
        if wid in self._owned:
            raise ValueError(f"replica {wid} already owns its weights")
        self._owned[wid] = params

    def release(self, wid: int) -> None:
        """Scale-in: drop the replica's tensors so their memory is
        reclaimable (and it stops being a d2d donor candidate)."""
        self._owned.pop(wid, None)

    # -- placement -------------------------------------------------------------
    def placement(self, wid: int) -> torch.device:
        """The device replica ``wid``'s weights land on: replicas
        round-robin over ``devices``, as JAX's over ``jax.devices()``
        (with one device, that device: JAX's None, the seed's)."""
        return self.devices[wid % len(self.devices)]

    # -- Table-2 transports ----------------------------------------------------
    def provision(self, wid: int, strategy: str,
                  donor: Optional[int] = None) -> tuple[Params, float]:
        """Materialize replica ``wid``'s own weights through
        ``strategy``; returns ``(params, measured_seconds)``.

        The measured wall time is reported to the TLManager so the
        Scaler's next cost query predicts from observed bandwidth.  The
        weights land on :meth:`placement` of ``wid``.
        """
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown weight strategy {strategy!r}")
        if wid in self._owned:
            raise ValueError(f"replica {wid} already owns its weights")
        dev = self.placement(wid)
        src = ()
        if strategy == "d2d":
            if donor is None or donor not in self._owned:
                raise ValueError(
                    f"d2d provisioning for replica {wid} needs a live "
                    f"donor (have {sorted(self._owned)}, got {donor!r}); "
                    f"scale-from-zero must fall back to 'disk'"
                )
            src = (next(iter(self._owned[donor].values())).device,)
        _synchronize(dev, *src)   # nothing earlier in the window
        t0 = time.perf_counter()
        if strategy == "d2d":
            params = {k: _owned_copy(v, dev)
                      for k, v in self._owned[donor].items()}
        elif strategy == "cpu":
            params = {k: torch.empty(h.shape, dtype=h.dtype, device=dev)
                      .copy_(h, non_blocking=True)
                      for k, h in self.host.items()}
        else:  # disk
            params, _ = load_checkpoint(self.ckpt_dir, 0, self.host,
                                        device=dev)
        _synchronize(dev, *src)
        dt = time.perf_counter() - t0
        self._owned[wid] = params
        if self.tl is not None:
            self.tl.observe_weight_load(strategy, self.nbytes, dt)
        return params, dt
