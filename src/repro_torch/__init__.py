"""PyTorch/CUDA port of the HFX serving system.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``configs``, ``core``, ``kernels``, ``models``, ``serving``,
``training``, ``distributed``, ``launch``) and imports nothing from it.  Hot paths that ``repro`` runs as Pallas TPU
kernels run here as hand-written CUDA C++ for ``sm_90a`` (see
``repro_torch.kernels``), each beside a plain PyTorch version that the
CPU takes.

Entry points place their tensors on ``"cuda"`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU device they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises when CUDA is asked for and absent — never a
    quiet drop to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
