"""Checkpoints of the port: atomic writes, a manifest, keep-last gc.

The torch counterpart of ``repro/distributed/checkpoint.py``, with its
protocol: a step is written into a ``.tmp_*`` staging directory and
renamed atomically into ``step_XXXXXXXX``; ``keep_last`` bounds how many
steps stay; ``latest_step`` + ``load_latest`` give crash-safe resume,
and ``load_latest`` sweeps ``.tmp_*`` leftovers of a writer that died
before its rename.  A JSON manifest of keys, shapes and dtypes refuses
a mismatched load.

A tree is a flat mapping of names to tensors (a model's
``state_dict``).  The tensors go into one ``torch.save`` of the flat
dict inside the staging directory, so bfloat16 — which numpy, and so
the JAX package's ``np.savez``, cannot hold — round-trips bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Mapping, Optional

import torch

from repro_torch import resolve_device

ARRAYS = "arrays.pt"
MANIFEST = "manifest.json"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r} in the manifest")
    return dt


def _flatten(tree: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Host tensors that own exactly their bytes: ``torch.save`` writes
    a view's whole base storage, so a view is cloned first."""
    flat = {}
    for k, t in tree.items():
        t = t.detach().to("cpu")
        nbytes = t.numel() * t.element_size()
        if not t.is_contiguous() or t.untyped_storage().nbytes() != nbytes:
            t = t.contiguous().clone()
        flat[k] = t
    return flat


def save_checkpoint(ckpt_dir: str, step: int,
                    tree: Mapping[str, torch.Tensor],
                    extra: Optional[dict] = None,
                    keep_last: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    manifest = {
        "step": step,
        "extra": extra or {},
        "arrays": {
            k: {"shape": list(v.shape),
                "dtype": str(v.dtype).removeprefix("torch.")}
            for k, v in flat.items()
        },
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        torch.save(flat, os.path.join(tmp, ARRAYS))
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        final = _step_dir(ckpt_dir, step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.startswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def _manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), MANIFEST)) as f:
        return json.load(f)


def checkpoint_nbytes(ckpt_dir: str, step: int) -> float:
    """Total tensor bytes a restore of ``step`` would read, computed
    from the manifest alone (no tensors touched) — what a disk-path
    weight-provisioning cost model should charge."""
    total = 0.0
    for meta in _manifest(ckpt_dir, step)["arrays"].values():
        n = 1
        for d in meta["shape"]:
            n *= d
        total += n * _dtype(meta["dtype"]).itemsize
    return total


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int,
                    tree_like: Mapping[str, Any],
                    device=None) -> tuple[dict[str, torch.Tensor], dict]:
    """Restore the keys of ``tree_like`` (values replaced, in its
    order) onto ``device``: CUDA unless the caller names another
    (:func:`repro_torch.resolve_device`, raising without a card; pass
    ``device="cpu"`` for host tensors).  Every tensor is a fresh
    copy: the file is memory-mapped, and a tensor returned without a
    copy would alias it.  Raises on a key the checkpoint lacks, on a
    manifest that disagrees with the stored tensor, and on a shape or
    dtype that differs from ``tree_like``'s (where its values have
    them, as tensors on any device, ``meta`` included, do)."""
    path = _step_dir(ckpt_dir, step)
    manifest = _manifest(ckpt_dir, step)
    flat = torch.load(os.path.join(path, ARRAYS), map_location="cpu",
                      weights_only=True, mmap=True)
    dev = resolve_device(device)
    out = {}
    for key, leaf in tree_like.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = flat[key]
        want = manifest["arrays"][key]
        if (list(t.shape) != want["shape"]
                or t.dtype != _dtype(want["dtype"])):
            raise ValueError(f"manifest/array mismatch for {key!r}")
        if hasattr(leaf, "shape") and tuple(leaf.shape) != tuple(t.shape):
            raise ValueError(
                f"{key!r}: checkpoint shape {tuple(t.shape)} != "
                f"expected {tuple(leaf.shape)}"
            )
        if hasattr(leaf, "dtype") and leaf.dtype != t.dtype:
            raise ValueError(
                f"{key!r}: checkpoint dtype {t.dtype} != expected "
                f"{leaf.dtype}"
            )
        out[key] = torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)
    return out, manifest["extra"]


def load_latest(ckpt_dir: str, tree_like: Mapping[str, Any], device=None):
    # sweep half-written staging dirs left by a writer that died before
    # its atomic rename — they can only accumulate, never resurrect
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith(".tmp_"):
                shutil.rmtree(os.path.join(ckpt_dir, name),
                              ignore_errors=True)
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, extra = load_checkpoint(ckpt_dir, step, tree_like, device)
    return step, tree, extra
