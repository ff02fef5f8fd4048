"""Meshes (counterpart of ``repro/launch/mesh.py``).

The production meshes are data: :class:`MeshSpec` holds the axis names
and sizes that the sharding plans and the meta-device dry run read, and
no device is created for them.  :func:`make_local_mesh` builds a real
``DeviceMesh`` over the ranks this process group has (tests, one card).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names, in order, and their sizes."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A ``(data, model)`` DeviceMesh over the process group's
    ``data * model`` ranks; no ``pod`` axis, as JAX's has none."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))
