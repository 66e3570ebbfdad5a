"""Device-mesh helpers.

The JAX-native replacement for the reference's multi-device story (CUDA
peer-to-peer copies, reference: src/sparsebase/converter/converter_cuda.cu:
12-22): placement over a ``jax.sharding.Mesh`` with XLA collectives over the
devices' interconnect (NVLink between the GPUs of one host), per
SURVEY.md §2.13/§5. The cards of one host reach each other all to all,
so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))

def make_mesh_2d(shape: Sequence[int], axes: Sequence[str] = ("x", "y")) -> Mesh:
    devs = np.array(jax.devices()[: int(np.prod(shape))]).reshape(tuple(shape))
    return Mesh(devs, tuple(axes))


def shard_rows(mesh: Mesh, axis: str = "x") -> NamedSharding:
    """Shard the leading dimension over ``axis``."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
