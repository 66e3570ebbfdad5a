"""Execution-place abstraction: where a format's arrays live.

JAX-native redesign of the reference context layer
(reference: src/sparsebase/context/context.h:18-21, cpu_context.h:12,
cuda_context_cuda.cuh:14-19). The reference distinguishes CPU vs
CUDA(device_id); here the axes are:

* ``HostContext``            — numpy arrays in host RAM
* ``DeviceContext(device)``  — jax.Arrays committed to one device (GPU/CPU)
* ``MeshContext(mesh, spec)``— jax.Arrays sharded over a ``jax.sharding.Mesh``
                               with a ``PartitionSpec`` per array role

Equality follows the reference's ``IsEquivalent`` semantics: two contexts
are equivalent iff data placed in one can be consumed in the other without
a transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


class Context:
    """Base execution place."""

    def is_equivalent(self, other: "Context") -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class HostContext(Context):
    """Arrays live in host memory as numpy arrays."""

    def is_equivalent(self, other: Context) -> bool:
        return isinstance(other, HostContext)

    def __repr__(self) -> str:
        return "HostContext()"


@dataclasses.dataclass(frozen=True)
class DeviceContext(Context):
    """Arrays are jax.Arrays committed to a single device.

    ``device=None`` means "the default device" (whatever JAX picks),
    equivalent to any other default-device context.
    """

    device: Optional[jax.Device] = None

    def is_equivalent(self, other: Context) -> bool:
        if not isinstance(other, DeviceContext):
            return False
        if self.device is None or other.device is None:
            return True
        return self.device == other.device

    def __repr__(self) -> str:
        return f"DeviceContext({self.device})"


@dataclasses.dataclass(frozen=True)
class MeshContext(Context):
    """Arrays are sharded over a device mesh.

    ``axis`` names the mesh axis over which the leading (row/vertex)
    dimension of sparse structures is partitioned. This is the JAX-native
    analogue of the reference's CUDA multi-device story (peer-to-peer copy,
    converter/converter_cuda.cu:12-22) — except transfers ride
    collectives inserted by XLA rather than explicit P2P memcpy.
    """

    mesh: Mesh
    axis: str = "x"

    def is_equivalent(self, other: Context) -> bool:
        return (
            isinstance(other, MeshContext)
            and self.mesh == other.mesh
            and self.axis == other.axis
        )

    def sharding(self, spec: Optional[PartitionSpec] = None) -> NamedSharding:
        if spec is None:
            spec = PartitionSpec(self.axis)
        return NamedSharding(self.mesh, spec)

    def __repr__(self) -> str:
        return f"MeshContext(axes={dict(zip(self.mesh.axis_names, self.mesh.devices.shape))}, axis={self.axis!r})"


CPU_CONTEXT = HostContext()


def default_device_context() -> DeviceContext:
    return DeviceContext(None)


def context_of(x) -> Context:
    """Infer the context of an array (numpy -> Host, jax -> Device/Mesh)."""
    import numpy as np

    if x is None:
        return HostContext()
    if isinstance(x, np.ndarray):
        return HostContext()
    if isinstance(x, jax.core.Tracer):
        return DeviceContext(None)
    if isinstance(x, jax.Array):
        sharding = x.sharding
        if isinstance(sharding, NamedSharding) and sharding.mesh.size > 1:
            mesh = sharding.mesh
            if isinstance(mesh, jax.sharding.AbstractMesh):
                return MeshContext(mesh, mesh.axis_names[0])
            return MeshContext(Mesh(mesh.devices, mesh.axis_names), mesh.axis_names[0])
        devs = list(x.devices())
        return DeviceContext(devs[0] if len(devs) == 1 else None)
    return HostContext()
