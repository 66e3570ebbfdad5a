"""Format base machinery: pytree sparse containers.

JAX-native redesign of the reference format hierarchy
(reference: src/sparsebase/format/format.h:86-163,
format_implementation.h:23-58, format_order_two.h:22-156,
format_order_one.h:23-). Key departures, per the design mapping in
SURVEY.md §7:

* Formats are frozen dataclasses registered as JAX pytrees — so they flow
  through ``jit`` / ``shard_map`` / ``grad`` directly. Array fields are the
  pytree children; ``shape`` is static metadata.
* C++ template parameters <IDType, NNZType, ValueType> become array dtypes;
  the reference's ``void`` ValueType (pattern matrices) becomes
  ``vals=None``.
* Ownership semantics (kOwned/kNotOwned, deleters, release_*, move
  conversions — format/format.h:41-71, csr.cc:178-249) are moot: arrays are
  immutable. Donation via ``jax.jit(donate_argnums=...)`` recovers the
  "move" optimization where it matters.
* The execution place lives *in the arrays* (numpy = host, jax.Array =
  device/mesh), surfaced via :meth:`Format.context`; ``device_put`` /
  resharding replace the CUDA H2D/D2H conversion edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Type, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

from ..context import Context, DeviceContext, HostContext, MeshContext, context_of
from ..utils.exceptions import TypeMismatchError
from ..utils.typing import convert_array_dtype

T = TypeVar("T", bound="Format")

_REGISTERED_FORMATS: list = []


def _is_host(*arrays) -> bool:
    for a in arrays:
        if isinstance(a, jax.Array):
            return False
    return True


def xp_for(*arrays):
    """numpy for host-resident data, jax.numpy otherwise (incl. traced)."""
    return np if _is_host(*[a for a in arrays if a is not None]) else jnp


class Format:
    """Abstract sparse/dense container.

    API parity with the reference ``Format`` (format/format.h:86-163):
    ``get_dimensions`` -> :attr:`shape`, ``get_num_nnz`` -> :attr:`nnz`,
    ``get_order`` -> :attr:`order`, ``get_context`` -> :meth:`context`,
    ``get_id``/``get_name`` -> the Python type, ``Clone`` -> :meth:`clone`,
    ``AsAbsolute<T>`` -> :meth:`as_format`, ``Is<T>`` -> ``isinstance``.
    """

    order: int = -1

    # -- introspection -------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def nnz(self) -> int:
        raise NotImplementedError

    def _arrays(self) -> Tuple[Optional[object], ...]:
        """All array fields (some may be None)."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    @property
    def context(self) -> Context:
        for a in self._arrays():
            if a is not None:
                return context_of(a)
        return HostContext()

    def as_format(self, cls: Type[T]) -> T:
        """Checked downcast; raises TypeMismatchError like AsAbsolute<T>
        (format/format.h:142)."""
        if not isinstance(self, cls):
            raise TypeMismatchError(
                f"Object is of type {type(self).__name__}, not {cls.__name__}"
            )
        return self

    def clone(self: T) -> T:
        """Shallow copy (arrays are immutable, so sharing is safe)."""
        return dataclasses.replace(self)

    # -- placement -----------------------------------------------------------
    def to(self: T, context: Context) -> T:
        """Move every array field to ``context`` (the H2D/D2H/reshard edge)."""

        def move(a):
            if a is None:
                return None
            if isinstance(context, HostContext):
                return np.asarray(a)
            if isinstance(context, DeviceContext):
                if context.device is None:
                    return jnp.asarray(a)
                return jax.device_put(a, context.device)
            if isinstance(context, MeshContext):
                from jax.sharding import PartitionSpec

                # 1-D arrays shard on their only axis; rank-2+ on the first.
                return jax.device_put(a, context.sharding(PartitionSpec(context.axis)))
            raise TypeMismatchError(f"Unknown context {context!r}")

        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (np.ndarray, jax.Array)) or v is None:
                if v is not None:
                    changes[f.name] = move(v)
        return dataclasses.replace(self, **changes)

    def to_host(self: T) -> T:
        return self.to(HostContext())

    def to_device(self: T, device=None) -> T:
        return self.to(DeviceContext(device))

    # -- conversion ----------------------------------------------------------
    def convert(self, to_cls: Type[T], context: Optional[Context] = None) -> T:
        """Convert to another format class (and optionally placement) via the
        conversion graph — the member analogue of
        ``FormatOrderTwo::Convert<ToType>`` (format_order_two.h:36-58)."""
        from ..convert import convert as _convert

        return _convert(self, to_cls, context=context)

    def can_convert(self, to_cls: Type["Format"]) -> bool:
        from ..convert import can_convert as _can

        return _can(type(self), to_cls)


def register_format(cls):
    """Register a format dataclass as a JAX pytree.

    Array fields are children; every other field is static metadata. This
    replaces the explicit-instantiation generator of the reference
    (src/generate_explicit_instantiations.py) — JIT specializes per
    dtype/shape automatically.
    """
    fields = dataclasses.fields(cls)
    data_fields = [f.name for f in fields if f.metadata.get("static") is not True]
    meta_fields = [f.name for f in fields if f.metadata.get("static") is True]
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    _REGISTERED_FORMATS.append(cls)
    return cls


def static_field(**kw):
    return dataclasses.field(metadata={"static": True}, **kw)


def registered_formats():
    return tuple(_REGISTERED_FORMATS)
