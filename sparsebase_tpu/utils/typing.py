"""Dtype utilities: overflow-checked array casting and dtype universes.

JAX-native replacement for the reference's compile-time template-type
machinery (``CanTypeFitValue`` / ``isTypeConversionSafe`` /
``ConvertArrayType``, reference: src/sparsebase/utils/utils.h:39-149).
Where the reference stamps out a cartesian product of explicit template
instantiations, JAX simply JIT-specializes per dtype — so the only work
left is runtime overflow checking when a user requests a *narrowing*
dtype conversion of index/value arrays.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from .exceptions import TypeMismatchError

ArrayLike = Union[np.ndarray, jax.Array]

# Dtype universes analogous to the CMake ID_TYPES / NNZ_TYPES / VALUE_TYPES
# lists (reference: CMakeLists.txt:15-18). int64/float64 need jax x64 mode.
ID_DTYPES = (jnp.int32, jnp.uint32, jnp.int64, jnp.uint64)
NNZ_DTYPES = (jnp.int32, jnp.uint32, jnp.int64, jnp.uint64)
VALUE_DTYPES = (jnp.float32, jnp.float64, jnp.bfloat16, jnp.int32, jnp.int64)
FLOAT_DTYPES = (jnp.float32, jnp.float64, jnp.bfloat16)


def _dtype(d) -> np.dtype:
    return jnp.dtype(d)


def can_dtype_fit(to_dtype, values: ArrayLike) -> bool:
    """True iff every element of ``values`` is exactly representable in
    ``to_dtype``. Analogue of ``CanTypeFitValue`` applied array-wide."""
    to_dtype = _dtype(to_dtype)
    vals = np.asarray(values)
    if vals.size == 0:
        return True
    if np.issubdtype(to_dtype, np.integer):
        info = np.iinfo(to_dtype)
        if np.issubdtype(vals.dtype, np.floating):
            if not np.all(np.equal(np.mod(vals, 1), 0)):
                return False
        mn, mx = vals.min(), vals.max()
        return mn >= info.min and mx <= info.max
    # floating target: check round-trip for integer sources wider than mantissa
    if np.issubdtype(vals.dtype, np.integer):
        rt = vals.astype(to_dtype).astype(vals.dtype)
        return bool(np.all(rt == vals))
    # float -> float narrowing: check magnitude range only (precision loss is
    # allowed for value arrays, matching numpy semantics; exact check would
    # forbid float64->float32 entirely).
    finfo = np.finfo(to_dtype) if to_dtype != jnp.bfloat16 else np.finfo(np.float32)
    finite = vals[np.isfinite(vals)]
    if finite.size == 0:
        return True
    return bool(np.all(np.abs(finite.astype(np.float64)) <= float(finfo.max)))


def convert_array_dtype(values: ArrayLike, to_dtype, *, check: bool = True) -> ArrayLike:
    """Cast an array to ``to_dtype`` with overflow detection.

    Analogue of ``ConvertArrayType`` (utils/utils.h:113-149): raises
    ``TypeMismatchError`` if any element cannot be represented. ``check``
    can only be performed on concrete (non-traced) arrays; inside ``jit``
    the cast is unchecked.
    """
    to_dtype = _dtype(to_dtype)
    if isinstance(values, jax.core.Tracer):
        return values.astype(to_dtype)
    if values is None:
        return None
    if _dtype(values.dtype) == to_dtype:
        return values
    if check and not can_dtype_fit(to_dtype, values):
        raise TypeMismatchError(
            f"Array with dtype {values.dtype} contains values that do not fit in {to_dtype}"
        )
    if isinstance(values, np.ndarray):
        return values.astype(to_dtype)
    return jnp.asarray(values, dtype=to_dtype)


def index_dtype_for(n: int):
    """Smallest supported index dtype able to address ``n`` items."""
    return jnp.int32 if n <= np.iinfo(np.int32).max else jnp.int64
