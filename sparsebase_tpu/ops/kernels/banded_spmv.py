"""Banded (DIA) SpMV.

The reference's performance showcase is CUDA SpMV after bandwidth-
reducing reordering (reference: tutorials/004_cuda_spmv). In DIA form
the reordered matrix is a band, and banded SpMV needs no gathers or
scatters —

    y[i] = Σ_d  data[d, i] * x[i + offsets[d]]

is a sum of shifted elementwise products: k streaming reads of the band
against k shifted windows of one x.

:func:`banded_spmv` computes it in XLA: each diagonal's shift is a
``dynamic_slice`` of the zero-padded x, multiplied and added in one
unrolled chain that XLA fuses into a single pass. It specialises on the
concrete diagonal offsets (compile-time constants), as the reference's
CUDA kernel is launched per matrix. On one H100 it reads the 27-diagonal
band of a 2M-row operator at 85-88% of the rate of a plain device copy;
a Pallas kernel on the Triton route measured equal in f32 and about 20%
slower with a bf16 band, so no hand-written kernel is kept (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ...formats.dia import DIA


def _static_offsets(dia: DIA):
    if isinstance(dia.offsets, jax.core.Tracer):
        raise TypeError(
            "banded SpMV specializes on the concrete diagonal offsets; call "
            "it outside jit (the kernel itself is compiled)"
        )
    return tuple(int(o) for o in np.asarray(dia.offsets).tolist())


@functools.partial(jax.jit, static_argnums=(0, 1))
def _banded_spmv_xla(offsets, shape, data, x):
    n, m = shape
    pad = max((abs(o) for o in offsets), default=0)
    x_pad = jnp.pad(x.astype(jnp.float32), (pad, pad + max(n - m, 0)))
    y = jnp.zeros((n,), jnp.float32)
    data = data.astype(jnp.float32)
    for d, off in enumerate(offsets):
        seg = jax.lax.dynamic_slice(x_pad, (pad + off,), (n,))
        y = y + data[d] * seg
    return y


def banded_spmv(dia: DIA, x):
    """y = A @ x via per-diagonal shifted slices (XLA path), compiled once
    per band structure."""
    return _banded_spmv_xla(_static_offsets(dia), dia.shape, jnp.asarray(dia.data), jnp.asarray(x))


def dia_spmv_reference(dia: DIA, x):
    """Pure-jnp DIA SpMV (correctness oracle for the kernels)."""
    n, m = dia.shape
    offs = np.asarray(dia.offsets)
    x = jnp.asarray(x, jnp.float32)
    y = jnp.zeros((n,), jnp.float32)
    i = jnp.arange(n)
    for d, off in enumerate(offs.tolist()):
        j = i + off
        ok = (j >= 0) & (j < m)
        xv = jnp.where(ok, x[jnp.clip(j, 0, m - 1)], 0.0)
        y = y + jnp.asarray(dia.data)[d].astype(jnp.float32) * xv
    return y
