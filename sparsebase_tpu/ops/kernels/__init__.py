"""Device kernels for hot compute paths."""

from .banded_spmv import banded_spmv, dia_spmv_reference

__all__ = ["banded_spmv", "dia_spmv_reference"]
