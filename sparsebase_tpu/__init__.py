"""sparsebase_tpu — a JAX sparse data preprocessing engine.

A ground-up JAX/XLA redesign with the capabilities of SparseBase
(sparcityeu/SparseBase): sparse containers (CSR/COO/CSC/Array) as JAX
pytrees, a conversion graph, reordering/permutation/partitioning/feature
ops with auto-converting dispatch, sparse I/O, graph/hypergraph objects,
an experiment harness — plus mesh-sharded distributed variants the
reference does not have.

Layer map (mirrors SURVEY.md §1):

    experiment   benchmark harness
    bases        IOBase / ReorderBase / GraphFeatureBase façades
    objects, io  Graph/HyperGraph wrappers; MTX/edge-list/binary/METIS/PaToH
    ops          reorder / permute / partition / feature
    dispatch     Operation (auto-converting multi-format dispatch)
    convert      conversion graph + XLA conversion kernels
    formats      CSR / COO / CSC / DenseArray pytrees
    context      Host / Device / Mesh placement
    utils        exceptions, logger, dtype machinery
    parallel     mesh-sharded formats + distributed ops (multi-device layer)
"""

__version__ = "0.1.0"

from . import config, context, convert, dispatch, formats, utils
from .config import get_config, set_config
from .context import (
    CPU_CONTEXT,
    Context,
    DeviceContext,
    HostContext,
    MeshContext,
    context_of,
)
from .convert import can_convert, convert_cached, register_conversion
from .convert import convert as convert_format
from .dispatch import ClassMatcher, Operation
from .formats import COO, CSC, CSR, DIA, ELL, Array, DenseArray, Format

# Heavier layers (io pulls the native fastio loader, parallel pulls mesh
# machinery, ops pulls every algorithm) load lazily on first attribute
# access so `import sparsebase_tpu` stays fast.
_LAZY_SUBMODULES = (
    "bases",
    "bench_suite",
    "experiment",
    "io",
    "models",
    "objects",
    "ops",
    "parallel",
)
_LAZY_ATTRS = {
    "IOBase": "bases",
    "ReorderBase": "bases",
    "GraphFeatureBase": "bases",
    "Graph": "objects",
    "HyperGraph": "objects",
}


def __getattr__(name):
    import importlib

    if name in _LAZY_SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module
        return module
    if name in _LAZY_ATTRS:
        module = importlib.import_module(f".{_LAZY_ATTRS[name]}", __name__)
        value = getattr(module, name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_SUBMODULES) | set(_LAZY_ATTRS))


__all__ = [
    "__version__",
    "formats",
    "convert",
    "context",
    "dispatch",
    "utils",
    "Format",
    "CSR",
    "COO",
    "CSC",
    "DIA",
    "ELL",
    "DenseArray",
    "Array",
    "Context",
    "HostContext",
    "DeviceContext",
    "MeshContext",
    "CPU_CONTEXT",
    "context_of",
    "can_convert",
    "convert_format",
    "convert_cached",
    "register_conversion",
    "Operation",
    "ClassMatcher",
    *_LAZY_SUBMODULES,
    *_LAZY_ATTRS,
]
