"""Mesh-sharded formats + distributed ops (multi-device layer, SURVEY.md §5)."""

from .dist import (
    bfs_levels,
    degree_reorder,
    degrees,
    edge_cut,
    label_prop_partition,
    rcm_reorder,
    refine_partition,
    spmv,
    structure_features,
)
from .mesh import make_mesh, make_mesh_2d, replicated, shard_rows
from .sharded import ShardedCSR
from .sharded2d import Sharded2DCSR
from . import halo
from . import multihost
from . import ring
from . import sharded2d

# joining the conversion graph: CSR <-> ShardedCSR placement edges
from ..convert.graph import _register_mesh_edges

_register_mesh_edges()

__all__ = [
    "ShardedCSR",
    "Sharded2DCSR",
    "halo",
    "multihost",
    "ring",
    "sharded2d",
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "replicated",
    "spmv",
    "degrees",
    "bfs_levels",
    "degree_reorder",
    "rcm_reorder",
    "label_prop_partition",
    "refine_partition",
    "edge_cut",
    "structure_features",
]
