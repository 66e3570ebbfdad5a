"""Multi-host (DCN) wiring for the distributed layer.

SURVEY.md §2.13: communication within a host rides the device
interconnect via the shard_map
collectives in :mod:`.dist` / :mod:`.halo`; **across hosts** the same
code runs unchanged once ``jax.distributed`` is initialized — the mesh
then spans every process's devices and XLA routes the collectives over
the network between hosts and the device interconnect within them. The reference has no multi-node
path at all (its distribution story ends at CUDA P2P,
converter/converter_cuda.cu:12-22).

Multi-host execution has only run as several CPU processes on one host
(``tools/multiproc_dcn.py``); what this module provides is the (thin,
standard) bootstrap those runs need, kept separate so single-host users never
touch ``jax.distributed``:

* :func:`initialize` — process-group bootstrap (coordinator address +
  process count + rank), idempotent;
* :func:`global_mesh` — a 1-D mesh over *all* processes' devices;
* :func:`local_entry_counts` — splits a global nnz across processes for
  per-host COO loading.

Multi-host ingest uses the same :meth:`ShardedCSR.from_coo_sharded`:
each process reads only its slice of the entry list (PIGO-style chunked
parse), passes the per-process arrays, and the ``all_to_all`` routing
redistributes by row-block owner — no host ever materializes the whole
matrix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize ``jax.distributed`` (idempotent). With no arguments the
    values come from the standard env vars (``JAX_COORDINATOR_ADDRESS``
    etc.). Returns True if a
    multi-process group is active afterwards."""
    import jax

    if jax.process_count() > 1:
        return True
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception:
        # already initialized, or a single-process run with no coordinator
        pass
    return jax.process_count() > 1


def global_mesh(axis: str = "x"):
    """1-D mesh over every device of every process (= make_mesh on a
    single host)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def local_entry_counts(total_nnz: int) -> tuple[int, int]:
    """(start, count) of this process's slice of a global entry list —
    the per-host read assignment for distributed ingest."""
    import jax

    p = jax.process_count()
    i = jax.process_index()
    per = -(-total_nnz // p)
    start = min(i * per, total_nnz)
    return start, min(per, total_nnz - start)
