"""Benchmark experiment harness.

JAX-native analogue of the reference experiment layer
(reference: src/sparsebase/experiment/experiment_type.h:26-39,
concrete_experiment.cc:34-91, experiment_helper.h:19-100). Same shape:
a cartesian product of data loaders × file targets × preprocesses ×
kernels × repetitions, wall-clocking each kernel run and recording
runtimes/results/auxiliary data keyed by
``"file,...,preprocess_id,kernel_id,run_index"``.

Additions over the reference:

* kernels returning jax arrays are ``block_until_ready``'d before the
  stop timestamp (dispatch is async — without the sync you'd time the
  enqueue, not the work)
* a warmup run (default 1) absorbs XLA compile time; pass ``warmup=0``
  to time cold compiles
* optional ``jax.profiler`` trace capture per kernel (``trace_dir``)
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

LoaderFn = Callable[[Sequence[str]], Any]
PreprocessFn = Callable[[Any, Any, Any], Any]
KernelFn = Callable[[Any, Any, Any, Any], Any]


class Experiment:
    """Interface parity with ``experiment::ExperimentType``
    (experiment_type.h:26-39)."""

    def add_data_loader(self, loader: LoaderFn, targets: Sequence[Tuple[Sequence[str], Any]]):
        raise NotImplementedError

    def add_preprocess(self, pid: str, fn: PreprocessFn, params: Any = None):
        raise NotImplementedError

    def add_kernel(self, kid: str, fn: KernelFn, params: Any = None):
        raise NotImplementedError

    def run(self, times: int = 1, store_auxiliary: bool = False):
        raise NotImplementedError


class ConcreteExperiment(Experiment):
    """Parity: ``experiment::ConcreteExperiment`` (concrete_experiment.cc)."""

    def __init__(self, warmup: int = 1, trace_dir: Optional[str] = None):
        self._loaders: List[Tuple[LoaderFn, List[Tuple[List[str], Any]]]] = []
        self._preprocesses: Dict[str, Tuple[PreprocessFn, Any]] = {}
        self._kernels: Dict[str, Tuple[KernelFn, Any]] = {}
        self._runtimes: Dict[str, float] = {}
        self._results: Dict[str, Any] = {}
        self._auxiliary: Dict[str, Any] = {}
        self.warmup = warmup
        self.trace_dir = trace_dir

    # -- construction --------------------------------------------------------
    def add_data_loader(self, loader, targets):
        self._loaders.append((loader, [(list(f), p) for f, p in targets]))

    def add_preprocess(self, pid, fn, params=None):
        self._preprocesses[pid] = (fn, params)

    def add_kernel(self, kid, fn, params=None):
        self._kernels[kid] = (fn, params)

    # -- execution (concrete_experiment.cc:34-91 loop) -----------------------
    def run(self, times: int = 1, store_auxiliary: bool = False):
        # dispatch is asynchronous: each run ends in block_until_ready, so
        # a timing covers the work and not only its enqueue
        from jax import block_until_ready

        for loader, targets in self._loaders:
            for file_names, fparams in targets:
                data = loader(file_names)
                fkey = ",".join(file_names)
                if store_auxiliary:
                    self._auxiliary[f"data,{fkey}"] = data
                for pid, (pfn, pparams) in self._preprocesses.items():
                    pdata = pfn(data, fparams, pparams)
                    if store_auxiliary:
                        self._auxiliary[f"preprocess,{pid},{fkey}"] = pdata
                    for kid, (kfn, kparams) in self._kernels.items():
                        for w in range(self.warmup):
                            block_until_ready(kfn(pdata, fparams, pparams, kparams))
                        for i in range(times):
                            ctx = _maybe_trace(self.trace_dir, f"{pid}-{kid}-{i}")
                            with ctx:
                                t0 = time.perf_counter()
                                res = block_until_ready(kfn(pdata, fparams, pparams, kparams))
                                dt = time.perf_counter() - t0
                            key = f"{fkey},{pid},{kid},{i}"
                            self._runtimes[key] = dt
                            self._results[key] = res
        return self

    # -- results (GetRunTimes/GetResults/GetAuxiliary) -----------------------
    def get_run_times(self) -> Dict[str, float]:
        return dict(self._runtimes)

    def get_results(self) -> Dict[str, Any]:
        return dict(self._results)

    def get_auxiliary(self) -> Dict[str, Any]:
        return dict(self._auxiliary)


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _maybe_trace(trace_dir, name):
    """Per-kernel named profiler scope: each (preprocess, kernel, rep)
    traces into its own ``trace_dir/<name>`` directory and is wrapped in
    a ``TraceAnnotation`` so runs are distinguishable in the viewer
    (reference only wall-clocks, concrete_experiment.cc:57-70; SURVEY.md
    §5 asks for named scopes on top)."""
    if trace_dir is None:
        return _NullCtx()
    import contextlib
    import os

    import jax

    @contextlib.contextmanager
    def ctx():
        with jax.profiler.trace(os.path.join(str(trace_dir), str(name))):
            with jax.profiler.TraceAnnotation(str(name)):
                yield

    return ctx()


# -- canned loaders / preprocesses (experiment_helper.h:19-100 parity) -------


def load_csr(file_names):
    from .bases import IOBase

    return IOBase.read_mtx_to_csr(file_names[0])


def load_coo(file_names):
    from .bases import IOBase

    return IOBase.read_mtx_to_coo(file_names[0])


def load_csc(file_names):
    from .convert import csr_to_csc
    from .bases import IOBase

    return csr_to_csc(IOBase.read_mtx_to_csr(file_names[0]))


def load_format(fmt_cls):
    """Generic loader factory: read MTX then convert to any registered
    format class (experiment_helper.h LoadFormat<T>)."""

    def fn(file_names):
        from .bases import IOBase

        return IOBase.read_mtx_to_csr(file_names[0]).convert(fmt_cls)

    return fn


def pass_preprocess(data, fparams, pparams):
    """Identity preprocess (experiment_helper.h Pass)."""
    return data


def reorder_csr(reorderer_factory):
    """Returns a preprocess applying reorder+permute (ReorderCSR helper)."""

    def fn(data, fparams, pparams):
        from .bases import ReorderBase

        order = reorderer_factory().get_reorder(data)
        if data.shape[0] == data.shape[1]:
            return ReorderBase.permute2d(order, data)
        # rectangular: a row ordering cannot renumber columns
        return ReorderBase.permute2d_rowwise(order, data)

    return fn


def load_sharded_csr(mesh=None, axis: str = "x", halo: bool = True):
    """Returns a loader producing a :class:`~.parallel.ShardedCSR` over
    ``mesh`` (default: all devices) — the distributed analogue of
    ``LoadCSR`` (experiment_helper.h:33-42); no reference counterpart."""

    def fn(file_names):
        from .bases import IOBase
        from .parallel import ShardedCSR, make_mesh

        m = mesh if mesh is not None else make_mesh(axis=axis)
        csr = IOBase.read_mtx_to_csr(file_names[0])
        return ShardedCSR.from_csr(csr, m, axis=axis, halo=halo), m

    return fn


def distributed_reorder(kind: str = "rcm"):
    """Preprocess applying a distributed reorder to a (ShardedCSR, mesh)
    pair; returns (sharded, mesh, order)."""

    def fn(data, fparams, pparams):
        from .parallel import halo as _halo

        sh, mesh = data
        if kind == "rcm":
            order = _halo.rcm_reorder(sh, mesh)
        elif kind == "degree":
            from .parallel import degree_reorder

            order = degree_reorder(sh, mesh)
        else:
            raise ValueError(f"unknown distributed reorder {kind!r}")
        return sh, mesh, order

    return fn


def distributed_spmv_kernel(data, fparams, pparams, kparams):
    """Kernel: boundary-proportional SpMV on the (possibly reordered)
    sharded matrix (the distributed take on tutorial 004's SpMV)."""
    import jax.numpy as jnp

    from .parallel import halo as _halo

    sh, mesh = data[0], data[1]
    x = jnp.ones((sh.shape[1],), jnp.float32)
    return _halo.spmv(sh, x, mesh)
