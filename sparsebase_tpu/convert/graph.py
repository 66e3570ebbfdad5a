"""Conversion graph: registry + BFS path-finding + chain application.

JAX-native analogue of the reference converter
(reference: src/sparsebase/converter/converter.h:65-350, converter.cc —
``ConversionMap`` registration :124-128, ``ConversionBFS`` :138-195,
``GetConversionChain`` :197-213, ``ApplyConversionChain`` :253-). The
reference keys edges on (from type, to type) with per-edge context
conditions; here edges are keyed on format classes with an optional
``condition(from_ctx, to_ctx)``, and placement moves (host↔device↔mesh —
the analogues of the CUDA H2D/D2H/P2P edges,
converter/converter_order_two_cuda.cu:21-40, converter_cuda.cu:12-22) are
uniform ``Format.to`` transitions appended to any chain.

A process-wide default graph plays the role of the reference's
``ConverterStore`` singleton (converter/converter_store.h:10-45); formats
may carry a custom graph (``set_converter`` analogue) by passing
``graph=`` to :func:`convert`.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple, Type

from ..context import Context
from ..formats.base import Format
from ..utils.exceptions import ConversionError

ConversionFn = Callable[[Format], Format]
Condition = Callable[[Optional[Context], Optional[Context]], bool]

_JITTED: Dict[int, ConversionFn] = {}


def _device_fn(fn: ConversionFn) -> ConversionFn:
    """jit-wrap a conversion kernel (cached per fn) so repeated device
    conversions hit the XLA compilation cache instead of re-dispatching
    eager ops. Host (numpy) inputs bypass this."""
    import jax

    key = id(fn)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn)
    return _JITTED[key]


class ContextConversion:
    """Marks a conversion whose implementation needs the *target context*
    (e.g. CSR → ShardedCSR needs the mesh). The wrapped fn is called as
    ``fn(fmt, to_context)`` and runs eagerly (it performs placement
    itself), so the chain executor neither jit-wraps it nor pre-moves the
    input — the analogue of the reference's context-conditional CUDA
    edges (converter_order_two.cc:288-341) generalized to meshes."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, fmt, to_ctx=None):
        return self.fn(fmt, to_ctx)


class EagerConversion:
    """Marks a conversion that must run eagerly even on device inputs:
    its output's static metadata (shapes) depends on the data — e.g.
    CSR → ELL sizes the padded width to the max row degree, ELL → CSR
    sizes the flat arrays to the true nnz — so it performs its own small
    host syncs and cannot be traced."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, fmt):
        return self.fn(fmt)


class ConversionGraph:
    """Directed multigraph over format classes with conditional edges."""

    def __init__(self):
        # from_cls -> to_cls -> [(condition | None, fn)]
        self._edges: Dict[Type[Format], Dict[Type[Format], List[Tuple[Optional[Condition], ConversionFn]]]] = {}

    # -- registration (Converter::RegisterConversionFunction analogue) -------
    def register(
        self,
        from_cls: Type[Format],
        to_cls: Type[Format],
        fn: ConversionFn,
        condition: Optional[Condition] = None,
    ) -> None:
        self._edges.setdefault(from_cls, {}).setdefault(to_cls, []).append((condition, fn))

    def clear_edge(self, from_cls: Type[Format], to_cls: Type[Format]) -> None:
        self._edges.get(from_cls, {}).pop(to_cls, None)

    # -- path finding (ConversionBFS analogue, converter.cc:138-195) ---------
    def _usable(self, edges, from_ctx, to_ctx) -> Optional[ConversionFn]:
        for condition, fn in edges:
            if condition is None or condition(from_ctx, to_ctx):
                return fn
        return None

    def get_chain(
        self,
        from_cls: Type[Format],
        to_cls: Type[Format],
        from_ctx: Optional[Context] = None,
        to_ctx: Optional[Context] = None,
    ) -> Optional[List[Tuple[ConversionFn, Type[Format]]]]:
        """BFS for the shortest conversion chain; None if unreachable.

        Returns a list of (fn, resulting_class) steps; an empty list means
        no format change needed.
        """
        if from_cls is to_cls or issubclass(from_cls, to_cls):
            return []
        frontier = deque([from_cls])
        parents: Dict[Type[Format], Tuple[Type[Format], ConversionFn]] = {from_cls: None}
        while frontier:
            cur = frontier.popleft()
            for nxt, edges in self._edges.get(cur, {}).items():
                if nxt in parents:
                    continue
                fn = self._usable(edges, from_ctx, to_ctx)
                if fn is None:
                    continue
                parents[nxt] = (cur, fn)
                if nxt is to_cls:
                    chain = []
                    node = nxt
                    while parents[node] is not None:
                        prev, f = parents[node]
                        chain.append((f, node))
                        node = prev
                    chain.reverse()
                    return chain
                frontier.append(nxt)
        return None

    def can_convert(self, from_cls: Type[Format], to_cls: Type[Format]) -> bool:
        return self.get_chain(from_cls, to_cls) is not None

    # -- execution (Converter::Convert / ApplyConversionChain analogue) ------
    def convert(
        self,
        fmt: Format,
        to_cls: Type[Format],
        context: Optional[Context] = None,
    ) -> Format:
        result = self.convert_cached(fmt, to_cls, context)[-1]
        return result

    def convert_cached(
        self,
        fmt: Format,
        to_cls: Type[Format],
        context: Optional[Context] = None,
    ) -> List[Format]:
        """Like ``ConvertCached`` (converter.h:230-): returns every
        intermediate plus the final format, in order. The input itself is
        not included; if no work is needed the list holds just ``fmt``."""
        from_ctx = fmt.context
        chain = self.get_chain(type(fmt), to_cls, from_ctx, context)
        if chain is None:
            raise ConversionError(type(fmt).__name__, to_cls.__name__)
        # Placement first: run conversions where the result must live
        # (mirrors the reference inserting the H2D step before a CUDA impl).
        # Context-consuming edges (ContextConversion) do their own
        # placement, so the pre-move is skipped when the chain starts
        # (or ends) with one.
        out: List[Format] = []
        cur = fmt
        has_ctx_edge = any(isinstance(fn, ContextConversion) for fn, _ in chain)
        if (
            context is not None
            and not from_ctx.is_equivalent(context)
            and not has_ctx_edge
        ):
            cur = cur.to(context)
            out.append(cur)
        from ..context import HostContext

        on_host = isinstance(cur.context, HostContext)
        for fn, _cls in chain:
            if isinstance(fn, ContextConversion):
                cur = fn(cur, context)
            elif isinstance(fn, EagerConversion):
                cur = fn(cur)
            else:
                cur = fn(cur) if on_host else _device_fn(fn)(cur)
            out.append(cur)
        if not out:
            out.append(fmt)
        return out


# -- process-wide default graph (ConverterStore analogue) --------------------
_DEFAULT = ConversionGraph()


def default_graph() -> ConversionGraph:
    return _DEFAULT


def register_conversion(from_cls, to_cls, fn, condition=None):
    _DEFAULT.register(from_cls, to_cls, fn, condition)


def can_convert(from_cls, to_cls) -> bool:
    return _DEFAULT.can_convert(from_cls, to_cls)


def convert(fmt, to_cls, context=None, graph: Optional[ConversionGraph] = None):
    return (graph or _DEFAULT).convert(fmt, to_cls, context)


def convert_cached(fmt, to_cls, context=None, graph: Optional[ConversionGraph] = None):
    return (graph or _DEFAULT).convert_cached(fmt, to_cls, context)


def _register_builtin_edges():
    from ..formats.coo import COO
    from ..formats.csc import CSC
    from ..formats.csr import CSR
    from ..formats.dia import DIA
    from ..formats.ell import ELL
    from . import kernels as k

    register_conversion(COO, CSR, k.coo_to_csr)
    register_conversion(CSR, COO, k.csr_to_coo)
    register_conversion(COO, CSC, k.coo_to_csc)
    register_conversion(CSC, COO, k.csc_to_coo)
    register_conversion(CSR, CSC, k.csr_to_csc)
    register_conversion(CSC, CSR, k.csc_to_csr)
    # offsets become static metadata through a host sync: not jittable
    register_conversion(CSR, DIA, EagerConversion(k.csr_to_dia))
    register_conversion(DIA, CSR, EagerConversion(k.dia_to_csr))
    register_conversion(CSR, ELL, EagerConversion(k.csr_to_ell))
    register_conversion(ELL, CSR, EagerConversion(k.ell_to_csr))


_MESH_EDGES_DONE = False


def _register_mesh_edges():
    """Mesh-placement edges: ShardedCSR joins the conversion graph, gated
    on the target being a MeshContext (the CUDA-edge analogue). Called by
    ``sparsebase_tpu.parallel`` on import — the only way user code can
    name ShardedCSR."""
    global _MESH_EDGES_DONE
    if _MESH_EDGES_DONE:
        return
    _MESH_EDGES_DONE = True
    from ..context import MeshContext
    from ..formats.csr import CSR
    from ..parallel.sharded import ShardedCSR

    def to_sharded(csr, to_ctx):
        return ShardedCSR.from_csr(csr, to_ctx.mesh, axis=to_ctx.axis)

    def to_csr(sh, to_ctx):
        out = sh.to_csr()
        if to_ctx is not None:
            out = out.to(to_ctx)
        return out

    register_conversion(
        CSR,
        ShardedCSR,
        ContextConversion(to_sharded),
        condition=lambda f, t: isinstance(t, MeshContext),
    )
    register_conversion(ShardedCSR, CSR, ContextConversion(to_csr))


_register_builtin_edges()
