"""Operation dispatch with automatic input conversion.

JAX-native analogue of the reference ``FunctionMatcherMixin``
(reference: src/sparsebase/utils/function_matcher_mixin.h:40-418):
an operation holds a registry mapping tuples of input format classes to
implementation functions. Execution (``Execute`` :228-245 /
``CachedExecute`` :171-226 / ``GetFunction`` :335-416) first looks for an
exact key match; failing that, it asks the conversion graph for the
cheapest chain converting the inputs to some registered key
(``CheckIfKeyMatches`` :302-324 + per-key ``GetConversionChain``), applies
it, and runs the matched function.

Also here: :class:`ClassMatcher`, the analogue of ``ClassMatcherMixin``
(utils/class_matcher_mixin.h:12-170) used by fused feature extraction to
cover a requested feature set with the largest registered fused classes.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from .context import Context
from .convert.graph import ConversionGraph, default_graph
from .formats.base import Format
from .utils.exceptions import (
    DirectExecutionNotAvailableError,
    FunctionNotFoundError,
)

Key = Tuple[Type[Format], ...]
ImplFn = Callable[..., Any]


class Operation:
    """Multi-format operation with auto-conversion dispatch.

    Subclasses (or instances) register implementations keyed on the tuple
    of input format classes::

        op = Operation("reorder")
        op.register((CSR,), my_csr_impl)
        result = op.execute(params, some_coo)   # auto-converts COO→CSR
    """

    def __init__(self, name: str = "op", graph: Optional[ConversionGraph] = None):
        self.name = name
        self._graph = graph
        self._registry: Dict[Key, ImplFn] = {}

    # -- registration (RegisterFunction :67; override/unregister parity) -----
    def register(self, key: Sequence[Type[Format]], fn: ImplFn, overwrite: bool = True) -> bool:
        key = tuple(key)
        if not overwrite and key in self._registry:
            return False
        self._registry[key] = fn
        return True

    def unregister(self, key: Sequence[Type[Format]]) -> bool:
        return self._registry.pop(tuple(key), None) is not None

    def registered_keys(self) -> List[Key]:
        return list(self._registry)

    def graph(self) -> ConversionGraph:
        return self._graph or default_graph()

    # -- matching ------------------------------------------------------------
    def _match(
        self, formats: Sequence[Format], context: Optional[Context]
    ) -> Tuple[ImplFn, List[List]]:
        """Returns (fn, per-input conversion chains). Exact match first, else
        the minimum-total-cost convertible key (GetFunction :335-416)."""
        in_key = tuple(type(f) for f in formats)
        if in_key in self._registry:
            return self._registry[in_key], [None] * len(formats)
        graph = self.graph()
        best = None
        for key, fn in self._registry.items():
            if len(key) != len(formats):
                continue
            chains = []
            total = 0
            ok = True
            for fmt, target in zip(formats, key):
                if isinstance(fmt, target):
                    chains.append(None)
                    continue
                chain = graph.get_chain(type(fmt), target, fmt.context, context)
                if chain is None:
                    ok = False
                    break
                chains.append(chain)
                total += len(chain)
            if ok and (best is None or total < best[0]):
                best = (total, fn, chains)
        if best is None:
            raise FunctionNotFoundError(
                f"{self.name}: no implementation reachable for input types "
                f"({', '.join(t.__name__ for t in in_key)})"
            )
        return best[1], best[2]

    # -- execution -----------------------------------------------------------
    def execute(
        self,
        params: Any,
        *formats: Format,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Any:
        """Dispatch and run; converts inputs if needed (Execute :228-245).

        With ``convert_input=False``, raises
        :class:`DirectExecutionNotAvailableError` unless an exact key
        matches (mirroring the reference flag).
        """
        intermediates, result = self.execute_cached(
            params, *formats, context=context, convert_input=convert_input
        )
        return result

    def execute_cached(
        self,
        params: Any,
        *formats: Format,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Tuple[List[Optional[Format]], Any]:
        """Like ``CachedExecute`` (:171-226): additionally returns, per
        input, the converted format actually consumed (None if used as-is)."""
        in_key = tuple(type(f) for f in formats)
        if not convert_input and in_key not in self._registry:
            raise DirectExecutionNotAvailableError(in_key, self._registry.keys())
        fn, chains = self._match(formats, context)
        converted: List[Optional[Format]] = []
        final_inputs: List[Format] = []
        # Named profiler scopes (SURVEY §5 directive; reference analogue:
        # the per-kernel timers of concrete_experiment.cc:57-70): every
        # dispatched op and every auto-conversion shows up as its own
        # span in a jax.profiler trace instead of one opaque blob.
        import jax

        for fmt, chain in zip(formats, chains):
            if chain is None:
                if context is not None and not fmt.context.is_equivalent(context):
                    with jax.profiler.TraceAnnotation(
                        f"sbtpu:convert:{type(fmt).__name__}:to_context"
                    ):
                        fmt = fmt.to(context)
                    converted.append(fmt)
                else:
                    converted.append(None)
                final_inputs.append(fmt)
            else:
                cur = fmt
                if context is not None and not cur.context.is_equivalent(context):
                    with jax.profiler.TraceAnnotation(
                        f"sbtpu:convert:{type(cur).__name__}:to_context"
                    ):
                        cur = cur.to(context)
                for f, _cls in chain:
                    with jax.profiler.TraceAnnotation(
                        f"sbtpu:convert:{type(cur).__name__}->{_cls.__name__}"
                    ):
                        cur = f(cur)
                converted.append(cur)
                final_inputs.append(cur)
        with jax.profiler.TraceAnnotation(f"sbtpu:op:{self.name}"):
            return converted, fn(final_inputs, params)


class ClassMatcher:
    """Greedy largest-subset cover for fused feature extraction.

    Analogue of ``ClassMatcherMixin`` (utils/class_matcher_mixin.h:12-170):
    registered classes are keyed by the frozenset of feature ids they
    produce; ``match`` covers a requested id set with the largest
    registered classes first.
    """

    def __init__(self):
        self._classes: Dict[frozenset, Callable[[], Any]] = {}

    def register(self, ids: Sequence, factory: Callable[[], Any]) -> None:
        self._classes[frozenset(ids)] = factory

    def match(self, ids: Sequence) -> List[Any]:
        need = set(ids)
        chosen: List[Any] = []
        # Largest registered subset first (MatchClass :96-135 uses bitmask
        # enumeration via prev_permutation; a sorted greedy scan over
        # registered keys is equivalent for exact covers).
        while need:
            best = None
            for key in sorted(self._classes, key=len, reverse=True):
                if key <= need:
                    best = key
                    break
            if best is None:
                raise FunctionNotFoundError(
                    f"No registered class produces features {sorted(map(str, need))}"
                )
            chosen.append(self._classes[best]())
            need -= best
        return chosen
