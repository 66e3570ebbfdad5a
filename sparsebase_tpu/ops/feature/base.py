"""Feature-extraction framework: Extractable features + fused extraction.

JAX-native analogue of the reference feature framework
(reference: src/sparsebase/feature/feature_preprocess_type.h:9-18,
feature/extractor.{h,cc}, utils/extractable.h). A :class:`Feature` is an
auto-converting :class:`Operation` whose ``extract`` returns a dict
``{feature_class: value}``; fused features return several entries.
:class:`Extractor` covers a requested feature set with the largest
registered fused classes (ClassMatcher, the ``ClassMatcherMixin``
analogue) and merges results — one pass over the data computes several
features (extractor.cc:44-56).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Type

from ...context import Context
from ...dispatch import ClassMatcher, Operation
from ...formats.base import Format
from ...utils.exceptions import FeatureError


class Feature(Operation):
    """Extractable analogue: a dispatchable feature with params and sub-ids."""

    def __init__(self, name: str):
        super().__init__(name)
        self.params: Any = None
        # per-sub-feature params map (Extractable::pmap_ analogue)
        self.pmap: Dict[type, Any] = {}

    @classmethod
    def feature_id(cls) -> type:
        """Python type plays the role of std::type_index."""
        return cls

    def get_sub_ids(self) -> List[type]:
        return [type(self)]

    def get_subs(self) -> List["Feature"]:
        return [self]

    def extract(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ) -> Dict[type, Any]:
        value = self.execute(self.params, fmt, context=context, convert_input=convert_input)
        return {type(self): value}


class FusedFeature(Feature):
    """A feature computing several sub-features in one pass.

    Subclasses set ``SUB_FEATURES`` (tuple of Feature classes) and register
    an impl returning a dict keyed by those classes
    (cf. Degrees_DegreeDistribution, degrees_degree_distribution.cc:78-150).
    """

    SUB_FEATURES: Sequence[Type[Feature]] = ()

    def get_sub_ids(self) -> List[type]:
        return sorted(self.SUB_FEATURES, key=lambda c: c.__name__)

    def get_subs(self) -> List[Feature]:
        return [cls() for cls in self.get_sub_ids()]

    def extract(
        self, fmt: Format, context: Optional[Context] = None, convert_input: bool = True
    ) -> Dict[type, Any]:
        out = self.execute(self.params, fmt, context=context, convert_input=convert_input)
        if not isinstance(out, dict):
            raise FeatureError(f"{self.name}: fused impl must return a dict")
        return out


class Extractor:
    """Fused feature extraction (feature::Extractor analogue).

    ``extract`` merges the requested features into the largest registered
    (possibly fused) classes, runs each once, and unions the results.
    """

    def __init__(self):
        self._matcher = ClassMatcher()
        self._in: Dict[type, Feature] = {}

    # registration of available classes (ClassMatcherMixin::RegisterClass)
    def register_class(self, feature_cls: Type[Feature]) -> None:
        probe = feature_cls()
        self._matcher.register(probe.get_sub_ids(), feature_cls)

    # user selections (Extractor::Add / Subtract, extractor.cc)
    def add(self, feature: Feature) -> None:
        for fid in feature.get_sub_ids():
            self._in[fid] = feature

    def subtract(self, feature: Feature) -> None:
        for fid in feature.get_sub_ids():
            self._in.pop(fid, None)

    def get_list(self) -> List[type]:
        return sorted(self._in, key=lambda c: c.__name__)

    def extract(
        self,
        fmt: Format,
        features: Optional[Sequence] = None,
        context: Optional[Context] = None,
        convert_input: bool = True,
    ) -> Dict[type, Any]:
        """Run the requested (or added) features with fusion."""
        if features is not None:
            ids = [f if isinstance(f, type) else type(f) for f in features]
        else:
            ids = self.get_list()
        instances = self._matcher.match(ids)  # factories are invoked by match
        result: Dict[type, Any] = {}
        for inst in instances:
            result.update(inst.extract(fmt, context=context, convert_input=convert_input))
        return {k: v for k, v in result.items() if k in ids} if features is not None else result
