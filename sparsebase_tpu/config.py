"""Runtime configuration.

The reference's configuration is compile-time only: CMake options →
``config.h`` cmakedefines (USE_CUDA/USE_PIGO/USE_METIS/... +
ID/NNZ/VALUE type lists, reference: CMakeLists.txt:10-18, config.h.in).
Here a process-global dataclass plays both roles (SURVEY.md §5): feature
toggles are runtime flags, and the dtype universe defaults feed format
constructors.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Config:
    # dtype defaults (the ID_TYPES/NNZ_TYPES/VALUE_TYPES analogue)
    id_dtype: object = np.int32
    nnz_dtype: object = np.int32
    value_dtype: object = np.float32
    float_dtype: object = np.float32

    # feature toggles (USE_* analogues; all native, so default-on)
    use_fastio: bool = True  # native C++ parser for Pigo* readers
    use_device_kernels: bool = True  # device paths of reorders/features
    use_graphkit: bool = True  # native C++ host-graph-algorithm kernels

    # algorithm knobs
    rcm_peripheral_search: bool = True  # host RCM pseudo-peripheral pass
    sort_on_construction: bool = True  # CSR/COO invariant repair in .new()

    # logging
    log_level: Optional[str] = None  # "info" | "warning" | None (leave as-is)

    def apply(self) -> "Config":
        """Push settings into the relevant subsystems."""
        if self.log_level is not None:
            from .utils.logger import LogLevel, Logger

            Logger.set_level(
                {"info": LogLevel.LOG_LVL_INFO, "warning": LogLevel.LOG_LVL_WARNING}[
                    self.log_level
                ]
            )
        return self


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kw) -> Config:
    """Update global settings, e.g. ``set_config(use_fastio=False)``."""
    global _config
    _config = dataclasses.replace(_config, **kw).apply()
    return _config
