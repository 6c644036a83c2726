"""Control variables the port reads (a trimmed copy of the JAX package's
``utils/config.py`` registry).

Only what ``coll/device.py`` ``_select_transport`` reads: ``USE_DEVICE_COLL``
and the per-collective ``<COLL>_ALGO`` overrides. Each is settable through
the same ``MV2T_<NAME>`` environment variable as in the JAX package, read
at first use, or with :meth:`Config.set`.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict

ENV_PREFIX = "MV2T_"

_TRUE = {"1", "true", "yes", "on", "y"}
_FALSE = {"0", "false", "no", "off", "n"}


def _parse(typ: type, raw: str) -> Any:
    if typ is bool:
        low = raw.strip().lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
        raise ValueError(f"bad boolean: {raw!r}")
    return raw.strip()


class Config:
    """Registry of the port's cvars: name -> (default, type), values read
    from the environment at first use and overridable with ``set``."""

    def __init__(self, decls: Dict[str, Any]) -> None:
        self._defaults = dict(decls)
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _load(self, name: str) -> Any:
        default = self._defaults[name]
        raw = os.environ.get(ENV_PREFIX + name)
        return default if raw is None else _parse(type(default), raw)

    def __getitem__(self, name: str) -> Any:
        with self._lock:
            if name not in self._values:
                self._values[name] = self._load(name)
            return self._values[name]

    def get(self, name: str, default: Any = None) -> Any:
        if name not in self._defaults:
            return default
        return self[name]

    def set(self, name: str, value: Any) -> None:
        if name not in self._defaults:
            raise KeyError(f"unknown cvar {name!r}")
        with self._lock:
            self._values[name] = value


# <COLL>_ALGO names, one per MPI collective family the slot channel runs
ALGO_CVARS = ("ALLREDUCE", "REDUCE", "BCAST", "ALLGATHER", "ALLTOALL",
              "REDUCE_SCATTER")

_config = Config({"USE_DEVICE_COLL": True,
                  **{f"{c}_ALGO": "" for c in ALGO_CVARS}})


def get_config() -> Config:
    return _config
