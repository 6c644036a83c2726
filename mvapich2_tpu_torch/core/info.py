"""MPI_Info objects (a copy of the JAX package's ``core/info.py``):
ordered string key-value sets. The spawn, port and name-service calls
(``runtime/spawn.py``, ``runtime/nameserv.py``) take an Info or a dict
(``as_dict``)."""

from __future__ import annotations

from typing import Dict, Optional

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024


class Info:
    def __init__(self, items: Optional[Dict[str, str]] = None):
        self._d: Dict[str, str] = dict(items or {})

    def set(self, key: str, value: str) -> None:
        self._d[key] = value

    def get(self, key: str) -> Optional[str]:
        return self._d.get(key)

    def delete(self, key: str) -> None:
        self._d.pop(key, None)

    @property
    def nkeys(self) -> int:
        return len(self._d)

    def nthkey(self, n: int) -> str:
        return list(self._d.keys())[n]

    def dup(self) -> "Info":
        return Info(self._d)

    def items(self):
        return self._d.items()


INFO_NULL = None
INFO_ENV = Info()


def as_dict(info) -> Dict[str, str]:
    """The hints of an Info, a dict or INFO_NULL, as a dict."""
    if isinstance(info, Info):
        return dict(info.items())
    return dict(info) if isinstance(info, dict) else {}
