"""Attribute caching on communicators and datatypes (a copy of the JAX
package's ``core/attr.py``).

A Keyval carries the copy and delete callbacks with MPI's semantics:
``Comm.dup`` and ``Datatype.dup`` run each keyval's ``copy_fn``
(``copy_all``), ``Comm.free`` runs every ``delete_fn`` (``delete_all``),
and setting a key that holds a value deletes the old one first. Keyval
ids come from one process-wide counter, so two rank threads' keyvals
never share an id.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional, Tuple

from .errors import MPIException, MPI_ERR_KEYVAL

_keyval_ids = itertools.count(100)


class Keyval:
    def __init__(self, copy_fn: Optional[Callable] = None,
                 delete_fn: Optional[Callable] = None, extra: Any = None):
        self.id = next(_keyval_ids)
        self.copy_fn = copy_fn
        self.delete_fn = delete_fn
        self.extra = extra
        self.freed = False


KEYVAL_INVALID = -1


class AttrCache:
    """Per-object attribute dictionary keyed by Keyval."""

    def __init__(self):
        self._attrs: Dict[int, Tuple[Keyval, Any]] = {}

    def set(self, obj, keyval: Keyval, value: Any) -> None:
        if keyval.freed:
            raise MPIException(MPI_ERR_KEYVAL, "freed keyval")
        old = self._attrs.get(keyval.id)
        if old is not None and keyval.delete_fn is not None:
            keyval.delete_fn(obj, keyval.id, old[1], keyval.extra)
        self._attrs[keyval.id] = (keyval, value)

    def get(self, keyval: Keyval) -> Tuple[bool, Any]:
        got = self._attrs.get(keyval.id)
        return (True, got[1]) if got is not None else (False, None)

    def delete(self, obj, keyval: Keyval) -> None:
        got = self._attrs.pop(keyval.id, None)
        if got is not None and keyval.delete_fn is not None:
            keyval.delete_fn(obj, keyval.id, got[1], keyval.extra)

    def copy_all(self, old_obj, new_cache: "AttrCache") -> None:
        """On dup: apply each keyval's copy semantics (a keyval with no
        ``copy_fn``, MPI_NULL_COPY_FN, is not copied)."""
        for kv, value in list(self._attrs.values()):
            if kv.copy_fn is None:
                continue
            flag, newval = kv.copy_fn(old_obj, kv.id, kv.extra, value)
            if flag:
                new_cache._attrs[kv.id] = (kv, newval)

    def delete_all(self, obj) -> None:
        for kv, value in list(self._attrs.values()):
            if kv.delete_fn is not None:
                kv.delete_fn(obj, kv.id, value, kv.extra)
        self._attrs.clear()
