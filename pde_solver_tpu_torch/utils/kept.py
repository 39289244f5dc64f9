"""The port's kept state: the bounded caches that calls share, and the
content hash that keys them.  A cache's owner passes the ``release`` that
frees what an entry holds on the device (its captured graphs) when the
entry leaves, evicted or cleared."""

import hashlib
import weakref

import numpy as np

from pde_solver_tpu_torch.utils import observability as obs

_ALL = weakref.WeakSet()


class Kept:
    """An LRU of at most ``size`` entries.  A put under a key it holds
    replaces that entry unreleased (its owner re-keeps the same object)."""

    def __init__(self, size: int, release=None):
        self.size = size
        self._release = release
        self._entries: dict = {}
        # its views, for inspection
        self.keys, self.values, self.items = (
            self._entries.keys, self._entries.values, self._entries.items)
        _ALL.add(self)

    def get(self, key):
        """The entry of ``key``, now the most recent, or None."""
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._entries[key] = entry
        return entry

    def put(self, key, value) -> None:
        """Keep ``value`` as the most recent entry; evict past ``size``."""
        self._entries.pop(key, None)
        self._entries[key] = value
        self._trim(self.size)

    def clear(self) -> None:
        """Release every entry, least recent first."""
        self._trim(0)

    def _trim(self, size: int) -> None:
        while len(self._entries) > size:
            entry = self._entries.pop(next(iter(self._entries)))
            if self._release is not None:
                self._release(entry)

    def __len__(self) -> int:
        return len(self._entries)


def clear_all() -> None:
    """Empty every :class:`Kept`, releasing its entries."""
    for cache in list(_ALL):
        cache.clear()


def feed(h, arrays):
    """Feed the arrays' bytes, in order, to the blake2b state ``h`` (None:
    a fresh one), counting them (``hashed_bytes``); returns the state."""
    if h is None:
        h = hashlib.blake2b(digest_size=16)
    n = 0
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(a)
        n += a.nbytes
    obs.count("hashed_bytes", n)
    return h


def digest(arrays) -> str:
    """A content key: the blake2b-128 hex digest of the arrays' bytes, in
    order, in the ``setup.hash`` span."""
    with obs.span("setup.hash"):
        return feed(None, arrays).hexdigest()
