"""Closeable FIFO handoff between pipeline stages.

The port's copy of ``gol_tpu/pipeline/inflight.py``: the ordered conduit
between a dispatching stage and a completing stage of a two-thread
pipeline (the JAX package's serve scheduler uses it between its dispatcher
and completer).

Deliberately tiny: ``put`` never blocks (the producer bounds in-flight
work before claiming, so the queue never exceeds the window depth); ``get``
blocks until an item or close; ``close`` drains: consumers see every item
already put, then ``None``. Put-after-close is a loud error (a dispatcher
bug must not silently enqueue work no consumer will ever see) and ``None``
stays out of band.
"""

from __future__ import annotations

import collections
import threading


class Handoff:
    """Unbounded closeable FIFO; ``get`` returns None once closed and empty."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: collections.deque = collections.deque()
        self._closed = False

    def put(self, item) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("handoff is closed")
            self._items.append(item)
            self._cv.notify_all()

    def get(self):
        """Next item, blocking; None when closed and drained."""
        with self._cv:
            while not self._items and not self._closed:
                self._cv.wait()
            if self._items:
                return self._items.popleft()
            return None

    def __len__(self) -> int:
        with self._cv:
            return len(self._items)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
