"""Prefetching host loader — a copy of ``repro.data.loader``: a background
thread keeps a bounded queue of ready batches so host data work overlaps
device compute."""

from __future__ import annotations

import queue
import threading

__all__ = ["ShardedLoader"]


class ShardedLoader:
    """Iterates ``iterator`` through a queue of at most ``prefetch`` items
    filled by a daemon thread; :meth:`close` stops it."""

    def __init__(self, iterator, prefetch: int = 2):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
