"""Host-side prefetch: a producer thread fills a bounded queue of batches
while the main thread feeds the card.

Port of ``rnnt_tpu/data/pipeline.py``'s ``PrefetchIterator``; the train
loop wraps its ``BatchIterator`` in one, so tokenizing and collating the
next batches overlaps the current step's kernels.
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Wrap an iterable; a daemon producer thread keeps ``depth`` items
    ready.  Exceptions in the producer re-raise in the consumer."""

    _DONE = object()

    def __init__(self, iterable, depth: int = 4):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None

        def produce():
            try:
                for item in iterable:
                    self._queue.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised in consumer
                self._err = e
            finally:
                self._queue.put(self._DONE)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item
