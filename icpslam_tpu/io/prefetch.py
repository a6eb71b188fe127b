"""Host-side scan prefetch: overlap scan prep + host→device transfer with
device compute.

Without it every scan's host work — npz decompression / .bin parse,
padding to capacity, and the host→device transfer — runs serialized with
the step dispatch, and mission wall throughput falls well below the
device step rate. The reference hides the same work
behind its callback threads (the AsyncSpinner's whole job,
``/root/reference/src/icpslam_node.cpp:9``); here a bounded background
thread prepares and ``jax.device_put``s scan i+1..i+depth while the
device computes scan i, so the main loop consumes clouds that are already
resident.

``device_put`` is async (returns immediately with the transfer enqueued),
and JAX dispatch is thread-safe, so the worker thread costs the main loop
nothing. Generator exceptions propagate to the consumer; the queue is
bounded so a fast producer cannot run ahead of memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

_STOP = object()


def prefetch(iterable: Iterable, prep: Callable, depth: int = 3) -> Iterator:
    """Yield ``prep(item)`` for each item, computed ``depth`` ahead in a
    background thread. ``depth <= 0`` degrades to inline mapping."""
    if depth <= 0:
        for item in iterable:
            yield prep(item)
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    err = []

    def worker():
        try:
            for item in iterable:
                q.put(prep(item))
        except BaseException as e:  # noqa: BLE001 — must surface in consumer
            err.append(e)
        finally:
            q.put(_STOP)

    t = threading.Thread(target=worker, name="scan-prefetch", daemon=True)
    t.start()
    while True:
        x = q.get()
        if x is _STOP:
            if err:
                raise err[0]
            return
        yield x
