"""Prefetching of host work ahead of the device: ``prefetch_iterable``, the
port's copy of ``aha_tpu/data/pipeline.py:44-78``. The batch iterator and
the offline feature extraction of that module belong to training
(ROADMAP.md, Queue 1 item 6)."""

from __future__ import annotations

import queue
import threading

_DONE = object()


class _Raise:
    """Carries a producer's exception to the consumer (an item may itself be
    an exception object)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterable(it, depth: int = 2):
    """Yield ``it``'s items in order, computed up to ``depth`` ahead by a
    daemon thread: the drivers wrap their dataset loops with it so that the
    next video's decode (cv2 releases the interpreter lock) overlaps the
    device's scoring of this one. A producer's exception re-raises at the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for x in it:
                if stop.is_set():
                    return
                q.put(x)
            q.put(_DONE)
        except BaseException as e:            # re-raised on the consumer's side
            q.put(_Raise(e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            x = q.get()
            if x is _DONE:
                break
            if isinstance(x, _Raise):
                raise x.exc
            yield x
    finally:
        stop.set()
        try:                                   # unblock a producer waiting on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
