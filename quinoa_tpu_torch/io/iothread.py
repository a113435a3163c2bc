"""Asynchronous output worker: overlap file I/O with time stepping.

The port's own copy of quinoa_tpu/io/iothread.py.  The reference overlaps
its ExodusII field writes with computation via Charm++'s asynchronous
MeshWriter chare group (src/IO/MeshWriter.hpp).  Here one worker thread
runs whole write closures while the step loop goes on enqueueing device
work.  Torch tensors are mutable, so the caller hands the worker host
copies of what a write reads (the CLI copies the state to the host on
the main thread before it submits), never a tensor a later step could
change.

A SINGLE worker preserves write order per run.  Exceptions are captured
and re-raised at `close()` so a failed write still fails the run, just
not mid-overlap.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class AsyncWriter:
    """One background thread draining a FIFO of write closures."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self._exc: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        if enabled:
            self._thread = threading.Thread(
                target=self._drain, name="quinoa-io", daemon=True
            )
            self._thread.start()

    def _drain(self):
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                if self._exc is None:
                    fn()
            except BaseException as e:  # noqa: BLE001 — reported at close
                self._exc = e

    def submit(self, fn: Callable[[], None]) -> None:
        """Run `fn` on the worker (or inline when disabled)."""
        if self._exc is not None:
            self.close()  # re-raises the stored failure
        if self._thread is None:
            fn()
        else:
            self._q.put(fn)

    def close(self) -> None:
        """Drain the queue, stop the worker, re-raise any failure."""
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
