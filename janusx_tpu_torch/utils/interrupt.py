"""Cooperative interrupt handling.

Reference analog: script/_common/interrupt.py (SIGINT handlers that kill
child processes) + the Rust kernels' check_ctrlc polling. Here: a
context manager that tracks spawned children and guarantees they are
terminated on Ctrl-C or scope exit; long host loops can poll
``interrupted()`` to stop between device dispatches.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import subprocess
import threading

log = logging.getLogger("janusx_tpu.interrupt")

_flag = threading.Event()
_children: list = []
_lock = threading.Lock()


def interrupted() -> bool:
    return _flag.is_set()


def register_child(proc: subprocess.Popen) -> None:
    with _lock:
        _children.append(proc)


def _kill_children() -> None:
    with _lock:
        procs, _children[:] = _children[:], []
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
                p.wait(timeout=5)
            except Exception:
                try:
                    p.kill()
                except Exception:
                    pass


@contextlib.contextmanager
def graceful_interrupts():
    """Install a SIGINT handler for the scope: first Ctrl-C sets the
    cooperative flag and kills registered children; a second Ctrl-C raises
    KeyboardInterrupt immediately."""
    _flag.clear()
    prev = signal.getsignal(signal.SIGINT)

    def handler(signum, frame):
        if _flag.is_set():
            signal.signal(signal.SIGINT, prev)
            raise KeyboardInterrupt
        log.warning("interrupt: finishing current stage (Ctrl-C again to abort)")
        _flag.set()
        _kill_children()

    try:
        signal.signal(signal.SIGINT, handler)
    except ValueError:  # not main thread: no handler, but the scope must
        # still clean up registered children and the cooperative flag
        try:
            yield
        finally:
            _kill_children()
            _flag.clear()
        return
    try:
        yield
    finally:
        _kill_children()
        signal.signal(signal.SIGINT, prev)
        _flag.clear()
