"""Abandoned step attempts: their in-place writes are dropped.

The training supervisor runs a step with ``step_timeout_s`` on a worker
thread and abandons the thread when the deadline passes, then restores
the pre-step state and retries (the JAX package does the same). A JAX
step that wakes up later can only assign new arrays; a PyTorch step
updates parameters and optimizer state in place, so a woken step would
write into the state the supervisor has just restored.

:func:`abandon` condemns the worker thread. The train steps
(``fleet.TrainStep``, ``CommOptTrainStep``) and ``Optimizer.step`` call
:func:`check` before they start and before their backward, and make
their in-place writes inside :func:`commit`, which refuses a condemned
thread. ``abandon`` then waits on the same lock, so once it returns True
no condemned write can begin, and a write that was under way has
finished (the supervisor's restore then overwrites it). A write that
does not finish within its timeout leaves the state unrestorable: the
supervisor aborts. A condemned attempt raises
:class:`AttemptAbandoned` on its own thread, where nobody waits for it;
``stats["dropped"]`` counts them.

What this does not cover: a closure of the user's own that writes state
in place outside these steps, and a step wedged inside its own backward
(its gradients land in ``param.grad`` while the retry runs). See
ROADMAP.md, "Divergences kept on purpose".
"""
from __future__ import annotations

import contextlib
import threading
import weakref

__all__ = ["AttemptAbandoned", "abandon", "check", "commit", "stats"]

_lock = threading.RLock()
_condemned: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
stats = {"abandoned": 0, "dropped": 0}


class AttemptAbandoned(RuntimeError):
    """This step attempt was abandoned by its supervisor; its writes are
    dropped."""


def abandon(thread: threading.Thread, timeout: float = None) -> bool:
    """Condemn ``thread``'s step attempt. Returns True once no write of
    it is under way; False if one is still under way after ``timeout``
    seconds (the attempt is wedged inside its writes, or in a collective
    they wait for, and the state cannot be restored under it)."""
    _condemned.add(thread)      # a write that starts from now is refused
    stats["abandoned"] += 1
    if not _lock.acquire(timeout=-1 if timeout is None else timeout):
        return False
    _lock.release()
    return True


def check() -> None:
    """Raise :class:`AttemptAbandoned` in a condemned attempt."""
    if threading.current_thread() in _condemned:
        with _lock:
            stats["dropped"] += 1
        raise AttemptAbandoned(
            "step attempt abandoned by its supervisor: update dropped")


@contextlib.contextmanager
def commit():
    """The in-place writes of one step: refused in a condemned attempt;
    :func:`abandon` waits for one under way."""
    with _lock:
        check()
        yield
