"""``spawn``: run a function in worker processes, one per rank.
Counterpart of ``paddle_tpu/distributed/spawn.py``.

Each worker gets the environment that ``init_parallel_env`` reads:
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``
(torchrun's names) and ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM``
(the reference's), with a free port on localhost. ``nprocs <= 1`` runs
the function in this process under that environment (world size 1),
restores the environment after it, and returns the function's result.
Workers are started with the ``spawn`` method, so ``func`` must be
importable by name (a module-level function).
"""
from __future__ import annotations

import os
import time

import torch
import torch.multiprocessing as mp

from .collective import free_port

__all__ = ["spawn"]

_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
         "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM")


def _env(rank, nprocs, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(nprocs),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nprocs)}


def _worker(env, func, args):
    os.environ.update(env)
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, timeout=None, **kwargs):
    """Run ``func(*args)`` on ``nprocs`` ranks (-1: one per visible GPU,
    at least one). With ``join`` wait for all of them and raise
    ``RuntimeError`` if any exits non-zero, or if ``timeout`` seconds pass
    first; the other workers are terminated then. Without ``join`` return
    the processes."""
    if nprocs is None or nprocs < 0:
        nprocs = max(1, torch.cuda.device_count())
    port = free_port()
    if nprocs <= 1:
        saved = {k: os.environ.get(k) for k in _KEYS}
        os.environ.update(_env(0, 1, port))
        try:
            return func(*args)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker,
                        args=(_env(rank, nprocs, port), func, args),
                        daemon=False)
        p.start()
        procs.append(p)
    if not join:
        return procs
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"spawn: workers still running after "
                                   f"{timeout} s")
            if any(p.exitcode not in (None, 0) for p in procs):
                break                   # one failed: stop the others
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn workers failed: exitcodes "
                           f"{[p.exitcode for p in procs]}")
    return None
