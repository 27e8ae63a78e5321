"""DataLoader. Counterpart of ``paddle_tpu/io/dataloader.py`` (reference:
python/paddle/io/dataloader/dataloader_iter.py).

The same batches in the same order as the JAX package's loader; each
batch lands on the loader's ``device`` as torch tensors (the framework's
default, ``cuda``, which raises when CUDA is absent: pass
``device="cpu"``).

``num_workers > 0`` runs true multiprocess workers (the analog of the
reference's ``_DataLoaderIterMultiProcess``): each worker process pulls
batch-index tasks from a shared queue, collates to numpy and ships the
batch back; the parent reorders to preserve batch order. Workers are
host-side processes that never see the card (``CUDA_VISIBLE_DEVICES`` is
empty in them). If the dataset or collate function cannot cross a
process boundary (unpicklable closures), a producer thread feeding a
bounded queue takes over, as in the JAX package when its native
prefetcher is not built. The native ring-buffer prefetcher and the
parallel ``gather_stack`` are the host runtime (ROADMAP.md, port queue
item 7). Each fetch calls ``profiler.benchmark()``'s reader-cost hooks
and, while tracing is on, records one ``train.data`` span.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
import queue
import threading
import time

import numpy as np
import torch

from ..framework.device import resolve_device
from ..observability import tracing as _tracing
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn"]

_WORKER_TLS = threading.local()
# what a span site enters while tracing is off
_NO_SPAN = contextlib.nullcontext()


class WorkerInfo:
    """Reference: io/dataloader/worker.py::WorkerInfo."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


def _worker_info():
    return getattr(_WORKER_TLS, "info", None)


class _ExcInfo:
    """Pickled exception crossing the worker -> parent queue."""

    def __init__(self, exc):
        import traceback

        self.exc = exc
        self.tb = traceback.format_exc()


def _mp_worker_loop(dataset, collate_fn, idx_q, out_q, worker_id,
                    num_workers, worker_init_fn, iterable, batch_size,
                    drop_last):
    """Runs in a child process (module-level for spawn picklability)."""
    _WORKER_TLS.info = WorkerInfo(worker_id, num_workers, dataset)
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if iterable:
            # each worker iterates its own dataset copy; sharding is the
            # dataset's job via get_worker_info() (reference worker.py)
            batch = []
            for item in dataset:
                batch.append(item)
                if len(batch) == batch_size:
                    out_q.put(("data", collate_fn(batch)))
                    batch = []
            if batch and not drop_last:
                out_q.put(("data", collate_fn(batch)))
        else:
            while True:
                task = idx_q.get()
                if task is None:
                    break
                bidx, idxs = task
                try:
                    out = ("batch", bidx,
                           collate_fn([dataset[i] for i in idxs]))
                except Exception as e:  # ship to parent, keep serving
                    out = ("batch", bidx, _ExcInfo(e))
                out_q.put(out)
    except Exception as e:
        out_q.put(("fatal", _ExcInfo(e)))
    finally:
        out_q.put(("done", worker_id))


def default_collate_fn(batch):
    """Stack samples into batched arrays: numpy samples into numpy
    arrays, tensor samples into a tensor on their device; the loader
    moves the batch to its device."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return np.asarray(batch)
    return batch


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, device=None):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.return_list = return_list
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def _make_batches(self):
        if self._iterable_mode:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _try_multiprocess_iter(self):
        """Spawn worker processes; None if state can't cross processes
        (unpicklable dataset/collate -> caller falls back to a thread).
        Picklability surfaces from Process.start() itself (spawn pickles
        the args there): no wasteful pre-serialization of the dataset."""
        method = os.environ.get("PADDLE_TPU_MP_START", "spawn")
        try:
            ctx = multiprocessing.get_context(method)
            return self._multiprocess_iter(ctx)
        except (TypeError, AttributeError, ValueError, ImportError,
                OSError) as e:
            import pickle
            if isinstance(e, pickle.PicklingError) or "pickle" in str(e):
                return None
            if isinstance(e, (TypeError, AttributeError)):
                return None  # unpicklable closures raise these from spawn
            raise

    def _multiprocess_iter(self, ctx):
        n = self.num_workers
        out_q = ctx.Queue()
        idx_q = ctx.Queue() if not self._iterable_mode else None
        procs = []
        timeout = self.timeout if self.timeout and self.timeout > 0 else None
        # workers are host-side (numpy) processes and must never claim the
        # card: hide it from them while they start
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for wid in range(n):
                p = ctx.Process(
                    target=_mp_worker_loop,
                    args=(self.dataset, self.collate_fn, idx_q, out_q, wid,
                          n, self.worker_init_fn, self._iterable_mode,
                          getattr(self, "batch_size", 1),
                          getattr(self, "drop_last", False)),
                    daemon=True)
                p.start()
                procs.append(p)
        except BaseException:
            for p in procs:  # failed mid-gang (e.g. unpicklable args)
                if p.is_alive():
                    p.terminate()
            raise
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

        def shutdown():
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=1.0)

        def get(block_timeout):
            # poll in short slices so a worker that died before signaling
            # (bad unpickle, OOM-kill) raises instead of hanging forever
            deadline = (time.monotonic() + block_timeout
                        if block_timeout else None)
            while True:
                try:
                    return out_q.get(timeout=1.0)
                except queue.Empty:
                    pass
                dead = [p.pid for p in procs
                        if not p.is_alive() and p.exitcode not in (0, None)]
                if dead:
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} died unexpectedly "
                        f"(exitcodes: "
                        f"{[p.exitcode for p in procs]})")
                if deadline and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"DataLoader worker timed out after {block_timeout}s")

        if self._iterable_mode:
            def gen():
                done = 0
                try:
                    while done < n:
                        msg = get(timeout)
                        if msg[0] == "done":
                            done += 1
                        elif msg[0] == "fatal":
                            raise RuntimeError(
                                "DataLoader worker failed:\n" + msg[1].tb)
                        else:
                            yield msg[1]
                finally:
                    shutdown()
            return gen()

        def gen():
            tasks = list(enumerate(self.batch_sampler))
            n_tasks = len(tasks)
            inflight_target = n * self.prefetch_factor
            sent = 0
            try:
                for _ in range(min(inflight_target, n_tasks)):
                    idx_q.put(tasks[sent])
                    sent += 1
                buffered = {}
                next_idx = 0
                done = 0
                while next_idx < n_tasks:
                    while next_idx in buffered:
                        b = buffered.pop(next_idx)
                        if isinstance(b, _ExcInfo):
                            raise RuntimeError(
                                "DataLoader worker raised:\n" + b.tb)
                        next_idx += 1
                        if sent < n_tasks:
                            idx_q.put(tasks[sent])
                            sent += 1
                        yield b
                    if next_idx >= n_tasks:
                        break
                    msg = get(timeout)
                    if msg[0] == "batch":
                        buffered[msg[1]] = msg[2]
                    elif msg[0] == "fatal":
                        raise RuntimeError(
                            "DataLoader worker failed:\n" + msg[1].tb)
                    elif msg[0] == "done":
                        done += 1
                        if done == n and next_idx < n_tasks:
                            raise RuntimeError(
                                "all DataLoader workers exited early")
            finally:
                for _ in procs:
                    try:
                        idx_q.put(None)
                    except Exception:
                        pass
                shutdown()
        return gen()

    def _to_device(self, b):
        if isinstance(b, tuple):
            return tuple(self._to_device(x) for x in b)
        if isinstance(b, list):
            return [self._to_device(x) for x in b]
        if isinstance(b, dict):
            return {k: self._to_device(v) for k, v in b.items()}
        if isinstance(b, np.ndarray):
            return torch.from_numpy(b).to(self.device)
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        return b

    def __iter__(self):
        # the benchmark() reader-cost hooks (reference fluid/reader.py
        # calls them inside its reader loop; profiler/timer.py) and one
        # train.data span per fetch, the move to the device included
        from ..profiler.timer import benchmark as _benchmark

        bm = _benchmark()
        bm.check_if_need_record(self)  # first active loader owns timing
        it = self._iter_batches()
        try:
            while True:
                bm.before_reader(owner=id(self))
                try:
                    with (_tracing.span("train.data", cat="train")
                          if _tracing._ENABLED else _NO_SPAN):
                        batch = self._to_device(next(it))
                except StopIteration:
                    return
                finally:
                    bm.after_reader(owner=id(self))
                yield batch
        finally:
            bm.release_reader(self)

    def _iter_batches(self):
        if self.num_workers == 0:
            yield from self._make_batches()
            return

        # Iterable datasets keep the single-producer path: multiprocess
        # workers would each replay the full stream (num_workers x
        # duplication) unless the dataset shards itself; opt in with
        # PADDLE_TPU_ITERABLE_MP=1 when it does (via get_worker_info,
        # reference worker.py contract).
        mp_ok = (not self._iterable_mode
                 or os.environ.get("PADDLE_TPU_ITERABLE_MP") == "1")
        if mp_ok and os.environ.get("PADDLE_TPU_DATALOADER_MP", "1") != "0":
            mp_iter = self._try_multiprocess_iter()
            if mp_iter is not None:
                yield from mp_iter
                return

        def tagged_batches():
            # mark the producing thread as worker 0 of num_workers so
            # get_worker_info() answers inside dataset/collate code
            _WORKER_TLS.info = WorkerInfo(0, self.num_workers, self.dataset)
            try:
                yield from self._make_batches()
            finally:
                _WORKER_TLS.info = None

        q: queue.Queue = queue.Queue(self.num_workers * self.prefetch_factor)
        sentinel = object()

        def producer():
            try:
                for b in tagged_batches():
                    q.put(b)
                q.put(sentinel)
            except BaseException as e:  # surface dataset errors to consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is sentinel:
                break
            if isinstance(b, BaseException):
                raise b
            yield b
