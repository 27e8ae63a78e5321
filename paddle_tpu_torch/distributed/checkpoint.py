"""Checkpointing with an atomic, checksummed commit. Counterpart of
``paddle_tpu/distributed/checkpoint.py``.

The commit layer is the JAX package's, line for line (it is
format-agnostic): every ``CheckpointManager`` step is written into a
hidden temp dir, sealed with a ``COMMIT`` manifest of per-file sizes +
CRC32 checksums, and then renamed into place, one atomic filesystem op.
A SIGKILL at ANY instant therefore leaves either the previous committed
steps untouched, or the new step fully committed; ``restore_latest``
verifies manifests and falls back past torn or corrupted steps instead of
loading them. The two packages read each other's COMMIT markers.

The state format is the port's own:

* **World 1.** ``save_distributed(state, path)`` writes ``path`` as one
  file in the JAX package's ``framework/io.save`` layout: a pickle of the
  state's nested dicts and lists with numpy leaves. bfloat16 tensors are
  widened to float32 (exact) and listed in a dtype record beside the file
  (``<path>.dtypes.json``), so a bf16 round trip is bit for bit. The JAX
  package's ``load_distributed`` reads a non-directory path through
  ``framework.io.load``, so its ``CheckpointManager.restore_latest`` reads
  a step the port wrote.
* **World > 1.** ``path`` is a directory in which each rank writes its
  own file, ``shard-<rank>-of-<world>`` (and its dtype record); nothing
  is gathered. Under ``CheckpointManager`` rank 0 seals the step once
  every rank's file has landed.
* **Restore.** Each rank reads its own file when the checkpoint's world
  is the current one. Otherwise every file is read and the result is a
  :class:`RankStates` (the per-rank trees in rank order), which
  ``resilience.TrainState`` hands to a train step that can re-shard it
  (``CommOptTrainStep`` across dp degrees).

A save copies every tensor to host memory before it returns, also with
``async_save=True``: only host arrays reach the writer thread, so a step
that updates the parameters and moments in place right after the save
cannot tear the file (whose CRC would then match the torn bytes).

Loads land on the device: with a ``template`` (the same nested structure)
each leaf takes its template leaf's dtype and device; without one every
array becomes a tensor on ``device`` (the framework's default, ``cuda``,
which raises when CUDA is absent: pass ``device="cpu"``).
"""
from __future__ import annotations

import json
import os
import pickle
import re
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..jit.serialization import _ArtifactUnpickler

__all__ = ["COMMIT_MARKER", "CheckpointManager", "RankStates",
           "load_distributed", "save_distributed", "verify_commit",
           "wait_for_checkpoints", "write_commit_marker"]

_DTYPES_SUFFIX = ".dtypes.json"
_SHARD_RE = re.compile(r"shard-(\d+)-of-(\d+)")
# a rank polls this long for the others' files (and rank 0's seal)
_PEER_TIMEOUT_S = 600.0


class RankStates(list):
    """The per-rank state trees of a checkpoint written by another number
    of ranks than the reader's, in rank order."""


def _world():
    from .collective import get_rank, get_world_size
    return get_rank(), get_world_size()


# -- host snapshot -----------------------------------------------------------

def _host_leaf(v, path, dtypes, devices=None):
    """One leaf as a host numpy array: a CUDA tensor is copied (bf16
    widened to float32 on the card first) into pinned memory without
    waiting; the caller synchronizes ``devices`` once."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            dtypes[json.dumps(path)] = "bfloat16"
            t = t.float()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            if devices is not None:
                devices.add(t.device)
            return buf.numpy()
        return t.to("cpu", copy=True).numpy()
    if isinstance(v, np.ndarray):
        return v.copy()
    return v


def _to_host(tree, path=(), dtypes=None, devices=None):
    """``tree`` with every tensor copied into a host numpy array (bf16
    widened to float32 and recorded in ``dtypes`` by key path). The copy
    is complete when this returns."""
    top = devices is None
    devices = set() if top else devices
    if isinstance(tree, dict):
        out = {k: _to_host(v, path + (k,), dtypes, devices)
               for k, v in tree.items()}
    elif isinstance(tree, (list, tuple)):
        out = [_to_host(v, path + (i,), dtypes, devices)
               for i, v in enumerate(tree)]
        out = out if isinstance(tree, list) else tuple(out)
    else:
        out = _host_leaf(tree, list(path), dtypes, devices)
    if top:
        for d in devices:
            torch.cuda.synchronize(d)
    return out


# -- files -------------------------------------------------------------------

class _CrcWriter:
    """A file that keeps the size and CRC32 of what was written to it,
    so the COMMIT manifest need not read the file back."""

    def __init__(self, fh):
        self.fh, self.size, self.crc = fh, 0, 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        n = self.fh.write(b)
        self.size += n
        return n


def _write_state(host, dtypes, path, times=None):
    """The ``framework/io.save`` layout (pickle protocol 5: arrays are
    written from their own memory), published atomically: a kill
    mid-pickle never leaves a torn file where a good one used to be.
    Returns {file name: [size, crc32]} of the state file; ``times`` gets
    the seconds of the pickle (its CRC in the same pass) and the fsync."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    if dtypes:
        tmp = f"{path}{_DTYPES_SUFFIX}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(dtypes, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path + _DTYPES_SUFFIX)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        w = _CrcWriter(fh)
        t0 = time.perf_counter()
        pickle.dump(host, w, protocol=5)
        fh.flush()
        t1 = time.perf_counter()
        os.fsync(fh.fileno())
        if times is not None:
            times.update(pickle_s=t1 - t0, fsync_s=time.perf_counter() - t1)
    os.replace(tmp, path)
    return {os.path.basename(path): [w.size, w.crc & 0xFFFFFFFF]}


class _StateUnpickler(_ArtifactUnpickler):
    """Admits what a state file holds: numpy arrays and dtypes, builtin
    containers and ``ml_dtypes`` dtypes (a JAX-written bf16 array)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except pickle.UnpicklingError:
            raise pickle.UnpicklingError(
                f"load_distributed: the state file refers to "
                f"{module}.{name}, which a checkpoint never holds") from None


def _read_state(path):
    with open(path, "rb") as fh:
        tree = _StateUnpickler(fh).load()
    dtypes = {}
    if os.path.isfile(path + _DTYPES_SUFFIX):
        with open(path + _DTYPES_SUFFIX, encoding="utf-8") as fh:
            dtypes = json.load(fh)
    return tree, dtypes


def _shards(path):
    """{rank: file} of a multi-rank state directory, checked whole."""
    found, worlds = {}, set()
    for name in os.listdir(path):
        m = _SHARD_RE.fullmatch(name)
        if m:
            found[int(m.group(1))] = os.path.join(path, name)
            worlds.add(int(m.group(2)))
    if len(worlds) != 1 or sorted(found) != list(range(worlds.pop())):
        raise FileNotFoundError(f"{path}: the rank files are incomplete "
                                f"({sorted(found)})")
    return found


def _shard_name(rank, world):
    return f"shard-{rank:05d}-of-{world:05d}"


# -- typed load --------------------------------------------------------------

def _host_tensor(a, bf16=False):
    """A stored array as a CPU tensor (no copy when it is writable): an
    ml_dtypes bf16 array via float32; ``bf16`` marks a widened one."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a, bf16 = a.astype(np.float32), True
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t, bf16


def _leaf(tree):
    if isinstance(tree, dict) and tree.get("__tensor__") is True:
        return tree["data"]             # a JAX framework/io Tensor record
    return tree


def _typed(tree, dtypes, device, path=()):
    """Template-free: every array a tensor on ``device`` (bf16 where the
    dtype record says so)."""
    tree = _leaf(tree)
    if isinstance(tree, dict):
        return {k: _typed(v, dtypes, device, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_typed(v, dtypes, device, path + (i,))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, (np.ndarray, np.generic)):
        t, bf16 = _host_tensor(
            tree, dtypes.get(json.dumps(list(path))) == "bfloat16")
        t = t.to(device)
        return t.to(torch.bfloat16) if bf16 else t
    return tree


def _like(tree, template, where="state"):
    """``tree`` in ``template``'s structure, each leaf in its template
    leaf's dtype and on its device; raises ValueError on a mismatch."""
    tree = _leaf(tree)
    if isinstance(template, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: not a dict")
        if set(tree) != set(template):
            raise ValueError(f"{where}: keys {sorted(map(str, tree))} do not "
                             f"match the template's "
                             f"{sorted(map(str, template))}")
        return {k: _like(tree[k], template[k], f"{where}.{k}")
                for k in template}
    if isinstance(template, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(template):
            raise ValueError(f"{where}: length does not match the template")
        out = [_like(a, b, f"{where}[{i}]")
               for i, (a, b) in enumerate(zip(tree, template))]
        return out if isinstance(template, list) else tuple(out)
    if isinstance(template, torch.Tensor):
        if tree is None:
            raise ValueError(f"{where}: missing array")
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(template.device, template.dtype,
                                    copy=True)
        t, _ = _host_tensor(tree)
        # to the device first, then the dtype: bf16 narrows on the card
        return t.to(template.device).to(template.dtype)
    if isinstance(template, np.ndarray):
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        return np.asarray(tree, dtype=template.dtype).copy()
    return tree


def _convert(tree, dtypes, template, device):
    if template is not None:
        return _like(tree, template)
    from ..framework.device import resolve_device
    return _typed(tree, dtypes, resolve_device(device))


# -- save / load -------------------------------------------------------------

_pending: list = []         # async writer threads, joined by wait_for_...
_pending_lock = threading.Lock()


def _spawn_writer(fn, name):
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:      # re-raised by wait_for_checkpoints
            box["err"] = e

    t = threading.Thread(target=run, daemon=True, name=name)
    t.box = box
    with _pending_lock:
        _pending.append(t)
    t.start()
    return t


def save_distributed(state, path, async_save=False):
    """Save a nested dict/list of tensors and arrays.

    The host copy is taken before this returns; with ``async_save=True``
    only the file write runs on a background thread; join it with
    :func:`wait_for_checkpoints`. At world > 1 every rank calls this and
    writes its own file under the directory ``path``."""
    rank, world = _world()
    dtypes: dict = {}
    host = _to_host(state, (), dtypes)
    path = os.path.abspath(path)
    if world > 1:
        target = os.path.join(path, _shard_name(rank, world))
    else:
        wait_for_checkpoints()
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)
        target = path

    def write():
        _write_state(host, dtypes, target)

    if async_save:
        _spawn_writer(write, f"ckpt-write-{os.path.basename(path)}")
    else:
        write()
    return path


def wait_for_checkpoints():
    """Block until outstanding async saves are durable; re-raise the
    first failure."""
    with _pending_lock:
        threads = list(_pending)
        _pending.clear()
    err = None
    for t in threads:
        t.join()
        if err is None and "err" in t.box:
            err = t.box["err"]
    if err is not None:
        raise err


def load_distributed(path, template=None, device=None):
    """Restore a saved tree. With a ``template`` (the same structure;
    leaves are tensors or arrays) each leaf takes its template leaf's
    dtype and device; without one every array lands on ``device``
    (default: the framework's, ``cuda``). A directory written by another
    number of ranks loads whole, as a :class:`RankStates`."""
    if not os.path.isdir(path):
        tree, dtypes = _read_state(path)
        return _convert(tree, dtypes, template, device)
    rank, world = _world()
    files = _shards(path)
    if len(files) == world:
        tree, dtypes = _read_state(files[rank])
        return _convert(tree, dtypes, template, device)
    out = RankStates()
    for r in sorted(files):
        tree, dtypes = _read_state(files[r])
        out.append(_convert(tree, dtypes, template, device))
    return out


# -- atomic commit layer ------------------------------------------------------

COMMIT_MARKER = "COMMIT"


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OverflowError):
        return True     # exists (or unknowable): treat as live, don't sweep
    return True


def _crc32_file(path, chunk=1 << 20):
    crc = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            crc = zlib.crc32(block, crc)
    return crc & 0xFFFFFFFF


def _manifest(root, known=None):
    """{relative file path: [size, crc32]} over every file under root
    (excluding the COMMIT marker itself). ``known`` holds entries the
    writer computed as it wrote; they are taken when the size matches."""
    out = {}
    known = known or {}
    for base, _dirs, names in os.walk(root):
        for name in sorted(names):
            if base == root and name == COMMIT_MARKER:
                continue
            full = os.path.join(base, name)
            rel = os.path.relpath(full, root)
            size = os.path.getsize(full)
            k = known.get(rel)
            out[rel] = ([size, k[1]] if k is not None and k[0] == size
                        else [size, _crc32_file(full)])
    return out


def write_commit_marker(root, step=None, known=None):
    """Seal ``root``: record every file's size + CRC32 in a COMMIT
    manifest, fsynced before it lands, so verify_commit can prove the
    directory is neither torn nor bit-rotted. ``known``: {relative path:
    [size, crc32]} the writer computed while writing."""
    marker = {"step": step, "files": _manifest(root, known)}
    path = os.path.join(root, COMMIT_MARKER)
    # the marker is written inside a still-hidden .tmp-ckpt dir; the
    # caller's dir rename IS the publish
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(marker))
        fh.flush()
        os.fsync(fh.fileno())
    return path


def verify_commit(root):
    """(ok, reason): COMMIT marker present and every manifest entry
    matches the bytes on disk."""
    path = os.path.join(root, COMMIT_MARKER)
    if not os.path.isfile(path):
        return False, "missing COMMIT marker"
    try:
        with open(path, encoding="utf-8") as fh:
            marker = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        return False, f"unreadable COMMIT marker ({type(e).__name__})"
    for rel, (size, crc) in marker.get("files", {}).items():
        full = os.path.join(root, rel)
        if not os.path.isfile(full):
            return False, f"missing shard {rel}"
        if os.path.getsize(full) != size:
            return False, f"truncated shard {rel}"
        if _crc32_file(full) != crc:
            return False, f"bad checksum on shard {rel}"
    return True, "ok"


def _poll(cond, what, timeout=_PEER_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: {what} did not happen within "
                               f"{timeout:.0f} s")
        time.sleep(0.01)


class CheckpointManager:
    """Step-numbered checkpoints with retention (reference:
    incubate/checkpoint/auto_checkpoint.py train-epoch-range bookkeeping).

    save(step, state) writes <dir>/ckpt-<step> asynchronously and prunes to
    ``max_to_keep``; restore_latest() reloads the newest durable step.

    Writes are atomic: state lands in a hidden ``.tmp-ckpt-*`` dir, a
    COMMIT manifest (per-file size + CRC32) seals it, and one rename
    publishes it. Async saves overlap training but serialize with each
    other; retention prunes committed steps only and never the newest.

    At world > 1 every rank calls ``save`` with its own state: the ranks
    agree on rank 0's temp dir (one broadcast), each writes its file, and
    rank 0 seals and publishes once all of them are there; a rank's
    ``wait()`` returns once the step is published. Only rank 0 prunes and
    sweeps. ``device`` is where template-free restores land (default: the
    framework's device). ``last_save`` holds the newest published save's
    costs on this rank: its step, its file's bytes, the host copy, the
    pickle (CRC included) and fsync of the write, and the wall from the
    host copy's start to the publish.
    """

    def __init__(self, directory, max_to_keep: int = 3, device=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.device = device
        self.rank, self.world = _world()
        os.makedirs(self.directory, exist_ok=True)
        self._inflight: Optional[threading.Thread] = None
        self._inflight_error = None
        self.last_save: Optional[dict] = None
        if self.rank != 0:
            return
        # leftovers from a KILLED writer are dead on arrival (nobody can
        # commit them) — but another live manager on this dir may still
        # be writing its own tmp, so only sweep when the owning pid is
        # gone
        for name in os.listdir(self.directory):
            if not name.startswith(".tmp-ckpt-"):
                continue
            m = re.fullmatch(r"\.tmp-ckpt-\d+-(\d+)", name)
            if m and m.group(1) != str(os.getpid()) \
                    and not _pid_alive(int(m.group(1))):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt-(\d+)", name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    def all_steps(self):
        return [s for s, _ in self._step_dirs()]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self):
        """Join the in-flight async save; re-raise its failure if any."""
        t = self._inflight
        if t is not None:
            t.join()
            self._inflight = None
        if self._inflight_error is not None:
            err, self._inflight_error = self._inflight_error, None
            raise err

    def _owner_pid(self):
        """Rank 0's pid on every rank (it names the shared temp dir)."""
        if self.world == 1:
            return os.getpid()
        from ..framework.device import resolve_device
        from .collective import broadcast
        t = torch.tensor([os.getpid() if self.rank == 0 else 0],
                         dtype=torch.int64, device=resolve_device())
        return int(broadcast(t, src=0).item())

    def save(self, step: int, state: Any, async_save=True):
        """Write ckpt-<step>. The host copy of ``state`` is taken before
        this returns; with async_save the file write and the
        commit+rename run on a background thread (training continues);
        call wait(), or the next save, to join it.
        """
        self.wait()
        step = int(step)
        tmp = os.path.join(self.directory,
                           f".tmp-ckpt-{step}-{self._owner_pid()}")
        final = os.path.join(self.directory, f"ckpt-{step}")
        if self.rank == 0:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        if self.world > 1:
            from .collective import barrier
            barrier()
        dtypes: dict = {}
        t0 = time.perf_counter()
        host = _to_host(state, (), dtypes)
        copied = time.perf_counter()
        inner = os.path.join(tmp, "state")
        target = (os.path.join(inner, _shard_name(self.rank, self.world))
                  if self.world > 1 else inner)

        def finalize():
            times = {}
            written = _write_state(host, dtypes, target, times)
            known = {os.path.relpath(os.path.join(os.path.dirname(target),
                                                  k), tmp): v
                     for k, v in written.items()}
            if self.rank != 0:
                # rank 0 publishes; this rank's save ends when it has
                _poll(lambda: not os.path.isdir(tmp), f"step {step}'s seal")
            else:
                if self.world > 1:
                    _poll(lambda: _complete(inner, self.world),
                          f"every rank's file of step {step}")
                write_commit_marker(tmp, step, known)
                if os.path.isdir(final):        # re-save of the same step
                    shutil.rmtree(final)
                os.rename(tmp, final)           # the atomic publish
            self.last_save = dict(
                step=step, bytes=sum(v[0] for v in written.values()),
                host_copy_s=copied - t0, wall_s=time.perf_counter() - t0,
                **times)
            if self.rank == 0:
                self._prune(keep_step=step)

        if async_save:
            def runner():
                try:
                    finalize()
                except Exception as e:      # surfaced on the next wait()
                    self._inflight_error = e
            t = threading.Thread(target=runner, daemon=True,
                                 name=f"ckpt-commit-{step}")
            self._inflight = t
            t.start()
        else:
            finalize()
        return final

    def _prune(self, keep_step=None):
        """Drop committed steps beyond max_to_keep, oldest first. The
        newest committed step (and the one just written) are never
        candidates, so a reader always finds an intact latest."""
        dirs = self._step_dirs()
        committed = [(s, p) for s, p in dirs
                     if os.path.isfile(os.path.join(p, COMMIT_MARKER))]
        excess = len(committed) - self.max_to_keep
        for s, p in committed[:max(excess, 0)]:
            if s == keep_step or (committed and s == committed[-1][0]):
                continue
            shutil.rmtree(p, ignore_errors=True)

    def restore(self, step: int, template=None):
        root = os.path.join(self.directory, f"ckpt-{step}")
        inner = os.path.join(root, "state")
        # committed layout keeps the state under <step>/state; fall back
        # to the pre-manifest layout where state WAS the step dir
        return load_distributed(
            inner if os.path.exists(inner) else root, template, self.device)

    def restore_latest(self, template=None):
        """(step, state) of the newest INTACT checkpoint: steps whose
        COMMIT manifest is missing or fails verification are skipped
        with a warning (torn write, bit rot) instead of raised on.
        Directories from the pre-manifest format (no COMMIT anywhere)
        load as before."""
        try:
            self.wait()
        except Exception as e:
            # a failed async save must not block restoring an older step
            warnings.warn(f"in-flight save failed before restore: "
                          f"{type(e).__name__}: {e}")
        dirs = self._step_dirs()
        if not dirs:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        any_committed = any(
            os.path.isfile(os.path.join(p, COMMIT_MARKER))
            for _s, p in dirs)
        skipped = []
        for step, path in reversed(dirs):
            if any_committed:
                ok, reason = verify_commit(path)
                if not ok:
                    warnings.warn(
                        f"skipping checkpoint step {step}: {reason}")
                    skipped.append((step, reason))
                    continue
            try:
                return step, self.restore(step, template)
            except Exception as e:
                warnings.warn(
                    f"skipping checkpoint step {step}: restore failed "
                    f"({type(e).__name__}: {e})")
                skipped.append((step, f"{type(e).__name__}: {e}"))
        raise FileNotFoundError(
            f"no intact checkpoint under {self.directory} "
            f"(skipped: {skipped})")


def _complete(inner, world):
    try:
        return len(_shards(inner)) == world
    except (FileNotFoundError, OSError):
        return False
