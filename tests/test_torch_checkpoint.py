"""The port's checkpoint commit layer and ``CheckpointManager``
(``paddle_tpu_torch/distributed/checkpoint.py``) and its checkpoint
corruption (``resilience/chaos.py``) against the JAX package's.

- The ``TrainingWatchdog`` cases of ``tests/test_resilience.py:37``.
- The port's ``verify_commit`` gives JAX's verdict on a JAX-written step
  under each damage (missing marker, missing shard, truncated shard, bad
  checksum); JAX's ``verify_commit`` accepts a port-written step.
- Both packages' ``corrupt_checkpoint`` on two copies of one tree damage
  the same file and byte, in every mode.
- The manager's retention, stale-tmp sweep, fallback past damaged steps
  and legacy dirs mirror ``tests/test_resilience.py:133-215``.
- At world 1 the JAX package's ``CheckpointManager.restore_latest``
  reads a port-written step (bf16 as float32) with equal arrays.
- The async-save race: tensors mutated right after ``save(async_save=
  True)`` restore to their values at save time; with the host copy
  planted out (the writer reads the live tensors) the same test sees the
  mutation.
- Template-free loads land on the framework's device (CUDA by default,
  raising without it).
"""
import filecmp
import os
import shutil
import subprocess
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.resilience import chaos as jchaos
from paddle_tpu.utils.watchdog import TrainingWatchdog as JaxWatchdog
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch.distributed.checkpoint import (CheckpointManager,
                                                     verify_commit)
from paddle_tpu_torch.resilience import chaos, corrupt_checkpoint
from paddle_tpu_torch.utils.watchdog import TrainingWatchdog


# ---------------------------------------------------------------------------
# watchdog (tests/test_resilience.py:37)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Watchdog", [TrainingWatchdog, JaxWatchdog],
                         ids=["port", "jax"])
class TestWatchdog:
    def test_no_phantom_stall_on_first_step(self, Watchdog):
        stalls = []
        wd = Watchdog(step_timeout_s=0.05, on_stall=stalls.append)
        time.sleep(0.12)            # "long setup" before training starts
        assert wd.step(1.0)
        assert wd.stats["stalls"] == 0 and not stalls
        time.sleep(0.12)            # a real inter-step stall IS reported
        assert wd.step(1.0)
        assert wd.stats["stalls"] == 1 and len(stalls) == 1

    def test_explicit_start_arms_timer(self, Watchdog):
        wd = Watchdog(step_timeout_s=0.05).start()
        time.sleep(0.12)
        wd.step(1.0)
        assert wd.stats["stalls"] == 1

    def test_nan_patience_still_raises(self, Watchdog):
        wd = Watchdog(nan_patience=2)
        assert not wd.step(float("nan"))
        with pytest.raises(FloatingPointError):
            wd.step(float("nan"))


# ---------------------------------------------------------------------------
# the commit layer across packages
# ---------------------------------------------------------------------------

def _np_state(v):
    return {"w": np.full((4,), float(v), np.float32),
            "step": np.asarray(v, np.int64)}


def _tree_state():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((64, 16)).astype(np.float32),
            "b": {"c": rng.standard_normal((300,)).astype(np.float32),
                  "d": np.arange(50, dtype=np.int64)}}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """One step committed by the JAX package's manager."""
    d = tmp_path_factory.mktemp("jax_ck")
    jck.CheckpointManager(str(d)).save(1, _tree_state(), async_save=False)
    return os.path.join(str(d), "ckpt-1")


def _damage(root, how):
    files = sorted(os.path.join(b, n) for b, _, ns in os.walk(root)
                   for n in ns if n != "COMMIT"
                   and os.path.getsize(os.path.join(b, n)) > 0)
    victim = max(files, key=os.path.getsize)
    if how == "marker":
        os.remove(os.path.join(root, "COMMIT"))
    elif how == "shard":
        os.remove(victim)
    elif how == "truncate":
        with open(victim, "rb+") as fh:
            fh.truncate(os.path.getsize(victim) // 2)
    elif how == "checksum":
        with open(victim, "rb+") as fh:
            b = fh.read(1)
            fh.seek(0)
            fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("how,reason", [
    (None, "ok"), ("marker", "missing COMMIT marker"),
    ("shard", "missing shard"), ("truncate", "truncated shard"),
    ("checksum", "bad checksum on shard")])
def test_verify_commit_verdicts_match_jax(jax_step, tmp_path, how, reason):
    root = str(tmp_path / "ckpt-1")
    shutil.copytree(jax_step, root)
    if how:
        _damage(root, how)
    got, want = verify_commit(root), jck.verify_commit(root)
    assert got == want
    assert got[0] == (how is None) and got[1].startswith(reason)


def test_jax_verify_commit_accepts_a_port_step(tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    path = mgr.save(3, {"w": torch.arange(12.0).bfloat16(),
                        "s": _tree_state()}, async_save=False)
    assert jck.verify_commit(path) == (True, "ok") == verify_commit(path)


@pytest.mark.parametrize("mode", ["truncate", "flip", "uncommit"])
@pytest.mark.parametrize("seed", [0, 7])
def test_corrupt_checkpoint_same_victim_as_jax(tmp_path, mode, seed):
    mgr = CheckpointManager(tmp_path / "src", device="cpu")
    src = mgr.save(1, {"x": _tree_state(), "y": torch.ones(100)},
                   async_save=False)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    va = corrupt_checkpoint(a, seed=seed, mode=mode)
    vb = jchaos.corrupt_checkpoint(b, seed=seed, mode=mode)
    assert os.path.relpath(va, a) == os.path.relpath(vb, b)
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only)
    for base, _, names in os.walk(a):
        for n in names:
            pa = os.path.join(base, n)
            pb = os.path.join(b, os.path.relpath(pa, a))
            assert open(pa, "rb").read() == open(pb, "rb").read(), n


# ---------------------------------------------------------------------------
# the manager (tests/test_resilience.py:133-215, on the port)
# ---------------------------------------------------------------------------

class TestAtomicCheckpoint:
    def test_commit_marker_written_and_verified(self, tmp_path):
        mgr = CheckpointManager(tmp_path, max_to_keep=3)
        path = mgr.save(1, _np_state(1), async_save=False)
        assert os.path.isfile(os.path.join(path, "COMMIT"))
        assert verify_commit(path) == (True, "ok")

    @pytest.mark.parametrize("damage", ["truncate", "flip", "uncommit"])
    def test_restore_latest_skips_damaged_newest(self, tmp_path, damage):
        mgr = CheckpointManager(tmp_path, max_to_keep=3)
        mgr.save(1, _np_state(1), async_save=False)
        mgr.save(2, _np_state(2), async_save=False)
        corrupt_checkpoint(os.path.join(str(tmp_path), "ckpt-2"),
                           mode=damage)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            step, out = mgr.restore_latest(_np_state(0))
        assert step == 1
        np.testing.assert_array_equal(np.asarray(out["w"]), [1.0] * 4)
        assert any("skipping checkpoint step 2" in str(x.message)
                   for x in w)

    def test_all_damaged_raises_filenotfound(self, tmp_path):
        mgr = CheckpointManager(tmp_path, max_to_keep=3)
        mgr.save(1, _np_state(1), async_save=False)
        corrupt_checkpoint(os.path.join(str(tmp_path), "ckpt-1"),
                           mode="truncate")
        with pytest.raises(FileNotFoundError), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mgr.restore_latest(_np_state(0))

    def test_stale_tmp_dir_ignored_and_cleaned(self, tmp_path):
        mgr = CheckpointManager(tmp_path, max_to_keep=3)
        mgr.save(3, _np_state(3), async_save=False)
        gone = subprocess.Popen(["true"])
        gone.wait()                             # reaped: the pid is free
        dead = tmp_path / f".tmp-ckpt-9-{gone.pid}"
        dead.mkdir()
        (dead / "partial").write_bytes(b"\x00" * 64)
        live = tmp_path / f".tmp-ckpt-8-{os.getpid()}"
        live.mkdir()
        step, _ = mgr.restore_latest(_np_state(0))
        assert step == 3
        CheckpointManager(tmp_path)             # init sweeps dead tmp
        assert not dead.exists()
        assert live.exists()                    # live writer untouched

    def test_prune_keeps_newest_and_skips_uncommitted(self, tmp_path):
        mgr = CheckpointManager(tmp_path, max_to_keep=2)
        for s in range(1, 5):
            mgr.save(s, _np_state(s), async_save=False)
        assert mgr.all_steps() == [3, 4]
        torn = tmp_path / "ckpt-9"
        torn.mkdir()
        mgr.save(5, _np_state(5), async_save=False)
        assert 5 in mgr.all_steps()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            step, _ = mgr.restore_latest(_np_state(0))
        assert step == 5

    def test_async_save_overlaps_and_commits(self, tmp_path):
        mgr = CheckpointManager(tmp_path, max_to_keep=2)
        mgr.save(1, _np_state(1), async_save=True)
        mgr.wait()
        assert verify_commit(os.path.join(str(tmp_path), "ckpt-1"))[0]

    def test_last_save_records_the_write(self, tmp_path):
        mgr = CheckpointManager(tmp_path, device="cpu")
        assert mgr.last_save is None
        path = mgr.save(2, {"w": torch.arange(64.0)}, async_save=True)
        mgr.wait()
        got = mgr.last_save
        assert got["step"] == 2
        assert got["bytes"] == os.path.getsize(os.path.join(path, "state"))
        for k in ("host_copy_s", "pickle_s", "fsync_s"):
            assert 0 <= got[k] <= got["wall_s"], k

    def test_legacy_dirs_without_any_commit_still_load(self, tmp_path):
        ck.save_distributed(_np_state(4), str(tmp_path / "ckpt-4"),
                            async_save=False)
        mgr = CheckpointManager(tmp_path)
        step, out = mgr.restore_latest(_np_state(0))
        assert step == 4
        np.testing.assert_array_equal(np.asarray(out["w"]), [4.0] * 4)


def test_jax_manager_reads_a_port_world1_step(tmp_path):
    """The port writes <step>/state in framework/io.save's layout: the
    JAX package's restore_latest reads it template-free, arrays equal
    (a bf16 tensor as float32, exactly)."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
    state = {"params": {"w": w.bfloat16(), "b": w[0].clone()},
             "opt": {"m": w * 2, "beta1_pow": torch.tensor(0.81)},
             "loader": {"epoch": np.asarray(1), "batch_index": np.asarray(3)},
             "ids": torch.arange(10)}
    CheckpointManager(tmp_path, device="cpu").save(7, state,
                                                   async_save=False)
    step, got = jck.CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 7
    want = {"params": {"w": w.bfloat16().float().numpy(),
                       "b": w[0].numpy()},
            "opt": {"m": (w * 2).numpy(), "beta1_pow": np.float32(0.81)},
            "loader": {"epoch": 1, "batch_index": 3},
            "ids": np.arange(10)}

    def same(a, b):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                same(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    same(got, want)
    # and the port reads it back bit for bit, bf16 included
    _, back = CheckpointManager(tmp_path, device="cpu").restore_latest()
    assert back["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["w"], w.bfloat16())
    assert back["ids"].dtype == torch.int64


def test_template_free_load_defaults_to_cuda(tmp_path):
    path = ck.save_distributed({"w": torch.ones(3)}, str(tmp_path / "s"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.load_distributed(path)
    out = ck.load_distributed(path, device="cpu")
    assert out["w"].device.type == "cpu"
    out = ck.load_distributed(path, template={"w": torch.zeros(3).double()})
    assert out["w"].dtype == torch.float64


# ---------------------------------------------------------------------------
# the async-save race
# ---------------------------------------------------------------------------

def _race(tmp_path, monkeypatch, planted):
    """Save a tensor asynchronously, mutate it in place while the writer
    is held, then restore: the value it comes back with."""
    go = threading.Event()
    real_write = ck._write_state

    def held_write(host, dtypes, path, times=None):
        go.wait(10)
        if planted:                 # the writer reads the live tensors
            host = {k: ck._host_leaf(v, [k], {}) for k, v in host.items()}
        return real_write(host, dtypes, path, times)
    monkeypatch.setattr(ck, "_write_state", held_write)
    if planted:
        monkeypatch.setattr(ck, "_to_host", lambda tree, path, dtypes: tree)
    w = torch.zeros(256)
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, {"w": w}, async_save=True)
    w.add_(1.0)                     # the next step's in-place update
    go.set()
    mgr.wait()
    monkeypatch.undo()
    return mgr.restore_latest()[1]["w"]


@pytest.mark.parametrize("planted", [False, True],
                         ids=["host_copy", "planted_no_copy"])
def test_async_save_race(tmp_path, monkeypatch, planted):
    got = _race(tmp_path, monkeypatch, planted)
    if planted:
        assert torch.equal(got, torch.ones(256))     # torn: the race shows
    else:
        assert torch.equal(got, torch.zeros(256))    # the value at save


def test_chaos_corrupt_fault_hits_the_newest_step(tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, _np_state(1), async_save=False)
    mgr.save(2, _np_state(2), async_save=False)
    calls = []
    fn = chaos.ChaosMonkey(at={0: "corrupt"}, manager=mgr).wrap(
        lambda: calls.append(1) or 0.5)
    assert fn() == 0.5 and calls == [1]     # corrupts, then runs the step
    assert not verify_commit(str(tmp_path / "ckpt-2"))[0]
    assert verify_commit(str(tmp_path / "ckpt-1"))[0]
    with pytest.raises(ValueError, match="needs ChaosMonkey"):
        chaos.ChaosMonkey(at={0: "corrupt"}).wrap(lambda: 0.0)()
