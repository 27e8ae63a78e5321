"""The port's training supervisor (``paddle_tpu_torch/resilience``)
against the JAX package's.

- Every ``TestSupervisorLadder`` case of ``tests/test_resilience.py:245``
  runs on both packages from the same weights (a ``Linear(4, 1)`` with
  Adam): the flight-ledger event sequence is equal (times and trace ids
  left out), ``stats()`` is equal, the losses agree within rtol 1e-5 in
  fp32.
- One guard restored twice gives the same step bit for bit (restores
  copy out of the guard; a capture is a copy).
- The wedged step of the ladder, in the port, is condemned: when it wakes
  up its update is dropped, and the gradient its backward left is not
  added to the next step's; a step wedged inside its in-place writes
  aborts the supervisor instead of hanging it.
- Kill and resume (``tests/test_resilience.py:509``, on the port): a
  subprocess on the CPU trains 12 steps with dropout and a ``GradScaler``
  under a ``Supervisor``, batches from ``DataLoader`` +
  ``DistributedBatchSampler(shuffle=True)`` + ``ResumableLoader``; a
  victim SIGKILLs itself at step 9 and a relaunch resumes: its losses and
  loss scales equal the uninterrupted run's bit for bit.
- ``tools/torch_chaos_train.py`` gives ``tools/chaos_train.py``'s verdict
  fields for ``nan``, ``stall``, ``error`` and ``corrupt`` (the ``kill``
  round trip is slow, as the JAX package's is).
- ``TrainState(program=)`` raises, naming port queue item 9.
"""
import json
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu import resilience as jres
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.distributed import checkpoint as ck
from paddle_tpu_torch import resilience as res
from paddle_tpu_torch.framework import attempt
from paddle_tpu_torch.framework.io import load_numpy_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
LOSS_RTOL = 1e-5


# ---------------------------------------------------------------------------
# one tiny setup, both packages
# ---------------------------------------------------------------------------

def _weights(seed=0):
    jpaddle.seed(seed)
    net = jnn.Linear(4, 1)
    return {k: np.asarray(v._data) for k, v in net.state_dict().items()}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(8, 4)).astype(np.float32),
            rng.normal(size=(8, 1)).astype(np.float32))


def _jax_setup(lr=0.05):
    net = jnn.Linear(4, 1)
    net.set_state_dict({k: jpaddle.to_tensor(v)
                        for k, v in _weights().items()})
    opt = joptim.Adam(learning_rate=lr, parameters=net.parameters())
    x, y = (jpaddle.to_tensor(a) for a in _data())

    def train_step(xb, yb):
        loss = ((net(xb) - yb) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return net, opt, x, y, train_step


def _port_setup(lr=0.05):
    net = nn.Linear(4, 1, device="cpu")
    load_numpy_state_dict(net, _weights())
    opt = optimizer.Adam(learning_rate=lr, parameters=net.parameters())
    x, y = (torch.from_numpy(a) for a in _data())

    def train_step(xb, yb):
        loss = ((net(xb) - yb) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    return net, opt, x, y, train_step


JAX = types.SimpleNamespace(
    name="jax", setup=_jax_setup, Manager=jck.CheckpointManager,
    Monkey=jres.ChaosMonkey, Supervisor=jres.Supervisor,
    TrainState=jres.TrainState, Aborted=jres.SupervisorAborted,
    weight=lambda net: np.asarray(net.state_dict()["weight"]._data))
PORT = types.SimpleNamespace(
    name="port", setup=_port_setup,
    Manager=lambda d, **kw: ck.CheckpointManager(d, device="cpu", **kw),
    Monkey=res.ChaosMonkey, Supervisor=res.Supervisor,
    TrainState=res.TrainState, Aborted=res.SupervisorAborted,
    weight=lambda net: net.weight.detach().numpy().copy())


def _loss(v):
    if v is None:
        return None
    return float(np.asarray(v._data) if hasattr(v, "_data") else v)


# each scenario mirrors the TestSupervisorLadder case of the same name and
# returns (supervisor, losses, extra facts)

def _skip_nonfinite(P, tmp):
    net, opt, x, y, step = P.setup()
    sup = P.Supervisor(P.Monkey(at={1: "nan"}).wrap(step),
                       P.TrainState(model=net, optimizer=opt))
    l0 = sup.step(x, y)
    before = P.weight(net)
    l1 = sup.step(x, y)
    untouched = np.array_equal(before, P.weight(net))
    l2 = sup.step(x, y)
    return sup, [l0, l1, l2], {"untouched": untouched}


def _retry_on_error_and_stall(P, tmp):
    net, opt, x, y, step = P.setup()
    chaos = P.Monkey(at={1: "error", 3: "stall"}, stall_s=0.01)
    sup = P.Supervisor(chaos.wrap(step), P.TrainState(model=net,
                                                      optimizer=opt),
                       max_retries=2, retry_backoff_s=0.0)
    return sup, [sup.step(x, y) for _ in range(4)], {}


def _wedged_step(P, tmp):
    net, opt, x, y, step = P.setup()
    calls = {"n": 0}

    def sometimes_hangs(xb, yb):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.6)        # wedged (abandoned by the supervisor)
        return step(xb, yb)

    sup = P.Supervisor(sometimes_hangs, P.TrainState(model=net,
                                                     optimizer=opt),
                       step_timeout_s=0.1, max_retries=1,
                       retry_backoff_s=0.0)
    out = sup.step(x, y)
    return sup, [out], {"w_after": P.weight(net)}


def _rollback(P, tmp):
    net, opt, x, y, step = P.setup()
    mgr = P.Manager(str(tmp / "ck"), max_to_keep=2)
    sup = P.Supervisor(P.Monkey(at={2: "nan", 3: "nan"}).wrap(step),
                       P.TrainState(model=net, optimizer=opt),
                       manager=mgr, save_interval=1, nan_patience=2,
                       max_rollbacks=1)
    losses = [sup.step(x, y) for _ in range(4)]
    sup.close()
    return sup, losses, {}


def _abort(P, tmp):
    net, opt, x, y, step = P.setup()
    mgr = P.Manager(str(tmp / "ck"), max_to_keep=2)
    sup = P.Supervisor(P.Monkey(at={k: "error" for k in range(40)}).wrap(
        step), P.TrainState(model=net, optimizer=opt), manager=mgr,
        max_retries=1, max_rollbacks=0, retry_backoff_s=0.0)
    with pytest.raises(P.Aborted) as ei:
        sup.step(x, y)
    with pytest.raises(P.Aborted):
        sup.step(x, y)          # the supervisor stays dead after abort
    pm = ei.value.postmortem
    on_disk = json.load(open(ei.value.path))
    return sup, [], {"exception": pm["exception"],
                     "retries": pm["stats"]["retries"],
                     "aborted_at_step": on_disk["aborted_at_step"]}


def _emergency_save(P, tmp):
    net, opt, x, y, step = P.setup()
    mgr = P.Manager(str(tmp / "ck"), max_to_keep=4)
    sup = P.Supervisor(P.Monkey(at={3: "nan"}).wrap(step),
                       P.TrainState(model=net, optimizer=opt),
                       manager=mgr, save_interval=0)
    losses = [sup.step(x, y) for _ in range(4)]
    mgr.wait()
    return sup, losses, {"steps": mgr.all_steps()}


def _cadence_and_resume(P, tmp):
    net, opt, x, y, step = P.setup()
    mgr = P.Manager(str(tmp / "ck"), max_to_keep=2)
    sup = P.Supervisor(step, P.TrainState(model=net, optimizer=opt),
                       manager=mgr, save_interval=2)
    losses = [sup.step(x, y) for _ in range(4)]
    sup.close()
    trained = P.weight(net).copy()
    # restart analog: a fresh model and optimizer, resumed from disk
    net2, opt2, _, _, _ = P.setup()
    sup2 = P.Supervisor(step, P.TrainState(model=net2, optimizer=opt2),
                        manager=mgr)
    nxt = sup2.resume()
    return sup, losses, {"steps": mgr.all_steps(), "next": nxt,
                         "restored": np.array_equal(P.weight(net2),
                                                    trained)}


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _skip_nonfinite, _retry_on_error_and_stall, _wedged_step, _rollback,
    _abort, _emergency_save, _cadence_and_resume)}
_DROP = ("t", "duration_s", "gap_s", "trace_id", "loss", "postmortem")


def _events(sup):
    return [{k: v for k, v in r.items() if k not in _DROP}
            for r in sup.ledger.to_list()]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = {}
    for name, fn in SCENARIOS.items():
        sup, losses, extra = fn(JAX, tmp_path_factory.mktemp(name))
        out[name] = (_events(sup), sup.stats(), [_loss(v) for v in losses],
                     [r.get("loss") for r in sup.ledger.to_list()], extra)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_ladder_matches_jax(name, tmp_path, jax_runs):
    events, stats, losses, led_losses, extra = jax_runs[name]
    sup, got, gextra = SCENARIOS[name](PORT, tmp_path)
    assert _events(sup) == events
    assert sup.stats() == stats
    got = [_loss(v) for v in got]
    assert [v is None for v in got] == [v is None for v in losses]
    np.testing.assert_allclose([v for v in got if v is not None],
                               [v for v in losses if v is not None],
                               rtol=LOSS_RTOL)
    led = [r.get("loss") for r in sup.ledger.to_list()]
    assert [v is None for v in led] == [v is None for v in led_losses]
    np.testing.assert_allclose(
        [float(v) for v in led if v is not None],
        [float(v) for v in led_losses if v is not None], rtol=LOSS_RTOL)
    for k, v in extra.items():
        if k == "w_after":
            continue
        assert gextra[k] == v, k
    if name == "skip_nonfinite":
        assert gextra["untouched"]
    if name == "wedged_step":
        # the abandoned attempt wakes up, runs, and its update is dropped
        before = attempt.stats["dropped"]
        for t in sup.zombies:
            t.join(5)
        assert attempt.stats["dropped"] == before + 1
        assert np.array_equal(PORT.weight(_weighted(sup)), gextra["w_after"])


def _weighted(sup):
    return sup.state.model


def test_wedged_eager_step_leaves_no_gradient():
    """The abandoned eager attempt wakes up, runs its backward into
    ``param.grad`` and is refused at ``Optimizer.step``; the next
    supervised step must not add that gradient to its own: two steps
    equal an uninterrupted run's two bit for bit."""
    sup, _, _ = _wedged_step(PORT, None)
    for t in sup.zombies:
        t.join(5)
    net = sup.state.model
    assert net.weight.grad is not None      # the zombie's backward landed
    sup.step(*(torch.from_numpy(a) for a in _data()))
    net2, opt2, x, y, step = _port_setup()
    plain = res.Supervisor(step, res.TrainState(model=net2, optimizer=opt2))
    plain.step(x, y)
    plain.step(x, y)
    for a, b in zip(net.parameters(), net2.parameters()):
        assert torch.equal(a, b)


def test_step_wedged_inside_its_commit_aborts(tmp_path):
    """A step still inside its in-place writes ``step_timeout_s`` after
    it was abandoned cannot be restored under: the supervisor aborts
    with a post-mortem instead of waiting on it."""
    net, opt, x, y, step = _port_setup()
    inside, release = threading.Event(), threading.Event()
    update = opt.update_param

    def wedged_update(*a, **kw):
        inside.set()
        release.wait(10)
        return update(*a, **kw)

    opt.update_param = wedged_update
    sup = res.Supervisor(step, res.TrainState(model=net, optimizer=opt),
                         step_timeout_s=0.2, max_retries=1,
                         retry_backoff_s=0.0,
                         postmortem_path=str(tmp_path / "pm.json"))
    t0 = time.perf_counter()
    with pytest.raises(res.SupervisorAborted) as ei:
        sup.step(x, y)
    assert time.perf_counter() - t0 < 5
    assert inside.is_set()
    assert "inside its in-place writes" in ei.value.postmortem["exception"]
    assert sup.stats()["retries"] == 0
    assert os.path.isfile(tmp_path / "pm.json")
    release.set()
    for t in sup.zombies:
        t.join(5)
        assert not t.is_alive()


def test_one_guard_restores_twice_bitwise():
    """A restore copies out of the guard, so the guard is the same for
    the second restore: the same step from it is bitwise the same."""
    net, opt, x, y, step = _port_setup()
    state = res.TrainState(model=net, optimizer=opt)
    step(x, y)                      # moments exist
    guard = state.capture()
    outs = []
    for _ in range(2):
        state.restore(guard)
        loss = step(x, y)
        outs.append((loss.numpy().tobytes(), PORT.weight(net).tobytes(),
                     {k: t.numpy().tobytes() for k, t in
                      opt.state_dict()["param_0"].items()}))
    assert outs[0] == outs[1]
    # and the guard still holds the pre-step weights
    assert not np.array_equal(guard["model"]["weight"].numpy(),
                              PORT.weight(net))


def test_capture_before_step_one_has_the_moments():
    net, opt, _, _, _ = _port_setup()
    snap = res.TrainState(model=net, optimizer=opt).capture()
    assert {"moment1", "moment2", "beta1_pow", "beta2_pow"} <= set(
        snap["optimizer"]["param_0"])
    assert set(snap["rng"]) == {"seed", "generators", "tracker"}


def test_program_is_refused():
    with pytest.raises(NotImplementedError, match="item 9"):
        res.TrainState(program=object())


# ---------------------------------------------------------------------------
# kill and resume, bit for bit (tests/test_resilience.py:509 on the port)
# ---------------------------------------------------------------------------

_WORKER = r'''
import json, os, sys
sys.modules["jax"] = None
sys.modules["paddle_tpu"] = None
import numpy as np
import torch
torch.set_num_threads(1)
import paddle_tpu_torch as paddle
paddle.set_device("cpu")
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
from paddle_tpu_torch.resilience import (ChaosMonkey, ResumableLoader,
                                         Supervisor, TrainState)

mode, out_path, ckpt_dir, kill_step = (sys.argv[1], sys.argv[2],
                                       sys.argv[3], int(sys.argv[4]))
TOTAL = 12

paddle.seed(1234)

class _DS:
    def __init__(self):
        rng = np.random.default_rng(7)
        self.x = rng.normal(size=(32, 4)).astype(np.float32)
        w = rng.normal(size=(4, 1)).astype(np.float32)
        self.y = (self.x @ w).astype(np.float32)
    def __len__(self): return 32
    def __getitem__(self, i): return self.x[i], self.y[i]

# dropout exercises the RNG state; the scaler exercises AMP state
net = torch.nn.Sequential(nn.Linear(4, 16, device="cpu"), nn.ReLU(),
                          nn.Dropout(0.25), nn.Linear(16, 1, device="cpu"))
opt = optimizer.Adam(learning_rate=0.01, parameters=net.parameters())
scaler = GradScaler(enable=True, init_loss_scaling=2.0 ** 10,
                    incr_every_n_steps=4)
ds = _DS()
sampler = DistributedBatchSampler(ds, batch_size=4, num_replicas=1,
                                  rank=0, shuffle=True)
loader = ResumableLoader(DataLoader(ds, batch_sampler=sampler,
                                    device="cpu"), epochs=3)

def train_step(xb, yb):
    loss = ((net(xb) - yb) ** 2).mean()
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()
    return loss.detach()

mgr = CheckpointManager(ckpt_dir, max_to_keep=2, device="cpu")
step_fn = train_step
if mode == "victim":
    step_fn = ChaosMonkey(at={kill_step: "kill"}).wrap(train_step)
sup = Supervisor(step_fn,
                 TrainState(model=net, optimizer=opt, scaler=scaler,
                            loader=loader),
                 manager=mgr, save_interval=3)
start = sup.resume()
recs, step = [], start
for xb, yb in loader:
    if step >= TOTAL:
        break
    loss = sup.step(xb, yb)
    recs.append({"step": step,
                 "bits": int(np.float32(float(loss)).view(np.int32)),
                 "scale": float(scaler.get_loss_scaling())})
    step += 1
sup.close()
with open(out_path, "w") as fh:
    json.dump({"start": start, "recs": recs}, fh)
'''


def _run_worker(script, mode, out, ckpt, kill_step, expect_kill=False):
    r = subprocess.run(
        [sys.executable, str(script), mode, str(out), str(ckpt),
         str(kill_step)],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300, cwd=REPO)
    if expect_kill:
        assert r.returncode == -9, (r.returncode, r.stderr[-2000:])
    else:
        assert r.returncode == 0, r.stderr[-2000:]
    return r


def test_kill_and_resume_bitwise(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    base_out = tmp_path / "baseline.json"
    _run_worker(script, "baseline", base_out, tmp_path / "ck_base", 0)
    baseline = json.load(open(base_out))
    assert baseline["start"] == 0 and len(baseline["recs"]) == 12

    kill_out = tmp_path / "victim.json"
    _run_worker(script, "victim", kill_out, tmp_path / "ck", 9,
                expect_kill=True)
    assert not kill_out.exists()        # SIGKILL: no flush, no atexit

    res_out = tmp_path / "resume.json"
    _run_worker(script, "resume", res_out, tmp_path / "ck", 0)
    resumed = json.load(open(res_out))
    # cadence saves at steps 2/5/8; the step-8 save is async, so the kill
    # may race its commit: the resume point is whichever step committed
    assert resumed["start"] in (6, 9), resumed["start"]
    assert resumed["recs"][-1]["step"] == 11
    by_step = {r["step"]: r for r in baseline["recs"]}
    for rec in resumed["recs"]:
        want = by_step[rec["step"]]
        assert rec["bits"] == want["bits"], (rec, want)
        assert rec["scale"] == want["scale"]


# ---------------------------------------------------------------------------
# the chaos CLI against tools/chaos_train.py
# ---------------------------------------------------------------------------

def _cli(module, argv, capsys):
    sys.path.insert(0, TOOLS)
    try:
        mod = __import__(module)
    finally:
        sys.path.pop(0)
    rc = mod.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


_VERDICT = ("steps", "resumed_from", "skipped", "retries", "rollbacks",
            "anomalies", "fired", "ok", "ledger", "fault", "injected_step",
            "seed", "total_steps", "bench")


@pytest.mark.parametrize("fault", ["nan", "stall", "error", "corrupt"])
def test_chaos_cli_verdict_matches_jax(fault, tmp_path, capsys):
    args = ["--fault", fault, "--step", "3", "--json"]
    rc_j, want = _cli("chaos_train", args + ["--workdir",
                                             str(tmp_path / "j")], capsys)
    rc_p, got = _cli("torch_chaos_train", args + [
        "--workdir", str(tmp_path / "p"), "--device", "cpu"], capsys)
    assert rc_p == rc_j == 0
    assert set(got) == set(want)
    for k in _VERDICT:
        got_k = json.loads(json.dumps(got[k]))
        assert got_k == want[k], k


def test_chaos_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    sys.path.insert(0, TOOLS)
    try:
        import torch_chaos_train
    finally:
        sys.path.pop(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_chaos_train.main(["--fault", "nan", "--workdir",
                                str(tmp_path)])


@pytest.mark.slow
def test_chaos_cli_kill_roundtrip(tmp_path, capsys):
    rc, rec = _cli("torch_chaos_train", [
        "--fault", "kill", "--step", "5", "--json", "--workdir",
        str(tmp_path), "--device", "cpu"], capsys)
    assert rc == 0 and rec["victim_sigkilled"] and rec["resumed_from"] > 0
