"""The port's ``CommOptTrainStep`` restored across dp degrees against the
JAX package's (``tests/test_comm_opt_resilience.py``: Adam lr 1e-2 on
the JAX package's MLP, int8 with qblock 64, with and without zero1).

The JAX steps (dp4 and dp2 on the 8 virtual devices) train 3 steps each,
and each loads the other's stored arrays: that is the reference. The
port runs in one spawn of 4 gloo ranks (``torch_dist_worker.
remesh_worker``) from the JAX model's initial weights:

- dp2 -> dp4 and dp4 -> dp2 from the same stored arrays (the JAX steps'
  ``state_dict``): the re-sharded flat moments, ``e2``, the beta pows,
  the replicated flat moments and the summed ``e1`` equal the JAX
  package's ``load_state_dict`` result bit for bit;
- the port's own dp4 checkpoint (four rank files, sealed by rank 0)
  restored at dp2 through ``TrainState`` equals what the JAX package's
  dp2 step makes of the same arrays, bit for bit, and trains on finite;
- the same-mesh round trip (``tests/test_comm_opt_resilience.py:108``)
  is bitwise: 2 steps after ``load_state_dict`` give the uninterrupted
  losses;
- a tp change still raises JAX's ``NotImplementedError``.
"""
import concurrent.futures
import os
import pickle

import jax
import numpy as np
import pytest

import paddle_tpu
import torch_dist_worker as W
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optim
from paddle_tpu.distributed import fleet as jax_fleet
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu_torch import distributed as dist

WORLD = 4


def _jax_step(dp, cfg, init):
    s = jax_fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    s.comm_opt = True
    s.comm_opt_configs = dict(cfg)
    jax_fleet.init(is_collective=True, strategy=s)
    model = jax_fleet.distributed_model(
        jnn.Sequential(jnn.Linear(8, 32), jnn.Tanh(), jnn.Linear(32, 1)))
    model.set_state_dict({k: paddle_tpu.to_tensor(v)
                          for k, v in init.items()})
    opt = jax_fleet.distributed_optimizer(
        jax_optim.Adam(learning_rate=0.01, parameters=model.parameters()),
        strategy=s)
    return opt.make_train_step(model, lambda m, a, b: ((m(a) - b) ** 2)
                               .mean())


def _numpy(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v), tree)


def _jax_side(init):
    """Per config: the dp4 and dp2 steps' stored states after 3 steps,
    and what each degree's fresh step makes of the other's."""
    x, y = (paddle_tpu.to_tensor(a) for a in W.tp_mlp_data())
    out = {}
    try:
        for name, cfg in W.REMESH_CONFIGS.items():
            stored = {}
            for dp in (4, 2):
                step = _jax_step(dp, cfg, init)
                for _ in range(W.REMESH_STEPS):
                    step(x, y)
                stored[f"dp{dp}"] = _numpy(step.state_dict())
            loaded = {}
            for dp, src in ((2, "dp4"), (4, "dp2")):
                step = _jax_step(dp, cfg, init)
                step.load_state_dict(stored[src])
                loaded[f"{src}_at_dp{dp}"] = _numpy(
                    {"opt": step._opt_state, "ef": step._ef})
            out[name] = (stored, loaded)
    finally:
        jax_mesh.set_mesh(None)
    return out


def _jax_load(name, dp, state, init):
    try:
        step = _jax_step(dp, W.REMESH_CONFIGS[name], init)
        step.load_state_dict(state)
        return _numpy({"opt": step._opt_state, "ef": step._ef})
    finally:
        jax_mesh.set_mesh(None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("remesh")
    try:
        jax_mesh.set_mesh(None)
        jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.Tanh(),
                              jnn.Linear(32, 1))
        init = {k: np.asarray(v._data) for k, v in jnet.state_dict().items()}
    finally:
        jax_mesh.set_mesh(None)
    jax_runs = _jax_side(init)
    inputs = {"init": init, **{n: stored for n, (stored, _) in
                               jax_runs.items()}}
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(dist.spawn, W.remesh_worker,
                           args=(str(out), str(out / "inputs.pkl")),
                           nprocs=WORLD, timeout=600)
        port.result()
    port_runs = {}
    for name in W.REMESH_CONFIGS:
        with open(out / f"{name}.pkl", "rb") as f:
            port_runs[name] = pickle.load(f)
    return init, jax_runs, port_runs


def _assert_bitwise(got, want, what):
    """The port's flat state against the JAX step's (its opt and ef
    trees), array by array, bit for bit."""
    for part in ("opt", "ef"):
        assert set(got[part]) == set(want[part]), (what, part)
        for k in want[part]:
            a, b = np.asarray(got[part][k]), np.asarray(want[part][k])
            assert a.shape == b.shape, (what, part, k, a.shape, b.shape)
            assert a.dtype == b.dtype, (what, part, k)
            assert a.tobytes() == b.tobytes(), (what, part, k)


@pytest.mark.parametrize("name", list(W.REMESH_CONFIGS))
@pytest.mark.parametrize("direction", ["dp4_at_dp2", "dp2_at_dp4"])
def test_remesh_from_jax_arrays_is_jax_bitwise(runs, name, direction):
    _, jax_runs, port_runs = runs
    got = port_runs[name]["jax4_at_dp2" if direction == "dp4_at_dp2"
                          else "jax2_at_dp4"]
    _assert_bitwise(got, jax_runs[name][1][direction], direction)
    if direction == "dp4_at_dp2":
        # e1 is summed into replica 0: the other replica starts empty
        e1 = np.asarray(got["ef"]["e1"])
        assert e1.shape[0] == 2 and not e1[1].any() and e1[0].any()


@pytest.mark.parametrize("name", list(W.REMESH_CONFIGS))
def test_port_checkpoint_restores_at_dp2_as_jax(runs, name):
    init, _, port_runs = runs
    r = port_runs[name]
    assert r["n_files"] == WORLD
    want = _jax_load(name, 2, r["port4"], init)
    _assert_bitwise(r["port4_at_dp2"], want, "port ck4 at dp2")
    assert all(np.isfinite(r["losses_after"]))


@pytest.mark.parametrize("name", list(W.REMESH_CONFIGS))
def test_same_mesh_roundtrip_is_bitwise(runs, name):
    cont, resumed = runs[2][name]["roundtrip"]
    assert resumed == cont


def test_tp_change_still_raises(runs):
    for name in W.REMESH_CONFIGS:
        msg = runs[2][name]["tp_change"]
        assert msg is not None and "restore across tp degrees" in msg
