"""The port's pipeline bodies against the JAX package's.

``ops.pipeline.spmd_pipeline`` (GPipe, differentiated by autograd) and
``ops.pipeline.pipeline_1f1b`` run on 2 and 4 gloo ranks (one
module-scoped spawn of 4 ranks from ``torch_dist_worker.pipe_ops_worker``),
each rank holding only its stage's chunk. The JAX bodies
``_pipeline_local`` and ``_pipeline_1f1b_local`` run under a fully
manual ``jax.shard_map`` over a pp-only mesh of the CPU devices
(``check_vma=False``): their entry points pass ``shard_map(auto=)``,
which this JAX does not take. The cases
(``torch_dist_worker.PIPE_OP_CASES``): pp 2 and 4 with 2, 4 and 8
micro-batches, the stage a stack of two tanh layers; and pp 2 and 4 with
``_decoder_chunk`` at LLAMA_TINY's widths as the stage (one layer a
stage, 32 positions). GPipe's output and its gradients for a given
cotangent (every chunk's, and x's), and 1F1B's loss, chunk gradients,
last-stage gradients and dx, are held to JAX's by ``||got - want|| /
||want||`` at 1e-5 (fp32, reordered sums).

Also: three planted faults fail that judge (the stages applied in the
wrong order; micro-batch b's cotangent paired with micro-batch b+1's
saved graph; the replicated output's backward summing the ranks'
cotangents); ``max_in_flight`` is M under GPipe and at most ``P - p``
(so at most P) under 1F1B, the port's form of
``test_1f1b_peak_memory_below_gpipe``; the same ``ValueError``s as JAX's;
and the port's ``PipelineLayer`` against JAX's on carried weights.
"""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker as W
from paddle_tpu import nn as jax_nn
from paddle_tpu import to_tensor
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jax_pp
from paddle_tpu.ops import pipeline as jax_pl
from paddle_tpu.text.models import llama_pipe as jax_llama_pipe
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import nn as port_nn
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, SharedLayerDesc)
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.ops import pipeline as pl

WORLD = 4
REL = 1e-5


def _jax_stage(stage):
    if stage == "tanh":
        def tanh_stack(c, x):
            for i in range(c["w"].shape[0]):
                x = jnp.tanh(x @ c["w"][i])
            return x
        return tanh_stack
    c = W.PIPE_TINY
    return functools.partial(jax_llama_pipe._decoder_chunk,
                             n_heads=c["heads"], n_kv=c["kv"], eps=c["eps"],
                             theta=c["theta"])


def _jax_case(name):
    """JAX's results of a case, as the worker writes the port's (every
    chunk's gradients whole)."""
    body, stage, n, m = W.PIPE_OP_CASES[name]
    stacked, last, x, tgt, ct = W.pipe_op_inputs(name)
    mesh_ = Mesh(np.asarray(jax.devices()[:n]), ("pp",))
    fn = _jax_stage(stage)
    micro = x.reshape(m, -1, *x.shape[1:])
    if body == "gpipe":
        run = jax.shard_map(
            functools.partial(jax_pl._pipeline_local, stage_fn=fn,
                              axis_name="pp", n_stages=n, n_micro=m),
            mesh=mesh_, in_specs=(P("pp"), P()), out_specs=P(),
            check_vma=False)
        out, vjp = jax.vjp(jax.jit(run), stacked, micro)
        g, dmicro = vjp(jnp.asarray(ct.reshape(micro.shape)))
        return dict(out=np.asarray(out).reshape(x.shape),
                    grads={k: np.asarray(v) for k, v in g.items()},
                    dx=np.asarray(dmicro).reshape(x.shape))
    run = jax.shard_map(
        functools.partial(jax_pl._pipeline_1f1b_local, stage_fn=fn,
                          last_fn=W.pipe_last_fn, axis_name="pp",
                          n_stages=n, n_micro=m),
        mesh=mesh_, in_specs=(P("pp"), P(), P(), P()),
        out_specs=(P(), P("pp"), P(), P()), check_vma=False)
    loss, g, lg, dx = jax.jit(run)(stacked, last, micro,
                                   tgt.reshape(m, -1, *tgt.shape[1:]))
    return dict(loss=float(loss), grads={k: np.asarray(v)
                                         for k, v in g.items()},
                last_grads={k: np.asarray(v) for k, v in lg.items()},
                dx=np.asarray(dx).reshape(x.shape))


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_case(name) for name in W.PIPE_OP_CASES}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    names = list(W.PIPE_OP_CASES) + list(W.PIPE_FAULTS)
    dist.spawn(W.pipe_ops_worker, args=(str(out), names), nprocs=WORLD,
               timeout=600)
    runs = {}
    for name in names:
        case = name if name in W.PIPE_OP_CASES else W.PIPE_FAULTS[name][0]
        n = W.PIPE_OP_CASES[case][2]
        ranks = []
        for r in range(n):
            with open(out / f"{name}.r{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        runs[name] = ranks
    return runs


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _errors(ranks, want):
    """Relative error of each result of the port's ranks against JAX's:
    the chunk gradients concatenated in stage order; the replicated
    results of every rank."""
    errs = {}
    for k, v in want["grads"].items():
        errs[f"grad {k}"] = _rel(np.concatenate(
            [r["grads"][k] for r in ranks]), v)
    for r, rk in enumerate(ranks):
        for key in ("out", "dx", "loss"):
            if key in want:
                errs[f"{key} rank {r}"] = _rel(rk[key], want[key])
        for k, v in want.get("last_grads", {}).items():
            errs[f"last grad {k} rank {r}"] = _rel(rk["last_grads"][k], v)
    return errs


@pytest.mark.parametrize("name", list(W.PIPE_OP_CASES))
def test_body_matches_the_jax_body(jax_runs, port_runs, name):
    errs = _errors(port_runs[name], jax_runs[name])
    assert max(errs.values()) <= REL, errs


@pytest.mark.parametrize("name", list(W.PIPE_FAULTS))
def test_planted_fault_fails_the_judge(jax_runs, port_runs, name):
    errs = _errors(port_runs[name], jax_runs[W.PIPE_FAULTS[name][0]])
    assert max(errs.values()) > 1e-2, errs


@pytest.mark.parametrize("name", list(W.PIPE_OP_CASES))
def test_micro_batches_in_flight(port_runs, name):
    body, _, n, m = W.PIPE_OP_CASES[name]
    got = [r["max_in_flight"] for r in port_runs[name]]
    if body == "gpipe":
        assert got == [m] * n
    else:
        assert got == [min(n - p, m) for p in range(n)]
        assert max(got) <= n


# -- errors -------------------------------------------------------------------

def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("pp",))


def _both_raise(jax_call, port_call):
    with pytest.raises(ValueError) as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        port_call()
    return str(want.value), str(got.value)


def test_batch_not_divisible_by_n_micro_is_refused_as_jax_does():
    stage = lambda c, x: x  # noqa: E731
    w = np.zeros((4, 2, 2), np.float32)
    x = np.zeros((6, 2), np.float32)
    m = mesh.build_mesh(pp=2, world_size=2, rank=0)
    for jax_fn, port_fn, extra in (
            (jax_pl.spmd_pipeline, pl.spmd_pipeline, ()),
            (jax_pl.pipeline_1f1b, pl.pipeline_1f1b, (x,))):
        args = ((lambda y, t: 0.0,) if extra else ())
        want, got = _both_raise(
            lambda: jax_fn(stage, *args, {"w": jnp.asarray(w)},
                           jnp.asarray(x), *map(jnp.asarray, extra),
                           mesh=_jax_mesh(2), n_micro=4),
            lambda: port_fn(stage, *args, {"w": torch.from_numpy(w)},
                            torch.from_numpy(x),
                            *map(torch.from_numpy, extra), mesh=m,
                            n_micro=4))
        assert got == want == "batch 6 not divisible by n_micro 4"


def test_stacked_dim_not_divisible_by_the_stages_is_refused():
    stage = lambda c, x: x  # noqa: E731
    w = np.zeros((3, 2, 2), np.float32)
    x = np.zeros((4, 2), np.float32)
    m = mesh.build_mesh(pp=2, world_size=2, rank=0)
    want, got = _both_raise(
        lambda: jax_pl.spmd_pipeline(stage, {"w": jnp.asarray(w)},
                                     jnp.asarray(x), mesh=_jax_mesh(2)),
        lambda: pl.spmd_pipeline(stage, {"w": torch.from_numpy(w)},
                                 torch.from_numpy(x), mesh=m))
    assert got == want == ("stacked param ['w'] leading dim 3 not "
                           "divisible by 2 pp stages")
    # JAX's 1F1B leaves it to shard_map (whose auto= this JAX refuses);
    # the port's names it as its GPipe does
    with pytest.raises(ValueError, match=r"\['w'\] leading dim 3"):
        pl.pipeline_1f1b(stage, lambda y, t: 0.0, {"w": torch.from_numpy(w)},
                         torch.from_numpy(x), torch.from_numpy(x), mesh=m)


# -- PipelineLayer ------------------------------------------------------------

def _layers(desc, shared, linear, act, **kw):
    """Seven items, the shared one twice: Linear, act, Linear, shared,
    Linear, act, shared."""
    def tied():
        return shared("tied", linear, lambda layer, x: layer(x) * 0.5,
                      "weight", 8, 8, **kw)
    return [desc(linear, 8, 8, **kw), act, desc(linear, 8, 8, **kw), tied(),
            desc(linear, 8, 8, **kw), act, tied()]


def test_pipeline_layer_matches_jax_on_carried_weights():
    from paddle_tpu.nn import functional as jax_F
    want = jax_pp.PipelineLayer(
        _layers(jax_pp.LayerDesc, jax_pp.SharedLayerDesc, jax_nn.Linear,
                jax_F.tanh), num_stages=3)
    got = PipelineLayer(
        _layers(LayerDesc, SharedLayerDesc, port_nn.Linear, torch.tanh,
                device="cpu"), num_stages=3)
    assert got._stage_bounds == want._stage_bounds == [(0, 3), (3, 6),
                                                       (6, 7)]
    assert [got.get_stage_of(i) for i in range(8)] == \
        [want.get_stage_of(i) for i in range(8)]
    sd = {k: np.asarray(v._data) for k, v in want.state_dict().items()}
    assert set(sd) == set(got.state_dict())
    load_numpy_state_dict(got, sd)
    x = np.random.default_rng(5).standard_normal((3, 8)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            got(torch.from_numpy(x)).numpy(),
            np.asarray(want(to_tensor(x))._data), rtol=1e-5, atol=1e-6)
        y, yj = torch.from_numpy(x), to_tensor(x)
        for s in range(3):
            y, yj = got.stage_forward(s, y), want.stage_forward(s, yj)
            np.testing.assert_allclose(y.numpy(), np.asarray(yj._data),
                                       rtol=1e-5, atol=1e-6)
