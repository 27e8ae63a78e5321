"""The port's sequence-parallel attention bodies against the JAX package's.

``ops.ring_attention.ring_attention_local`` and
``ops.ulysses_attention.ulysses_attention_local`` run on 2 and 4 gloo
ranks (one module-scoped spawn of 4 ranks from
``torch_dist_worker.sep_ops_worker``), each rank on its block of the
sequence; the JAX bodies of the same name run under ``jax.vmap(...,
axis_name="sep")`` over the stacked blocks (their ``shard_map`` entry
points need ``shard_map(auto=)``, which this JAX does not take). The
cases (``torch_dist_worker.SEP_OP_CASES``): causal and not, GQA (8 query
heads over 4 kv heads, and over 2 at n = 4, Ulysses' repeat-up branch),
128-position chunks (the flash route, its plain version on the CPU),
and one bf16 case per body.

Outputs and dq/dk/dv, gathered over the ranks, are held to JAX's by
``||got - want|| / ||want||``: 1e-5 in fp32 (the sums are reordered),
and in bf16 the judges' limits of ``PERF.md`` section 2 (1e-2, over all
rows and over the last quarter). Also the JAX errors for a sequence or a
head count that does not divide, and the JAX guard's refusal of sep
beside sharding or tp.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from paddle_tpu.distributed import mesh as jax_mesh
from paddle_tpu.ops import ring_attention as jax_ring
from paddle_tpu.ops import ulysses_attention as jax_ulysses
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import mesh
from paddle_tpu_torch.ops.ring_attention import ring_attention
from paddle_tpu_torch.ops.ulysses_attention import ulysses_attention

WORLD = 4
REL = {"float32": 1e-5, "bfloat16": 1e-2}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _jax_case(name):
    """(out, dq, dk, dv) of the JAX body on the case's stacked blocks, as
    fp32 numpy arrays [B, L, ...] in sequence order."""
    mode, n, causal, (B, L, *_), dtype = W.SEP_OP_CASES[name]
    body = (jax_ring.ring_attention_local if mode == "ring"
            else jax_ulysses.ulysses_attention_local)
    q, k, v, do = W.sep_op_inputs(name)
    scale = 1.0 / np.sqrt(q.shape[-1])

    def stack(x):                  # [B, L, ...] -> [n, B, L / n, ...]
        x = jnp.asarray(x, JAX_DTYPES[dtype])
        return x.reshape(B, n, L // n, *x.shape[2:]).swapaxes(0, 1)

    def unstack(x):
        x = np.asarray(x.astype(jnp.float32)).swapaxes(0, 1)
        return x.reshape(B, L, *x.shape[3:])

    f = jax.vmap(lambda a, b, c: body(a, b, c, "sep", n, causal, scale),
                 axis_name="sep")
    out, vjp = jax.vjp(f, stack(q), stack(k), stack(v))
    return (unstack(out),) + tuple(unstack(g) for g in vjp(stack(do)))


@pytest.fixture(scope="module")
def jax_cases():
    return {name: _jax_case(name) for name in W.SEP_OP_CASES}


@pytest.fixture(scope="module")
def port_cases(tmp_path_factory):
    out = tmp_path_factory.mktemp("sepops")
    dist.spawn(W.sep_ops_worker, args=(str(out), list(W.SEP_OP_CASES)),
               nprocs=WORLD, timeout=300)
    ranks = []
    for r in range(WORLD):
        with open(out / f"sepops.r{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _gathered(ranks, name):
    """(out, dq, dk, dv) of the port, the ranks' blocks in order."""
    n = W.SEP_OP_CASES[name][1]
    got = [ranks[r][name] for r in range(n)]
    assert [g["block"][0] for g in got] == sorted(g["block"][0] for g in got)
    return (np.concatenate([g["out"] for g in got], axis=1),) + tuple(
        np.concatenate([g["grads"][i] for g in got], axis=1)
        for i in range(3))


def _rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("name", list(W.SEP_OP_CASES))
def test_body_matches_the_jax_body(jax_cases, port_cases, name):
    dtype = W.SEP_OP_CASES[name][4]
    got, want = _gathered(port_cases, name), jax_cases[name]
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        assert np.isfinite(g).all(), what
        tail = slice(w.shape[1] - w.shape[1] // 4, w.shape[1])
        for rel in (_rel(g, w), _rel(g[:, tail], w[:, tail])):
            assert rel < REL[dtype], (what, rel)


@pytest.mark.parametrize("name", ["ring_n4_causal", "ulysses_n4_full_kv2"])
def test_entry_point_on_whole_arrays_matches_the_jax_body(jax_cases,
                                                         port_cases, name):
    """``ring_attention`` / ``ulysses_attention`` on whole arrays held by
    every rank: the gathered output and the whole gradients, on every
    rank of the case."""
    n = W.SEP_OP_CASES[name][1]
    for r in range(n):
        for g, w in zip(port_cases[r][name]["whole"], jax_cases[name]):
            assert _rel(g, w) < REL["float32"], r


def test_every_rank_of_a_case_ran_it_and_staged_nothing(port_cases):
    """Every case ran on exactly its first n ranks; on the CPU no
    ppermute is staged through the host (gloo carries CPU tensors)."""
    for name, (_, n, *_rest) in W.SEP_OP_CASES.items():
        assert [r for r in range(WORLD) if name in port_cases[r]] == \
            list(range(n)), name
    assert all(rk["host_staged"]["ppermute"] == 0 for rk in port_cases)


def test_phase15a_judges_pass_the_bodies_and_fail_the_planted_faults(
        port_cases):
    """``chip_smoke.sep_ops`` (phase 15a) on 2 ranks at [1, 256, 4, 32]
    bf16: ring and Ulysses pass ``judge_forward`` / ``judge_backward``
    against whole-sequence flash attention, and each planted fault (the
    wraparound pair unmasked, dk/dv one rotation short of home, Ulysses'
    heads in the wrong rank order) fails its judge, on both ranks."""
    for r in range(2):
        judged = port_cases[r]["judged"]
        for mode in ("ring", "ulysses"):
            assert judged[mode]["forward_ok"], (r, mode, judged[mode])
            assert judged[mode]["backward_ok"], (r, mode, judged[mode])
        assert len(judged["faults_passed"]) == 3
        assert not any(judged["faults_passed"].values()), judged


# -- the JAX errors -----------------------------------------------------------

def _jax_error(fn, shape_q, shape_kv, sep=2):
    jax_mesh.set_mesh(None)
    try:
        m = jax_mesh.build_mesh(sep=sep)
        q = jnp.zeros(shape_q, jnp.float32)
        kv = jnp.zeros(shape_kv, jnp.float32)
        with pytest.raises(ValueError) as e:
            fn(q, kv, kv, mesh=m, causal=True)
        return str(e.value)
    finally:
        jax_mesh.set_mesh(None)


def _port_error(fn, shape_q, shape_kv, sep=2):
    m = mesh.build_mesh(sep=sep, world_size=sep, rank=0)
    q = torch.zeros(shape_q)
    kv = torch.zeros(shape_kv)
    with pytest.raises(ValueError) as e:
        fn(q, kv, kv, mesh=m, causal=True)
    return str(e.value)


@pytest.mark.parametrize("what,shape_q,shape_kv", [
    ("ring, seq len", (1, 7, 4, 16), (1, 7, 4, 16)),
    ("ulysses, seq len", (1, 7, 4, 16), (1, 7, 4, 16)),
    ("ulysses, num heads", (1, 8, 3, 16), (1, 8, 3, 16)),
])
def test_shape_errors_are_the_jax_errors(what, shape_q, shape_kv):
    jfn, pfn = ((jax_ring.ring_attention, ring_attention)
                if what.startswith("ring")
                else (jax_ulysses.ulysses_attention, ulysses_attention))
    want = _jax_error(jfn, shape_q, shape_kv)
    assert _port_error(pfn, shape_q, shape_kv) == want


@pytest.mark.parametrize("fn", [ring_attention, ulysses_attention])
@pytest.mark.parametrize("beside", ["sharding", "tp"])
def test_sep_beside_sharding_or_tp_is_refused_as_jax_guard_refuses(fn,
                                                                   beside):
    m = mesh.build_mesh(sep=2, world_size=4, rank=0, **{beside: 2})
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(NotImplementedError,
                       match=f"non-trivial axes \\['{beside}'\\]"):
        fn(q, q, q, mesh=m, causal=True)


def test_sep_of_one_is_plain_attention():
    """n == 1: sdpa_raw, as the JAX entry points."""
    from paddle_tpu_torch.nn.functional.attention import sdpa_raw
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(
        np.float32)) for _ in range(3))
    m = mesh.build_mesh(dp=1, world_size=1, rank=0)
    want = sdpa_raw(q, k, v, causal=True)
    for fn in (ring_attention, ulysses_attention):
        torch.testing.assert_close(fn(q, k, v, mesh=m, causal=True), want,
                                   rtol=0, atol=0)
