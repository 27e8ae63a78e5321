"""``distributed.utils.global_scatter`` / ``global_gather`` (the MoE
token-dispatch collectives) against the JAX package's.

On two gloo ranks (one module-scoped spawn of
``torch_dist_worker.dispatch_worker``): the reference docstring's example
(``tests/test_global_dispatch.py``'s rows, counts and expected rows) gives
the expected rows, and every result equals JAX's ``_global_scatter_raw``
/ ``_global_gather_raw`` under ``shard_map`` on two virtual devices, the
capacity padding zero included; the gather inverts the scatter; each
one's gradient under a random cotangent equals JAX's (the inverse
permutation); a bucket above ``capacity`` raises. In this process: the
world-size-1 identity with its gradient, and the ``ValueError`` /
``TypeError`` of mismatched counts and dtypes, as the JAX package raises
them.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu as paddle
import torch_dist_worker as W
from paddle_tpu.distributed import utils as JU
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed.utils import global_gather, global_scatter

SCATTER_EXPECTED = [
    np.array([[1, 2], [3, 4], [1, 2], [5, 6], [3, 4]], np.float32),
    np.array([[7, 8], [5, 6], [7, 8], [9, 10], [9, 10]], np.float32),
]
GATHER_EXPECTED = [
    np.array([[1, 2], [3, 4], [7, 8], [1, 2], [7, 8]], np.float32),
    np.array([[5, 6], [9, 10], [3, 4], [5, 6], [9, 10]], np.float32),
]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dispatch")
    dist.spawn(W.dispatch_worker, args=(str(out),), nprocs=2, timeout=300)
    runs = []
    for r in range(2):
        with open(out / f"dispatch.r{r}.pkl", "rb") as f:
            runs.append(pickle.load(f))
    return runs


def _jax(raw):
    """JAX's body on two devices, jitted (eager shard_map is slow): x
    [2, N, ...] per device -> [2, M, ...]."""
    f = jax.shard_map(
        lambda xs, lc, gc: raw(xs[0], lc[0], gc[0], "x",
                               W.DISPATCH_CAPACITY)[None],
        mesh=Mesh(np.asarray(jax.devices()[:2]), ("x",)),
        in_specs=(P("x"), P("x"), P("x")), out_specs=P("x"))
    lc, gc = jnp.asarray(W.DISPATCH_LC), jnp.asarray(W.DISPATCH_GC)
    return jax.jit(lambda x: f(x, lc, gc))


@pytest.mark.parametrize("name,raw,expected", [
    ("scatter", JU._global_scatter_raw, SCATTER_EXPECTED),
    ("gather", JU._global_gather_raw, GATHER_EXPECTED)])
def test_reference_example_and_jax(ranks, name, raw, expected):
    x = jnp.asarray(np.stack([W.DISPATCH_X, W.DISPATCH_X]))
    want = np.asarray(_jax(raw)(x))
    for r in range(2):
        got = ranks[r][name]
        np.testing.assert_array_equal(got[:5], expected[r])
        np.testing.assert_array_equal(got, want[r])   # zeros past 5 rows


def test_gather_inverts_scatter(ranks):
    xs = W.dispatch_inputs()[0]
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["round_trip"][:5], xs[r])


@pytest.mark.parametrize("name,raw,ct_index", [
    ("scatter", JU._global_scatter_raw, 1),
    ("gather", JU._global_gather_raw, 2)])
def test_gradient_is_jax_vjp(ranks, name, raw, ct_index):
    inputs = W.dispatch_inputs()
    x, ct = jnp.asarray(inputs[0]), jnp.asarray(inputs[ct_index])
    want = np.asarray(jax.jit(
        lambda x, ct: jax.vjp(_jax(raw), x)[1](ct)[0])(x, ct))
    for r in range(2):
        np.testing.assert_allclose(ranks[r][f"{name}_grad"], want[r],
                                   rtol=1e-6, atol=1e-6)


def test_bucket_over_capacity_raises(ranks):
    for r in range(2):
        assert "exceeds capacity 1" in ranks[r]["over_capacity"], r


def test_world1_identity_and_gradient():
    x = torch.from_numpy(W.DISPATCH_X).requires_grad_()
    lc = torch.tensor([3, 2])
    out = global_scatter(x, lc, lc)
    np.testing.assert_array_equal(out.detach().numpy(), W.DISPATCH_X)
    back = global_gather(out, lc, lc)
    np.testing.assert_array_equal(back.detach().numpy(), W.DISPATCH_X)
    (back * back).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2.0 * W.DISPATCH_X)
    # fewer counted rows than x has: the first sum(counts)
    part = global_scatter(x, np.array([2, 1]), np.array([1, 2]))
    np.testing.assert_array_equal(part.detach().numpy(), W.DISPATCH_X[:3])
    jpart = JU.global_scatter(paddle.to_tensor(W.DISPATCH_X),
                              paddle.to_tensor(np.array([2, 1])),
                              paddle.to_tensor(np.array([1, 2])))
    np.testing.assert_array_equal(part.detach().numpy(), jpart.numpy())


@pytest.mark.parametrize("fn,jfn", [(global_scatter, JU.global_scatter),
                                    (global_gather, JU.global_gather)])
def test_errors_match_jax(fn, jfn):
    x = W.DISPATCH_X
    for args, exc in (
            ((x, np.array([3, 1]), np.array([3, 2])), ValueError),
            ((x, np.array([3.0, 2.0], np.float32),
              np.array([3.0, 2.0], np.float32)), TypeError),
            ((x.astype(bool), np.array([3, 2]), np.array([3, 2])),
             TypeError),
            ((x, np.array([3, 2], np.uint32), np.array([3, 2])),
             TypeError)):
        with pytest.raises(exc) as got:
            fn(torch.from_numpy(args[0]), *args[1:])
        with pytest.raises(exc) as want:
            jfn(paddle.to_tensor(args[0]),
                *(paddle.to_tensor(a) for a in args[1:]))
        assert str(got.value) == str(want.value)
