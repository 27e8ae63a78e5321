"""The port's collectives and ``spawn`` on 4 CPU ranks (gloo).

The twins of ``tests/test_distributed.py::test_collectives_semantics``
and ``::test_spawn_multi_process``: each collective of
``paddle_tpu_torch.distributed`` runs on the world group and on this
rank's dp and tp groups of a 2 x 2 mesh, in one module-scoped spawn of 4
ranks (``tests/torch_dist_worker.py``), and every rank's result is held
to numpy exactly (float32 sums of small integers are exact). Also
``DataParallel.apply_collective_grads`` (the dp group's mean), the
tensor-parallel layers against the layers they were cut from,
``ParallelEnv``, ``is_initialized`` before and after
``destroy_process_group``, and the environment ``spawn`` gives.
"""
import pickle

import numpy as np
import pytest

import torch_dist_worker as W
from paddle_tpu_torch import distributed as dist

WORLD = 4
GROUPS = ("world", "dp", "tp")
OPS = ("all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
       "all_reduce_PROD", "all_reduce_AVG", "all_gather", "all_gather_list",
       "reduce_scatter", "reduce_scatter_list", "broadcast", "reduce",
       "scatter", "alltoall", "alltoall_single")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("collective")
    dist.spawn(W.collective_worker, args=(str(out),), nprocs=WORLD,
               timeout=240)

    def load(name):
        with open(out / name, "rb") as f:
            return pickle.load(f)

    return ([load(f"collective.r{r}.pkl") for r in range(WORLD)],
            [load(f"destroyed.r{r}.pkl") for r in range(WORLD)])


def _want(op, rank, members):
    """What ``op`` gives ``rank`` among ``members`` (global ranks)."""
    xs = np.stack([W.rank_input(r) for r in members])      # [n, 4, 2]
    i, n = members.index(rank), len(members)
    chunks = lambda x: np.split(x, n)                       # noqa: E731
    if op.startswith("all_reduce_"):
        fn = {"SUM": np.sum, "MAX": np.max, "MIN": np.min, "PROD": np.prod,
              "AVG": np.mean}[op.split("_")[-1]]
        return fn(xs, axis=0)
    if op in ("all_gather", "all_gather_list"):
        return xs
    if op in ("reduce_scatter", "reduce_scatter_list"):
        return chunks(xs.sum(axis=0))[i]
    if op == "broadcast":
        return xs[0]
    if op == "reduce":
        return xs.sum(axis=0) if i == 0 else None
    if op == "scatter":
        return chunks(xs[0])[i]
    # alltoall: rank i's piece j goes to rank j's slot i
    return np.concatenate([chunks(x)[i] for x in xs])


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_numpy(results, op, group):
    ranks, _ = results
    for out in ranks:
        members = out["members"][group]
        want = _want(op, out["rank"], members)
        if want is None:
            assert op not in out[group]
            continue
        np.testing.assert_allclose(out[group][op], want, rtol=1e-6,
                                   err_msg=f"rank {out['rank']}")


def test_groups_follow_the_mesh(results):
    ranks, _ = results
    for out in ranks:
        r = out["rank"]
        assert out["members"]["world"] == list(range(WORLD))
        assert out["members"]["tp"] == [r - r % 2, r - r % 2 + 1]
        assert out["members"]["dp"] == [r % 2, r % 2 + 2]


def test_data_parallel_averages_grads_over_dp(results):
    ranks, _ = results
    for out in ranks:
        members = out["members"]["dp"]
        want = np.mean([W.rank_input(m).sum(axis=0) for m in members],
                       axis=0)
        np.testing.assert_allclose(out["data_parallel_grad"][0], want,
                                   rtol=1e-6)


@pytest.mark.parametrize("what", ["loss", "emb", "col", "row", "head",
                                  "col_bias", "row_bias"])
def test_tensor_parallel_layers_match_the_full_layers(results, what):
    """``fleet.meta_parallel``'s layers on a tp group of 2 give the full
    layers' per-token losses and, on each rank, its slice of every
    gradient."""
    ranks, _ = results
    for out in ranks:
        got, want = out["mp_layers"][what]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"rank {out['rank']}")


def test_env_and_lifecycle(results):
    ranks, destroyed = results
    for r, out in enumerate(ranks):
        assert out["rank"] == r and out["world_size"] == WORLD
        assert out["is_initialized"]
        assert out["parallel_env"] == (r, WORLD, r)
    assert not any(destroyed)


def test_spawn_multi_process(tmp_path):
    dist.spawn(W.spawn_env_worker, args=(str(tmp_path),), nprocs=2,
               timeout=120)
    assert (tmp_path / "r0").read_text() == "2 0 2"
    assert (tmp_path / "r1").read_text() == "2 1 2"


def test_spawn_one_process_runs_inline_and_restores_the_env(tmp_path):
    import os
    before = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE")}
    dist.spawn(W.spawn_env_worker, args=(str(tmp_path),), nprocs=1)
    assert (tmp_path / "r0").read_text() == "1 0 1"
    assert {k: os.environ.get(k) for k in before} == before


def test_spawn_reports_a_failed_worker(tmp_path):
    with pytest.raises(RuntimeError, match="spawn workers failed"):
        dist.spawn(W.spawn_env_worker, args=(str(tmp_path / "missing"),),
                   nprocs=2, timeout=120)
