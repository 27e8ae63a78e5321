"""The port's ``io`` (datasets, samplers, ``DataLoader``) and
``ResumableLoader`` against the JAX package's.

- ``DistributedBatchSampler`` gives JAX's index order: every rank of 1,
  2 and 3 replicas, shuffled or not, over 2 epochs, with and without
  ``drop_last``; ``state_dict`` / ``load_state_dict`` restore the order.
- ``DataLoader`` gives JAX's batches over 2 epochs with
  ``num_workers=0``, with process workers, and with the producer thread
  a dataset that cannot be pickled falls back to; tuples and dicts
  collate alike; ``get_worker_info`` answers inside the producer.
- ``ResumableLoader``'s cursor and fast-forward mirror
  ``tests/test_resilience.py:389-417`` and give JAX's batches.
- The loader's batches land on its device: CUDA by default, raising
  without it.
"""
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from paddle_tpu import io as jio
from paddle_tpu.resilience import ResumableLoader as JaxResumable
from paddle_tpu_torch import io
from paddle_tpu_torch.resilience import ResumableLoader


def _DS():
    return W.IoRows()


def _DictDS():
    return W.IoRows(as_dict=True)


def _np(b):
    if isinstance(b, (tuple, list)):
        return [_np(v) for v in b]
    if isinstance(b, dict):
        return {k: _np(v) for k, v in b.items()}
    if isinstance(b, torch.Tensor):
        return b.numpy()
    return np.asarray(b._data if hasattr(b, "_data") else b)


def _same(a, b):
    if isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,bs,nranks,shuffle,drop_last", [
    (13, 2, 1, True, False), (13, 2, 2, True, False),
    (13, 3, 3, True, True), (12, 4, 2, False, False),
    (40, 5, 2, True, True)])
def test_distributed_batch_sampler_order_matches_jax(n, bs, nranks, shuffle,
                                                    drop_last):
    data = list(range(n))
    for rank in range(nranks):
        kw = dict(batch_size=bs, num_replicas=nranks, rank=rank,
                  shuffle=shuffle, drop_last=drop_last)
        p = io.DistributedBatchSampler(data, **kw)
        j = jio.DistributedBatchSampler(data, **kw)
        assert len(p) == len(j)
        for epoch in range(2):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j)
        s = io.DistributedBatchSampler(data, **kw)
        s.load_state_dict(p.state_dict())
        assert p.state_dict() == {"epoch": 1} and list(s) == list(p)


@pytest.mark.parametrize("workers,ds_kind", [
    (0, "tuple"), (0, "dict"), (2, "tuple")],
    ids=["inline-tuple", "inline-dict", "processes-tuple"])
def test_dataloader_batches_match_jax(workers, ds_kind):
    ds = _DS() if ds_kind == "tuple" else _DictDS()
    mk = dict(batch_size=3, num_replicas=1, rank=0, shuffle=True)
    ps, js = io.DistributedBatchSampler(ds, **mk), \
        jio.DistributedBatchSampler(ds, **mk)
    port = io.DataLoader(ds, batch_sampler=ps, num_workers=workers,
                         device="cpu")
    jax = jio.DataLoader(ds, batch_sampler=js)
    for epoch in range(2):
        ps.set_epoch(epoch)
        js.set_epoch(epoch)
        batches = list(port)
        _same([_np(b) for b in batches], [_np(b) for b in jax])
        assert all(isinstance(t, torch.Tensor)
                   for b in batches for t in (b if ds_kind == "tuple"
                                              else b.values()))


def test_unpicklable_dataset_falls_back_to_a_producer_thread():
    base = _DS()
    seen = []

    class Local(io.Dataset):            # a local class: spawn cannot
        def __len__(self):              # pickle it
            return len(base)

        def __getitem__(self, i):
            seen.append(io.get_worker_info())
            return base[i]

    port = io.DataLoader(Local(), batch_size=4, num_workers=2,
                         device="cpu")
    jax = jio.DataLoader(base, batch_size=4)
    _same([_np(b) for b in port], [_np(b) for b in jax])
    assert seen and all(w is not None and w.num_workers == 2 for w in seen)
    assert io.get_worker_info() is None


def test_tensor_dataset_and_collate():
    x = torch.arange(24.0).reshape(8, 3)
    y = np.arange(8)
    batches = list(io.DataLoader(io.TensorDataset([x, y]), batch_size=3,
                                 device="cpu"))
    assert [tuple(b[0].shape) for b in batches] == [(3, 3), (3, 3), (2, 3)]
    assert torch.equal(batches[1][0], x[3:6])
    assert batches[2][1].tolist() == [6, 7]


def test_dataloader_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        io.DataLoader(_DS(), batch_size=2)


# ---------------------------------------------------------------------------
# ResumableLoader (tests/test_resilience.py:389-417)
# ---------------------------------------------------------------------------

class _Rows:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        return np.asarray([i], np.float32)


def _loader(pkg):
    ds = _Rows()
    if pkg == "port":
        sampler = io.DistributedBatchSampler(ds, batch_size=2,
                                             num_replicas=1, rank=0,
                                             shuffle=True)
        return io.DataLoader(ds, batch_sampler=sampler, device="cpu")
    sampler = jio.DistributedBatchSampler(ds, batch_size=2, num_replicas=1,
                                          rank=0, shuffle=True)
    return jio.DataLoader(ds, batch_sampler=sampler)


def _rows(b):
    return _np(b).ravel().tolist()


def test_fast_forward_continues_exactly():
    ref = [_rows(b) for b in ResumableLoader(_loader("port"), epochs=2)]
    assert ref == [_rows(b) for b in JaxResumable(_loader("jax"), epochs=2)]
    rl = ResumableLoader(_loader("port"), epochs=2)
    seen = []
    for b in rl:
        seen.append(_rows(b))
        if len(seen) == 7:          # mid-epoch-2 interruption
            break
    cursor = rl.state_dict()
    assert cursor == {"epoch": 1, "batch_index": 1}
    rl2 = ResumableLoader(_loader("port"), epochs=2)
    rl2.set_state_dict(cursor)
    rest = [_rows(b) for b in rl2]
    assert seen + rest == ref
    jl = JaxResumable(_loader("jax"), epochs=2)
    jl.set_state_dict(cursor)
    assert [_rows(b) for b in jl] == rest
