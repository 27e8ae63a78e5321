"""Datasets, samplers and the DataLoader. Counterpart of
``paddle_tpu/io``: the same batch order as the JAX package's loader, the
batches as torch tensors on the loader's device (``cuda`` unless the
caller passes ``device="cpu"``)."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn

__all__ = ["ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
           "IterableDataset", "Subset", "TensorDataset", "random_split",
           "BatchSampler", "DistributedBatchSampler", "RandomSampler",
           "Sampler", "SequenceSampler", "WeightedRandomSampler",
           "DataLoader", "default_collate_fn", "get_worker_info"]


def get_worker_info():
    """Reference: io/dataloader/worker.py::get_worker_info. Inside a
    worker (process or producer thread) this returns its (id,
    num_workers, dataset); in the main thread None."""
    from .dataloader import _worker_info
    return _worker_info()
