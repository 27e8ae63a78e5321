"""The 1F1B pipeline train step. Counterpart of
``paddle_tpu/distributed/fleet/pp_train_step.py``
(``Compiled1F1BTrainStep``, ``make_1f1b_train_step``).

Reference: ``fleet/meta_parallel/pipeline_parallel.py``, whose
``train_batch`` runs the 1F1B schedule and then the optimizer. Each call
of ``Pipeline1F1BTrainStep``:

1. takes this rank's ``data_pspec`` slice of the global batch (over dp;
   every stage of a pp group gets the same slice);
2. runs the embedding forward outside the ring, on every rank;
3. runs ``ops.pipeline.pipeline_1f1b`` over the stacked chunk this rank
   holds, with ``last_fn`` (final norm, head and CE) inside the last
   stage; it returns the loss, the chunk's gradients, the last-stage
   gradients and ``dx``, the last three replicated over pp as JAX's
   ``psum``s make them;
4. runs the embedding backward from ``dx``;
5. averages the gradients over dp (never over pp: the chunks are
   disjoint, and the replicated ones are already equal), clips, updates
   this rank's parameters in place (AdamW on the chunk) and steps the LR,
   as ``TrainStep`` does.

Model contract: ``model.pipeline_parts()`` returning ``(embed_params,
stacked_params, last_params, embed_fn, stage_fn, last_fn)``, see
``text.models.llama_pipe.LlamaForCausalLMPipe.pipeline_parts``. The
schedule's ``n_micro`` micro-batches are its accumulation:
``accumulate_steps`` is not used, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...ops import pipeline
from .train_step import TrainStep

__all__ = ["Pipeline1F1BTrainStep", "make_1f1b_train_step"]


def _owned(model, *batch):
    raise RuntimeError("the 1F1B step owns the loss")


class Pipeline1F1BTrainStep(TrainStep):
    """``TrainStep`` whose gradients come from the 1F1B schedule instead of
    autograd over the model's forward (which gives the GPipe backward,
    holding ``n_micro`` micro-batches)."""

    def __init__(self, model, optimizer, n_micro=None, strategy=None):
        self.n_micro = n_micro
        (self._embed_p, self._stacked_p, self._last_p, self._embed_fn,
         self._stage_fn, self._last_fn) = model.pipeline_parts()
        super().__init__(model, optimizer, _owned, strategy=strategy)

    def _grads(self, batch):
        ids, labels = batch
        dev = self._embed_p["embed_tokens.weight"].device
        ids = torch.as_tensor(ids, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        x = self._embed_fn(self._embed_p, ids)
        loss, g_stack, g_last, dx = pipeline.pipeline_1f1b(
            self._stage_fn, self._last_fn, self._stacked_p, x.detach(),
            labels, last_params=self._last_p, mesh=self.mesh,
            n_micro=self.n_micro)
        g_embed = torch.autograd.grad(x, list(self._embed_p.values()), dx)
        grads = dict(zip(self._embed_p, g_embed))
        for src in (g_stack, g_last):
            grads.update(src)
        return loss, {k: grads[k].to(p.dtype) if k in grads
                      else torch.zeros_like(p)
                      for k, p in self._params.items()}


def make_1f1b_train_step(model, optimizer, n_micro=None,
                         strategy=None) -> Pipeline1F1BTrainStep:
    return Pipeline1F1BTrainStep(model, optimizer, n_micro=n_micro,
                                 strategy=strategy)
