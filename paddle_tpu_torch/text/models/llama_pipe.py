"""Pipelined, stacked-weight Llama. Counterpart of
``paddle_tpu/text/models/llama_pipe.py`` (``LlamaForCausalLMPipe``,
``_decoder_chunk``, ``_rms``).

The decoder weights are stacked, a leading ``[num_layers, ...]`` dim on
``wq wk wv wo wg wu wd`` (paddle layout, ``[in, out]``) and ``ln1 ln2``,
annotated ``("pp", None, "tp")`` (o and down ``("pp", "tp", None)``), so
``fleet.distributed_model`` on a mesh with pp > 1 leaves each rank only
its contiguous chunk of the layers. The ``state_dict`` keys are the JAX
model's (``wq``, ..., ``embed_tokens.weight``, ``norm.weight``,
``lm_head.weight``), and a JAX model's weights carry across with
``framework.io.load_numpy_state_dict`` (each rank takes its chunk).

The embedding, final norm and head stay outside the pipeline, whole on
every pp rank. ``forward`` runs the stack as ``_decoder_chunk`` over all
layers at pp 1, and through ``ops.pipeline.spmd_pipeline`` (GPipe,
``n_micro`` micro-batches, default the pp degree) when the mesh's pp is
larger; with labels it returns the dense fp32 shifted CE (no fused head,
as in the JAX model). ``pipeline_parts()`` gives the 1F1B train step its
pieces (``fleet.pp_train_step``).

Attention goes through ``nn.functional.attention.sdpa_raw(causal=True)``:
on CUDA the hand-written flash forward and backward kernels whenever the
sequence length is a multiple of 128 and the head dim is one they are
built for. ``LlamaConfig.remat`` ("selective" or full) recomputes each
layer in the backward, as ``llama._remat_layer`` does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ...distributed.mesh import get_mesh
from ...framework.device import resolve_device
from ...nn import Embedding, Linear, RMSNorm
from ...nn import functional as F
from ...nn.functional.attention import sdpa_raw
from ...nn.initializer import Constant, Normal
from ...nn.param_attr import _param
from ...ops.pipeline import spmd_pipeline
from ...tensor_ops import matmul
from .llama import LlamaConfig, _check_config, _remat_layer, _rope

__all__ = ["LlamaForCausalLMPipe"]

_STACKED = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "ln1", "ln2")


def _rms(x, w, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _decoder_chunk(chunk, x, *, n_heads, n_kv, eps, theta, remat=False):
    """Apply a chunk of stacked decoder layers (the leading dim of the
    ``chunk`` leaves) to x ``[B, L, H]``: the body of one pipeline stage,
    and of the whole stack at pp 1."""
    b, l, h = x.shape
    hd = h // n_heads
    pos = torch.arange(l, device=x.device)

    def one(x, lp):
        h1 = _rms(x, lp["ln1"], eps)
        q = (h1 @ lp["wq"]).reshape(b, l, n_heads, hd)
        k = (h1 @ lp["wk"]).reshape(b, l, n_kv, hd)
        v = (h1 @ lp["wv"]).reshape(b, l, n_kv, hd)
        q, k = _rope(q, k, pos, theta, x.dtype)
        attn = sdpa_raw(q, k, v, causal=True)
        x = x + attn.reshape(b, l, h) @ lp["wo"]
        h2 = _rms(x, lp["ln2"], eps)
        return x + (TF.silu(h2 @ lp["wg"]) * (h2 @ lp["wu"])) @ lp["wd"]

    remat = remat and torch.is_grad_enabled()
    for i in range(chunk["wq"].shape[0]):
        lp = {k: v[i] for k, v in chunk.items()}
        if remat:
            x = _remat_layer(lambda y, _seq, lp=lp: one(y, lp), x, remat)
        else:
            x = one(x, lp)
    return x


class LlamaForCausalLMPipe(nn.Module):
    """Stacked-weight Llama LM; pipeline-parallel when the mesh's pp > 1.

    ``n_micro``: micro-batches of the pipeline schedule (the reference's
    ``accumulate_steps`` in the hybrid strategy); defaults to the pp
    degree. ``device`` defaults to the framework's (``cuda``) and raises
    when CUDA is absent."""

    def __init__(self, config: LlamaConfig, n_micro: Optional[int] = None,
                 *, device=None):
        super().__init__()
        _check_config(config)
        self.config = c = config
        self.n_micro = n_micro
        self.device = dev = resolve_device(device)
        L, h, ff = c.num_hidden_layers, c.hidden_size, c.intermediate_size
        kv = c.num_key_value_heads * (h // c.num_attention_heads)

        def mk(shape, init, pspec):
            p = _param(shape, init, dev, c.dtype)
            p.pspec = pspec
            return p

        w = Normal(mean=0.0, std=0.02)
        col, row = ("pp", None, "tp"), ("pp", "tp", None)
        self.wq = mk((L, h, h), w, col)
        self.wk = mk((L, h, kv), w, col)
        self.wv = mk((L, h, kv), w, col)
        self.wo = mk((L, h, h), w, row)
        self.wg = mk((L, h, ff), w, col)
        self.wu = mk((L, h, ff), w, col)
        self.wd = mk((L, ff, h), w, row)
        self.ln1 = mk((L, h), Constant(1.0), ("pp", None))
        self.ln2 = mk((L, h), Constant(1.0), ("pp", None))
        kw = dict(device=dev, dtype=c.dtype)
        self.embed_tokens = Embedding(c.vocab_size, h, **kw)
        self.embed_tokens.weight.pspec = ("tp", None)
        self.norm = RMSNorm(h, c.rms_norm_eps, **kw)
        self.tie = c.tie_word_embeddings
        if not self.tie:
            # tied head reuses embed_tokens.weight [vocab, h] transposed
            self.lm_head = Linear(h, c.vocab_size, bias_attr=False, **kw)
            self.lm_head.weight.pspec = (None, "tp")

    def _stacked(self):
        return {k: getattr(self, k) for k in _STACKED}

    def _stage_fn(self, remat):
        c = self.config
        return functools.partial(
            _decoder_chunk, n_heads=c.num_attention_heads,
            n_kv=c.num_key_value_heads, eps=c.rms_norm_eps,
            theta=c.rope_theta, remat=remat)

    def pipeline_parts(self):
        """The decomposition the 1F1B train step takes (the reference
        PipelineLayer's stage partition): ``(embed_params, stacked_params,
        last_params, embed_fn, stage_fn, last_fn)``, name-keyed parameter
        dicts and functions over tensors. ``last_fn`` is the final norm,
        the head and the shifted CE, run inside the last stage so its
        backward starts in the pipeline."""
        if self.tie:
            raise NotImplementedError(
                "1F1B train step requires untied embeddings (the tied head "
                "weight would need grads from two pipeline roles)")
        c = self.config
        embed = {"embed_tokens.weight": self.embed_tokens.weight}
        last = {"norm.weight": self.norm.weight,
                "lm_head.weight": self.lm_head.weight}

        def embed_fn(ev, ids):
            return ev["embed_tokens.weight"][ids]

        def last_fn(lp, y, labels):
            h = _rms(y, lp["norm.weight"], c.rms_norm_eps)
            logits = (h @ lp["lm_head.weight"])[:, :-1]
            logp = torch.log_softmax(
                logits.reshape(-1, c.vocab_size).float(), dim=-1)
            tgt = labels[:, 1:].reshape(-1).long()
            return -logp.gather(1, tgt[:, None]).mean()

        return (embed, self._stacked(), last, embed_fn,
                self._stage_fn(False), last_fn)

    def forward(self, input_ids, labels=None):
        """input_ids [B, L] -> logits [B, L, vocab] in the model dtype, on
        every pp rank; with labels [B, L], the mean CE of the logits at t
        against the labels at t + 1 (fp32 scalar)."""
        c = self.config
        ids = torch.as_tensor(input_ids, device=self.device).long()
        x = self.embed_tokens(ids)
        mesh = get_mesh()
        pp = mesh.axis_size("pp")
        stage = self._stage_fn(c.remat)
        if pp > 1:
            x = spmd_pipeline(stage, self._stacked(), x, mesh=mesh,
                              n_micro=self.n_micro or pp)
        else:
            x = stage(self._stacked(), x)
        x = self.norm(x)
        logits = (matmul(x, self.embed_tokens.weight, transpose_y=True)
                  if self.tie else self.lm_head(x))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device).long()
        # next-token prediction: logits at t score labels at t+1
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, c.vocab_size).float(),
            labels[:, 1:].reshape(-1))
