"""GPT decoder LM. Counterpart of ``paddle_tpu/text/models/gpt.py``.

Same config, parameter names and layouts as the JAX package (pre-LN
blocks, learned positions, one fused ``qkv`` projection; ``Linear``
weights ``[in, out]``; ``state_dict`` keys such as
``gpt.blocks.0.qkv.weight``, ``gpt.wpe.weight`` and ``lm_head.weight``),
so a JAX model's weights carry across with
``framework.io.load_numpy_state_dict``. q, k and v are views of the fused
projection (row stride ``3 * hidden``), handed as they are to
``F.scaled_dot_product_attention``, which takes the hand-written flash
kernel on eligible CUDA inputs (the tensor-core variant reads the views
through their strides).

``GPTConfig.dtype`` is the port's own field (the JAX model is built in
float32 and cast with ``.to``): parameters are made in it.
``forward(input_ids, labels=None)`` follows the caller's grad mode
(score under ``torch.inference_mode()``); with ``labels`` it returns the
fp32 mean CE of the logits at t against the labels at t + 1.
``generate(...)`` runs ``text.generation.gpt_generate``.

Tensor parallel: the weights carry the JAX model's annotations
(``param.pspec``: qkv and fc1 split by columns, proj and fc2 by rows), and
``fleet.distributed_model`` at tp > 1 swaps those Linears for
``mp_layers``' column- and row-parallel ones (``check_tensor_parallel``
first asks that tp divide the heads). GSPMD splits the JAX model's fused
``qkv`` by contiguous columns; a rank here needs the q, k and v columns
of its own heads, so ``qkv``'s columns (weight and bias) are cut in the
order of ``_gpt_qkv_tp_permutation`` (``qkv.tp_column_order``), and
``framework.io`` reads and writes full arrays in the JAX layout. A
block runs on its rank's ``hidden / tp`` columns: ``H / tp`` heads,
proj and fc2 reduced over tp with their biases added once, after the sum.
``wte``, ``wpe`` and ``lm_head`` stay whole and the CE dense, as in JAX.
``serving.Engine(model, tp=N)`` takes the whole model instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import Dropout, Embedding, LayerNorm, Linear
from ...nn import functional as F


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    dropout: float = 0.1
    dtype: str = "float32"


GPT_TINY = GPTConfig(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=512,
                     max_position_embeddings=128)


def _gpt_qkv_tp_permutation(h, tp):
    """Column permutation mapping the fused ``[q | k | v]`` qkv layout to
    device-major ``[q_0 k_0 v_0 | q_1 k_1 v_1 | ...]``: block d of the
    permuted columns is rank d's head slice of all three projections."""
    hc = h // tp
    return np.concatenate([np.arange(blk * h + d * hc, blk * h + (d + 1) * hc)
                           for d in range(tp) for blk in range(3)])


class GPTBlock(nn.Module):
    def __init__(self, c: GPTConfig, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=c.dtype)
        h = c.hidden_size
        self.ln_1 = LayerNorm(h, **kw)
        self.num_heads = c.num_attention_heads
        self.head_dim = h // c.num_attention_heads
        self.qkv = Linear(h, 3 * h, **kw)
        self.proj = Linear(h, h, **kw)
        self.qkv.weight.pspec = (None, "tp")
        self.qkv.tp_column_order = partial(_gpt_qkv_tp_permutation, h)
        self.proj.weight.pspec = ("tp", None)
        self.ln_2 = LayerNorm(h, **kw)
        self.fc1 = Linear(h, c.intermediate_size, **kw)
        self.fc2 = Linear(c.intermediate_size, h, **kw)
        self.fc1.weight.pspec = (None, "tp")
        self.fc2.weight.pspec = ("tp", None)
        self.drop = Dropout(c.dropout)

    def forward(self, x):
        b, l, _ = x.shape
        qkv = self.qkv(self.ln_1(x))
        h = qkv.shape[-1] // 3          # this rank's width (hidden / tp)
        heads = (b, l, h // self.head_dim, self.head_dim)
        q, k, v = qkv.split(h, dim=-1)
        attn = F.scaled_dot_product_attention(
            q.reshape(heads), k.reshape(heads), v.reshape(heads),
            is_causal=True)
        x = x + self.drop(self.proj(attn.reshape(b, l, h)))
        return x + self.drop(self.fc2(F.gelu(self.fc1(self.ln_2(x)))))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig = GPTConfig(), *, device=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.wte = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, **kw)
        self.drop = Dropout(config.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(config, device=device)
             for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **kw)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with its (untied) LM head; ``device`` defaults to the
    framework's (``cuda``) and raises when CUDA is absent."""

    def __init__(self, config: GPTConfig = GPTConfig(), *, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.gpt = GPTModel(config, device=self.device)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, device=self.device,
                              dtype=config.dtype)

    def check_tensor_parallel(self, tp):
        """Raise ValueError unless ``tp`` splits the heads evenly:
        ``fleet.distributed_model`` asks before it splits the layers."""
        n = self.config.num_attention_heads
        if n % tp:
            raise ValueError(f"tensor-parallel degree {tp} does not divide "
                             f"num_attention_heads={n}")

    def forward(self, input_ids, labels=None):
        """input_ids [B, L] -> logits [B, L, vocab] in the model dtype;
        with labels [B, L], the fp32 mean CE of the logits at t against
        the labels at t + 1."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        logits = self.lm_head(self.gpt(ids))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device).long()
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, self.config.vocab_size).float(),
            labels[:, 1:].reshape(-1))

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=0, temperature=1.0, eos_token_id=None, seed=0,
                 top_p=None, pad_token_id=None, attention_mask=None):
        """Autoregressive decode with a preallocated KV cache
        (``text.generation.gpt_generate``): greedy, or sampled with
        top-k / top-p from ``seed``."""
        from ..generation import gpt_generate
        return gpt_generate(self, input_ids, max_new_tokens=max_new_tokens,
                            do_sample=do_sample, top_k=top_k, top_p=top_p,
                            temperature=temperature,
                            eos_token_id=eos_token_id, seed=seed,
                            pad_token_id=pad_token_id,
                            attention_mask=attention_mask)
