"""ERNIE-MoE style transformer. Counterpart of
``paddle_tpu/text/models/ernie_moe.py``.

Same config, parameter names and layouts as the JAX package
(``state_dict`` keys such as ``ernie.blocks.1.moe.w_up``,
``ernie.blocks.1.moe.gate.weight``, ``ernie.blocks.0.qkv.bias`` and
``lm_head.weight``), so a JAX model's weights carry across with
``framework.io.load_numpy_state_dict``. Every ``moe_every``-th block's
FFN is an ``nn.MoELayer``; the others are a dense GELU (erf) FFN.
Attention is bidirectional, through ``F.scaled_dot_product_attention``
(the hand-written flash kernels on eligible CUDA inputs).

``ErnieMoEConfig.dtype`` is the port's own field (the JAX model is built
in float32 and cast with ``.to``): parameters are made in it. With
``labels`` the forward returns the fp32 mean CE of the logits plus
``aux_loss_weight`` times the MoE layers' summed load-balance losses.

Under ``mp_degree`` > 1 the model trains expert parallel, as the JAX
one does (``nn.moe``): each tp rank holds ``E / tp`` experts of every
MoE layer and computes the rest of the model whole on the same tokens.
Every rank seeds alike and draws its dropout masks in the same order, so
the masks agree across the tp ranks.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import Dropout, Embedding, LayerNorm, Linear, MoELayer
from ...nn import functional as F


@dataclass
class ErnieMoEConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    num_experts: int = 8
    moe_every: int = 2  # every Nth layer is MoE
    top_k: int = 2
    max_position_embeddings: int = 512
    dropout: float = 0.1
    aux_loss_weight: float = 0.01
    dtype: str = "float32"


ERNIE_MOE_TINY = ErnieMoEConfig(vocab_size=1024, hidden_size=128,
                                num_hidden_layers=2, num_attention_heads=4,
                                intermediate_size=256, num_experts=4,
                                max_position_embeddings=128)


class MoEBlock(nn.Module):
    def __init__(self, c: ErnieMoEConfig, use_moe: bool, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=c.dtype)
        h = c.hidden_size
        self.ln_1 = LayerNorm(h, **kw)
        self.num_heads = c.num_attention_heads
        self.head_dim = h // c.num_attention_heads
        self.qkv = Linear(h, 3 * h, **kw)
        self.proj = Linear(h, h, **kw)
        self.ln_2 = LayerNorm(h, **kw)
        self.use_moe = use_moe
        if use_moe:
            self.moe = MoELayer(h, c.intermediate_size, c.num_experts,
                                k=c.top_k, **kw)
        else:
            self.fc1 = Linear(h, c.intermediate_size, **kw)
            self.fc2 = Linear(c.intermediate_size, h, **kw)
        self.drop = Dropout(c.dropout)

    def forward(self, x):
        b, l, h = x.shape
        heads = (b, l, self.num_heads, self.head_dim)
        q, k, v = self.qkv(self.ln_1(x)).split(h, dim=-1)
        attn = F.scaled_dot_product_attention(
            q.reshape(heads), k.reshape(heads), v.reshape(heads),
            is_causal=False)
        x = x + self.drop(self.proj(attn.reshape(b, l, h)))
        y = self.ln_2(x)
        if self.use_moe:
            return x + self.drop(self.moe(y))
        return x + self.drop(self.fc2(F.gelu(self.fc1(y))))


class ErnieMoEModel(nn.Module):
    def __init__(self, config: ErnieMoEConfig = ErnieMoEConfig(), *,
                 device=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.word_emb = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.pos_emb = Embedding(config.max_position_embeddings,
                                 config.hidden_size, **kw)
        self.blocks = nn.ModuleList([
            MoEBlock(config, use_moe=(i % config.moe_every
                                      == config.moe_every - 1),
                     device=device)
            for i in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, **kw)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_emb(input_ids) + self.pos_emb(pos)[None]
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    def aux_loss(self):
        """Sum of the MoE layers' load-balance losses of the last forward
        (None without MoE layers)."""
        total = None
        for blk in self.blocks:
            if blk.use_moe and blk.moe.aux_loss is not None:
                total = (blk.moe.aux_loss if total is None
                         else total + blk.moe.aux_loss)
        return total


class ErnieMoEForPretraining(nn.Module):
    """ERNIE-MoE with its LM head; ``device`` defaults to the framework's
    (``cuda``) and raises when CUDA is absent."""

    def __init__(self, config: ErnieMoEConfig = ErnieMoEConfig(), *,
                 device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.ernie = ErnieMoEModel(config, device=self.device)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias_attr=False, device=self.device,
                              dtype=config.dtype)

    def moe_layers(self):
        return [blk.moe for blk in self.ernie.blocks if blk.use_moe]

    def check_tensor_parallel(self, tp):
        """``fleet.distributed_model`` asks before it splits layers over
        tp > 1. Any degree runs: tp is expert parallel here (the banks
        of each ``MoELayer`` cut to the rank's experts, or kept whole with
        a warning when tp does not divide them), and the attention and
        dense FFN Linears carry no tp annotation, as in the JAX model, so
        every tp rank computes them whole."""

    def forward(self, input_ids, labels=None):
        """input_ids [B, L] -> logits [B, L, vocab]; with labels [B, L],
        the fp32 mean CE (labels -100 ignored) plus the weighted aux
        loss."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        logits = self.lm_head(self.ernie(ids))
        if labels is None:
            return logits
        labels = torch.as_tensor(labels, device=self.device).long()
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            labels.reshape(-1), ignore_index=-100)
        aux = self.ernie.aux_loss()
        if aux is not None:
            loss = loss + self.config.aux_loss_weight * aux
        return loss
