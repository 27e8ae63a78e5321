"""T5 encoder-decoder. Counterpart of ``paddle_tpu/text/models/t5.py``.

The same config, parameter names and layouts as the JAX package
(``t5.shared``, ``t5.encoder.blocks.<i>.{ln1,self_attn,ln2,ff}``, the
decoder's ``ln_cross`` / ``cross_attn``, ``final_layer_norm``, and
``lm_head`` when the embeddings are untied), so a JAX model's weights
carry across with ``framework.io.load_numpy_state_dict``. The arithmetic
is JAX's:

- ``T5LayerNorm`` is a scale-only RMS norm: the rms in fp32, the result
  cast back to the input dtype, then multiplied by the weight;
- attention has no ``1 / sqrt(d)`` scale; the scores are fp32 (the
  products of q and k in fp32), the relative bias is added in fp32, the
  decoder's causal mask is ``tril(k = Lk - Lq)`` at -1e30, and the
  probabilities are cast to q's dtype before the product with v. This
  body is plain PyTorch, as it is an einsum outside any Pallas kernel in
  JAX;
- only ``blocks[0]`` of a stack owns a ``relative_attention_bias``; its
  table is shared by every block of the stack (bidirectional in the
  encoder, one-directional in the decoder; cross attention has none);
- the bucket of each (query, key) pair is computed once per
  ``(qlen, klen, direction)`` on the CPU in float32 (``_rel_bucket``,
  ``log`` of ``n / max_exact + 1e-9`` and a truncating cast) and moved to
  the device: at n = 16, 32, 64 the formula lands exactly on an integer,
  where a device ``log`` one ulp low would change the bucket;
- the tied head scales the decoder output by ``d_model ** -0.5`` and
  multiplies by ``shared.weight`` transposed (``tensor_ops.matmul``, an
  amp cast site); the labels' decoder input is ``_shift_right``: rolled
  right, ``decoder_start_token_id`` first, -100 read as ``pad_token_id``.

``generate`` is JAX's greedy decode: the decoder re-runs on a padded
``[B, M + 1]`` buffer each step and position t's argmax fills t + 1;
rows that emitted ``eos_token_id`` keep emitting it. The encoder runs
once (its output does not change between steps). ``T5Config.dtype``
("float32" or "bfloat16") is the dtype the parameters are made in;
``device`` defaults to the framework's (``cuda``).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import Embedding, Linear
from ...nn import functional as F
from ...nn.initializer import Constant
from ...nn.param_attr import _param
from ...nn.layer.norm import rms_norm
from ...tensor_ops import matmul

__all__ = ["T5Config", "T5_TINY", "T5LayerNorm", "T5Attention", "T5FF",
           "T5Block", "T5Stack", "T5Model", "T5ForConditionalGeneration"]


@dataclass
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"  # or "gated-gelu"
    tie_word_embeddings: bool = True
    pad_token_id: int = 0
    decoder_start_token_id: int = 0
    dtype: str = "float32"


T5_TINY = T5Config(vocab_size=256, d_model=64, d_kv=16, d_ff=128,
                   num_layers=2, num_decoder_layers=2, num_heads=4)


class T5LayerNorm(nn.Module):
    """Scale-only RMS norm (no mean subtraction, no bias)."""

    def __init__(self, d, eps=1e-6, *, device=None, dtype="float32"):
        super().__init__()
        self.weight = _param((d,), Constant(1.0), device, dtype)
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _rel_bucket(rel_pos, bidirectional, num_buckets, max_distance):
    """HF-compatible relative position bucketing (T5 paper), in float32
    on the tensor's device (the CPU for ``_bucket_table``)."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # true float32 divisions, as XLA's (a tensor divided by a Python
    # number may be multiplied by its reciprocal instead)
    f32 = dict(dtype=torch.float32, device=n.device)
    val_large = max_exact + (
        torch.log(n.float() / torch.tensor(max_exact, **f32) + 1e-9)
        / torch.tensor(math.log(max_distance / max_exact), **f32)
        * (num_buckets - max_exact)).to(ret.dtype)
    val_large = val_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=64)
def _bucket_table(qlen, klen, bidirectional, num_buckets, max_distance,
                  device):
    """The ``[qlen, klen]`` bucket of each (query, key) pair, computed once
    on the CPU and kept on ``device`` (the last 64 kept)."""
    ctx = torch.arange(qlen, dtype=torch.int32)[:, None]
    mem = torch.arange(klen, dtype=torch.int32)[None, :]
    return _rel_bucket(mem - ctx, bidirectional, num_buckets,
                       max_distance).long().to(device)


class T5Attention(nn.Module):
    def __init__(self, c: T5Config, has_rel_bias=False, bidirectional=True,
                 *, device=None):
        super().__init__()
        kw = dict(bias_attr=False, device=device, dtype=c.dtype)
        inner = c.num_heads * c.d_kv
        self.q = Linear(c.d_model, inner, **kw)
        self.k = Linear(c.d_model, inner, **kw)
        self.v = Linear(c.d_model, inner, **kw)
        self.o = Linear(inner, c.d_model, **kw)
        self.n_heads = c.num_heads
        self.d_kv = c.d_kv
        self.has_rel_bias = has_rel_bias
        self.bidirectional = bidirectional
        self.num_buckets = c.relative_attention_num_buckets
        self.max_distance = c.relative_attention_max_distance
        if has_rel_bias:
            self.relative_attention_bias = Embedding(
                self.num_buckets, c.num_heads, device=device, dtype=c.dtype)

    def _bias(self, qlen, klen):
        """The relative bias ``[1, H, qlen, klen]`` in the table's dtype."""
        table = self.relative_attention_bias.weight
        buckets = _bucket_table(qlen, klen, self.bidirectional,
                                self.num_buckets, self.max_distance,
                                table.device)
        return table[buckets].permute(2, 0, 1)[None]

    def forward(self, x, kv=None, bias=None, causal=False):
        b, ql, _ = x.shape
        kv = x if kv is None else kv
        kl = kv.shape[1]
        qh = self.q(x).reshape(b, ql, self.n_heads, self.d_kv).transpose(1, 2)
        kh = self.k(kv).reshape(b, kl, self.n_heads, self.d_kv).transpose(1, 2)
        vh = self.v(kv).reshape(b, kl, self.n_heads, self.d_kv).transpose(1, 2)
        # T5: NO 1/sqrt(d) scaling
        s = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
        if bias is not None:
            s = s + bias.float()
        if causal:
            cm = torch.ones(ql, kl, dtype=torch.bool,
                            device=s.device).tril(diagonal=kl - ql)
            s = s.masked_fill(~cm, -1e30)
        p = torch.softmax(s, dim=-1).to(qh.dtype)
        o = torch.matmul(p, vh)
        return self.o(o.transpose(1, 2).reshape(b, ql, -1))


class T5FF(nn.Module):
    def __init__(self, c: T5Config, *, device=None):
        super().__init__()
        kw = dict(bias_attr=False, device=device, dtype=c.dtype)
        self.gated = c.feed_forward_proj.startswith("gated")
        if self.gated:
            self.wi_0 = Linear(c.d_model, c.d_ff, **kw)
            self.wi_1 = Linear(c.d_model, c.d_ff, **kw)
        else:
            self.wi = Linear(c.d_model, c.d_ff, **kw)
        self.wo = Linear(c.d_ff, c.d_model, **kw)

    def forward(self, x):
        if self.gated:
            return self.wo(F.gelu(self.wi_0(x)) * self.wi_1(x))
        return self.wo(F.relu(self.wi(x)))


class T5Block(nn.Module):
    def __init__(self, c: T5Config, is_decoder, has_rel_bias, *,
                 device=None):
        super().__init__()
        kw = dict(device=device)
        norm = dict(eps=c.layer_norm_epsilon, device=device, dtype=c.dtype)
        self.is_decoder = is_decoder
        self.ln1 = T5LayerNorm(c.d_model, **norm)
        self.self_attn = T5Attention(c, has_rel_bias,
                                     bidirectional=not is_decoder, **kw)
        if is_decoder:
            self.ln_cross = T5LayerNorm(c.d_model, **norm)
            self.cross_attn = T5Attention(c, False, **kw)
        self.ln2 = T5LayerNorm(c.d_model, **norm)
        self.ff = T5FF(c, **kw)

    def forward(self, x, enc=None, self_bias=None):
        x = x + self.self_attn(self.ln1(x), bias=self_bias,
                               causal=self.is_decoder)
        if self.is_decoder and enc is not None:
            x = x + self.cross_attn(self.ln_cross(x), kv=enc)
        return x + self.ff(self.ln2(x))


class T5Stack(nn.Module):
    def __init__(self, c: T5Config, is_decoder, n_layers, *, device=None):
        super().__init__()
        self.is_decoder = is_decoder
        self.blocks = nn.ModuleList([
            T5Block(c, is_decoder, has_rel_bias=(i == 0), device=device)
            for i in range(n_layers)])
        self.final_layer_norm = T5LayerNorm(
            c.d_model, c.layer_norm_epsilon, device=device, dtype=c.dtype)

    def forward(self, x, enc=None):
        qlen = x.shape[1]
        bias = self.blocks[0].self_attn._bias(qlen, qlen)
        for blk in self.blocks:
            x = blk(x, enc=enc, self_bias=bias)
        return self.final_layer_norm(x)


class T5Model(nn.Module):
    def __init__(self, config: T5Config = T5Config(), *, device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        kw = dict(device=self.device)
        self.shared = Embedding(config.vocab_size, config.d_model,
                                dtype=config.dtype, **kw)
        self.encoder = T5Stack(config, False, config.num_layers, **kw)
        self.decoder = T5Stack(config, True, config.num_decoder_layers, **kw)

    def forward(self, input_ids, decoder_input_ids):
        enc = self.encoder(self.shared(input_ids))
        dec = self.decoder(self.shared(decoder_input_ids), enc=enc)
        return dec, enc


class T5ForConditionalGeneration(nn.Module):
    """T5 with its LM head: logits ``[B, Ld, V]`` in the model dtype, or
    with ``labels`` the fp32 CE (``ignore_index=-100``)."""

    def __init__(self, config: T5Config = T5Config(), *, device=None):
        super().__init__()
        self.config = config
        self.t5 = T5Model(config, device=device)
        self.device = self.t5.device
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.d_model, config.vocab_size,
                                  bias_attr=False, device=self.device,
                                  dtype=config.dtype)

    def _ids(self, x):
        return torch.as_tensor(x, device=self.device).long()

    def _shift_right(self, labels):
        c = self.config
        shifted = torch.roll(labels, 1, dims=-1)
        shifted[:, 0] = c.decoder_start_token_id
        return torch.where(shifted == -100, c.pad_token_id, shifted)

    def _logits(self, dec):
        c = self.config
        if c.tie_word_embeddings:
            dec = dec * (c.d_model ** -0.5)
            return matmul(dec, self.t5.shared.weight, transpose_y=True)
        return self.lm_head(dec)

    def forward(self, input_ids, decoder_input_ids=None, labels=None):
        c = self.config
        if labels is not None:
            labels = self._ids(labels)
        if decoder_input_ids is None:
            if labels is None:
                raise ValueError("need decoder_input_ids or labels")
            decoder_input_ids = self._shift_right(labels)
        dec, _ = self.t5(self._ids(input_ids), self._ids(decoder_input_ids))
        logits = self._logits(dec)
        if labels is not None:
            return F.cross_entropy(logits.reshape(-1, c.vocab_size).float(),
                                   labels.reshape(-1), ignore_index=-100)
        return logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, eos_token_id=1,
                 name=None):
        """Greedy seq2seq decode: ``[B, max_new_tokens + 1]`` int64 ids,
        the start token first."""
        c = self.config
        ids = self._ids(input_ids)
        m = int(max_new_tokens)
        b = ids.shape[0]
        dec = torch.full((b, m + 1), c.pad_token_id, dtype=torch.long,
                         device=self.device)
        dec[:, 0] = c.decoder_start_token_id
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        enc = self.t5.encoder(self.t5.shared(ids))
        for t in range(m):
            out = self.t5.decoder(self.t5.shared(dec), enc=enc)
            tok = self._logits(out).float().argmax(dim=-1)[:, t]
            if eos_token_id is not None:
                tok = torch.where(done, eos_token_id, tok)
                done = done | (tok == eos_token_id)
            dec[:, t + 1] = tok
        return dec
