"""Llama-2 family. Counterpart of ``paddle_tpu/text/models/llama.py``.

Same configs, parameter names and layouts as the JAX package (``Linear``
weights ``[in, out]``; ``state_dict`` keys such as
``llama.layers.0.self_attn.q_proj.weight`` and ``lm_head.weight``), so a
JAX model's weights carry across with
``framework.io.load_numpy_state_dict``. Attention goes through
``F.scaled_dot_product_attention``, which takes the hand-written flash
kernel on eligible CUDA inputs.

``forward(input_ids, labels=None)`` follows the caller's grad mode:
scoring runs it under ``torch.inference_mode()`` (the serving engine
does), training runs it with gradients. With ``labels`` it returns the
next-token mean CE: dense (fp32 logits through ``F.cross_entropy``), or,
when ``fused_ce_chunk > 0`` and the head is not tied, through
``F.fused_linear_cross_entropy`` without the ``[N, vocab]`` logits. The
logits and the dense CE call the ``lm_head`` module (as the JAX
``_logits`` does), so a head swapped by ``nn.quant`` runs quantized; the
fused head and the serving engine read ``lm_head.weight``, as in the JAX
package.
``remat=True``/``"full"`` recomputes each decoder layer in the backward
(``torch.utils.checkpoint``); ``"selective"`` keeps the matmul outputs
and recomputes the rest, as the JAX package's
``dots_with_no_batch_dims_saveable`` policy.

The weights carry the JAX model's tensor-parallel annotations
(``param.pspec``): q/k/v, gate and up ``(None, "tp")``, o and down
``("tp", None)``, ``embed_tokens`` ``("tp", None)``, ``lm_head``
``(None, "tp")``. ``fleet.distributed_model`` at tp > 1 swaps those
layers for their ``mp_layers`` counterparts; attention then takes its
head counts from the local projection widths (``num_heads / tp``,
``num_key_value_heads / tp``), and the loss runs on the vocabulary
shard: the fused head through ``fused_ce_loss`` over the tp group, the
dense one through the vocab-parallel cross-entropy.

``sequence_parallel=True`` runs attention over sequence shards when the
caller declares that the inputs are this rank's shard
(``distributed.mesh.sequence_shard``, which the train step enters on a
mesh with sep > 1): ``sep_mode="ring"`` through
``ops.ring_attention.ring_attention_local``, ``"ulysses"`` through
``ops.ulysses_attention.ulysses_attention_local``, the rotary positions
starting at the shard's global offset. With labels the rank's loss is
its part of the global next-token mean: the last local position's target
is the next rank's first label (one ``ppermute``), the last rank's last
position has none, and the sum over the rank's targets is divided by
the count over every rank of the dp x sep group, so the sum of those
ranks' losses is the JAX model's mean. Outside a declared shard the
input is the whole sequence and attention is the usual one. A model
without ``sequence_parallel`` is refused on a mesh with sep > 1
(``check_sequence_parallel``).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.nn.functional as TF
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ...amp.auto_cast import amp_state, amp_state_guard
from ...distributed import collective as C
from ...distributed.mesh import current_sequence_shard, sep_guard
from ...framework.device import resolve_device
from ...nn import Embedding, Linear, RMSNorm
from ...nn import functional as F
from ...ops.ring_attention import ring_attention_local
from ...ops.ulysses_attention import ulysses_attention_local
from ...tensor_ops import matmul


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # False | True/"full" (recompute whole layers) | "selective" (keep
    # matmul outputs, recompute the rest)
    remat: object = False
    # attention over the mesh's "sep" shards of the sequence
    sequence_parallel: bool = False
    # "ring" (ppermute KV ring) or "ulysses" (all-to-all head re-shard;
    # needs heads % sep == 0)
    sep_mode: str = "ring"
    fused_ce_chunk: int = 0


LLAMA2_7B = LlamaConfig()
LLAMA2_13B = LlamaConfig(hidden_size=5120, intermediate_size=13824,
                         num_hidden_layers=40, num_attention_heads=40,
                         num_key_value_heads=40)
LLAMA_TINY = LlamaConfig(vocab_size=1024, hidden_size=256,
                         intermediate_size=688, num_hidden_layers=2,
                         num_attention_heads=8, num_key_value_heads=4,
                         max_position_embeddings=512)


_SEP_BODIES = {"ring": ring_attention_local,
               "ulysses": ulysses_attention_local}


def _check_config(c: LlamaConfig):
    if c.sequence_parallel and c.sep_mode not in _SEP_BODIES:
        raise ValueError(f"LlamaConfig.sep_mode={c.sep_mode!r}; want 'ring' "
                         "or 'ulysses'")
    if c.remat not in (False, True, "full", "selective"):
        raise ValueError(f"LlamaConfig.remat={c.remat!r}; want False, "
                         "True, 'full' or 'selective'")


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective remat: keep matmul outputs, recompute everything else
    (the JAX policy saves dots without batch dims, i.e. the projections'
    ``x @ W``, which reach the dispatcher as ``aten.mm``)."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(layer, x, mode, seq=None):
    """One decoder layer under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint`` per layer); ``seq`` (the sequence shard)
    and the amp policy of the forward reach the recompute too."""
    amp = amp_state()

    def body(y, seq):
        with amp_state_guard(amp):
            return layer(y, seq)

    if mode == "selective":
        return checkpoint(body, x, seq, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts,
                              _save_matmuls))
    return checkpoint(body, x, seq, use_reentrant=False)


def _rope(q, k, positions, theta, dtype):
    """Rotary embedding on q, k [B, L, H, D]: rotate in fp32, cast to
    ``dtype``."""
    d = q.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=q.device) / d))
    freqs = positions[:, None].float() * inv_freq[None, :]      # [L, D/2]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(dtype)

    return rot(q), rot(k)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        c = config
        self.num_heads = c.num_attention_heads
        self.num_kv_heads = c.num_key_value_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.theta = c.rope_theta
        self.sep_mode = c.sep_mode
        h = c.hidden_size
        kv = self.num_kv_heads * self.head_dim
        kw = dict(bias_attr=False, device=device, dtype=c.dtype)
        self.q_proj = Linear(h, h, **kw)
        self.k_proj = Linear(h, kv, **kw)
        self.v_proj = Linear(h, kv, **kw)
        self.o_proj = Linear(h, h, **kw)
        # Megatron tp: heads (the output dim) split on q/k/v, o's input
        for lin in (self.q_proj, self.k_proj, self.v_proj):
            lin.weight.pspec = (None, "tp")
        self.o_proj.weight.pspec = ("tp", None)

    def forward(self, x, seq=None):
        """``x`` is the whole sequence, or with ``seq`` (a
        ``SequenceShard``) this rank's shard of it."""
        # head counts from the (local) projection widths: all of them, or
        # num_heads / tp and num_kv_heads / tp under tensor parallel
        b, l, _ = x.shape
        hd = self.head_dim
        q = self.q_proj(x).reshape(b, l, -1, hd)
        k = self.k_proj(x).reshape(b, l, -1, hd)
        v = self.v_proj(x).reshape(b, l, -1, hd)
        off = 0 if seq is None else seq.index * l
        q, k = _rope(q, k, torch.arange(off, off + l, device=x.device),
                     self.theta, q.dtype)
        if seq is not None:
            out = _SEP_BODIES[self.sep_mode](q, k, v, seq.group, causal=True)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, l, -1))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        h, ff = config.hidden_size, config.intermediate_size
        kw = dict(bias_attr=False, device=device, dtype=config.dtype)
        self.gate_proj = Linear(h, ff, **kw)
        self.up_proj = Linear(h, ff, **kw)
        self.down_proj = Linear(ff, h, **kw)
        self.gate_proj.weight.pspec = (None, "tp")
        self.up_proj.weight.pspec = (None, "tp")
        self.down_proj.weight.pspec = ("tp", None)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=config.dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, device=device)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, device=device)

    def forward(self, x, seq=None):
        x = x + self.self_attn(self.input_layernorm(x), seq)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      **kw)
        self.embed_tokens.weight.pspec = ("tp", None)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, device=device)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def forward(self, input_ids, seq=None):
        x = self.embed_tokens(input_ids)
        remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = _remat_layer(layer, x, self.config.remat, seq) if remat \
                else layer(x, seq)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama with its LM head; ``device`` defaults to the framework's
    (``cuda``) and raises when CUDA is absent."""

    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        _check_config(config)
        self.config = config
        self.device = resolve_device(device)
        self.llama = LlamaModel(config, device=self.device)
        self.tie = config.tie_word_embeddings
        if not self.tie:
            # tied head reuses embed_tokens.weight [vocab, h] transposed
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, device=self.device,
                                  dtype=config.dtype)
            self.lm_head.weight.pspec = (None, "tp")

    def check_tensor_parallel(self, tp):
        """Raise ValueError unless ``tp`` splits the heads evenly (the KV
        heads included): ``fleet.distributed_model`` asks before it
        splits the layers."""
        c = self.config
        for what, n in (("num_attention_heads", c.num_attention_heads),
                        ("num_key_value_heads", c.num_key_value_heads)):
            if n % tp:
                raise ValueError(f"tensor-parallel degree {tp} does not "
                                 f"divide {what}={n}")

    def check_sequence_parallel(self, mesh):
        """Raise unless this model runs on ``mesh``'s sep shards:
        ``sequence_parallel`` set, no sharding or tp beside sep (the JAX
        guard), and for Ulysses heads that divide by the sep degree.
        ``fleet.distributed_model`` asks before it places the model."""
        from ...distributed.fleet.placement import no_sequence_parallel
        n = mesh.axis_size("sep")
        if not self.config.sequence_parallel:
            raise no_sequence_parallel(self, n)
        sep_guard(mesh)
        h = self.config.num_attention_heads
        if self.config.sep_mode == "ulysses" and h % n:
            raise ValueError(f"num heads {h} not divisible by axis size "
                             f"{n}")

    def _tp_group(self):
        """The tensor-parallel group the vocabulary is split over, or
        None (not split)."""
        mod = self.llama.embed_tokens if self.tie else self.lm_head
        g = getattr(mod, "mp_group", None)
        return g if g is not None and g.nranks > 1 else None

    def _local_logits(self, hidden, tp):
        """The logits of this rank's vocabulary shard."""
        from ...distributed.fleet.meta_parallel.mp_layers import copy_to_tp
        if self.tie:
            return matmul(copy_to_tp(hidden, tp),
                          self.llama.embed_tokens.weight, transpose_y=True)
        return self.lm_head(hidden)

    def head_weight(self):
        """The LM head as ``[h, vocab]`` (a view for the tied head)."""
        if self.tie:
            return self.llama.embed_tokens.weight.t()
        return self.lm_head.weight

    def _logits(self, hidden):
        """The head applied to ``hidden``: the tied embedding's transpose,
        or the ``lm_head`` module itself, so a head swapped by quantization
        (``Int8Linear``, QAT's ``QuantizedLinear``) takes part."""
        tp = self._tp_group()
        if tp is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import \
                gather_last_dim
            return gather_last_dim(self._local_logits(hidden, tp), tp)
        return matmul(hidden, self.head_weight()) if self.tie else \
            self.lm_head(hidden)

    def forward(self, input_ids, labels=None):
        """input_ids [B, L] -> logits [B, L, vocab] in the model dtype; with
        labels [B, L], the mean CE of the logits at t against the labels
        at t + 1 (fp32 scalar). Inside ``mesh.sequence_shard`` both are
        this rank's shard [B, L/n], and the loss is this rank's part of
        the global mean."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        seq = current_sequence_shard()
        if seq is not None:
            from ...distributed.fleet.placement import no_sequence_parallel
            if not self.config.sequence_parallel:
                raise no_sequence_parallel(self, seq.n)
        hidden = self.llama(ids, seq)
        if labels is None:
            return self._logits(hidden)
        labels = torch.as_tensor(labels, device=self.device).long()
        if seq is not None:
            return self._shard_loss(hidden, labels, seq)
        tp = self._tp_group()
        if self.config.fused_ce_chunk and not self.tie:
            # the [N, vocab] fp32 logits never materialize
            return F.fused_linear_cross_entropy(
                hidden[:, :-1], self.lm_head.weight, labels[:, 1:],
                chunk_size=self.config.fused_ce_chunk, tp_group=tp)
        if tp is not None:
            from ...distributed.fleet.meta_parallel.mp_layers import \
                vocab_parallel_cross_entropy
            logits = self._local_logits(hidden, tp)[:, :-1]
            lbl = labels[:, 1:].reshape(-1)
            loss = vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), lbl, tp)
            return loss.sum() / (lbl != -100).sum().float().clamp_min(1e-12)
        logits = self._logits(hidden)
        return F.cross_entropy(
            logits[:, :-1].reshape(-1, self.config.vocab_size).float(),
            labels[:, 1:].reshape(-1))

    def _shard_loss(self, hidden, labels, seq):
        """This rank's part of the global next-token mean over a sequence
        shard: the sum of its targets' CE over the count of the targets of
        every rank of ``seq.loss_group`` (dp x sep), whose parts sum to
        the mean. A rank's last position scores the next rank's first
        label; the last rank's last position scores nothing."""
        b, l = labels.shape
        nxt = C.ppermute(labels[:, :1], -1, seq.group)     # from rank i + 1
        if seq.index == seq.n - 1:
            hidden, target = hidden[:, :-1], labels[:, 1:]
        else:
            target = torch.cat([labels[:, 1:], nxt], dim=1)
        if self.config.fused_ce_chunk and not self.tie:
            # the fused head's mean over its rows, reweighted by the rows
            # of every rank (the JAX fused head counts every row)
            rows = seq.loss_group.nranks // seq.n * b * (seq.n * l - 1)
            return F.fused_linear_cross_entropy(
                hidden, self.lm_head.weight, target,
                chunk_size=self.config.fused_ce_chunk) * (
                    target.numel() / rows)
        logits = self._logits(hidden)
        loss = F.cross_entropy(
            logits.reshape(-1, self.config.vocab_size).float(),
            target.reshape(-1), reduction="sum")
        count = C.all_reduce((target != -100).sum().float(),
                             group=seq.loss_group)
        return loss / count.clamp_min(1e-12)

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 top_k=0, temperature=1.0, eos_token_id=None, seed=0,
                 num_beams=1, length_penalty=1.0, top_p=None,
                 pad_token_id=None, attention_mask=None):
        """Autoregressive decode with a preallocated KV cache
        (``text.generation.generate``): greedy, or sampled with top-k /
        top-p from ``seed``. ``num_beams > 1`` runs beam search
        (``text.generation.beam_search_generate``; the sampling and
        padding arguments are ignored there, as in JAX)."""
        if num_beams and num_beams > 1:
            from ..generation import beam_search_generate
            return beam_search_generate(
                self, input_ids, max_new_tokens=max_new_tokens,
                num_beams=num_beams, eos_token_id=eos_token_id,
                length_penalty=length_penalty)
        from ..generation import generate as _gen
        return _gen(self, input_ids, max_new_tokens=max_new_tokens,
                    do_sample=do_sample, top_k=top_k, top_p=top_p,
                    temperature=temperature, eos_token_id=eos_token_id,
                    seed=seed, pad_token_id=pad_token_id,
                    attention_mask=attention_mask)

    def init_cache(self, batch_size):
        """An empty KV cache per layer: ``(k, v)`` pairs of ``[batch_size,
        0, num_key_value_heads, head_dim]`` in the model's dtype, on its
        device."""
        c = self.config
        hd = c.hidden_size // c.num_attention_heads
        dt = self.llama.embed_tokens.weight.dtype
        return [tuple(torch.zeros((batch_size, 0, c.num_key_value_heads, hd),
                                  dtype=dt, device=self.device)
                      for _ in range(2))
                for _ in range(c.num_hidden_layers)]
