"""Per-layer Llama and GPT bodies, sampling filters and ``generate()``.

Counterpart of ``paddle_tpu/text/generation.py`` on one device: ``_rms``,
``_ln``, ``_rope_rows``, ``_nucleus_filter``, ``_filter_logits``,
``_prompt_mask``; the slot-layout bodies ``_llama_prefill_layer``,
``_llama_decode_layer``, ``_gpt_prefill_layer`` and ``_gpt_decode_layer``;
the paged bodies ``_paged_view``, ``_paged_decode_attention``,
``_llama_decode_layer_paged``, ``_gpt_decode_layer_paged``,
``_llama_chunk_layer`` and ``_gpt_chunk_layer``, and the speculative
verify layers ``_llama_verify_layer`` and ``_gpt_verify_layer`` (the chunk
layers under the verify name, as in JAX); batch ``generate()`` /
``gpt_generate()`` (``_generate`` stands for both ``_generate_jit`` and
``_gpt_generate_jit``) and ``beam_search_generate`` (``_beam_generate``
for ``_beam_generate_jit``). The serving engine and ``generate()`` run the
same bodies, as in the JAX package, through an arch object
(``arch_for``: ``_LlamaArch`` or ``_GPTArch``, the counterpart of the
JAX engine's ``_make_arch`` and of the ``arch`` branches of its
programs). The arithmetic mirrors the JAX bodies step for step,
including where bf16 rounds (RMSNorm and LayerNorm cast before the
weight multiply, rotary rotates in fp32, softmax probabilities are cast
to the model dtype before the PV product) and where masked scores are
set to ``-1e30``. Sampling draws its noise from ``ops.prng``, JAX's
threefry words bit for bit.

The bodies write K/V IN PLACE into the caches they are given (the JAX
bodies return updated caches). ``layer_weights`` and
``gpt_layer_weights`` take the place of ``_stacked_weights`` and
``_gpt_stacked_weights``: a list of per-layer dicts that reference the
module's parameters. Stacking would copy every weight (13.5 GB more at
7B), and a Python loop over layers needs no stacked operand.

Tensor parallelism (``Engine(tp=N)``): the placement rules
``_llama_tp_specs``, ``_gpt_tp_specs`` and ``_gpt_qkv_tp_permutation``
(defined beside the GPT model, whose training split uses it too) are
the JAX functions over plain tuples (per-layer specs: the JAX ones
without the stacked layer dim). Given a tp ``group``, the prefill, paged
decode and chunk bodies are JAX's ``_llama_prefill_layer_tp``,
``_llama_decode_layer_paged_tp``, ``_llama_chunk_layer_tp``,
``_gpt_prefill_layer_tp``, ``_gpt_decode_layer_paged_tp`` and
``_gpt_chunk_layer_tp``: the same arithmetic over this rank's shards
(``n_heads // tp`` query and ``n_kv // tp`` KV heads; GPT's fused qkv
permuted device-major), the o-/down-projections (GPT: proj, fc2)
row-parallel through ``distributed.collective_matmul``, their biases
added once, after the reduce. ``arch_for(model, group)`` holds the
rank's shards on its device, and its ``logits`` gathers the
vocab-sharded head (``matmul_allgather``). Without a group (or with one
of one rank) every body is the single-device one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ..distributed import mesh as _mesh
from ..distributed.collective_matmul import (matmul_allgather,
                                             ring_rowparallel_matmul)
from ..nn.functional.norm import layer_norm
from ..nn.layer.norm import rms_norm as _rms
from ..ops import flash_decode as _fd
from ..ops import prng as _prng
from .models.gpt import GPTForCausalLM, _gpt_qkv_tp_permutation
from .models.llama import LlamaForCausalLM, _rope

__all__ = ["arch_for", "layer_weights", "gpt_layer_weights", "generate",
           "gpt_generate", "beam_search_generate"]


def _check_unsplit(model):
    """A model whose parameters ``fleet.distributed_model`` split over
    ranks holds blocks, not weights: generation and serving raise
    (``Engine(model, tp=N)`` takes the whole model, as the JAX engine
    does, and places its own shards)."""
    if any(a is not None for p in model.parameters()
           for a in getattr(p, "placement", ())):
        raise NotImplementedError(
            "generation and serving take the whole model (Engine(model, "
            "tp=N) places its own shards); a model split over ranks by "
            "fleet.distributed_model (tp or sharding stage 3) is not "
            "served (ROADMAP.md, port queue item 4: multi-GPU)")


def layer_weights(model):
    """Per-layer weight views of a LlamaForCausalLM (no copies):
    ``{"layers": [{"wq", "wk", "wv", "wo", "wg", "wu", "wd", "ln1",
    "ln2"}, ...], "embed", "norm", "head"}``; ``head`` is ``[h, vocab]``.
    Raises on a model split over ranks."""
    _check_unsplit(model)
    layers = []
    for l in model.llama.layers:
        a, m = l.self_attn, l.mlp
        layers.append({
            "wq": a.q_proj.weight, "wk": a.k_proj.weight,
            "wv": a.v_proj.weight, "wo": a.o_proj.weight,
            "wg": m.gate_proj.weight, "wu": m.up_proj.weight,
            "wd": m.down_proj.weight,
            "ln1": l.input_layernorm.weight,
            "ln2": l.post_attention_layernorm.weight,
        })
    return {"layers": layers, "embed": model.llama.embed_tokens.weight,
            "norm": model.llama.norm.weight, "head": model.head_weight()}


# the per-layer keys of _GPT_STACK_KEYS, each a view of a block's parameter
_GPT_LAYER_PARAMS = {
    "wqkv": ("qkv", "weight"), "bqkv": ("qkv", "bias"),
    "wproj": ("proj", "weight"), "bproj": ("proj", "bias"),
    "ln1w": ("ln_1", "weight"), "ln1b": ("ln_1", "bias"),
    "ln2w": ("ln_2", "weight"), "ln2b": ("ln_2", "bias"),
    "wfc1": ("fc1", "weight"), "bfc1": ("fc1", "bias"),
    "wfc2": ("fc2", "weight"), "bfc2": ("fc2", "bias"),
}


def gpt_layer_weights(model):
    """Per-layer weight views of a GPTForCausalLM (no copies): ``{"layers":
    [{"wqkv", "bqkv", "wproj", "bproj", "ln1w", "ln1b", "ln2w", "ln2b",
    "wfc1", "bfc1", "wfc2", "bfc2"}, ...], "wte", "wpe", "lnfw", "lnfb",
    "head"}``; ``head`` is ``[h, vocab]``. Raises on a model split over
    ranks."""
    _check_unsplit(model)
    g = model.gpt
    layers = [{k: getattr(getattr(b, mod), attr)
               for k, (mod, attr) in _GPT_LAYER_PARAMS.items()}
              for b in g.blocks]
    return {"layers": layers, "wte": g.wte.weight, "wpe": g.wpe.weight,
            "lnfw": g.ln_f.weight, "lnfb": g.ln_f.bias,
            "head": model.lm_head.weight}


# ---------------------------------------------------------------------------
# tensor-parallel placement (the JAX specs, per layer, as plain tuples)
# ---------------------------------------------------------------------------

_TP_AXIS = "tp"


def _llama_tp_specs():
    """Spec per Llama weight key over the ``tp`` axis: column-parallel
    QKV/gate-up (output dim sharded), row-parallel o-/down-proj
    (contraction dim sharded), vocab-sharded head; norms and the
    embedding table replicated."""
    col, row = (None, _TP_AXIS), (_TP_AXIS, None)
    return {"wq": col, "wk": col, "wv": col, "wg": col, "wu": col,
            "wo": row, "wd": row, "ln1": (), "ln2": (),
            "embed": (), "norm": (), "head": (None, _TP_AXIS)}


def _gpt_tp_specs():
    """GPT weight placement: the fused qkv columns are taken in the
    device-major ``[q_d | k_d | v_d]`` order of
    :func:`_gpt_qkv_tp_permutation`, so a rank's block carries one head
    slice of each of q, k and v; the row-parallel proj/fc2 biases stay
    replicated (added once, after the reduce)."""
    col, row = (None, _TP_AXIS), (_TP_AXIS, None)
    return {"wqkv": col, "bqkv": (_TP_AXIS,),
            "wproj": row, "bproj": (),
            "wfc1": col, "bfc1": (_TP_AXIS,),
            "wfc2": row, "bfc2": (),
            "ln1w": (), "ln1b": (), "ln2w": (), "ln2b": (),
            "wte": (), "wpe": (), "lnfw": (), "lnfb": (),
            "head": (None, _TP_AXIS)}


def _rank_block(t, spec, mesh, device, perm=None):
    """This rank's block of weight ``t`` placed by ``spec``, copied to
    ``device`` (no copy where it is whole and already there). With
    ``perm``, ``t``'s last dim is read in that column order, and only the
    rank's own columns are gathered."""
    t = t.detach()
    if perm is not None:
        cols = _mesh.local_block(perm, spec[-1:], mesh)
        t = t[..., torch.from_numpy(cols).to(t.device)]
        spec = spec[:-1] + (None,)
    return _mesh.local_block(t, spec, mesh).to(device).contiguous()


def _shard_weights(w, specs, group, device, perms=None):
    """Every weight of ``w`` (the dict of ``layer_weights`` or
    ``gpt_layer_weights``) as this rank's block on ``device``: rank
    ``group.rank`` of a tp group of ``group.nranks`` takes block
    ``group.rank`` of each sharded dim. ``perms`` maps a key to its column
    order."""
    mesh = _mesh.Mesh(tp=group.nranks, rank=group.rank)
    perms = perms or {}

    def place(k, t):
        return _rank_block(t, specs[k], mesh, device, perms.get(k))

    return {"layers": [{k: place(k, t) for k, t in lw.items()}
                       for lw in w["layers"]],
            **{k: place(k, t) for k, t in w.items() if k != "layers"}}


def _rope_rows(q, k, pos, theta, dtype):
    """Rotary embedding for one-token-per-row decode: q, k [B, 1, H, D],
    pos [B] (each row at its own position)."""
    d = q.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=q.device) / d))
    freqs = pos[:, None].float() * inv_freq[None, :]           # [B, D/2]
    cos = torch.cos(freqs)[:, None, None, :]
    sin = torch.sin(freqs)[:, None, None, :]

    def rot(x):
        x1, x2 = x.float().chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(dtype)

    return rot(q), rot(k)


def _nucleus_filter(logits, top_p):
    """Top-p (nucleus) mask: keep the smallest set of tokens whose
    cumulative probability reaches ``top_p`` (ties broken by a stable
    descending sort; the arg-max is always kept, even for top_p=0)."""
    order = torch.argsort(-logits, dim=-1, stable=True)      # descending
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_excl < top_p
    keep_sorted[..., 0] = True                               # argmax stays
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(keep, logits, float("-inf"))


def _filter_logits(logits, temperature, do_sample, top_k, top_p):
    """Temperature / top-k / top-p filtering shared by ``generate()`` and
    the serving engine: fp32 logits [B, V] over a temperature floored at
    1e-6 (scalar or per-row [B]); with ``do_sample``, logits below the
    ``top_k``-th largest (ties kept) and outside the ``top_p`` nucleus
    become -inf."""
    t = torch.clamp(torch.as_tensor(temperature, dtype=torch.float32,
                                    device=logits.device), min=1e-6)
    if t.dim() == 1:
        t = t[:, None]
    logits = logits.float() / t
    if do_sample and top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if do_sample and top_p is not None and top_p < 1.0:
        logits = _nucleus_filter(logits, top_p)
    return logits


def _prompt_mask(ids, pad_token_id, attention_mask):
    """[B, L0] int32 prefix mask (1 = real token) for right-padded
    prompts. An explicit attention_mask wins; otherwise everything up to
    the last non-pad token is real (a pad_token_id inside the prompt is
    kept as a real token)."""
    if attention_mask is not None:
        return torch.as_tensor(attention_mask, device=ids.device).int()
    if pad_token_id is None:
        return torch.ones_like(ids, dtype=torch.int32)
    L0 = ids.shape[1]
    ar = torch.arange(1, L0 + 1, device=ids.device)
    plen = torch.where(ids != pad_token_id, ar[None, :], 0).amax(dim=1)
    return (ar[None, :] - 1 < plen[:, None]).int()


def _tp(group):
    """The tp degree of ``group`` (1 for None)."""
    return 1 if group is None else group.nranks


def _llama_mlp(x, lw, eps, group):
    """x plus the SwiGLU MLP of ``rms(x)``; the down-projection is
    row-parallel over ``group``."""
    h2 = _rms(x, lw["ln2"], eps)
    act = TF.silu(h2 @ lw["wg"]) * (h2 @ lw["wu"])
    return x + ring_rowparallel_matmul(act, lw["wd"], group)


def _llama_prefill_layer(x, lw, pos, *, n_heads, n_kv, eps, theta,
                         group=None):
    """One Llama decoder layer over a full [B, L] prompt (causal).
    Returns (x, (k, v)) with k/v [B, L, n_kv // tp, hd] for the KV cache.
    With a tp ``group`` (JAX's ``_llama_prefill_layer_tp``) ``lw`` holds
    this rank's shards and x stays replicated."""
    B, L, h = x.shape
    hd = h // n_heads
    hl, kvl = n_heads // _tp(group), n_kv // _tp(group)
    dt = x.dtype
    h1 = _rms(x, lw["ln1"], eps)
    q = (h1 @ lw["wq"]).reshape(B, L, hl, hd)
    k = (h1 @ lw["wk"]).reshape(B, L, kvl, hd)
    v = (h1 @ lw["wv"]).reshape(B, L, kvl, hd)
    q, k = _rope(q, k, pos, theta, dt)
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(n_heads // n_kv, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(n_heads // n_kv, dim=1)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    cm = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~cm, -1e30)
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p, vh)
    o = o.transpose(1, 2).reshape(B, L, hl * hd)
    x = x + ring_rowparallel_matmul(o, lw["wo"], group)
    return _llama_mlp(x, lw, eps, group), (k, v)


def _llama_decode_layer(xt, lw, kc_l, vc_l, write_idx, rope_pos, key_mask,
                        *, n_heads, n_kv, eps, theta):
    """One Llama decoder layer advancing every row one token against a
    slot-layout cache.

    xt [B, 1, h]; kc_l/vc_l [B, T, n_kv, hd] (written in place at row
    ``b``, line ``write_idx[b]``); rope_pos [B], each row's rotary
    position (it differs from write_idx only for right-padded prompts);
    key_mask [B, T] bool or None, attendable positions on top of the
    causal ``<= write_idx`` bound (False hides prompt padding lines)."""
    B, T = kc_l.shape[0], kc_l.shape[1]
    h = xt.shape[-1]
    hd = h // n_heads
    dt = xt.dtype
    h1 = _rms(xt, lw["ln1"], eps)
    q = (h1 @ lw["wq"]).reshape(B, 1, n_heads, hd)
    k = (h1 @ lw["wk"]).reshape(B, 1, n_kv, hd)
    v = (h1 @ lw["wv"]).reshape(B, 1, n_kv, hd)
    q, k = _rope_rows(q, k, rope_pos, theta, dt)
    rows = torch.arange(B, device=xt.device)
    kc_l[rows, write_idx] = k[:, 0]
    vc_l[rows, write_idx] = v[:, 0]
    kh = kc_l.repeat_interleave(n_heads // n_kv, dim=2)   # [B, T, H, hd]
    vh = vc_l.repeat_interleave(n_heads // n_kv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), kh.float()) \
        / math.sqrt(hd)
    valid = (torch.arange(T, device=xt.device)[None, :]
             <= write_idx[:, None])
    if key_mask is not None:
        valid = valid & key_mask
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.einsum("bht,bthd->bhd", p, vh).reshape(B, 1, h)
    return _llama_mlp(xt + o @ lw["wo"], lw, eps, None)


def _paged_view(pool_l, tables, block_size):
    """Each slot's contiguous K or V view gathered through its block-table
    row: pool_l [n_blocks, bs, kv, hd], tables [S, mb] -> [S, mb*bs, kv,
    hd] (view index == logical position; unused entries point at the
    trash block and sit past the causal bound)."""
    S, mb = tables.shape
    return pool_l[tables.long()].reshape(S, mb * block_size,
                                         pool_l.shape[-2], pool_l.shape[-1])


def _paged_decode_attention(q, kc_pool, vc_pool, tables, write_pos, flash,
                            dt):
    """One-token paged attention: q [S, H, hd] over the pool through block
    tables, attending view positions ``<= write_pos``. ``flash=True`` runs
    the hand-written flash-decode kernel (its plain version on a CPU
    tensor); False keeps the gathered form (``flash_decode_reference``:
    each slot's [T, kv, hd] view gathered through its table row, fp32
    scores). The kernel's output is token-identical through the engine,
    not bitwise (online-softmax reduction order)."""
    attend = _fd.flash_decode if flash else _fd.flash_decode_reference
    return attend(q, kc_pool, vc_pool, tables, write_pos).to(dt)


def _llama_decode_layer_paged(xt, lw, kc_pool, vc_pool, tables, dest,
                              write_pos, rope_pos, *, n_heads, n_kv, eps,
                              theta, flash_decode=False, group=None):
    """One Llama decoder layer advancing every slot one token against the
    paged pool. The new K/V is written IN PLACE into ``kc_pool``/``vc_pool``
    at flat pool index ``dest`` (the JAX body returns updated pools; here
    the engine's pool tensors are the state). Inactive rows' ``dest`` lies
    in the trash block; several of them may land on one line there, and
    which write wins is unspecified on CUDA -- harmless, because the trash
    block is never read below the causal bound. kc_pool/vc_pool
    [n_blocks, bs, n_kv // tp, hd] (one layer); tables [S, mb]; dest [S];
    write_pos/rope_pos [S]. With a tp ``group`` (JAX's
    ``_llama_decode_layer_paged_tp``; ``flash_decode`` is refused there)
    the pool holds this rank's kv-head slice."""
    S = xt.shape[0]
    h = xt.shape[-1]
    hd = h // n_heads
    hl, kvl = n_heads // _tp(group), n_kv // _tp(group)
    dt = xt.dtype
    h1 = _rms(xt, lw["ln1"], eps)
    q = (h1 @ lw["wq"]).reshape(S, 1, hl, hd)
    k = (h1 @ lw["wk"]).reshape(S, 1, kvl, hd)
    v = (h1 @ lw["wv"]).reshape(S, 1, kvl, hd)
    q, k = _rope_rows(q, k, rope_pos, theta, dt)
    nb, bs = kc_pool.shape[0], kc_pool.shape[1]
    kc_pool.view(nb * bs, kvl, hd)[dest] = k[:, 0]
    vc_pool.view(nb * bs, kvl, hd)[dest] = v[:, 0]
    o = _paged_decode_attention(q[:, 0], kc_pool, vc_pool, tables,
                                write_pos, flash_decode,
                                dt).reshape(S, 1, hl * hd)
    xt2 = xt + ring_rowparallel_matmul(o, lw["wo"], group)
    return _llama_mlp(xt2, lw, eps, group)


def _llama_chunk_layer(x, lw, kc_pool, vc_pool, table_row, gpos, wdest, *,
                       n_heads, n_kv, eps, theta, block_size, group=None):
    """One Llama layer over one block-aligned prefill CHUNK of one slot:
    x [1, C, h] at global positions ``gpos`` [C]. The chunk's K/V go IN
    PLACE to flat pool indices ``wdest`` [C] (shared-prefix and pad
    positions redirected into the trash block), then the chunk's rows
    attend over the slot's whole gathered view (earlier chunks and this
    one) under ``view_pos <= gpos``, masked scores at -1e30. With a tp
    ``group``, JAX's ``_llama_chunk_layer_tp``."""
    B, C, h = x.shape
    hd = h // n_heads
    hl, kvl = n_heads // _tp(group), n_kv // _tp(group)
    dt = x.dtype
    h1 = _rms(x, lw["ln1"], eps)
    q = (h1 @ lw["wq"]).reshape(B, C, hl, hd)
    k = (h1 @ lw["wk"]).reshape(B, C, kvl, hd)
    v = (h1 @ lw["wv"]).reshape(B, C, kvl, hd)
    q, k = _rope(q, k, gpos, theta, dt)
    nb, bs = kc_pool.shape[0], kc_pool.shape[1]
    kc_pool.view(nb * bs, kvl, hd)[wdest] = k[0]
    vc_pool.view(nb * bs, kvl, hd)[wdest] = v[0]
    kview = _paged_view(kc_pool, table_row[None], block_size)  # [1,T,kv,hd]
    vview = _paged_view(vc_pool, table_row[None], block_size)
    qh = q.transpose(1, 2)                                     # [1,H,C,hd]
    kh = kview.transpose(1, 2).repeat_interleave(n_heads // n_kv, dim=1)
    vh = vview.transpose(1, 2).repeat_interleave(n_heads // n_kv, dim=1)
    s = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    T = kview.shape[1]
    cm = torch.arange(T, device=x.device)[None, :] <= gpos[:, None]
    s = s.masked_fill(~cm[None, None], -1e30)
    p = torch.softmax(s, dim=-1).to(dt)
    o = torch.matmul(p, vh).transpose(1, 2).reshape(B, C, hl * hd)
    x = x + ring_rowparallel_matmul(o, lw["wo"], group)
    return _llama_mlp(x, lw, eps, group)


def _llama_verify_layer(x, lw, kc_pool, vc_pool, table_row, gpos, wdest, *,
                        n_heads, n_kv, eps, theta, block_size):
    """One Llama layer over a speculative VERIFY chunk: one slot's last
    emitted token and its k draft tokens at positions ``gpos`` [k+1],
    their K/V in place at ``wdest`` (positions past the draft's width
    redirected to the trash block), attending over the slot's gathered
    view under the causal bound. The chunk layer itself: a verify is a
    (k+1)-token chunk, so there is one body to keep equal to prefill."""
    return _llama_chunk_layer(x, lw, kc_pool, vc_pool, table_row, gpos,
                              wdest, n_heads=n_heads, n_kv=n_kv, eps=eps,
                              theta=theta, block_size=block_size)


# ---------------------------------------------------------------------------
# GPT (pre-LN, learned positions, one fused qkv projection)
# ---------------------------------------------------------------------------

def _ln(x, w, b, eps=1e-5):
    """LayerNorm as the JAX ``_ln``: fp32 mean and population variance,
    the normalized value cast to x's dtype, then times w, plus b."""
    return layer_norm(x, x.shape[-1], w, b, eps)


def _gpt_qkv(x, lw, n_heads, tp=1):
    """q, k, v [B, L, H // tp, hd] of one GPT block: the fused projection
    of ``ln_1(x)`` split into views (no copy). Under tp the rank's qkv
    block is ``[q_d | k_d | v_d]`` (``_gpt_qkv_tp_permutation``)."""
    B, L, h = x.shape
    qkv = _ln(x, lw["ln1w"], lw["ln1b"]) @ lw["wqkv"] + lw["bqkv"]
    return (t.reshape(B, L, n_heads // tp, h // n_heads)
            for t in qkv.split(h // tp, dim=-1))


def _gpt_tail(x, o, lw, group=None):
    """A GPT block after attention: the projected attention output o
    [B, L, h // tp] added to x, then the erf-GELU MLP of ``ln_2`` added;
    proj and fc2 are row-parallel over ``group``, their biases added once,
    after the reduce."""
    x = x + ring_rowparallel_matmul(o, lw["wproj"], group) + lw["bproj"]
    h2 = _ln(x, lw["ln2w"], lw["ln2b"])
    act = TF.gelu(h2 @ lw["wfc1"] + lw["bfc1"])
    return x + ring_rowparallel_matmul(act, lw["wfc2"], group) + lw["bfc2"]


def _gpt_prefill_layer(x, lw, *, n_heads, group=None):
    """One GPT block over a full [B, L] prompt (causal; positions enter at
    the wpe embedding). Returns (x, (k, v)), k/v [B, L, H // tp, hd].
    With a tp ``group``, JAX's ``_gpt_prefill_layer_tp``."""
    B, L, h = x.shape
    hd = h // n_heads
    q, k, v = _gpt_qkv(x, lw, n_heads, _tp(group))
    s = torch.matmul(q.transpose(1, 2).float(),
                     k.transpose(1, 2).float().transpose(-1, -2)) \
        / math.sqrt(hd)
    cm = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~cm, -1e30)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.matmul(p, v.transpose(1, 2)).transpose(1, 2).reshape(
        B, L, h // _tp(group))
    return _gpt_tail(x, o, lw, group), (k, v)


def _gpt_decode_layer(xt, lw, kc_l, vc_l, write_idx, key_mask, *, n_heads):
    """One GPT block advancing every row one token against a slot-layout
    cache (learned positions enter at the embedding, so only the cache
    line matters here). kc_l/vc_l [B, T, H, hd], written in place at row
    ``b``, line ``write_idx[b]``; key_mask as in the Llama decode layer."""
    B, T = kc_l.shape[0], kc_l.shape[1]
    h = xt.shape[-1]
    hd = h // n_heads
    q, k, v = _gpt_qkv(xt, lw, n_heads)
    rows = torch.arange(B, device=xt.device)
    kc_l[rows, write_idx] = k[:, 0]
    vc_l[rows, write_idx] = v[:, 0]
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), kc_l.float()) \
        / math.sqrt(hd)
    valid = (torch.arange(T, device=xt.device)[None, :]
             <= write_idx[:, None])
    if key_mask is not None:
        valid = valid & key_mask
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(xt.dtype)
    o = torch.einsum("bht,bthd->bhd", p, vc_l).reshape(B, 1, h)
    return _gpt_tail(xt, o, lw)


def _gpt_decode_layer_paged(xt, lw, kc_pool, vc_pool, tables, dest,
                            write_pos, *, n_heads, flash_decode=False,
                            group=None):
    """One GPT block advancing every slot one token against the paged pool:
    only the pool write (in place, at flat pool index ``dest``; inactive
    rows into the trash block) and the attention through the block tables
    differ from the slot body. ``flash_decode=True`` runs the flash-decode
    kernel (its plain version on a CPU tensor). With a tp ``group``, JAX's
    ``_gpt_decode_layer_paged_tp`` (the pool holds this rank's heads)."""
    S = xt.shape[0]
    h = xt.shape[-1]
    hd = h // n_heads
    hl = n_heads // _tp(group)
    q, k, v = _gpt_qkv(xt, lw, n_heads, _tp(group))
    nb, bs = kc_pool.shape[0], kc_pool.shape[1]
    kc_pool.view(nb * bs, hl, hd)[dest] = k[:, 0]
    vc_pool.view(nb * bs, hl, hd)[dest] = v[:, 0]
    o = _paged_decode_attention(q[:, 0], kc_pool, vc_pool, tables,
                                write_pos, flash_decode,
                                xt.dtype).reshape(S, 1, hl * hd)
    return _gpt_tail(xt, o, lw, group)


def _gpt_chunk_layer(x, lw, kc_pool, vc_pool, table_row, gpos, wdest, *,
                     n_heads, block_size, group=None):
    """One GPT block over one block-aligned prefill CHUNK of one slot (x
    [1, C, h] at global positions ``gpos``, which entered at the wpe
    embedding): K/V in place to ``wdest``, then the chunk's rows attend
    over the slot's gathered view under ``view_pos <= gpos``. With a tp
    ``group``, JAX's ``_gpt_chunk_layer_tp``."""
    B, C, h = x.shape
    hd = h // n_heads
    hl = n_heads // _tp(group)
    q, k, v = _gpt_qkv(x, lw, n_heads, _tp(group))
    nb, bs = kc_pool.shape[0], kc_pool.shape[1]
    kc_pool.view(nb * bs, hl, hd)[wdest] = k[0]
    vc_pool.view(nb * bs, hl, hd)[wdest] = v[0]
    kview = _paged_view(kc_pool, table_row[None], block_size)
    vview = _paged_view(vc_pool, table_row[None], block_size)
    s = torch.matmul(q.transpose(1, 2).float(),
                     kview.transpose(1, 2).float().transpose(-1, -2)) \
        / math.sqrt(hd)
    T = kview.shape[1]
    cm = torch.arange(T, device=x.device)[None, :] <= gpos[:, None]
    s = s.masked_fill(~cm[None, None], -1e30)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.matmul(p, vview.transpose(1, 2)).transpose(1, 2).reshape(
        B, C, hl * hd)
    return _gpt_tail(x, o, lw, group)


def _gpt_verify_layer(x, lw, kc_pool, vc_pool, table_row, gpos, wdest, *,
                      n_heads, block_size):
    """One GPT block over a speculative verify chunk (see
    ``_llama_verify_layer``): the chunk layer."""
    return _gpt_chunk_layer(x, lw, kc_pool, vc_pool, table_row, gpos, wdest,
                            n_heads=n_heads, block_size=block_size)


# ---------------------------------------------------------------------------
# the arch dispatch: generate() and the serving engine's programs
# ---------------------------------------------------------------------------

class _Arch:
    """What ``generate()`` and the engine's programs need of a model:
    its family (``name``, JAX's ``arch`` static), its per-layer weights (``layers``), head counts (the model's, not a
    rank's), FFN width, KV dtype, vocabulary, position table
    (``max_pos``, None where positions have no table), and how a token
    enters (``embed``), passes one layer in each KV layout (and a
    speculative verify chunk, ``verify_layer``), and leaves
    (``logits``).

    With a tp ``group`` of several ranks the arch holds this rank's
    shards of every weight on ``device`` (``_shard_weights``; the model
    itself may stay elsewhere), its paged and prefill layers are the tp
    bodies, and ``logits`` gathers the vocab-sharded head. It has no slot
    layout (the engine refuses ``kv_layout="slot"`` under tp)."""

    max_pos = None

    def __init__(self, w, n_heads, n_kv, head_dim, ffn, specs, group=None,
                 device=None, perms=None):
        self.vocab = int(w["head"].shape[-1])
        self.group = group if _tp(group) > 1 else None
        if self.group is not None:
            w = _shard_weights(w, specs, group, device, perms)
        self.w = w
        self.layers = w["layers"]
        self.n_heads, self.n_kv, self.head_dim = n_heads, n_kv, head_dim
        self.ffn = ffn


class _LlamaArch(_Arch):
    name = "llama"

    def __init__(self, model, group=None, device=None):
        c = model.config
        w = layer_weights(model)
        super().__init__(w, c.num_attention_heads, c.num_key_value_heads,
                         c.hidden_size // c.num_attention_heads,
                         c.intermediate_size, _llama_tp_specs(), group,
                         device)
        self.dtype = w["embed"].dtype
        self.eps = c.rms_norm_eps
        self.hp = dict(n_heads=self.n_heads, n_kv=self.n_kv, eps=self.eps,
                       theta=c.rope_theta)

    def embed(self, ids, pos):
        return self.w["embed"][ids]

    def logits(self, x):
        return matmul_allgather(_rms(x, self.w["norm"], self.eps),
                                self.w["head"], self.group)

    def prefill_layer(self, x, lw, pos):
        return _llama_prefill_layer(x, lw, pos, group=self.group, **self.hp)

    def decode_layer(self, xt, lw, kc, vc, write_idx, rope_pos, key_mask):
        return _llama_decode_layer(xt, lw, kc, vc, write_idx, rope_pos,
                                   key_mask, **self.hp)

    def paged_decode_layer(self, xt, lw, kc, vc, tables, dest, pos, flash):
        return _llama_decode_layer_paged(xt, lw, kc, vc, tables, dest, pos,
                                         pos, flash_decode=flash,
                                         group=self.group, **self.hp)

    def chunk_layer(self, x, lw, kc, vc, table_row, gpos, wdest,
                    block_size):
        return _llama_chunk_layer(x, lw, kc, vc, table_row, gpos, wdest,
                                  block_size=block_size, group=self.group,
                                  **self.hp)

    def verify_layer(self, x, lw, kc, vc, table_row, gpos, wdest,
                     block_size):
        return _llama_verify_layer(x, lw, kc, vc, table_row, gpos, wdest,
                                   block_size=block_size, **self.hp)


class _GPTArch(_Arch):
    name = "gpt"

    def __init__(self, model, group=None, device=None):
        c = model.config
        w = gpt_layer_weights(model)
        n_heads, h = c.num_attention_heads, c.hidden_size
        perms = None
        if _tp(group) > 1:
            # each rank takes its [q_d | k_d | v_d] columns of the fused qkv
            perm = _gpt_qkv_tp_permutation(h, group.nranks)
            perms = {"wqkv": perm, "bqkv": perm}
        super().__init__(w, n_heads, n_heads, h // n_heads,
                         int(w["layers"][0]["wfc1"].shape[-1]),
                         _gpt_tp_specs(), group, device, perms)
        self.dtype = w["wte"].dtype
        self.max_pos = c.max_position_embeddings

    def embed(self, ids, pos):
        # a last prefill chunk's pad rows may lie past the table: they read
        # its last row, as JAX's gather clamps, and write only to the trash
        # block
        pos = pos.clamp(max=self.max_pos - 1)
        return self.w["wte"][ids] + self.w["wpe"][pos]

    def logits(self, x):
        return matmul_allgather(_ln(x, self.w["lnfw"], self.w["lnfb"]),
                                self.w["head"], self.group)

    def prefill_layer(self, x, lw, pos):
        return _gpt_prefill_layer(x, lw, n_heads=self.n_heads,
                                  group=self.group)

    def decode_layer(self, xt, lw, kc, vc, write_idx, rope_pos, key_mask):
        return _gpt_decode_layer(xt, lw, kc, vc, write_idx, key_mask,
                                 n_heads=self.n_heads)

    def paged_decode_layer(self, xt, lw, kc, vc, tables, dest, pos, flash):
        return _gpt_decode_layer_paged(xt, lw, kc, vc, tables, dest, pos,
                                       n_heads=self.n_heads,
                                       flash_decode=flash, group=self.group)

    def chunk_layer(self, x, lw, kc, vc, table_row, gpos, wdest,
                    block_size):
        return _gpt_chunk_layer(x, lw, kc, vc, table_row, gpos, wdest,
                                n_heads=self.n_heads, block_size=block_size,
                                group=self.group)

    def verify_layer(self, x, lw, kc, vc, table_row, gpos, wdest,
                     block_size):
        return _gpt_verify_layer(x, lw, kc, vc, table_row, gpos, wdest,
                                 n_heads=self.n_heads, block_size=block_size)


def arch_for(model, group=None, device=None):
    """The arch object of a LlamaForCausalLM or GPTForCausalLM of this
    package (per-layer weight views, no copies); TypeError otherwise.
    With a tp ``group`` of several ranks, this rank's weight shards,
    copied to ``device`` (default: the model's), and the tp bodies."""
    for cls, arch in ((LlamaForCausalLM, _LlamaArch),
                      (GPTForCausalLM, _GPTArch)):
        if isinstance(model, cls):
            return arch(model, group,
                        model.device if device is None else device)
    raise TypeError(f"generation and serving take LlamaForCausalLM or "
                    f"GPTForCausalLM, got {type(model).__name__}")


# ---------------------------------------------------------------------------
# batch generate()
# ---------------------------------------------------------------------------

def _generate(arch, ids, prompt_len_mask, key, *, max_new, do_sample, top_k,
              eos_id, temperature, top_p=None, padded=False):
    """``_generate_jit``'s and ``_gpt_generate_jit``'s counterpart. ids
    [B, L0] (right-padded prompt), prompt_len_mask [B, L0] (1 = real
    token), key [2] on ids' device. With ``padded`` each row's positions
    (rotary, or GPT's wpe row) continue from its own prompt length and its
    pad lines are masked out of decode attention. Returns [B, L0 +
    max_new] int64."""
    B, L0 = ids.shape
    dev = ids.device
    T = L0 + max_new
    # prefill: the full causal pass over the (padded) prompt
    pos = torch.arange(L0, device=dev)
    x = arch.embed(ids, pos)
    kcache = [torch.zeros((B, T, arch.n_kv, arch.head_dim),
                          dtype=arch.dtype, device=dev) for _ in arch.layers]
    vcache = [torch.zeros_like(c) for c in kcache]
    for lw, kc, vc in zip(arch.layers, kcache, vcache):
        x, (k, v) = arch.prefill_layer(x, lw, pos)
        kc[:, :L0] = k
        vc[:, :L0] = v
    prompt_len = prompt_len_mask.sum(dim=1).long()
    logits0 = arch.logits(x[torch.arange(B, device=dev), prompt_len - 1])

    def sample(logits, sk):
        # one key draws over all B * V logits, as one
        # jax.random.categorical call does
        logits = _filter_logits(logits, temperature, do_sample, top_k, top_p)
        if not do_sample:
            return torch.argmax(logits, dim=-1)
        return _prng.categorical(sk, logits)

    key, sk = _prng.split(key)
    tok = sample(logits0, sk)
    out = [tok]
    done = (tok == eos_id) if eos_id is not None else None
    # pad lines of the prompt are never attended; generated lines (>= L0)
    # are gated by the causal <= write_idx bound alone
    key_mask = (torch.cat([prompt_len_mask.bool(),
                           torch.ones((B, max_new), dtype=torch.bool,
                                      device=dev)], dim=1)
                if padded else None)
    for i in range(1, max_new):
        write_idx = torch.full((B,), L0 + i - 1, dtype=torch.long,
                               device=dev)
        rope_pos = prompt_len + (i - 1) if padded else write_idx
        xt = arch.embed(tok, rope_pos)[:, None]
        for lw, kc, vc in zip(arch.layers, kcache, vcache):
            xt = arch.decode_layer(xt, lw, kc, vc, write_idx, rope_pos,
                                   key_mask)
        logits = arch.logits(xt[:, 0])
        key, sk = _prng.split(key)
        nxt = sample(logits, sk)
        if eos_id is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        out.append(nxt)
        tok = nxt
    return torch.cat([ids.long(), torch.stack(out, dim=1)], dim=1)


def generate(model, input_ids, max_new_tokens=32, do_sample=False, top_k=0,
             temperature=1.0, eos_token_id=None, seed=0, top_p=None,
             pad_token_id=None, attention_mask=None):
    """Greedy or sampled (top-k / top-p) generation for a
    ``LlamaForCausalLM`` or ``GPTForCausalLM`` of this package, on the
    model's device.

    input_ids [B, L0]. Right-padded prompts: pass ``pad_token_id`` (the
    mask follows from trailing pad tokens) and/or an explicit
    ``attention_mask`` [B, L0]; pad positions are excluded from attention
    and each row's generated tokens take positions continuing from its own
    prompt length. Without either, every token is real context. Sampling
    draws from ``PRNGKey(seed)``, split once per token, as the JAX package
    does. Returns int64 [B, L0 + max_new_tokens]. Raises ValueError for
    ``max_new_tokens < 1`` (the JAX package refuses it too: its first
    token has nowhere to go) and, for GPT, when a position would run past
    the wpe table (``L0 + max_new_tokens - 1 > max_position_embeddings``;
    the JAX package reads clamped or NaN-filled rows there)."""
    if int(max_new_tokens) < 1:
        raise ValueError(f"generate: max_new_tokens={max_new_tokens}; want "
                         "at least 1")
    arch = arch_for(model)
    dev = model.device
    ids = torch.as_tensor(input_ids, device=dev).long()
    if ids.dim() == 1:
        ids = ids[None]
    max_new = int(max_new_tokens)
    if arch.max_pos is not None and ids.shape[1] + max_new - 1 \
            > arch.max_pos:
        raise ValueError(f"generate: prompt ({ids.shape[1]}) + "
                         f"max_new_tokens ({max_new}) runs past the position "
                         f"table ({arch.max_pos} positions)")
    mask = _prompt_mask(ids, pad_token_id, attention_mask)
    padded = pad_token_id is not None or attention_mask is not None
    with torch.inference_mode():
        return _generate(
            arch, ids, mask, _prng.prng_key(seed, dev), max_new=max_new,
            do_sample=bool(do_sample), top_k=int(top_k), eos_id=eos_token_id,
            temperature=torch.tensor(float(temperature), device=dev),
            top_p=None if top_p is None else float(top_p), padded=padded)


#: ``paddle_tpu``'s name for GPT generation; ``generate`` takes both archs
gpt_generate = generate


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def _top_k_first_index(x, k):
    """``jax.lax.top_k`` over the last axis: the k largest values, equal
    values in index order (a stable descending sort; ``torch.topk`` leaves
    the order of ties open). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _beam_generate(arch, ids, *, max_new, num_beams, eos_id, length_penalty):
    """``_beam_generate_jit``'s counterpart: the prompt prefilled once per
    row, its K/V tiled to ``num_beams`` beams folded into the batch dim of
    the slot caches; each step extends every beam by the top
    ``num_beams`` of all (beam, token) continuations of the summed fp32
    log-probs, and the caches, tokens and eos flags follow their beams. A
    beam that emitted eos extends only with eos, at an unchanged score.
    The best beam of each row by ``score / length ** length_penalty``
    (length: through the first eos). ids [B, L0]; returns int64 [B, L0 +
    max_new]."""
    B, L0 = ids.shape
    K = num_beams
    dev = ids.device
    T = L0 + max_new
    neg = -1e9
    pos = torch.arange(L0, device=dev)
    x = arch.embed(ids, pos)
    kcache, vcache = [], []
    for lw in arch.layers:
        x, (k, v) = arch.prefill_layer(x, lw, pos)
        kc = torch.zeros((B * K, T, arch.n_kv, arch.head_dim),
                         dtype=arch.dtype, device=dev)
        vc = torch.zeros_like(kc)
        kc[:, :L0] = k.repeat_interleave(K, dim=0)
        vc[:, :L0] = v.repeat_interleave(K, dim=0)
        kcache.append(kc)
        vcache.append(vc)
    logp0 = torch.log_softmax(arch.logits(x[:, -1]).float(), dim=-1)  # [B,V]
    V = logp0.shape[-1]
    scores, tok0 = _top_k_first_index(logp0, K)                  # [B, K]
    toks = torch.zeros((B, K, max_new), dtype=torch.long, device=dev)
    toks[..., 0] = tok0
    done = (tok0 == eos_id) if eos_id is not None else torch.zeros(
        (B, K), dtype=torch.bool, device=dev)
    if eos_id is not None:
        frozen = torch.full((V,), neg, dtype=torch.float32, device=dev)
        frozen[eos_id] = 0.0
    rows = torch.arange(B, device=dev)[:, None] * K
    for i in range(1, max_new):
        write_idx = torch.full((B * K,), L0 + i - 1, dtype=torch.long,
                               device=dev)
        xt = arch.embed(toks[..., i - 1].reshape(B * K), write_idx)[:, None]
        for lw, kc, vc in zip(arch.layers, kcache, vcache):
            xt = arch.decode_layer(xt, lw, kc, vc, write_idx, write_idx,
                                   None)
        logp = torch.log_softmax(arch.logits(xt[:, 0]).float(),
                                 dim=-1).reshape(B, K, V)
        if eos_id is not None:
            logp = torch.where(done[..., None], frozen, logp)
        total = (scores[..., None] + logp).reshape(B, K * V)
        scores, idx = _top_k_first_index(total, K)
        beam = idx // V
        gidx = (rows + beam).reshape(B * K)
        kcache = [kc.index_select(0, gidx) for kc in kcache]
        vcache = [vc.index_select(0, gidx) for vc in vcache]
        toks = torch.gather(toks, 1, beam[..., None].expand(B, K, max_new))
        done = torch.gather(done, 1, beam)
        new_tok = idx % V
        toks[..., i] = new_tok
        if eos_id is not None:
            done = done | (new_tok == eos_id)
    if eos_id is not None:
        hit = torch.cat([toks == eos_id,
                         torch.ones((B, K, 1), dtype=torch.bool,
                                    device=dev)], dim=2)
        lengths = torch.argmax(hit.int(), dim=2) + 1
    else:
        lengths = torch.full((B, K), max_new, device=dev)
    ranked = scores / lengths.float() ** torch.tensor(
        float(length_penalty), dtype=torch.float32, device=dev)
    best = torch.argmax(ranked, dim=1)
    return torch.cat([ids.long(), toks[torch.arange(B, device=dev), best]],
                     dim=1)


def beam_search_generate(model, input_ids, max_new_tokens=32, num_beams=4,
                         eos_token_id=None, length_penalty=1.0):
    """Beam search for a ``LlamaForCausalLM`` of this package (the
    HF/PaddleNLP beam semantics of the JAX package's
    ``beam_search_generate``: length-penalised summed log-probs, finished
    beams frozen at eos), on the model's device. input_ids [B, L0], every
    token real context. Returns int64 [B, L0 + max_new_tokens]."""
    if int(max_new_tokens) < 1:
        raise ValueError(f"beam_search_generate: max_new_tokens="
                         f"{max_new_tokens}; want at least 1")
    arch = arch_for(model)
    ids = torch.as_tensor(input_ids, device=model.device).long()
    if ids.dim() == 1:
        ids = ids[None]
    with torch.inference_mode():
        return _beam_generate(arch, ids, max_new=int(max_new_tokens),
                              num_beams=int(num_beams), eos_id=eos_token_id,
                              length_penalty=float(length_penalty))
