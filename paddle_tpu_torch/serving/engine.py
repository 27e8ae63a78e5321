"""Iteration-level (continuous) batching engine for Llama and GPT.

Counterpart of ``paddle_tpu/serving/engine.py``:

- ``submit()`` enqueues a request; admission prefills it straight into
  its KV storage, the prompt right-padded to the next power-of-two bucket
  (the JAX package's padding, so the prefill math matches it row for
  row). The default ``kv_layout="paged"`` draws fixed-size blocks from a
  shared pool through host-side block tables; common prompt prefixes are
  shared through a refcounted radix index (copy-on-write on the partial
  tail block), prompts longer than ``prefill_chunk`` prefill in
  block-aligned chunks co-scheduled with decode (one chunk per step, the
  fully shared leading chunks skipped), and pool exhaustion preempts the
  least important request, which later replays prompt + emitted tokens
  token-identically. ``kv_layout="slot"`` keeps one ``max_len`` slab row
  per slot.
- ``step()`` runs one chunk of the oldest chunked prefill, then advances
  every decode-active slot one token with one fused decode step over
  ``[n_slots, ...]``; requests join and leave between steps, and a slot
  part-way through its chunks sits inactive in the decode batch.
  ``flash_decode=True`` (paged only) runs decode attention through the
  hand-written flash-decode kernel (its plain version on the CPU);
  ``False`` keeps the gathered plain attention. Both are token-identical.
- Sampling (``do_sample=True`` with ``top_k``/``top_p``, engine-wide;
  temperature and ``seed`` per request): each request owns a threefry key
  chain (``ops.prng``, JAX's words bit for bit) seeded at admission and
  split once per decode step, so its tokens depend on (prompt, seed,
  arguments) only, never on its neighbours, and equal batch
  ``generate(seed=...)``'s for one request. A replay fast-forwards the
  chain past the tokens it already emitted. Greedy engines never touch
  the keys.
- The ``_*_impl`` functions are plain torch functions over
  ``text/generation.py``'s per-layer bodies, reached through the model's
  arch object (``generation.arch_for``, the counterpart of JAX's
  ``_make_arch`` and of its programs' ``arch`` branches: GPT's learned
  positions enter at the embedding, its KV heads are its query heads,
  and ``max_len`` may not run past its position table), run under
  ``torch.inference_mode()``. They update the KV storage and the keys IN
  PLACE (the JAX programs donated and returned them).
- ``tp=N`` (paged layout) serves one model over the N ranks of a mesh's
  ``tp`` axis, one process per GPU: each rank holds its shards of the
  weights (the JAX placement: column-parallel q/k/v and gate/up,
  row-parallel o/down, the vocab-sharded head; GPT's fused qkv
  device-major) and ``n_kv // N`` heads of the KV pool, and the same
  three programs run through a tp arch object, whose bodies reduce the
  row-parallel projections and gather the logits over the tp group
  (``distributed.collective_matmul``): 2 x layers + 1 collectives a
  decode step. The JAX engine's three ``shard_map`` programs have no twin
  here: SPMD processes need none.
- ``speculative=SpecConfig(...)`` (paged, one rank) is draft-verify
  decoding (``serving/speculative.py``: n-gram, custom or model drafts):
  each step the slots with a proposal verify it in one chunk-shaped pass
  (``_spec_verify_impl``), the others take the plain decode step (the
  flash-decode kernel under ``flash_decode=True``); the emitted tokens
  are the non-speculative engine's, greedy and sampled.

Host bookkeeping (scheduler, block tables, radix, positions) is numpy.
The keys ``[n_slots, 2]``, temperatures and vocab masks live on the
device. Each decode step sends its small int32 state to the device in one
copy and reads the sampled tokens back once: that read is the step's only
device synchronisation, with or without sampling.

- ``adopt(handle)`` re-injects a handle from another engine over the
  same model (``serving.resilience.EngineSupervisor``'s rebuild and
  ``serving.fleet.ReplicaFleet``'s migration): admission re-prefills
  ``prompt + emitted`` and fast-forwards the key chain past the emitted
  tokens (the prefill's ``skip``), so the request continues
  token-identically, greedy or sampled, speculative or not. A handle from
  an engine with another ``model_fingerprint`` raises ``AdoptMismatch``.
  ``shed_queued`` evicts the lowest queued priority class under brownout
  (``RequestShed`` with a finite ``retry_after_s``). An engine the
  supervisor replaced is condemned: its ``step()`` does nothing and a
  late emission of a wedged step's thread is dropped.

Not in this slice (each raises ``NotImplementedError`` naming its
``ROADMAP.md`` item): ``adopt`` under ``tp > 1`` (serving robustness) and
AOT program handles (runtime services). Tracing spans are not emitted;
handles carry a trace id all the same. A seed is taken modulo 2^32 (the
JAX engine's ``np.uint32(seed)`` refuses one outside ``[0, 2^32)``).
"""
from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from ..distributed import collective as _C
from ..distributed import mesh as _mesh
from ..framework.device import resolve_device
from ..framework.trace_id import new_trace_id
from ..ops import flash_decode as _fd
from ..ops import prng as _prng
from ..text import generation as G
from .kv_cache import PagedKVCache, SlotKVCache
from .metrics import EngineMetrics, RequestMetrics
from .scheduler import EngineOverloaded, PriorityScheduler
from .speculative import SpecConfig, make_runtime

__all__ = ["Engine", "RequestHandle", "EngineOverloaded", "RequestTimeout",
           "RequestShed", "RequestCancelled", "AdoptMismatch",
           "DEFAULT_RETRY_AFTER_S"]

#: Conservative retry-after hint (seconds) when the engine has no basis
#: for a live estimate (no decode history yet, or nothing active).
DEFAULT_RETRY_AFTER_S = 1.0


class RequestTimeout(TimeoutError):
    """A request exceeded its ``max_time_s`` deadline: its KV blocks were
    reclaimed and ``result()`` raises this. Tokens generated before the
    deadline remain on ``handle.tokens``. ``replica`` names the fleet
    replica that held the request (None outside a ReplicaFleet)."""

    def __init__(self, message, replica=None):
        super().__init__(message)
        self.replica = replica


class RequestShed(RuntimeError):
    """The request was evicted from the queue by overload brownout
    (``serving.resilience.EngineSupervisor`` past its ITL SLO): retry after
    ``retry_after_s`` seconds. ``replica`` names the fleet replica that
    shed it (None outside a ReplicaFleet)."""

    def __init__(self, message, retry_after_s=None, replica=None):
        super().__init__(message)
        self.retry_after_s = retry_after_s
        self.replica = replica


class RequestCancelled(RuntimeError):
    """The request was cancelled before finishing; tokens generated before
    cancellation stay on ``handle.tokens``."""


class AdoptMismatch(RuntimeError):
    """``Engine.adopt()`` refused a handle whose origin engine served
    another model, config or sampling mode (another ``model_fingerprint``):
    replaying its tokens here would silently diverge. The tp degree, KV
    layout and geometry and the speculative config may differ: adopt
    replays from tokens, not KV bytes."""


def _not_in_slice(what, item):
    return NotImplementedError(
        f"{what} is not in this slice of the PyTorch port (ROADMAP.md, "
        f"port queue: {item})")


def _model_fingerprint(model, arch, statics, eos_token_id):
    """A cheap, deterministic identity of the token math an engine runs:
    the model's class and config, the arch, the engine-wide sampling mode,
    the eos token and the weights' names, shapes and dtypes. Engines with
    equal fingerprints emit the same tokens for the same (prompt, seed,
    arguments): the ``adopt()`` precondition. It leaves out the tp degree,
    the KV layout and geometry and the speculative config (adopt replays
    from tokens), and reads metadata only: no weight bytes, no device
    work. The port's own digest; it need not equal the JAX engine's."""
    import dataclasses
    cfg = model.config
    cfg_repr = (repr(sorted(dataclasses.asdict(cfg).items()))
                if dataclasses.is_dataclass(cfg) else repr(cfg))
    wspec = tuple(sorted((k, tuple(getattr(v, "full_shape", v.shape)),
                          str(v.dtype))
                         for k, v in model.state_dict().items()))
    parts = (type(model).__name__, cfg_repr, arch.name,
             tuple(sorted(statics.items())), eos_token_id, wspec)
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the device functions
# ---------------------------------------------------------------------------

def _admission_keys(seed, skip, device):
    """A request's key chain at admission: ``PRNGKey(seed)`` fast-forwarded
    past the ``skip`` splits a replayed request already consumed, then
    split once -> (the key the slot keeps, the key that samples the first
    token), on ``device``. The seed is a host value, so the chain is
    computed on the host and sent in one copy."""
    key = _prng.prng_key(seed)
    for _ in range(int(skip)):
        key = _prng.split(key)[0]
    pair = _prng.split(key).to(device)
    return pair[0], pair[1]


def _first_token(logits0, keys, slot, seed, skip, temp, vmask, *, do_sample,
                 top_k, top_p):
    """Sample a request's first token from logits0 [V] and, when sampling,
    register its key chain in row ``slot`` of the device keys [S, 2].
    Greedy engines never read the keys and leave them alone."""
    logits0 = torch.where(vmask > 0, logits0, float("-inf"))
    logits_f = G._filter_logits(logits0[None], temp, do_sample, top_k, top_p)
    if not do_sample:
        return torch.argmax(logits_f, dim=-1)[0]
    key, sk = _admission_keys(seed, skip, logits0.device)
    keys[slot] = key
    return _prng.categorical(sk, logits_f)[0]


def _next_tokens(logits, tok, active, keys, temps, *, do_sample, top_k,
                 top_p):
    """The decode step's sampling: every row's key splits, the new key
    replaces the old one on active rows only, and each active row draws
    from its filtered logits with the split-off key (``jax.vmap`` of
    ``split`` and ``categorical``); inactive rows keep their token. The
    keys are updated in place and never leave the device."""
    logits_f = G._filter_logits(logits, temps, do_sample, top_k, top_p)
    if do_sample:
        split = _prng.split(keys)                        # [S, 2, 2]
        nxt = _prng.categorical_rows(split[:, 1], logits_f)
        keys.copy_(torch.where(active[:, None], split[:, 0], keys))
    else:
        nxt = torch.argmax(logits_f, dim=-1)
    return torch.where(active, nxt, tok.long())


def _prefill_impl(arch, kc, vc, keys, ids, n_prompt, slot, seed, skip, temp,
                  vmask, *, do_sample, top_k, top_p):
    """Slot layout: prefill one request (ids [1, Lb], right-padded to its
    bucket) into lines ``[0, Lb)`` of slab row ``slot``, in place. Lines
    past ``n_prompt`` hold padding KV, which the causal bound hides until
    a decode step overwrites them. Returns the first token (0-dim)."""
    Lb = ids.shape[1]
    pos = torch.arange(Lb, device=ids.device)
    x = arch.embed(ids, pos)
    for l, lw in enumerate(arch.layers):
        x, (k, v) = arch.prefill_layer(x, lw, pos)
        kc[l, slot, :Lb] = k[0]
        vc[l, slot, :Lb] = v[0]
    logits0 = arch.logits(x[0, n_prompt - 1])
    return _first_token(logits0, keys, slot, seed, skip, temp, vmask,
                        do_sample=do_sample, top_k=top_k, top_p=top_p)


def _decode_impl(arch, kc, vc, tok, cur_pos, active, keys, temps, vmasks, *,
                 do_sample, top_k, top_p):
    """Slot layout: one fused decode step; every row writes its new K/V at
    line ``cur_pos`` of its own slab row (an inactive row writes garbage
    into a line of its free slot that any later occupant overwrites
    before reading). Returns the next token of every slot [S]."""
    xt = arch.embed(tok, cur_pos)[:, None]
    for l, lw in enumerate(arch.layers):
        xt = arch.decode_layer(xt, lw, kc[l], vc[l], cur_pos, cur_pos, None)
    logits = arch.logits(xt[:, 0])
    logits = torch.where(vmasks > 0, logits, float("-inf"))
    return _next_tokens(logits, tok, active, keys, temps,
                        do_sample=do_sample, top_k=top_k, top_p=top_p)


def _paged_prefill_impl(arch, kc, vc, keys, ids, n_prompt, slot, seed, skip,
                        temp, table_row, skip_write, vmask, *, do_sample,
                        top_k, top_p, block_size):
    """Prefill one request (ids [1, Lb], right-padded to its bucket): the
    full causal forward, K/V written in place into the pools through the
    slot's block-table row. Positions below ``skip_write`` (radix-shared
    prefix, already resident) and at/above ``n_prompt`` (bucket padding)
    go to the trash block, so shared blocks are never rewritten. Returns
    the first token (0-dim tensor)."""
    Lb = ids.shape[1]
    bs = block_size
    pos = torch.arange(Lb, device=ids.device)
    writable = (pos >= skip_write) & (pos < n_prompt)
    dest = torch.where(writable, table_row[pos // bs] * bs + pos % bs,
                       pos % bs)
    _, nb, _, kvh, hd = kc.shape
    x = arch.embed(ids, pos)
    for l, lw in enumerate(arch.layers):
        x, (k, v) = arch.prefill_layer(x, lw, pos)
        kc[l].view(nb * bs, kvh, hd)[dest] = k[0]
        vc[l].view(nb * bs, kvh, hd)[dest] = v[0]
    logits0 = arch.logits(x[0, n_prompt - 1])
    return _first_token(logits0, keys, slot, seed, skip, temp, vmask,
                        do_sample=do_sample, top_k=top_k, top_p=top_p)


def _paged_decode_impl(arch, kc, vc, tables, tok, cur_pos, active, keys,
                       temps, vmasks, *, do_sample, top_k, top_p, block_size,
                       flash_decode=False):
    """One fused paged decode step: every decode-active slot advances one
    token at its own position (GPT's learned position ``wpe[cur_pos]``
    enters at the embedding), writing K/V in place through its block
    table (inactive rows, a slot part-way through a chunked prefill among
    them, write into the trash block) and attending over its pages --
    gathered, or through the flash-decode kernel. Returns the next token
    of every slot [S]."""
    S = tok.shape[0]
    bs = block_size
    rows = torch.arange(S, device=tok.device)
    blk = tables[rows, cur_pos // bs]
    dest = torch.where(active, blk * bs + cur_pos % bs, cur_pos % bs)
    xt = arch.embed(tok, cur_pos)[:, None]
    for l, lw in enumerate(arch.layers):
        xt = arch.paged_decode_layer(xt, lw, kc[l], vc[l], tables, dest,
                                     cur_pos, flash_decode)
    logits = arch.logits(xt[:, 0])
    logits = torch.where(vmasks > 0, logits, float("-inf"))
    return _next_tokens(logits, tok, active, keys, temps,
                        do_sample=do_sample, top_k=top_k, top_p=top_p)


def _paged_chunk_impl(arch, kc, vc, keys, ids, chunk_start, n_prompt, slot,
                      table_row, skip_write, is_final, seed, skip, temp,
                      vmask, *, do_sample, top_k, top_p, block_size):
    """One block-aligned prefill CHUNK of one slot (ids [1, C], global
    positions ``chunk_start + j``), co-scheduled with the fused decode
    step: through every layer, its K/V scattered in place into the pool
    (shared-prefix and pad positions into the trash block), attending
    over the slot's gathered view. The final chunk samples the first
    token from the admission-seeded key chain (``skip`` fast-forward for
    a replay) and returns it; a middle chunk returns None."""
    C = ids.shape[1]
    bs = block_size
    gpos = chunk_start + torch.arange(C, device=ids.device)
    writable = (gpos >= skip_write) & (gpos < n_prompt)
    # the last chunk may run past the table; those rows write nowhere real
    blk = table_row[(gpos // bs).clamp(max=table_row.shape[0] - 1)]
    wdest = torch.where(writable, blk * bs + gpos % bs, gpos % bs)
    x = arch.embed(ids, gpos)
    for l, lw in enumerate(arch.layers):
        x = arch.chunk_layer(x, lw, kc[l], vc[l], table_row, gpos, wdest,
                             bs)
    if not is_final:
        return None
    li = min(max(n_prompt - 1 - chunk_start, 0), C - 1)
    logits0 = arch.logits(x[0, li])
    return _first_token(logits0, keys, slot, seed, skip, temp, vmask,
                        do_sample=do_sample, top_k=top_k, top_p=top_p)


def _spec_verify_impl(arch, kc, vc, keys, ids, start, slot, table_row,
                      n_write, temp, vmask, *, do_sample, top_k, top_p,
                      block_size):
    """Speculative verify: ONE pass over one slot's draft chunk, scoring
    k+1 positions (the chunk layers, as ``verify_layer``). ``ids`` [1, k+1]
    = [last emitted token, d_1..d_k] at positions ``start + j``; their K/V
    go in place through the slot's table row, positions at or past
    ``n_write`` (past the draft's width) to the trash block. The vocab
    mask applies as in decode.

    From the slot's current key ``keys[slot]``, position j samples with
    exactly the split the non-speculative decode step would consume:
    ``key, sk = split(key)``, then filter and sample with ``sk``. Returns
    the k+1 samples [k+1] and the key after each split [k+1, 2] (the
    engine accepts the drafts that equal their samples and restores the
    slot's key to the one after the last emitted token). With ``keys``
    None (a greedy engine, whose keys nothing reads) no chain is made
    and None is returned for it."""
    K1 = ids.shape[1]
    bs = block_size
    j = torch.arange(K1, device=ids.device)
    gpos = start + j
    # padded positions may run past the table: they write nowhere real
    blk = table_row[(gpos // bs).clamp(max=table_row.shape[0] - 1)]
    wdest = torch.where(j < n_write, blk * bs + gpos % bs, gpos % bs)
    x = arch.embed(ids, gpos)
    for l, lw in enumerate(arch.layers):
        x = arch.verify_layer(x, lw, kc[l], vc[l], table_row, gpos, wdest,
                              bs)
    logits = arch.logits(x[0])
    logits = torch.where(vmask[None] > 0, logits, float("-inf"))
    logits_f = G._filter_logits(logits, temp, do_sample, top_k, top_p)
    if keys is None:
        return torch.argmax(logits_f, dim=-1), None
    key, chain, sks = keys[slot], [], []
    for _ in range(K1):
        key, sk = _prng.split(key)
        chain.append(key)
        sks.append(sk)
    if do_sample:
        samples = _prng.categorical_rows(torch.stack(sks), logits_f)
    else:
        samples = torch.argmax(logits_f, dim=-1)
    return samples, torch.stack(chain)


def _accept_len(samples, props):
    """How many draft tokens a verify accepts: the longest prefix of
    ``props`` equal to the chain's samples."""
    m = 0
    while m < len(props) and samples[m] == props[m]:
        m += 1
    return m


# ---------------------------------------------------------------------------
# requests and the engine
# ---------------------------------------------------------------------------

class RequestHandle:
    """One submitted request: streams tokens as the engine decodes.

    ``tokens`` grows as the engine steps; ``on_token(handle, token)`` fires
    per token (the first during prefill: that stamp is the TTFT);
    ``result()`` pumps the engine until this request finishes and returns
    prompt + generated tokens as int32 numpy. ``seed`` seeds the request's
    key chain when the engine samples. ``replica_id`` is the fleet replica
    that serves it now (restamped by ``adopt``), ``model_fingerprint`` its
    origin engine's (the adopt guard), ``trace_id`` one id for its whole
    life, kept across adopt.
    """

    def __init__(self, engine, request_id, prompt_ids, max_new_tokens,
                 temperature, seed, on_token, max_time_s=None, priority=0,
                 logit_mask=None):
        self._engine = engine
        self.request_id = request_id
        self.prompt_ids = prompt_ids
        self.n_prompt = int(prompt_ids.shape[0])
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.on_token = on_token
        self.priority = int(priority)
        self.logit_mask = logit_mask
        self.max_time_s = None if max_time_s is None else float(max_time_s)
        self.deadline = (None if max_time_s is None
                         else time.monotonic() + float(max_time_s))
        self.tokens = []
        self.finished = False
        # "eos" | "length" | "timeout" | "shed" | "cancelled"
        self.finish_reason = None
        self.retry_after_s = None      # stamped when shed under brownout
        self.replica_id = getattr(engine, "replica_id", None)
        self.model_fingerprint = getattr(engine, "model_fingerprint", None)
        self.slot = None
        self.metrics = RequestMetrics()
        self.trace_id = new_trace_id()

    def result(self):
        while not self.finished:
            self._engine.step()
        if self.finish_reason == "timeout":
            where = (f" on replica {self.replica_id}"
                     if self.replica_id is not None else "")
            raise RequestTimeout(
                f"request {self.request_id} exceeded max_time_s="
                f"{self.max_time_s} after {len(self.tokens)} tokens"
                f"{where}; its slot was reclaimed", replica=self.replica_id)
        if self.finish_reason == "shed":
            where = (f" by replica {self.replica_id}"
                     if self.replica_id is not None else "")
            raise RequestShed(
                f"request {self.request_id} (priority {self.priority}) "
                f"was shed under overload{where}; retry after "
                f"{self.retry_after_s}s", retry_after_s=self.retry_after_s,
                replica=self.replica_id)
        if self.finish_reason == "cancelled":
            raise RequestCancelled(
                f"request {self.request_id} was cancelled after "
                f"{len(self.tokens)} tokens")
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.tokens, np.int32)])

    def __repr__(self):
        state = self.finish_reason or (
            "decoding" if self.slot is not None else "queued")
        return (f"RequestHandle(id={self.request_id}, prompt={self.n_prompt}"
                f", tokens={len(self.tokens)}, {state})")


class _ChunkState:
    """Host bookkeeping of one in-progress chunked prefill."""

    __slots__ = ("h", "ids", "n_eff", "n_shared", "next", "skip")

    def __init__(self, h, ids, n_eff, n_shared, start):
        self.h = h
        self.ids = np.ascontiguousarray(ids, np.int32)
        self.n_eff = int(n_eff)
        self.n_shared = int(n_shared)
        self.next = int(start)          # next chunk-start position
        self.skip = len(h.tokens)       # key-chain fast-forward (replay)


class Engine:
    """Continuous-batching serving engine over a ``LlamaForCausalLM`` or
    ``GPTForCausalLM`` of this package (see the module docstring). Runs on
    the model's device.

    The sampling mode (``do_sample``, ``top_k``, ``top_p``) is engine-wide;
    temperature, seed, length and logit mask are per request.

    ``tp=N > 1`` serves the model tensor-parallel over the ``tp`` axis of
    ``mesh`` (default: the mesh ``fleet.init`` or ``set_mesh`` set, else
    ``build_mesh(tp=N)``; its ``tp`` axis must be N), on the process's
    device (``cuda:LOCAL_RANK`` after ``init_parallel_env``; the CPU when
    it was given ``device="cpu"``). The engine takes the whole model, as
    the JAX engine does, and copies only this rank's shards to that
    device, so the model may stay on the CPU. Paged layout only; tp must
    divide the heads, KV heads, vocabulary, FFN and hidden sizes;
    ``flash_decode`` and ``speculative`` are refused, as in JAX.

    ``speculative=SpecConfig(...)`` decodes draft-verify (paged layout;
    ``TypeError`` for anything but a ``SpecConfig``). A model draft must
    be of the target's family and vocabulary and on its device.

    ``replica_id`` names the engine within a ``ReplicaFleet`` (stamped on
    its handles and on the overload exceptions they raise);
    ``default_retry_after_s`` is the retry hint it gives with no decode
    history to estimate from.

    The SPMD contract under tp: every rank of the tp group builds the
    engine with the same arguments and runs the same driver, calling
    ``submit``, ``step``, ``cancel`` (and ``result``/``drain``, which
    step) in the same order with the same arguments. Every rank then
    samples the same token from the gathered full logits with the same
    key chain, so every rank emits the same tokens. Two guards: each
    ``submit`` all-reduces a hash of its arguments and raises
    ``RuntimeError`` on every rank when they differ, instead of leaving
    the ranks' collectives out of step; and deadlines (``max_time_s``)
    are rank 0's, both their values (sent at ``submit``) and the clock
    that expires them (sent at each step while a request has one), so a
    rank whose clock disagrees cannot free a slot alone."""

    def __init__(self, model, n_slots=8, max_len=None, *, do_sample=False,
                 top_k=0, top_p=None, eos_token_id=None, min_prompt_bucket=8,
                 token_budget=None, max_queue=None, base_seed=0,
                 kv_layout="paged", block_size=16, n_blocks=None,
                 prefill_chunk=None, prefix_sharing=True, tp=1, mesh=None,
                 flash_decode=False, speculative=None, replica_id=None,
                 default_retry_after_s=DEFAULT_RETRY_AFTER_S):
        # the arch dispatch (JAX's _make_arch): Llama or GPT, TypeError else
        self._arch = arch = G.arch_for(model)
        self.replica_id = replica_id
        self.default_retry_after_s = float(default_retry_after_s)
        # set by the supervisor when it replaces this engine: its step()
        # does nothing and a wedged step's late emissions are dropped
        self._condemned = False
        self.dropped_emissions = 0
        self.tp = int(tp)
        self._group = None
        if self.tp > 1:
            mesh = self._check_tp(mesh, arch, kv_layout)
        elif mesh is not None:
            raise ValueError("mesh= requires tp > 1")
        if kv_layout not in ("paged", "slot"):
            raise ValueError("kv_layout must be 'paged' or 'slot'")
        self.flash_decode = bool(flash_decode)
        if self.flash_decode and kv_layout != "paged":
            raise ValueError("flash_decode=True requires kv_layout="
                             "'paged' (the block-table operands)")
        if self.flash_decode and self.tp > 1:
            raise ValueError("flash_decode is not supported with tp > 1 "
                             "yet (the TP decode shards attention over "
                             "the mesh)")
        # speculative decoding: the verify writes through block tables,
        # and the TP decode shards attention over the mesh
        self.spec = speculative
        if self.spec is not None:
            if not isinstance(self.spec, SpecConfig):
                raise TypeError("speculative= takes a SpecConfig")
            if kv_layout != "paged":
                raise ValueError("speculative decoding requires "
                                 "kv_layout='paged' (the verify program "
                                 "writes through block tables)")
            if self.tp > 1:
                raise ValueError("speculative decoding is not supported "
                                 "with tp > 1 yet")
        c = model.config
        self.device = model.device
        if self.tp > 1:
            # every rank makes the mesh's groups (the SPMD contract), then
            # copies its own shards to its device
            self._group = mesh.init_groups().group("tp")
            self.device = resolve_device(None)
            self._arch = arch = G.arch_for(model, self._group, self.device)
        self._statics = dict(do_sample=bool(do_sample), top_k=int(top_k),
                             top_p=None if top_p is None else float(top_p))
        self.model_fingerprint = _model_fingerprint(
            model, arch, self._statics, eos_token_id)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len if max_len is not None
                           else c.max_position_embeddings)
        if arch.max_pos is not None and self.max_len > arch.max_pos:
            raise ValueError("max_len exceeds the position table")
        self.eos_token_id = eos_token_id
        self.min_prompt_bucket = int(min_prompt_bucket)
        self.base_seed = int(base_seed)
        self.kv_layout = kv_layout
        self.prefix_sharing = bool(prefix_sharing) and kv_layout == "paged"
        self._chunking = []        # in-progress chunked prefills (paged)
        self.chunk_used = False    # the chunk program has run
        # under tp the pool holds this rank's n_kv // tp heads
        geo = (c.num_hidden_layers, self.n_slots, self.max_len,
               arch.n_kv // self.tp, arch.head_dim, arch.dtype)
        if kv_layout == "paged":
            if self.flash_decode and self.device.type == "cuda":
                _fd.check_supported(arch.dtype, arch.n_heads, arch.n_kv,
                                    arch.head_dim)
            self.block_size = int(block_size)
            if prefill_chunk is not None:
                prefill_chunk = int(prefill_chunk)
                if prefill_chunk < self.block_size \
                        or prefill_chunk % self.block_size:
                    raise ValueError(
                        "prefill_chunk must be a block-aligned multiple "
                        f"of block_size={self.block_size}")
            self.prefill_chunk = prefill_chunk
            self.cache = PagedKVCache(*geo, block_size=self.block_size,
                                      n_blocks=n_blocks, device=self.device)
            self._paged_statics = dict(self._statics,
                                       block_size=self.block_size)
        else:
            self.block_size = None
            self.prefill_chunk = None
            self.cache = SlotKVCache(*geo, device=self.device)
        # host mirror of each slot's last token (inactive slots keep it)
        self._tok = np.zeros(self.n_slots, np.int32)
        # per-slot key chains, temperatures and vocab masks live on the
        # device: admission writes a slot's row, the decode step splits
        # the keys in place, and nothing reads them back
        self._vocab = arch.vocab
        self._keys = torch.zeros((self.n_slots, 2), dtype=torch.int64,
                                 device=self.device)
        self._temps = torch.ones(self.n_slots, dtype=torch.float32,
                                 device=self.device)
        self._vmask = torch.ones((self.n_slots, self._vocab),
                                 dtype=torch.float32, device=self.device)
        self.scheduler = PriorityScheduler(
            token_budget=token_budget or self.n_slots * self.max_len,
            max_queue=max_queue or max(4 * self.n_slots, 16))
        self.metrics = EngineMetrics()
        self.metrics.replica = replica_id
        self._by_slot = [None] * self.n_slots
        self._next_id = 0
        self.buckets_seen = set()
        self.metrics.tp = self.tp
        if self.tp > 1:
            g = self.tp_geometry()
            self.metrics.kv_pool_bytes_per_device = \
                g["kv_pool_bytes_per_device"]
            self.metrics.collectives_per_decode_step = \
                g["collectives_per_decode_step"]
        # the speculative ledger: the verify has run; a model draft's
        # prefill buckets and fused decode
        self.verify_used = False
        self.draft_buckets_seen = set()
        self.draft_decode_used = False
        self._spec = (None if self.spec is None
                      else make_runtime(self, self.spec))

    # -- tensor parallelism ---------------------------------------------------

    def _check_tp(self, mesh, arch, kv_layout):
        """JAX's ``_init_tp`` checks: the paged layout, a tp that divides
        every split dim, and a mesh whose ``tp`` axis is tp. Returns the
        mesh; nothing is placed and no collective runs yet."""
        if kv_layout != "paged":
            raise ValueError(
                "tensor-parallel serving requires kv_layout='paged' "
                "(the sharded pool + block-table operands)")
        tp = self.tp
        for name, dim in (("num_attention_heads", arch.n_heads),
                          ("num_key_value_heads", arch.n_kv),
                          ("vocab (head columns)", arch.vocab),
                          ("intermediate_size", arch.ffn),
                          ("hidden_size", arch.n_heads * arch.head_dim)):
            if dim % tp:
                raise ValueError(f"tp={tp} does not divide {name}={dim}")
        if mesh is None:
            mesh = _mesh.configured_mesh() or _mesh.build_mesh(tp=tp)
        if mesh.shape["tp"] != tp:
            raise ValueError(f"mesh tp axis {mesh.shape['tp']} != tp={tp}")
        if mesh.coords is None:
            raise ValueError(f"rank {mesh.rank} is outside the mesh "
                             f"{mesh.shape}")
        return mesh

    def tp_geometry(self):
        """The tp layout at a glance: the tp degree, the group's ranks,
        this rank's KV pool bytes and heads, and the collectives one fused
        decode step issues (an all-reduce per row-parallel projection, two
        a layer, and the head's all-gather). None on a single-rank
        engine."""
        if self.tp <= 1:
            return None
        return {
            "tp": self.tp,
            "ranks": list(self._group.ranks),
            "device": str(self.device),
            "kv_pool_bytes_per_device": self.cache.nbytes(),
            "kv_heads_per_device": self.cache.kv_heads,
            "weight_sharding": "column(qkv/gate-up) row(o/down) "
                               "vocab(head)",
            "collectives_per_decode_step": 2 * len(self._arch.layers) + 1,
            "collective_kind": "all_reduce (o/down) + all_gather (head)",
        }

    def _agree(self, ids, args, logit_mask, max_time_s):
        """The submit-time SPMD guard: one all-reduce (max) over the tp
        group of a hash of this request's arguments and of its negation,
        and of rank 0's deadline. Raises RuntimeError on every rank when
        the ranks' arguments differ; returns rank 0's deadline (None
        without ``max_time_s``)."""
        blob = hashlib.blake2b(digest_size=8)
        blob.update(ids.tobytes())
        blob.update(repr(args).encode())
        if logit_mask is not None:
            blob.update(np.asarray(logit_mask).tobytes())
        # 52 bits of it, exact in float64
        hv = float(int.from_bytes(blob.digest(), "little") >> 12)
        deadline = float("-inf")
        if max_time_s is not None and self._group.rank == 0:
            deadline = time.monotonic() + float(max_time_s)
        t = torch.tensor([hv, -hv, deadline], dtype=torch.float64,
                         device=self.device)
        _C.all_reduce(t, _C.ReduceOp.MAX, group=self._group)
        hi, neg_lo, deadline = t.tolist()
        if hi != -neg_lo:
            raise RuntimeError(
                f"tp ranks disagree on submit() #{self._next_id}: every "
                "rank must call submit/step/cancel in the same order with "
                "the same arguments (the Engine's SPMD contract)")
        return None if max_time_s is None else deadline

    def _rank0_clock(self, now):
        """Rank 0's ``time.monotonic()``, the clock every rank expires
        deadlines by."""
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        _C.broadcast(t, src=self._group.ranks[0], group=self._group)
        return float(t.item())

    # -- out of this slice --------------------------------------------------

    def precompile_aot(self, dest_dir, buckets=None):
        raise _not_in_slice("AOT program handles", "runtime services")

    # -- submission and admission -------------------------------------------

    def _bucket(self, n):
        b = self.min_prompt_bucket
        while b < n:
            b <<= 1
        return min(b, self.max_len)

    @staticmethod
    def _as_ids(prompt):
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.detach().cpu().numpy()
        ids = np.asarray(prompt, np.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1:
            raise ValueError(
                f"prompt must be a 1-D token sequence, got {ids.shape}")
        return ids

    def submit(self, prompt, max_new_tokens=32, temperature=1.0, seed=None,
               on_token=None, max_time_s=None, priority=0, logit_mask=None):
        """Enqueue a request; returns a RequestHandle immediately (the
        request often prefills inside this call). Raises EngineOverloaded
        past max_queue.

        ``seed`` seeds the request's key chain (default ``base_seed +
        request_id``), so a sampled request's tokens depend on its prompt,
        seed and arguments only; ``max_time_s`` is a wall-clock deadline
        over queueing and decoding; ``priority`` is the admission class (0
        first); ``logit_mask`` ([vocab], nonzero = allowed) constrains
        every sampled position of this request. Under tp every rank makes
        the same calls (see the class docstring)."""
        ids = self._as_ids(prompt)
        if self.tp > 1:
            deadline = self._agree(
                ids, (self._next_id, max_new_tokens, temperature, seed,
                      max_time_s, priority), logit_mask, max_time_s)
        if ids.shape[0] < 1:
            raise ValueError("empty prompt")
        if logit_mask is not None:
            m = np.asarray(logit_mask)
            if m.shape != (self._vocab,):
                raise ValueError(
                    f"logit_mask must have shape ({self._vocab},), got "
                    f"{m.shape}")
            logit_mask = (m > 0).astype(np.float32)
            if not logit_mask.any():
                raise ValueError("logit_mask allows no tokens")
        if max_time_s is not None and float(max_time_s) <= 0:
            raise ValueError("max_time_s must be positive")
        if ids.shape[0] + int(max_new_tokens) > self.max_len:
            raise ValueError(
                f"prompt ({ids.shape[0]}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_len={self.max_len}")
        if self.kv_layout == "paged":
            cap = (self.cache.pool.n_blocks - 1) * self.block_size
            if ids.shape[0] + int(max_new_tokens) + 1 > cap:
                raise ValueError(
                    f"prompt ({ids.shape[0]}) + max_new_tokens "
                    f"({max_new_tokens}) can never fit the KV pool "
                    f"({cap} token lines) -- raise n_blocks")
        rid = self._next_id
        self._next_id += 1
        h = RequestHandle(self, rid, ids, max_new_tokens, temperature,
                          self.base_seed + rid if seed is None else seed,
                          on_token, max_time_s=max_time_s, priority=priority,
                          logit_mask=logit_mask)
        if self.tp > 1:
            h.deadline = deadline        # rank 0's, on every rank
        self.metrics.requests_submitted += 1
        try:
            self.scheduler.enqueue(h, retry_after_s=self._retry_after_hint())
        except EngineOverloaded:
            self.metrics.requests_rejected += 1
            raise
        self._admit()
        return h

    def _retry_after_hint(self):
        """Seconds until a slot plausibly frees: the rolling ITL p95 times
        the shortest remaining active request; the conservative default
        without decode history or active requests."""
        itl = self.metrics.itl_p95()
        remaining = [h.max_new_tokens - len(h.tokens)
                     for h in self._by_slot if h is not None]
        if itl is None or not remaining:
            return self.default_retry_after_s
        return round(itl * max(1, min(remaining)), 3)

    def _admit(self):
        # a request that finishes during its own prefill frees its slot at
        # once: loop so the queue keeps draining into freed slots
        while True:
            if self.kv_layout == "paged":
                popped = self.scheduler.pop_admissible(
                    self.cache.n_free, free_tokens=self.cache.free_tokens())
            else:
                popped = self.scheduler.pop_admissible(self.cache.n_free)
            if not popped:
                return
            for h in popped:
                if not self._admit_one(h):
                    # the pool could not cover it even after radix
                    # eviction: back to the queue head
                    self.scheduler.release(h)
                    self.scheduler.requeue(h)
                    return

    @staticmethod
    def _full_ids(h):
        """prompt + already-emitted tokens (the replay sequence)."""
        if not h.tokens:
            return h.prompt_ids
        return np.concatenate(
            [h.prompt_ids, np.asarray(h.tokens, np.int32)])

    def _set_request_rows(self, h, slot):
        """The slot's temperature and vocab mask on the device."""
        self._temps[slot] = h.temperature
        self._vmask[slot] = (1.0 if h.logit_mask is None else
                             torch.from_numpy(h.logit_mask).to(self.device))

    def _admit_one(self, h):
        # a preempted request re-prefills prompt + its k emitted tokens and
        # fast-forwards its key chain k splits, so its next token is the
        # one the uninterrupted run would have drawn; normal admission is
        # k = 0
        k = len(h.tokens)
        n_eff = h.n_prompt + k
        if self.kv_layout == "paged":
            return self._admit_one_paged(h, k, n_eff)
        slot = self.cache.alloc(h.request_id)
        h.slot = slot
        self._by_slot[slot] = h
        Lb = self._bucket(n_eff)
        self.buckets_seen.add(Lb)
        ids = np.zeros((1, Lb), np.int32)
        ids[0, :n_eff] = self._full_ids(h)
        with torch.inference_mode():
            self._set_request_rows(h, slot)
            tok0 = int(_prefill_impl(
                self._arch, self.cache.kc, self.cache.vc, self._keys,
                torch.from_numpy(ids).to(self.device), n_eff, slot, h.seed,
                k, self._temps[slot], self._vmask[slot], **self._statics))
        self.metrics.prefills += 1
        self._tok[slot] = tok0
        self.cache.cur_pos[slot] = n_eff
        self._emit(h, tok0)
        return True

    def _admit_one_paged(self, h, k, n_eff):
        full = self._full_ids(h)
        slot = self.cache.alloc(h.request_id)
        # block coverage for [0, n_eff]: prompt + replay tokens + the
        # first decode write line; the radix shares any cached full-block
        # prefix, copy-on-write on a partial tail block
        match_ids = full if self.prefix_sharing else full[:0]
        admitted = self.cache.admit(slot, match_ids, n_eff + 1)
        if admitted is None:
            self.cache.free(slot)
            h.slot = None
            return False
        n_shared, cow = admitted
        h.slot = slot
        self._by_slot[slot] = h
        self.metrics.prompt_tokens += n_eff
        self.metrics.prefix_hit_tokens += min(n_shared, n_eff)
        if cow:
            self.metrics.cow_copies += 1
        with torch.inference_mode():
            self._set_request_rows(h, slot)
        if self.prefill_chunk is not None and n_eff > self.prefill_chunk:
            # a long prompt prefills in block-aligned chunks, one per step
            # beside the fused decode step; its slot joins the decode
            # batch after the final chunk. Fully shared leading chunks are
            # skipped (the radix holds their KV): start at the chunk with
            # the first unshared position, clamped so that the chunk with
            # the last prompt token (the sampling row) always runs.
            C = self.prefill_chunk
            start = (min(n_shared, n_eff - 1) // C) * C
            self._chunking.append(
                _ChunkState(h, full, n_eff, n_shared, start))
            self.metrics.chunked_prefills += 1
            return True
        Lb = self._bucket(n_eff)
        self.buckets_seen.add(Lb)
        ids = np.zeros((1, Lb), np.int32)
        ids[0, :n_eff] = full
        dev = self.device
        with torch.inference_mode():
            tok0 = int(_paged_prefill_impl(
                self._arch, self.cache.kc, self.cache.vc, self._keys,
                torch.from_numpy(ids).to(dev), n_eff, slot, h.seed, k,
                self._temps[slot],
                torch.from_numpy(self.cache.block_tables[slot]).to(dev),
                n_shared, self._vmask[slot], **self._paged_statics))
        self.metrics.prefills += 1
        self._tok[slot] = tok0
        self.cache.cur_pos[slot] = n_eff
        if self.prefix_sharing:
            self.cache.commit_prefix(slot, full)
        self._emit(h, tok0)
        if self._spec is not None and not h.finished:
            self._spec.on_admit(h, full)
        return True

    def _chunk_tick(self):
        """Advance the oldest in-progress chunked prefill by ONE chunk
        (the fused decode step then runs for every other slot: a long
        prompt holds the others back by one chunk per step at most)."""
        cs = self._chunking[0]
        h = cs.h
        C = self.prefill_chunk
        start = cs.next
        end = min(start + C, cs.n_eff)
        ids = np.zeros((1, C), np.int32)
        ids[0, :end - start] = cs.ids[start:end]
        is_final = end >= cs.n_eff
        dev = self.device
        with torch.inference_mode():
            tok0 = _paged_chunk_impl(
                self._arch, self.cache.kc, self.cache.vc, self._keys,
                torch.from_numpy(ids).to(dev), start, cs.n_eff, h.slot,
                torch.from_numpy(self.cache.block_tables[h.slot]).to(dev),
                cs.n_shared, is_final, h.seed, cs.skip,
                self._temps[h.slot], self._vmask[h.slot],
                **self._paged_statics)
            tok0 = None if tok0 is None else int(tok0)
        self.chunk_used = True
        self.metrics.chunk_steps += 1
        cs.next = end
        if is_final:
            self._chunking.pop(0)
            self.metrics.prefills += 1
            self._tok[h.slot] = tok0
            self.cache.cur_pos[h.slot] = cs.n_eff
            if self.prefix_sharing:
                self.cache.commit_prefix(h.slot, cs.ids)
            self._emit(h, tok0)
            if self._spec is not None and not h.finished:
                self._spec.on_admit(h, cs.ids)

    # -- paged pool pressure ------------------------------------------------

    def _decode_active(self):
        """Decode-step row mask: occupied slots minus those still part-way
        through a chunked prefill (they hold their slot but have no token
        yet). A copy: finishing requests change the cache's mask."""
        m = self.cache.active.copy()
        for cs in self._chunking:
            m[cs.h.slot] = False
        return m

    def _ensure_decode_capacity(self, active_mask):
        """Every decode-active slot needs a writable block for its next
        line. On pool exhaustion (after radix eviction) the least
        important request is PREEMPTED: its blocks free, it re-queues, and
        re-admission replays prompt + emitted tokens with the key-chain
        fast-forward, so its output is token-identical."""
        for slot in np.nonzero(active_mask)[0]:
            slot = int(slot)
            h = self._by_slot[slot]
            if h is None:
                continue
            while not self.cache.ensure(slot, int(self.cache.cur_pos[slot])):
                victim = self._pick_preempt_victim(exclude=h)
                if victim is None:
                    raise RuntimeError(
                        "KV pool exhausted with a single active request "
                        "-- unreachable given the submit() capacity check")
                self._preempt(victim)
                if h.slot is None:
                    break      # the needing slot itself got preempted

    def _pick_preempt_victim(self, exclude):
        cand = [x for x in self._by_slot
                if x is not None and x is not exclude]
        if not cand:
            return None
        # least important class first, newest arrival within it
        return max(cand, key=lambda x: (x.priority, x.request_id))

    def _preempt(self, h):
        slot = h.slot
        self._by_slot[slot] = None
        self.cache.free(slot)
        h.slot = None
        self._chunking = [cs for cs in self._chunking if cs.h is not h]
        self.scheduler.release(h)
        self.scheduler.requeue(h)
        self.metrics.preemptions += 1

    def adopt(self, handle):
        """Re-inject a handle from another engine over the same model (the
        supervisor's rebuild and the fleet's migration): it keeps its id,
        seed, priority, trace id and emitted tokens; admission re-prefills
        ``prompt + tokens`` and fast-forwards its key chain past them, so
        it continues token-identically to the uninterrupted run.

        Raises :class:`AdoptMismatch` when the handle's origin engine had
        another ``model_fingerprint``. The tp degree and the KV geometry
        may differ; an engine with ``tp > 1`` does not adopt yet."""
        if self.tp > 1:
            raise _not_in_slice("adopt() under tp > 1", "serving robustness")
        fp = getattr(handle, "model_fingerprint", None)
        if fp is not None and fp != self.model_fingerprint:
            raise AdoptMismatch(
                f"request {handle.request_id} originates from an engine "
                f"with model fingerprint {fp} but this engine serves "
                f"{self.model_fingerprint}: adopting would replay its "
                "token history through different math and silently "
                "diverge -- migrate only between replicas of the SAME "
                "model/config/sampling configuration")
        handle.slot = None
        handle._engine = self
        handle.replica_id = self.replica_id
        handle.model_fingerprint = self.model_fingerprint
        self._next_id = max(self._next_id, handle.request_id + 1)
        self.metrics.requests_submitted += 1
        self.scheduler.enqueue(handle,
                               retry_after_s=self._retry_after_hint())
        self._admit()
        return handle

    def shed_queued(self, protect_priority=0, retry_after_s=None):
        """Brownout degradation: evict the single lowest-priority class
        of queued requests (classes <= ``protect_priority`` are never
        shed). They finish with reason ``"shed"`` and ``result()`` raises
        :class:`RequestShed` with a finite ``retry_after_s``. Returns the
        evicted handles."""
        if retry_after_s is None:
            retry_after_s = self._retry_after_hint()
        out = self.scheduler.shed_lowest(protect_priority)
        for h in out:
            h.retry_after_s = retry_after_s
            self._finish(h, "shed")
        return out

    def cancel(self, handle):
        """Client abandoned the stream: a queued handle leaves the
        scheduler, an active one (part-way through a chunked prefill or
        decoding) frees its KV blocks at once. ``result()`` raises
        RequestCancelled. Returns False if already finished."""
        if handle.finished:
            return False
        if handle.slot is None:
            self.scheduler.remove(handle)
        self._finish(handle, "cancelled")
        return True

    # -- the decode loop ----------------------------------------------------

    def _expire(self):
        """Expired queued requests drop before taking a slot; expired
        active ones free their slot and resolve with a timeout. Under tp
        rank 0's clock decides for every rank (the deadlines are already
        rank 0's), read only while some request has a deadline."""
        now = time.monotonic()
        if self.tp > 1:
            if not (self.scheduler.has_deadlines() or any(
                    h is not None and h.deadline is not None
                    for h in self._by_slot)):
                return
            now = self._rank0_clock(now)
        for h in self.scheduler.drop_expired(now):
            self._finish(h, "timeout")
        for h in list(self._by_slot):
            if h is not None and h.deadline is not None \
                    and now > h.deadline:
                self._finish(h, "timeout")

    def step(self):
        """One engine iteration: expire overdue requests, admit waiting
        ones, advance ONE chunk of the oldest chunked prefill, then
        advance every decode-active slot one token with the fused decode
        step (paged: preempting first on pool exhaustion; speculative:
        ``_spec_step``). Returns the number of requests that decoded this
        step (0 on a condemned engine, which does nothing)."""
        if self._condemned:
            return 0
        self._expire()
        self._admit()
        paged = self.kv_layout == "paged"
        if paged and self._chunking:
            self._chunk_tick()
        if paged:
            self._ensure_decode_capacity(self._decode_active())
            active = self._decode_active()   # preemption may shrink it
            self.metrics.sample(self.cache.occupancy,
                                self.scheduler.queue_depth,
                                active=self.cache.n_active,
                                pool_free=self.cache.pool.n_free,
                                pool_total=self.cache.pool.n_blocks - 1)
        else:
            active = self.cache.active.copy()
            self.metrics.sample(self.cache.occupancy,
                                self.scheduler.queue_depth,
                                active=self.cache.n_active)
        n_active = int(active.sum())
        if not n_active:
            return 0
        if self._spec is not None:
            return self._spec_step(active, n_active)
        self._decode_once(active)
        return n_active

    def _decode_once(self, active):
        """One fused decode step over ``active`` rows."""
        S = self.n_slots
        paged = self.kv_layout == "paged"
        t0 = time.perf_counter()
        # tok, cur, active (and the block tables) travel in one int32 copy
        parts = [self._tok, self.cache.cur_pos, active.astype(np.int32)]
        if paged:
            parts.append(self.cache.block_tables.ravel())
        with torch.inference_mode():
            buf = torch.from_numpy(np.concatenate(parts)).to(self.device)
            state = (buf[:S], buf[S:2 * S], buf[2 * S:3 * S] > 0,
                     self._keys, self._temps, self._vmask)
            if paged:
                nxt = _paged_decode_impl(
                    self._arch, self.cache.kc, self.cache.vc,
                    buf[3 * S:].view(S, -1), *state,
                    flash_decode=self.flash_decode, **self._paged_statics)
            else:
                nxt = _decode_impl(self._arch, self.cache.kc, self.cache.vc,
                                   *state, **self._statics)
            toks = nxt.cpu().numpy().astype(np.int32)    # the step's sync
        self._tok = toks
        self.metrics.mark_decode(time.perf_counter() - t0)
        for slot in np.nonzero(active)[0]:
            self._emit(self._by_slot[int(slot)], int(toks[slot]))

    # -- speculative decoding (serving/speculative.py) -------------------------

    def _ensure_spec_capacity(self, h, k_eff):
        """Reserve writable blocks for the verify's k_eff + 1 candidate
        lines (positions cur..cur+k_eff), preempting as the decode path
        does on pool exhaustion. False when ``h`` itself was preempted on
        the way (its verify is skipped)."""
        base = int(self.cache.cur_pos[h.slot])
        for pos in range(base, base + k_eff + 1):
            while not self.cache.ensure(h.slot, pos):
                victim = self._pick_preempt_victim(exclude=h)
                if victim is None:
                    return False     # lone request: the cap keeps it
                self._preempt(victim)
                if h.slot is None:
                    return False
        return True

    def _spec_step(self, active, n_active):
        """One speculative iteration: propose up to k tokens for every
        slot that may take more than one (n-gram lookup or the draft
        model's fused steps), run the plain decode step for the slots
        with no proposal first, then verify each proposing slot's chunk
        in one pass and emit its accepted drafts and one chain sample:
        between 1 and k+1 tokens a slot, each the non-speculative
        engine's."""
        k = self.spec.k
        cand, plain = [], np.zeros(self.n_slots, bool)
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            h = self._by_slot[slot]
            if h is None:
                continue
            remaining = h.max_new_tokens - len(h.tokens)
            p = int(self.cache.cur_pos[slot])
            k_cap = min(k, remaining - 1, self.max_len - 1 - p)
            if k_cap >= 1:
                cand.append((h, k_cap))
            else:
                plain[slot] = True
        proposals = self._spec.propose_all(cand) if cand else {}
        plan = []
        for h, k_cap in cand:
            props = proposals.get(h.slot)
            if props is None or len(props) == 0:
                plain[h.slot] = True
            else:
                plan.append((h, np.asarray(props[:k_cap], np.int32)))
        if plain.any():
            self._decode_once(plain)
        for h, props in plan:
            if h.finished or h.slot is None:
                continue        # finished or preempted earlier this step
            if not self._ensure_spec_capacity(h, len(props)):
                continue        # preempted while reserving its lines
            self._verify_one(h, props)
        return n_active

    def _verify_one(self, h, props):
        """Verify one slot's draft chunk and emit the accepted drafts and
        the chain's next sample (see ``_spec_verify_impl``). The samples
        come back in one read, the verify's one synchronisation."""
        slot, k_eff = h.slot, len(props)
        p = int(self.cache.cur_pos[slot])
        K1 = self.spec.k + 1
        ids = np.zeros(K1, np.int32)
        ids[0] = h.tokens[-1]
        ids[1:1 + k_eff] = props
        t0 = time.perf_counter()
        with torch.inference_mode():
            # the ids and the slot's table row travel in one int32 copy
            buf = torch.from_numpy(np.concatenate(
                [ids, self.cache.block_tables[slot]])).to(self.device)
            samples, chain = _spec_verify_impl(
                self._arch, self.cache.kc, self.cache.vc,
                self._keys if self._statics["do_sample"] else None,
                buf[None, :K1], p, slot, buf[K1:], k_eff + 1,
                self._temps[slot], self._vmask[slot], **self._paged_statics)
            samples = samples.cpu().numpy()
        self.verify_used = True
        m = _accept_len(samples, props)
        e = m + 1           # the accepted drafts + the chain's own sample
        self.metrics.mark_decode(time.perf_counter() - t0, tokens=e)
        self.metrics.spec_steps += 1
        self.metrics.spec_proposed_tokens += k_eff
        self.metrics.spec_accepted_tokens += m
        self.metrics.spec_emitted_tokens += e
        for t in (*props[:m], samples[m]):
            self._emit(h, int(t))
            if h.finished or self._condemned:
                return
        self._rewind(h, p, e, samples, chain)

    def _rewind(self, h, p, e, samples, chain):
        """After a verify that emitted ``e`` tokens the slot continues as if
        it had taken e decode steps: its next token is the last emitted
        sample, its position p + e (rejected candidate lines lie past it,
        behind the causal bound, and the decode step overwrites a line
        before it reads it), its key the chain's after the e-th split."""
        slot = h.slot
        self._tok[slot] = samples[e - 1]
        self.cache.cur_pos[slot] = p + e
        if chain is not None:
            with torch.inference_mode():
                self._keys[slot] = chain[e - 1]
        self._spec.after_verify(h, int(samples[e - 1]), p + e)

    def _emit(self, h, token):
        if self._condemned:
            # a wedged step's thread returned after the supervisor replaced
            # this engine: the handle lives on the new one now, and dropping
            # the stale token keeps its replayed stream token-identical
            self.dropped_emissions += 1
            return
        h.tokens.append(token)
        h.metrics.mark_token()
        self.metrics.tokens_generated += 1
        self.cache.cur_pos[h.slot] = h.n_prompt + len(h.tokens) - 1
        if h.on_token is not None:
            h.on_token(h, token)
        if self.eos_token_id is not None and token == self.eos_token_id:
            self._finish(h, "eos")
        elif len(h.tokens) >= h.max_new_tokens:
            self._finish(h, "length")

    def _finish(self, h, reason):
        h.finished = True
        h.finish_reason = reason
        h.metrics.mark_finished()
        if h.slot is not None:         # queued-only timeouts held no slot
            self._by_slot[h.slot] = None
            # every block the slot holds is released: shared-prefix
            # refcounts drop, private blocks (a cancelled or timed-out
            # chunked prefill's written chunks among them) return to the
            # pool
            self.cache.free(h.slot)
            self.scheduler.release(h)
            if self._chunking:
                self._chunking = [cs for cs in self._chunking
                                  if cs.h is not h]
        if reason == "timeout":
            self.metrics.requests_timed_out += 1
        elif reason == "cancelled":
            self.metrics.requests_cancelled += 1
        elif reason == "shed":
            self.metrics.requests_shed += 1
        else:
            self.metrics.requests_completed += 1

    def drain(self):
        """Pump step() until every submitted request has finished."""
        while self.scheduler.queue_depth or self.cache.n_active:
            self.step()

    def generate_all(self, prompts, **gen_kwargs):
        """Submit a list of prompts, drain, return the handles."""
        handles = [self.submit(p, **gen_kwargs) for p in prompts]
        self.drain()
        return handles

    def stats(self):
        out = {**self.metrics.snapshot(),
               "n_slots": self.n_slots, "max_len": self.max_len,
               "kv_layout": self.kv_layout,
               "active": self.cache.n_active,
               "queue_depth": self.scheduler.queue_depth,
               # the whole pool, over every rank under tp
               "kv_cache_bytes": self.cache.nbytes() * self.tp,
               "prefill_buckets": sorted(self.buckets_seen),
               "chunk_program": self.chunk_used,
               "prefill_chunk": self.prefill_chunk,
               "prefix_sharing": self.prefix_sharing,
               "flash_decode": self.flash_decode,
               # process-wide count of flash-decode kernel launches (CUDA
               # only; the plain CPU path launches nothing)
               "flash_decode_launches": _fd.flash_decode.launches,
               "device": str(self.device),
               "replica": self.replica_id,
               "model_fingerprint": self.model_fingerprint}
        if self.kv_layout == "paged":
            out.update(self.cache.pool_stats())
        if self.spec is not None:
            ar = self.metrics.acceptance_rate()
            out["speculative"] = {
                "k": self.spec.k, "draft": self.spec.draft_kind(),
                "verify_used": self.verify_used,
                "draft_buckets_seen": sorted(self.draft_buckets_seen),
                "draft_decode_used": self.draft_decode_used,
                "acceptance_rate": (None if ar is None
                                    else round(ar, 4))}
        if self.tp > 1:
            out["mesh"] = self.tp_geometry()
        return out
