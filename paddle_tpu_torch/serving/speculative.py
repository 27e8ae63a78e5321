"""Speculative decoding for the serving engine: draft-verify with
token-identical acceptance.

Counterpart of ``paddle_tpu/serving/speculative.py``. Latency-shaped
traffic pays one target step per token; speculative decoding (Leviathan
et al., arXiv 2211.17192) spends draft work to collapse up to ``k`` tokens
into ONE verify pass. The drafts:

* ``SpecConfig(draft="ngram")``: a host-side n-gram index over each
  request's prompt + emitted tokens proposes the continuation that
  followed the most recent occurrence of the current suffix (prompt-lookup
  decoding). No draft model and no device work when nothing matches: the
  slot takes the plain decode step;
* ``SpecConfig(draft=model)``: a same-family model with its own
  slot-layout KV cache proposes ``k`` greedy tokens per round (k+1 fused
  draft decode steps, so a full accept leaves no hole in the draft's
  cache);
* any object with ``propose(ctx_ids, k) -> int32[<=k] | None``: a custom
  host proposer.

**Token-identical acceptance.** The engine's tokens equal the
non-speculative engine's, greedy AND sampled: the verify scores the k
draft tokens at k+1 positions and re-runs the request's own sampling at
each, with exactly the key split the non-speculative chain would have
used; a draft token is accepted iff it EQUALS that sample, and the first
mismatch emits the chain's sample instead. Acceptance changes speed,
never tokens, so preemption replay is unchanged.

**Paged rewind.** The verify writes candidate K/V for the k+1 positions
through the slot's block table (positions past the draft's width go to
the trash block); the host then rewinds the slot's position to the
accepted length. Rejected lines sit past the causal bound and are
rewritten by the step that first exposes them; ``commit_prefix`` indexes
prompt blocks only, so unverified tokens are never shared.

A model draft's prefill and its rounds of draft steps are traced as the
JAX module's are (``spec.draft_prefill``, ``spec.draft``; the engine's
verify is ``spec.verify``). The JAX module's ``probe_specs`` (AOT program
probes) has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..observability import tracing as _tracing
from ..text import generation as G

# what a span site enters while tracing is off
_NO_SPAN = contextlib.nullcontext()

__all__ = ["SpecConfig", "SPEC_COUNTER_KEYS", "NgramProposer",
           "make_runtime"]

#: The speculative counters of ``EngineMetrics``.
SPEC_COUNTER_KEYS = ("spec_steps", "draft_steps", "spec_proposed_tokens",
                     "spec_accepted_tokens", "spec_emitted_tokens")


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding configuration for ``Engine(speculative=...)``.

    ``draft`` is ``"ngram"``, a same-family ``LlamaForCausalLM`` /
    ``GPTForCausalLM`` of this package (model draft), or any object with
    ``propose(ctx_ids, k) -> int32[<=k] | None`` (a custom host proposer).
    ``k`` is the draft width: one verify scores k proposed tokens at k+1
    positions and emits between 1 and k+1 tokens. ``ngram_min`` /
    ``ngram_max`` bound the suffix order the n-gram proposer matches
    (longest first)."""

    draft: object = "ngram"
    k: int = 4
    ngram_max: int = 3
    ngram_min: int = 2

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError("SpecConfig.k must be >= 1")
        self.k = int(self.k)
        if self.draft == "ngram":
            if not (1 <= int(self.ngram_min) <= int(self.ngram_max)):
                raise ValueError("need 1 <= ngram_min <= ngram_max")
            self.ngram_min = int(self.ngram_min)
            self.ngram_max = int(self.ngram_max)

    def draft_kind(self):
        if self.draft == "ngram":
            return "ngram"
        if hasattr(self.draft, "propose"):
            return "custom"
        return "model"


class _NgramState:
    """Per-handle incremental n-gram index: for each order n, the position
    AFTER the most recent occurrence of every n-gram that ends at an
    already-continued position. Append-only (a request's context only
    grows, and a replay rebuilds the same prefix)."""

    __slots__ = ("idx", "upto")

    def __init__(self, nmin, nmax):
        self.idx = {n: {} for n in range(nmin, nmax + 1)}
        self.upto = 0     # n-grams ending before this position are indexed


class NgramProposer:
    """Draft-free lookahead: propose the tokens that followed the most
    recent earlier occurrence of the context's current suffix (the longest
    matching order first). Host-side only."""

    def __init__(self, cfg: SpecConfig):
        self.nmin = cfg.ngram_min
        self.nmax = cfg.ngram_max

    def propose(self, h, k_cap):
        ctx = h.prompt_ids.tolist() + h.tokens
        L = len(ctx)
        st = getattr(h, "_spec_ngram", None)
        if st is None:
            st = h._spec_ngram = _NgramState(self.nmin, self.nmax)
        # index the n-grams ending at positions [upto, L-2]: each has a
        # known continuation at the next position
        for e in range(st.upto, L - 1):
            for n in range(self.nmin, self.nmax + 1):
                if e - n + 1 < 0:
                    continue
                st.idx[n][tuple(ctx[e - n + 1:e + 1])] = e + 1
        st.upto = max(st.upto, L - 1)
        for n in range(min(self.nmax, L - 1), self.nmin - 1, -1):
            pos = st.idx[n].get(tuple(ctx[L - n:]))
            if pos is not None:
                out = ctx[pos:pos + k_cap]
                if out:
                    return np.asarray(out, np.int32)
        return None


class _HostProposerAdapter:
    """A custom ``propose(ctx_ids, k)`` object, or the built-in
    ``NgramProposer`` (which takes the handle), as the engine's draft
    runtime."""

    def __init__(self, proposer, by_handle):
        self.proposer = proposer
        self.by_handle = by_handle

    def on_admit(self, h, full):
        pass

    def after_verify(self, h, last_tok, new_cur):
        pass

    def propose_all(self, cand):
        out = {}
        for h, k_cap in cand:
            if self.by_handle:
                p = self.proposer.propose(h, k_cap)
            else:
                ctx = np.concatenate(
                    [h.prompt_ids, np.asarray(h.tokens, np.int32)])
                p = self.proposer.propose(ctx, k_cap)
            if p is not None and len(p):
                out[h.slot] = np.asarray(p[:k_cap], np.int32)
        return out


class _ModelDraft:
    """A same-family small model as the draft, with its own slot-layout KV
    cache (``[layers, n_slots, max_len, kv, hd]`` per K and V, one row per
    engine slot; no allocator of its own). It runs the engine's slot
    prefill and decode bodies (``_prefill_impl`` / ``_decode_impl``) on
    its own arch object, GREEDY: acceptance compares proposals with the
    target's chain samples, so sampling the draft would only add noise.
    ``layer_weights`` gives views, so a self-draft costs only its cache.

    Host state per slot: the position of the next draft line (``cur``);
    the token the next draft step feeds stays on the device (``tok``), so
    the k+1 draft steps of a round read their proposals back once."""

    def __init__(self, engine, model):
        arch = G.arch_for(model)
        if arch.name != engine._arch.name:
            raise ValueError(
                f"draft model arch {arch.name!r} != target arch "
                f"{engine._arch.name!r}: speculative drafts must be "
                "same-family")
        if arch.vocab != engine._vocab:
            raise ValueError(f"draft vocab {arch.vocab} != target vocab "
                             f"{engine._vocab}")
        if arch.max_pos is not None and engine.max_len > arch.max_pos:
            raise ValueError("draft position table < engine max_len")
        if model.device != engine.device:
            raise ValueError(f"draft model on {model.device}, engine on "
                             f"{engine.device}")
        self.engine = engine
        self.arch = arch
        S, T = engine.n_slots, engine.max_len
        dev = engine.device
        shape = (len(arch.layers), S, T, arch.n_kv, arch.head_dim)
        self.kc = torch.zeros(shape, dtype=arch.dtype, device=dev)
        self.vc = torch.zeros_like(self.kc)
        self.tok = torch.zeros(S, dtype=torch.long, device=dev)
        self.cur = np.zeros(S, np.int64)
        # a greedy draft never reads its keys or temperatures
        self._keys = torch.zeros((S, 2), dtype=torch.int64, device=dev)
        self._temps = torch.ones(S, dtype=torch.float32, device=dev)

    def on_admit(self, h, full):
        """Prefill the draft's cache for the slot's whole history (prompt
        + replayed tokens), the counterpart of the target's prefill; the
        draft then continues from the TARGET's first sample."""
        from .engine import _prefill_impl
        eng = self.engine
        slot, n_eff = h.slot, len(full)
        Lb = eng._bucket(n_eff)
        eng.draft_buckets_seen.add(Lb)
        ids = np.zeros((1, Lb), np.int64)
        ids[0, :n_eff] = full
        with (_tracing.span("spec.draft_prefill", cat="serving",
                            trace_id=h.trace_id, request_id=h.request_id,
                            bucket=Lb)
              if _tracing._ENABLED else _NO_SPAN), torch.inference_mode():
            _prefill_impl(self.arch, self.kc, self.vc, self._keys,
                          torch.from_numpy(ids).to(eng.device), n_eff, slot,
                          0, 0, 1.0, eng._vmask[slot], do_sample=False,
                          top_k=0, top_p=None)
            self.tok[slot] = h.tokens[-1]
        self.cur[slot] = n_eff

    def propose_all(self, cand):
        """k+1 fused greedy draft decode steps over every slot in ``cand``
        at once; the first k outputs are the proposals (the last step
        writes the k-th proposal's K/V, so a full accept leaves no hole).
        A line at or past ``max_len`` (only steps whose proposals lie past
        the slot's cap) writes the cache's last line instead, which no
        accepted proposal reads."""
        from .engine import _decode_impl
        eng = self.engine
        if not cand:
            return {}
        S, T = eng.n_slots, eng.max_len
        active = np.zeros(S, bool)
        for h, _ in cand:
            active[h.slot] = True
        k = eng.spec.k
        outs = []
        with (_tracing.span("spec.draft", cat="serving", n_slots=len(cand),
                            k=k)
              if _tracing._ENABLED else _NO_SPAN), torch.inference_mode():
            act = torch.from_numpy(active).to(eng.device)
            for _ in range(k + 1):
                cur = torch.from_numpy(np.minimum(self.cur, T - 1)).to(
                    eng.device)
                self.tok = _decode_impl(
                    self.arch, self.kc, self.vc, self.tok, cur, act,
                    self._keys, self._temps, eng._vmask, do_sample=False,
                    top_k=0, top_p=None)
                outs.append(self.tok)
                self.cur += active
                eng.metrics.draft_steps += 1
            toks = torch.stack(outs[:k], dim=1).cpu().numpy()   # one sync
        eng.draft_decode_used = True
        return {h.slot: toks[h.slot].astype(np.int32) for h, _ in cand}

    def after_verify(self, h, last_tok, new_cur):
        """Rewind or advance the draft to the target's state after a
        verify: it feeds the last emitted (chain-sampled) token at the
        accepted length next. Draft lines past it sit beyond the causal
        bound and are rewritten before they can be read."""
        with torch.inference_mode():
            self.tok[h.slot] = last_tok
        self.cur[h.slot] = new_cur


def make_runtime(engine, cfg: SpecConfig):
    """The engine's draft runtime: the n-gram proposer, a custom host
    proposer (the ``propose`` protocol), or a model draft."""
    kind = cfg.draft_kind()
    if kind == "ngram":
        return _HostProposerAdapter(NgramProposer(cfg), by_handle=True)
    if kind == "custom":
        return _HostProposerAdapter(cfg.draft, by_handle=False)
    return _ModelDraft(engine, cfg.draft)
