"""Pipeline-parallel Llama-2-7B training across GPUs over NCCL.

    python tools/torch_pp_train.py [--pp 4] [--steps 3]

The configuration pipeline parallel exists for: ``LlamaForCausalLMPipe``
at Llama-2-7B's published widths and full 32 layers (``LLAMA2_7B``:
bf16, untied), AdamW(lr=1e-4, wd=0.01, multi_precision) as
``chip_smoke.py``'s trainers, one NCCL process per GPU (cuda:rank),
``pp_degree=--pp``, each rank holding its 32/pp layers. Three runs, a
warm-up and ``--steps`` steps each, on one repeated batch:

1. against world 1: phase 8's 8-layer trainer (``LlamaForCausalLM``,
   fused head, batch 2 x 2048 of ``chip_smoke.train_ids``) at world 1 on
   cuda:0, then the same weights stacked into an 8-layer
   ``LlamaForCausalLMPipe`` under pp (1F1B, 2 micro-batches): every
   rank's losses within ``chip_smoke.PP_REL_TOL`` of world 1's;
2. the full model, 1F1B (``make_1f1b_train_step``), batch 8 x 2048 (ids
   then labels from ``default_rng(0)``), 8 micro-batches: the loss
   finite, its first value within 1.0 of ln 32000 and falling; rows 1-3
   launches per rank and step equal to ``chip_smoke.want_pp_launches``
   (all on the tensor cores); at most ``pp - stage`` micro-batches in
   flight; no point-to-point call staged through the host; peak memory
   below the card's; then one step under ``torch.profiler``
   (``chip_smoke.profile_step``) on every rank;
3. the full model, GPipe (``make_train_step``), the same weights and
   batch: losses within ``PP_REL_TOL`` of 1F1B's.

Needs ``--pp`` GPUs. Prints one JSON line: per run and rank the step time
(median of the timed steps), tokens/s, peak memory, launches and
micro-batches in flight, the profiles of ranks 0 and ``pp - 1``, with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

FULL_BATCH, FULL_MICRO = (8, 2048), 8
CUT_LAYERS, CUT_MICRO = cs.PHASE8_LAYERS, 2


def _modules():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models import (LLAMA2_7B, LlamaForCausalLM,
                                              LlamaForCausalLMPipe)
    return (pt, optimizer, fleet, fa, fc, rm, LLAMA2_7B, LlamaForCausalLM,
            LlamaForCausalLMPipe)


def stacked_from_llama(model):
    """A ``LlamaForCausalLM``'s weights under ``LlamaForCausalLMPipe``'s
    names: each decoder weight stacked over the layers (both packages
    keep ``[in, out]``)."""
    names = dict(wq="self_attn.q_proj", wk="self_attn.k_proj",
                 wv="self_attn.v_proj", wo="self_attn.o_proj",
                 wg="mlp.gate_proj", wu="mlp.up_proj", wd="mlp.down_proj",
                 ln1="input_layernorm", ln2="post_attention_layernorm")
    layers = model.llama.layers
    out = {k: torch.stack([layer.get_submodule(v).weight.detach()
                           for layer in layers])
           for k, v in names.items()}
    out["embed_tokens.weight"] = model.llama.embed_tokens.weight.detach()
    out["norm.weight"] = model.llama.norm.weight.detach()
    out["lm_head.weight"] = model.lm_head.weight.detach()
    return out


def _steps(step, ids, labels, steps, tag):
    """A warm-up and ``steps`` steps: (losses, seconds, launches per step,
    micro-batches in flight, host-staged point-to-point calls a step,
    peak GiB)."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import pipeline as pl
    _, _, _, fa, fc, rm, _, _, _ = _modules()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    staged = C.host_staged["batch_isend_irecv"]
    losses, secs, per_step = cs.run_steps(fa, fc, rm, step, ids, steps + 1,
                                          tag=tag, labels=labels)
    return dict(losses=losses, step_secs=secs, launches=per_step,
                max_in_flight=pl.counters["max_in_flight"],
                staged_p2p=C.host_staged["batch_isend_irecv"] - staged,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _worker(workdir, pp, steps, cut_layers, full_cfg, backend=None):
    """One of ``pp`` ranks: the cut model from phase 8's weights (1F1B),
    then the full model under 1F1B (and a profiled step) and GPipe, each
    from the seed-0 weights."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.framework.device import resolve_device
    (pt, optimizer, fleet, _, _, _, _, LlamaForCausalLM,
     LlamaForCausalLMPipe) = _modules()
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend=backend, timeout=1800)
    dev = resolve_device(None)          # cuda:LOCAL_RANK
    rank = dist.get_rank()
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = pp
    fleet.init(is_collective=True, strategy=s)
    stage = fleet.get_hybrid_communicate_group().get_stage_id()
    out = dict(rank=rank, stage=stage, backend=torch.distributed.get_backend(),
               runs={})

    def train(model, schedule, n_micro, ids, labels, tag, profile=False):
        model = fleet.distributed_model(model)
        adam = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                               parameters=model.parameters())
        step = (fleet.make_1f1b_train_step(model, adam, n_micro=n_micro)
                if schedule == "1f1b" else
                fleet.distributed_optimizer(adam).make_train_step(
                    model, lambda m, x, y: m(x, labels=y)))
        r = _steps(step, ids, labels, steps, tag)
        r["held_layers"] = model.wq.shape[0]
        if profile:
            r["profile"] = cs.profile_step(step, ids, labels)
        del step, model, adam
        torch.cuda.empty_cache()
        return r

    # 1. phase 8's weights, stacked, under pp
    cut = dataclasses.replace(full_cfg, num_hidden_layers=cut_layers)
    pt.seed(0)
    ref = LlamaForCausalLM(dataclasses.replace(cut, fused_ce_chunk=8192),
                           device=dev)
    weights = stacked_from_llama(ref)
    del ref
    model = LlamaForCausalLMPipe(cut, n_micro=CUT_MICRO, device=dev)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
    del weights
    ids = cs.train_ids(cut.vocab_size, *cs.PHASE8_BATCH).to(dev)
    out["runs"]["cut_1f1b"] = train(model, "1f1b", CUT_MICRO, ids, ids,
                                    f"[rank {rank}, 8 layers] ")
    # 2-3. the full model from seed 0
    ids, labels = cs.sep_batch(full_cfg.vocab_size, *FULL_BATCH, device=dev)
    for schedule in ("1f1b", "gpipe"):
        pt.seed(0)
        model = LlamaForCausalLMPipe(full_cfg, n_micro=FULL_MICRO,
                                     device=dev)
        out["runs"][schedule] = train(
            model, schedule, FULL_MICRO, ids, labels,
            f"[rank {rank}, {schedule}] ", profile=schedule == "1f1b")
    with open(os.path.join(workdir, f"pp.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _check_run(name, got, ref_losses, want_launches, pp, n_micro, schedule):
    """The checks of a run on every rank; returns the worst loss
    difference from ``ref_losses`` (None: not compared)."""
    worst = None
    for r, g in enumerate(got):
        stage = g["stage"]
        if ref_losses is not None:
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(g["losses"], ref_losses))
            worst = rel if worst is None else max(worst, rel)
            if not rel <= cs.PP_REL_TOL:
                raise AssertionError(f"{name} rank {r}: losses "
                                     f"{g['losses']} vs {ref_losses}")
        if any(c != want_launches for c in g["launches"]):
            raise AssertionError(f"{name} rank {r} launched "
                                 f"{g['launches']}, want {want_launches}")
        cap = min(pp - stage, n_micro) if schedule == "1f1b" else n_micro
        if g["max_in_flight"] != cap:
            raise AssertionError(f"{name} rank {r}: {g['max_in_flight']} "
                                 f"micro-batches in flight, want {cap}")
        if g["staged_p2p"]:
            raise AssertionError(f"{name} rank {r}: {g['staged_p2p']} "
                                 "point-to-point calls staged through "
                                 "the host")
    return worst


def pp_train(pp, steps, cfg=None, cut_layers=CUT_LAYERS,
             workdir="build/pp_train", backend=None):
    """World 1 (phase 8's trainer), then ``pp`` ranks; returns the report
    (raises on a check that fails)."""
    from paddle_tpu_torch import distributed as dist
    (pt, optimizer, fleet, fa, fc, rm, LLAMA2_7B, LlamaForCausalLM,
     _) = _modules()
    cfg = cfg or LLAMA2_7B
    cut = dataclasses.replace(cfg, num_hidden_layers=cut_layers,
                              fused_ce_chunk=8192)
    model, step = cs.llama_trainer(LlamaForCausalLM, cut, fleet, optimizer,
                                   pt.seed)
    ids = cs.train_ids(cut.vocab_size, *cs.PHASE8_BATCH)
    world1 = _steps(step, ids, ids, steps, "world 1, 8 layers: ")
    del step, model
    torch.cuda.empty_cache()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        dist.spawn(_worker, args=(workdir, pp, steps, cut_layers, cfg,
                                  backend), nprocs=pp, timeout=3000)
        ranks = []
        for r in range(pp):
            with open(os.path.join(workdir, f"pp.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    layers = cfg.num_hidden_layers
    report = dict(smi=cs.smi_line(), gpus=torch.cuda.device_count(), pp=pp,
                  steps=steps, backend=ranks[0]["backend"],
                  world1_cut=dict(losses=world1["losses"],
                                  step_ms=float(np.median(
                                      world1["step_secs"][1:])) * 1e3),
                  runs={})
    runs = dict(cut_1f1b=(cut_layers, CUT_MICRO, cs.PHASE8_BATCH, "1f1b"),
                **{s: (layers, FULL_MICRO, FULL_BATCH, s)
                   for s in ("1f1b", "gpipe")})
    for name, (n_layers, n_micro, (B, L), schedule) in runs.items():
        got = [dict(rk["runs"][name], stage=rk["stage"]) for rk in ranks]
        ref = (world1["losses"] if name == "cut_1f1b" else
               ranks[0]["runs"]["1f1b"]["losses"] if name == "gpipe"
               else None)
        worst = _check_run(name, got, ref,
                           cs.want_pp_launches(n_layers // pp, n_micro), pp,
                           n_micro, schedule)
        for r, g in enumerate(got):
            if g["held_layers"] != n_layers // pp:
                raise AssertionError(f"{name} rank {r} holds "
                                     f"{g['held_layers']} layers")
            if g["peak_gib"] * 2**30 >= torch.cuda.get_device_properties(
                    0).total_memory:
                raise AssertionError(f"{name} rank {r}: peak "
                                     f"{g['peak_gib']} GiB")
        losses = got[0]["losses"]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        if name == "1f1b":
            if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
                raise AssertionError(f"first loss {losses[0]} not within "
                                     f"1.0 of ln({cfg.vocab_size})")
            if not losses[1] > losses[2] > losses[3]:
                raise AssertionError(f"loss does not fall: {losses[1:]}")
        med = [float(np.median(g["step_secs"][1:])) for g in got]
        report["runs"][name] = dict(
            layers=n_layers, n_micro=n_micro, batch=[B, L],
            schedule=schedule, losses=losses, max_rel_to_ref=worst,
            step_ms_per_rank=[m * 1e3 for m in med],
            tokens_per_s=B * L / max(med),
            peak_gib_per_rank=[g["peak_gib"] for g in got],
            max_in_flight_per_rank=[g["max_in_flight"] for g in got],
            launches_per_rank_step=[g["launches"][-1] for g in got],
            bubble_share=(pp - 1) / (n_micro + pp - 1))
        if "profile" in got[0]:
            report["runs"][name]["profiles"] = {
                f"rank{r}": got[r]["profile"] for r in (0, pp - 1)}
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    if torch.cuda.device_count() < a.pp:
        print(f"needs {a.pp} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    report = pp_train(a.pp, a.steps)
    report["wall_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
