"""Sequence-parallel Llama training across GPUs over NCCL.

    python tools/torch_sep_train.py [--sep 4] [--steps 3]

Trains ``chip_smoke.SEP_CELL`` (``bench.py:bench_llama_long_context``'s
configuration: the 0.5B Llama, batch 1 x 8192, bf16, selective remat,
AdamW lr 1e-4; nothing cut) at world 1 on cuda:0, then under
``sep_degree=--sep`` with one NCCL process per GPU (cuda:rank), ring
then Ulysses, a warm-up and ``--steps`` steps each, every run from the
seed-0 weights (their fingerprint checked against world 1's). Each
rank's losses must be within ``chip_smoke.SEP_REL_TOL`` of world 1's,
its flash launches per step must equal ``chip_smoke.want_sep_launches``
(all on the tensor cores), and no ``ppermute`` may be staged through the
host (NCCL carries CUDA tensors). After the timed steps every run takes
one step under ``torch.profiler`` (``chip_smoke.profile_step``: device
busy against wall, the top kernels). Needs ``--sep`` GPUs. Prints one
JSON line: per mode and rank the step time (median of the timed steps),
tokens/s, peak memory and the worst loss difference, beside world 1's,
and the profiles of world 1 and of ranks 0 and ``sep - 1``, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
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


def _modules():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)
    return pt, optimizer, fleet, fa, fc, rm, LlamaConfig, LlamaForCausalLM


def _run(cfg, steps, tag, device):
    """A warm-up and ``steps`` steps of the cell on the current mesh, then
    a profiled one: (losses, seconds, launches per step, peak GiB, the
    initial weights' fingerprint, the profile)."""
    pt, optimizer, fleet, fa, fc, rm, _, LlamaForCausalLM = _modules()
    model, step = cs.llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                   pt.seed, device)
    fingerprint = cs.weights_fingerprint(model)
    ids, labels = cs.sep_batch(cfg.vocab_size, *cs.SEP_BATCH, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = cs.run_steps(fa, fc, rm, step, ids, steps + 1,
                                          tag=tag, labels=labels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = cs.profile_step(step, ids, labels)
    del step, model
    torch.cuda.empty_cache()
    return losses, secs, per_step, peak, fingerprint, prof


def _worker(workdir, cell, sep, steps, backend=None, device="cuda"):
    """One of ``sep`` ranks: the cell under ``sep_degree=sep``, ring then
    Ulysses, each from the seed-0 weights."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    _, _, fleet, _, _, _, LlamaConfig, _ = _modules()

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend=backend, timeout=900)
    rank = dist.get_rank()
    s = fleet.DistributedStrategy()
    s.hybrid_configs["sep_degree"] = sep
    fleet.init(is_collective=True, strategy=s)
    out = dict(rank=rank, backend=torch.distributed.get_backend(), modes={})
    for mode in cs.SEP_MODES:
        cfg = LlamaConfig(**{**cell, "sequence_parallel": True,
                             "sep_mode": mode})
        staged = C.host_staged["ppermute"]
        losses, secs, per_step, peak, fingerprint, prof = _run(
            cfg, steps, f"[rank {rank}, {mode}] ", device)
        out["modes"][mode] = dict(
            losses=losses, step_secs=secs, launches=per_step, peak_gib=peak,
            staged_ppermutes=C.host_staged["ppermute"] - staged,
            fingerprint=fingerprint, profile=prof)
    with open(os.path.join(workdir, f"sep.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def sep_train(sep, steps, cell=cs.SEP_CELL, workdir="build/sep_train",
              backend=None, device="cuda"):
    """World 1, then ``sep`` ranks; returns the report (raises on a
    check that fails)."""
    from paddle_tpu_torch import distributed as dist
    _, _, _, _, _, _, LlamaConfig, _ = _modules()
    cfg = LlamaConfig(**cell)
    layers, remat = cfg.num_hidden_layers, bool(cfg.remat)
    losses, secs, per_step, peak, fingerprint, prof = _run(
        cfg, steps, "world 1: ", device)
    want1 = cs.want_sep_launches(layers, 1, 0, "world 1", remat)
    if any(c != want1 for c in per_step):
        raise AssertionError(f"world 1 launched {per_step}, want {want1}")
    B, L = cs.SEP_BATCH
    t1 = float(np.median(secs[1:]))
    report = dict(smi=cs.smi_line(), gpus=torch.cuda.device_count(),
                  sep=sep, steps=steps,
                  world1=dict(step_ms=t1 * 1e3, tokens_per_s=B * L / t1,
                              peak_gib=peak, losses=losses, profile=prof),
                  modes={})
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        dist.spawn(_worker, args=(workdir, cell, sep, steps, backend,
                                  device), nprocs=sep, timeout=900)
        ranks = []
        for r in range(sep):
            with open(os.path.join(workdir, f"sep.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    for mode in cs.SEP_MODES:
        got = [rk["modes"][mode] for rk in ranks]
        worst = 0.0
        for r, g in enumerate(got):
            if g["fingerprint"] != fingerprint:
                raise AssertionError(f"{mode} rank {r}: the seed-0 weights "
                                     "differ from world 1's")
            worst = max(worst, max(abs(a - b) / abs(b)
                                   for a, b in zip(g["losses"], losses)))
            want = cs.want_sep_launches(layers, sep, r, mode, remat)
            if any(c != want for c in g["launches"]):
                raise AssertionError(f"{mode} rank {r} launched "
                                     f"{g['launches']}, want {want}")
            if g["staged_ppermutes"]:
                raise AssertionError(f"{mode} rank {r}: "
                                     f"{g['staged_ppermutes']} ppermutes "
                                     "staged through the host")
        if not worst <= cs.SEP_REL_TOL:
            raise AssertionError(f"{mode}: losses {worst:.3g} from world "
                                 f"1's (limit {cs.SEP_REL_TOL})")
        med = [float(np.median(g["step_secs"][1:])) for g in got]
        report["modes"][mode] = dict(
            backend=ranks[0]["backend"], max_rel_to_world1=worst,
            step_ms_per_rank=[m * 1e3 for m in med],
            tokens_per_s=B * L / max(med),
            peak_gib_per_rank=[g["peak_gib"] for g in got],
            launches_per_rank_step=[g["launches"][-1] for g in got],
            profiles={f"rank{r}": got[r]["profile"] for r in (0, sep - 1)})
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sep", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    if torch.cuda.device_count() < a.sep:
        print(f"needs {a.sep} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    report = sep_train(a.sep, a.steps)
    report["wall_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
