"""Where a decode step of the PyTorch port's serving engine spends its time.

    python tools/torch_profile_engine.py
        [--trace build/engine_decode_trace.json]

Builds Llama-2-7B (bf16, random seeded weights, full width and depth) on
the GPU, admits 8 requests sharing a 64-token prefix into
``Engine(n_slots=8, max_len=512, block_size=16, flash_decode=True)``,
warms up, then traces ``STEPS`` decode steps with ``torch.profiler``
(CPU + CUDA). Prints one JSON line: step wall time (host clock), device
busy time and idle share over the window, kernel launches per step, the
flash-decode kernel's device time per step and the variants it ran, and
the device time of the top kernels by name; writes the Chrome trace to
``--trace``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import seed  # noqa: E402
from paddle_tpu_torch.ops import flash_decode as fd  # noqa: E402
from paddle_tpu_torch.serving import Engine  # noqa: E402
from paddle_tpu_torch.text.models.llama import (LLAMA2_7B,  # noqa: E402
                                                LlamaForCausalLM)

STEPS = 10                                   # traced decode steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="build/engine_decode_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    cfg = LLAMA2_7B
    seed(0)
    model = LlamaForCausalLM(cfg, device="cuda")
    eng = Engine(model, n_slots=8, max_len=512, block_size=16,
                 flash_decode=True)
    rng = np.random.default_rng(1)
    sys_p = rng.integers(0, cfg.vocab_size, 64)
    for n in (16, 40, 64, 96, 128, 160, 192, 24):
        eng.submit(np.concatenate([sys_p, rng.integers(0, cfg.vocab_size,
                                                       n)]),
                   max_new_tokens=STEPS + 8)
    for _ in range(4):                       # warm-up decode steps
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, launches = {}, 0
    for e in prof.key_averages():
        # device-side events only (the aten ops that launch them carry the
        # same time again)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.self_device_time_total
            kernels[e.key] = kernels.get(e.key, 0.0) + us
            launches += e.count
    busy_ms = sum(kernels.values()) / 1e3
    decode_ms = sum(v for k, v in kernels.items() if "flash_decode" in k) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "layers": cfg.num_hidden_layers, "steps": STEPS,
        "step_wall_ms": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy_ms / STEPS,
        "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
        "kernel_launches_per_step": launches / STEPS,
        "flash_decode_ms_per_step": decode_ms / STEPS,
        "flash_decode_launches": dict(fd.flash_decode.launches_by_variant),
        "top_kernels_ms_per_step": {k: v / 1e3 / STEPS
                                    for k, v in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
