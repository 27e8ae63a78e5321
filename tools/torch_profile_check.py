"""Does a GPU profile of the PyTorch port hold every kernel it ran?

    python tools/torch_profile_check.py [--runs 3]

Builds Llama-2-7B (bf16, random seeded weights, full width and depth) on
the GPU and serves ``chip_smoke.py`` phase 5's eight prompts (32 new
tokens each, staggered admission) through a fresh
``Engine(n_slots=8, max_len=512, block_size=16, flash_decode=True)`` under
``profiler.Profiler(targets=[ProfilerTarget.GPU])``, ``--runs`` times in
each of three arms, alternated:

- ``flush``: the profiler as shipped, whose window closes after
  ``_flush_device_records`` (a device sync, a forced CUPTI flush, a
  ``_SETTLE_S`` wait and another flush);
- ``once``: a device sync and one forced CUPTI flush;
- ``none``: a device sync alone.

Before them it profiles one run with CPU and CUDA activity and then
serves for ``--age`` seconds unprofiled, as ``chip_smoke.py`` does
between phase 11's profile and phase 27c: in a fresh process a window
lost fewer records.

For every run it reads the exported Chrome trace and prints one JSON
line: the CUDA launch and copy calls the trace holds, the kernel and copy
records it holds, the calls whose record is missing (split into those in
the first and in the second half of the run's calls), and the
``flash_decode_split_kernel`` records beside the wrapper's launch count.
Exits 1 if a ``flush`` run's flash-decode records differ from the
wrapper's count. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import glob
import json
import os
import shutil
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from paddle_tpu_torch import profiler, seed  # noqa: E402
from paddle_tpu_torch.ops import _build  # noqa: E402
from paddle_tpu_torch.ops import flash_decode as fd  # noqa: E402
from paddle_tpu_torch.profiler.statistic import kernel_name  # noqa: E402
from paddle_tpu_torch.serving import Engine  # noqa: E402
from paddle_tpu_torch.text.models.llama import (  # noqa: E402
    LLAMA2_7B, LlamaForCausalLM)

#: the window's close in the arms that replace the flush
def _flush_once():
    import ctypes

    torch.cuda.synchronize()
    ctypes.CDLL("libcupti.so.12", mode=os.RTLD_NOLOAD).cuptiActivityFlushAll(
        profiler._CUPTI_FLUSH_FORCED)


ARMS = {"once": _flush_once, "none": torch.cuda.synchronize}
_CALLS = ("cuda_runtime", "cuda_driver")
_RECORDS = ("kernel", "gpu_memcpy", "gpu_memset")


def completeness(trace_path):
    """The trace's launch/copy calls, its device records, and the calls
    whose record is missing, by half of the run."""
    with open(trace_path) as f:
        evs = json.load(f)["traceEvents"]
    recs = {e["args"].get("correlation"): kernel_name(e["name"])
            for e in evs if e.get("ph") == "X" and e.get("cat") in _RECORDS}
    calls = sorted(e["args"]["correlation"] for e in evs
                   if e.get("ph") == "X" and e.get("cat") in _CALLS
                   and any(k in e["name"]
                           for k in ("Launch", "Memcpy", "Memset")))
    missing = [i for i, c in enumerate(calls) if c not in recs]
    half = len(calls) // 2
    return dict(
        calls=len(calls), records=len(recs),
        missing_first_half=sum(1 for i in missing if i < half),
        missing_second_half=sum(1 for i in missing if i >= half),
        flash_decode_records=sum(1 for n in recs.values()
                                 if n == "flash_decode_split_kernel"))


def one_run(model, prompts, arm, workdir):
    import chip_smoke as cs

    shutil.rmtree(workdir, ignore_errors=True)
    eng = Engine(model, **cs.SERVE_GEO, flash_decode=True)
    gc.collect()
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.GPU],
        on_trace_ready=profiler.export_chrome_tracing(workdir, "check"))
    prof.start()
    torch.cuda.synchronize()
    cs.reset_counts(fd.flash_decode)
    cs.staggered(eng, prompts, 32)
    launches = fd.flash_decode.launches
    shipped = profiler._flush_device_records
    if arm != "flush":
        profiler._flush_device_records = ARMS[arm]
    try:
        prof.stop()
    finally:
        profiler._flush_device_records = shipped
    rec = completeness(glob.glob(os.path.join(workdir, "*.json"))[0])
    shutil.rmtree(workdir, ignore_errors=True)
    return dict(arm=arm, wrapper_launches=launches, **rec)


def main():
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--age", type=float, default=60.0)
    ap.add_argument("--workdir", default="build/profile_check")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_check: CUDA is not available", file=sys.stderr)
        return 1
    smi = cs.smi_line()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _build.build(["flash_decode"])
    seed(0)
    model = LlamaForCausalLM(LLAMA2_7B, device="cuda")
    prompts = cs.workload(model.config.vocab_size, seed=1)
    cs.profile_decode_step(model, Engine, prompts, flash_decode=True)
    eng = Engine(model, **cs.SERVE_GEO, flash_decode=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.age:
        cs.staggered(eng, prompts, 32)
    del eng
    bad = 0
    for i in range(args.runs):
        for arm in ("flush", "once", "none"):
            r = one_run(model, prompts, arm, args.workdir)
            r.update(run=i, device=smi)
            print(json.dumps(r), flush=True)
            if arm == "flush" and \
                    r["flash_decode_records"] != r["wrapper_launches"]:
                bad += 1
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
