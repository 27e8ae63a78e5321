"""Where the split-K flash-decode kernel's time goes, on one GPU.

    python tools/torch_decode_probe.py

At ``chip_smoke.py`` phase 7's shapes (S=8, H=n_kv=32, hd=128, bs=16,
bf16; the 512- and 4096-position tables, same seeds), times the kernel
(CUDA events, L2 flushed, median of 20: ``chip_smoke.time_ms``):

- at phase 7's write positions, with every slot full (its own full table
  of distinct blocks: ``decode_case`` deals the pool without overlap, so
  the byte bound counts only distinct rows), with every slot at position
  0 (one live block per (slot, kv head)), and with no slot attending
  anything (every block exits at once: the launch and the grid's fixed
  cost);
- at split lengths ``P`` other than ``split_plan``'s (``n_split =
  ceil(T / P)``, at most 16), each output held to the plain version under
  ``judge_decode``. The wrapper takes its plan from the module's
  ``split_plan``, so the sweep replaces that function for the call and
  restores it after.

Prints one JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.ops import flash_decode as fd  # noqa: E402

PLANS = {32: (64, 128, 256, 512), 256: (256, 512, 1024)}


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    plan = fd.split_plan
    res = {"device": torch.cuda.get_device_name(0), "smi": cs.smi_line()}
    for mb, nb, seed in ((32, 257, 40), (256, 8 * 256 + 1, 41)):
        q, kc, vc, tables, wp = cs.decode_case(8, 32, 32, 128, 16, mb, nb,
                                               torch.bfloat16, seed=seed)
        T = mb * 16
        out = res[f"T{T}"] = {"split_plan": plan(mb, 16)}
        full = cs.decode_case(8, 32, 32, 128, 16, mb, nb, torch.bfloat16,
                              seed=seed,
                              fixed=[(s, T - 1) for s in range(8)])[3:]
        for what, (t, w) in (("phase 7", (tables, wp)),
                             ("all full", full),
                             ("all at 0", (tables, torch.zeros_like(wp))),
                             ("none attended",
                              (tables, torch.full_like(wp, -1)))):
            keys = int((w.long() + 1).sum())
            out[what] = dict(
                positions=keys,
                bound_ms=2 * keys * 32 * 128 * 2 / cs.PEAK_BYTES * 1e3,
                ms=cs.time_ms(lambda: fd.flash_decode(q, kc, vc, t, w),
                              flush))
        want = fd.flash_decode_reference(q, kc, vc, tables, wp)
        for P in PLANS[mb]:
            fd.split_plan = lambda mb_, bs_, P=P: (P, -(-mb_ * bs_ // P))
            try:
                ok = cs.judge_decode(fd.flash_decode(q, kc, vc, tables, wp),
                                     want, wp, cs.DECODE_TOL[q.dtype])[2]
                out[f"P={P}"] = dict(ok=ok, ms=cs.time_ms(
                    lambda: fd.flash_decode(q, kc, vc, tables, wp), flush))
            finally:
                fd.split_plan = plan
        del q, kc, vc
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
