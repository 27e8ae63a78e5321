"""Paged flash-decode: wrapper of ``csrc/flash_decode.cu``.

Counterpart of ``paddle_tpu/ops/pallas/flash_decode.py:flash_decode``
(the TPU kernel this replaces). One-token attention for every serving
slot: q ``[S, H, hd]`` against the paged pools ``[n_blocks, block_size,
n_kv, hd]`` through the block tables ``[S, max_blocks]`` (int32),
attending positions ``<= write_pos[s]``. q's slot rows may lie apart
(GPT's q is a view of its fused qkv projection, rows ``3 * hidden``
apart): the kernels read it through its slot stride, no copy. GQA maps query head ``h`` onto kv
head ``h // (H // n_kv)``. Returns ``[S, H, hd]`` in q's dtype.

The TPU kernel's ``kv_heads_per_step`` tuner knob shaped its VMEM use; the
CUDA kernels have no counterpart.

Two kernels (``_variant``): ``"split"``, the split-K kernel, which every
operand takes -- each slot's view is cut into ``P``-position splits
(``split_plan``, from the table width alone), one block per (split, kv
head, slot), and the last block of a (slot, kv head) merges the splits'
fp32 partials by their max and sum in the same launch; and ``"one_pass"``, the first version (one block per
(slot, kv head)), which takes the same operands and is reached only by
forcing the variant (``chip_smoke.py`` times it beside the new one).

CUDA tensors launch a kernel or raise; CPU tensors take the plain
gathered version ``flash_decode_reference``, which is also the engine's
``flash_decode=False`` attention.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["flash_decode", "flash_decode_reference", "split_plan"]

# (head dim, H // n_kv) pairs the kernels are instantiated for, each in bf16
# and fp32: LLAMA_TINY's (32, 2), every GPT-2 size's (64, 1), Llama-2-7B's
# and 13B's (128, 1), and the GQA parity case (128, 4)
SHAPES = ((32, 2), (64, 1), (128, 1), (128, 4))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split kernel's chunk (positions staged at a time) and most splits per
# slot: csrc/flash_decode.cu's kRows and kMaxSplits, whose C entry rejects
# a plan that breaks them
CHUNK = 64
MAX_SPLITS = 16
_ENTRY = {"split": "flash_decode_split", "one_pass": "flash_decode"}
_ARGTYPES = {
    "split": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
    "one_pass": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]),
}
# per (device, stream): the split kernel's merge counters, one per (slot,
# kv head), zero between launches (the last block of each resets its own)
_counters: dict = {}


def split_plan(mb, bs):
    """``(P, n_split)`` of the split kernel for a table of ``mb`` blocks of
    ``bs`` positions: ``P`` is the fewest 64-position chunks that keep the
    split count at most ``MAX_SPLITS`` (64 up to 1,024 positions, then
    128, 192, ...), and ``n_split = ceil(mb * bs / P)`` (at least 1). ``P``
    need not be a multiple of ``bs``. Depends on the table's width only:
    no write position is read to the host."""
    T = mb * bs
    chunks = max(1, -(-T // CHUNK))
    P = CHUNK * -(-chunks // MAX_SPLITS)
    return P, max(1, -(-T // P))


def flash_decode_reference(q, kc_pool, vc_pool, tables, write_pos,
                           scale=None):
    """The gathered plain version (``paddle_tpu``'s
    ``flash_decode_reference``): each slot's contiguous view is gathered
    through its table row, scores in fp32 masked to ``-1e30`` past
    ``write_pos``, softmax, p cast to q's dtype before the PV product."""
    S, H, hd = q.shape
    n_kv = kc_pool.shape[2]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    tables = tables.long()
    kview = kc_pool[tables].reshape(S, -1, n_kv, hd)
    vview = vc_pool[tables].reshape(S, -1, n_kv, hd)
    kh = kview.repeat_interleave(H // n_kv, dim=2)          # [S, T, H, hd]
    vh = vview.repeat_interleave(H // n_kv, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kh.float()) * scale
    T = kview.shape[1]
    valid = (torch.arange(T, device=q.device)[None, :]
             <= write_pos.to(q.device)[:, None])
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", p, vh).to(q.dtype)


def check_supported(dtype, H, n_kv, hd):
    """Raise unless the kernel is built for this dtype, head count, kv-head
    count and head dim (``Engine(flash_decode=True)`` asks at construction,
    so an unsupported model fails before it admits a request)."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_decode: dtype {dtype}; the kernel takes bf16 "
                        "or fp32")
    if H % n_kv or (hd, H // n_kv) not in SHAPES:
        raise ValueError(f"flash_decode: head dim {hd} with H / n_kv = "
                         f"{H}/{n_kv}; the kernel is built for (head dim, "
                         f"group) in {SHAPES}")


def _check(q, kc_pool, vc_pool, tables, write_pos):
    ts = (q, kc_pool, vc_pool, tables, write_pos)
    if not all(t.is_cuda and t.device == q.device for t in ts):
        raise ValueError("flash_decode: every operand must be on q's CUDA "
                         "device")
    if not (q.dtype == kc_pool.dtype == vc_pool.dtype):
        raise TypeError(f"flash_decode: dtypes {q.dtype}/{kc_pool.dtype}/"
                        f"{vc_pool.dtype}; q and the pools must agree")
    if tables.dtype != torch.int32 or write_pos.dtype != torch.int32:
        raise TypeError("flash_decode: tables and write_pos must be int32")
    if q.dim() != 3 or kc_pool.dim() != 4 or vc_pool.shape != kc_pool.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, pools "
                         f"{tuple(kc_pool.shape)}/{tuple(vc_pool.shape)}")
    S, H, hd = q.shape
    _, _, n_kv, phd = kc_pool.shape
    if phd != hd or tables.dim() != 2 or tables.shape[0] != S \
            or tuple(write_pos.shape) != (S,):
        raise ValueError("flash_decode: q, pools, tables and write_pos "
                         "disagree in shape")
    check_supported(q.dtype, H, n_kv, hd)
    if q.stride(2) != 1 or q.stride(1) != hd or q.stride(0) < H * hd \
            or q.stride(0) * q.element_size() % 16:
        raise ValueError(f"flash_decode: q strides {q.stride()}; want each "
                         "slot's heads and dims contiguous and slot rows a "
                         "multiple of 16 bytes apart")
    for name, t in zip(("kc_pool", "vc_pool", "tables", "write_pos"), ts[1:]):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    for name, t in (("q", q), ("kc_pool", kc_pool), ("vc_pool", vc_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be 16-byte aligned")


def _variant(q, kc_pool):
    """The kernel for these operands: ``"split"`` for every operand the
    wrapper takes (it takes all that the first kernel takes).
    ``"one_pass"`` is reached only by forcing the variant."""
    return "split"


def _counter_buffer(device, stream, n):
    """Zeroed int32 counters, at least ``n``, of this device and stream
    (two streams never share them)."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


def flash_decode(q, kc_pool, vc_pool, tables, write_pos, scale=None):
    """One-token paged attention; see the module docstring."""
    if not q.is_cuda:
        return flash_decode_reference(q, kc_pool, vc_pool, tables, write_pos,
                                      scale=scale)
    _check(q, kc_pool, vc_pool, tables, write_pos)
    S, H, hd = q.shape
    _, bs, n_kv, _ = kc_pool.shape
    mb = tables.shape[1]
    if scale is None:
        scale = 1.0 / (hd ** 0.5)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    variant = _variant(q, kc_pool)
    fn = _build.load("flash_decode", _ENTRY[variant], _ARGTYPES[variant])
    args = (q.data_ptr(), kc_pool.data_ptr(), vc_pool.data_ptr(),
            tables.data_ptr(), write_pos.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "split":
            P, n_split = split_plan(mb, bs)
            part = cnt = None
            if n_split > 1:      # fp32 (acc [hd], m, l) per split and head
                part = torch.empty(S * H * n_split * (hd + 2),
                                   dtype=torch.float32, device=q.device)
                cnt = _counter_buffer(q.device, stream, S * n_kv)
            err = fn(*args, 0 if part is None else part.data_ptr(),
                     0 if cnt is None else cnt.data_ptr(), S, H, n_kv, hd,
                     bs, mb, P, n_split, q.stride(0), float(scale),
                     _DTYPES[q.dtype], stream)
        else:
            err = fn(*args, S, H, n_kv, hd, bs, mb, q.stride(0),
                     float(scale), _DTYPES[q.dtype], stream)
    _build.check(err, _ENTRY[variant])
    flash_decode.launches += 1
    flash_decode.launches_by_variant[variant] += 1
    return out


#: kernel launches since the count was last reset (CPU calls not counted)
flash_decode.launches = 0
flash_decode.launches_by_variant = {"split": 0, "one_pass": 0}
