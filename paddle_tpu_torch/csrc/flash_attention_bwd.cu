// Flash attention backward: dq and dk/dv recomputed tile by tile from the
// forward's log-sum-exp, never writing the [Lq, Lk] probabilities to
// device memory.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/flash_attention.py:
// _bwd_dq_kernel (pallas_call at :279) and _bwd_dkv_kernel (pallas_call at
// :306). Same contract: q/dO [B, Lq, Hq, D], k/v [B, Lk, Hkv, D] (paddle
// layout, read through strides with a contiguous head dim); lse and
// delta = rowsum(dO * O) are fp32 [B, Hq, Lq]; causal is bottom-right
// aligned (query row i sees keys j <= i + Lk - Lq). Both kernels recompute
//     p  = exp(s - lse)            (0 where masked)
//     ds = p * (dO.V^T - delta) * scale
// and accumulate in fp32:
//     dq = ds.K                    (ds rounded to K's dtype first)
//     dk = ds^T.Q, dv = p^T.dO     (ds, p rounded to the operands' dtype)
// as the TPU kernels do. A fully masked row (lse = -0.7 * FLT_MAX) has
// p = 0 everywhere, so it contributes zero gradients, never NaN.
//
// What bounds them on the H100: operations. Per visible (query, key) pair
// dq does 6 * D FLOPs (s, dO.V^T, ds.K) and dk/dv 8 * D (s, dO.V^T, ds^T.Q,
// p^T.dO), against ~4 * (Lq + Lk) * D elements read, so at the training
// shapes (L = 2048, D = 128) they sit far above the card's ~295 FLOPs per
// byte.
//
// Two variants of each kernel, chosen by the wrapper
// (ops/flash_attention.py:_bwd_variant) before the launch from dtype,
// strides, alignment and head dim alone:
//
// tensor cores (flash_attention_bwd_{dq,dkv}_tc, bf16, D = 32, 64, 128), the
// main path's variant, built as the forward's (flash_attention_fwd.cu):
// TMA loads through 4-d tensor maps over the operands' strides (strided
// q/k/v/dO cost no copy) into 128-byte-swizzled shared memory (64-byte at
// D = 32), each ring stage guarded by a full and an empty mbarrier, and
// wgmma m64nNk16 with fp32 accumulators in registers:
//  - dq: 128 query rows of one (batch, query head), two consumer
//    warpgroups of 64 rows plus a producer warp whose first thread loads
//    Q and dO once and keeps a 2-stage ring of 64-key K/V tiles full.
//    S = Q K^T and dP = dO V^T are wgmma from shared memory (K and V are
//    [keys, D] with D contiguous: K-major B operands); p = 2^(s scale log2e
//    - lse log2e) and ds on the accumulator registers; ds rounded to bf16
//    in registers is the A operand of dQ += dS K (the accumulator's layout
//    is the A fragment's), K read MN-major, one m64n64 (n32 at D = 32) per
//    panel of D. Key tiles wholly above the causal diagonal are never
//    loaded (nor computed by a warpgroup whose rows they are above);
//    blocks with the most tiles start first; dQ is stored as bf16 straight
//    from the registers. S, dP and dQ take ~155 registers a thread at
//    D = 128, inside the 168 that 9 warps leave each;
//  - dk/dv: 128 keys of one (batch, kv head), two warpgroups of 64 keys
//    and no producer warp: dK, dV, S^T and dP^T take 192 registers a
//    thread at D = 128, so the block keeps to 8 warps, which may hold 255
//    (with a producer warpgroup handing registers over by setmaxnreg,
//    ptxas still spilled and serialized the wgmmas, warning C7512). K and
//    V stay in shared memory. The ring walks the query heads of the GQA
//    group and, for each, the 64-row query tiles that see the block's
//    keys (the first holds row k0 - (Lk - Lq)); warp 0 fills it: its
//    lanes stage each tile's lse (as lse log2e) and delta with plain loads
//    (a row of [B Hq, Lq] fp32 is not 16-byte aligned for every Lq) and
//    lane 0 TMA-loads Q and dO, first for the first two tiles and then
//    into each stage as soon as both warpgroups have released it.
//    S^T = K Q^T and dP^T = V dO^T are wgmma from shared memory; P^T and
//    dS^T, formed on the accumulators and rounded to bf16, are the A
//    operands of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major). A
//    warpgroup whose keys a query tile cannot see only releases it, in
//    ring order. The group's sum stays inside the block: no atomics,
//    deterministic. dK and dV are stored once, after the whole group;
//  - tile descriptors are made where they are used (hopper::desc_at), not
//    hoisted out of the loops where they would hold registers;
//  - masked scores are -inf by a predicate, not a branch or a select on p
//    (which made ptxas serialize the wgmmas, warning C7520); the row term
//    lse log2e is kept finite (a row that sees no key has lse =
//    -0.7 FLT_MAX, whose product with log2e overflows), so masked entries
//    give p = 0 exactly; TMA loads the ragged edges as zeros.
//
// CUDA cores (flash_attention_bwd_{dq,dkv}, fp32 and bf16): the first
// version. Every fp32 call takes it (the tensor cores would round fp32 to
// TF32, and the fp32 checks need full fp32 products), and bf16 where TMA
// cannot read the operands or D = 256 (dK and dV alone would take 256
// registers a thread):
//  - dq: one block per (query tile, batch * query head); a loop inside the
//    block walks the visible key tiles (the TPU's sequential grid axis),
//    staging 32 keys of K and V in shared memory (fp32) so every query row
//    of the block shares each load. Tiles wholly above the causal diagonal
//    are never loaded.
//  - dk/dv: one block per (key tile, batch * kv head); it loops over the
//    query heads of its kv head and over the query tiles that see its
//    keys, staging 32 rows of Q and dO (plus their lse and delta). Summing
//    the GQA group inside the block replaces the TPU's per-query-head
//    output and its group sum in XLA; no two blocks write the same rows,
//    so there are no atomics and no race.
//  - a row is shared by a group of lanes (4, or 8 at D = 256, which keeps
//    each lane at <= 32 head dims, so the dk/dv kernel's four row
//    accumulators stay in registers); the group reduces its partial dot
//    products with shuffles, and its shared-memory reads of one staged row
//    hit consecutive banks;
//  - the ragged Lq/Lk edges are masked in the kernels (no padding copy as
//    in _bwd); rows past the edge are computed but never stored;
//  - the products are plain fp32 FMAs on the CUDA cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // keys (dq) / query rows (dk/dv)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Strides {           // element strides of a [B, L, H, D] operand
  long long b, l, h;
};

template <int D>
struct Layout {
  static constexpr int kLanes = D >= 256 ? 8 : 4;  // lanes sharing a row
  static constexpr int kRows = kThreads / kLanes;  // rows a block owns
  static constexpr int kDpt = D / kLanes;          // head dims per lane
};

template <int kLanes>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Lq, int Lk, int Hq, int Hkv, Strides qs, Strides ks,
                    Strides vs, Strides os, int causal, float scale) {
  constexpr int kLanes = Layout<D>::kLanes;
  constexpr int kRows = Layout<D>::kRows;
  constexpr int kDpt = Layout<D>::kDpt;
  extern __shared__ float smem[];
  float* Ks = smem;                       // [kTile][D]
  float* Vs = smem + kTile * D;           // [kTile][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid / kLanes, t = tid % kLanes;
  const int row = q0 + r;
  const int offset = Lk - Lq;
  const bool row_in = row < Lq;

  float qr[kDpt], dor[kDpt], acc[kDpt];
  const T* qp = q + b * qs.b + (long long)row * qs.l + h * qs.h;
  const T* op = dout + b * os.b + (long long)row * os.l + h * os.h;
#pragma unroll
  for (int e = 0; e < kDpt; ++e) {
    qr[e] = row_in ? to_f(qp[t + kLanes * e]) : 0.f;
    dor[e] = row_in ? to_f(op[t + kLanes * e]) : 0.f;
    acc[e] = 0.f;
  }
  const long long srow = ((long long)b * Hq + h) * Lq + row;
  const float lse_r = row_in ? lse[srow] : 0.f;
  const float delta_r = row_in ? delta[srow] : 0.f;

  // key tiles with any key at or below the block's last row's diagonal
  int n_tiles = (Lk + kTile - 1) / kTile;
  if (causal) {
    const int last = q0 + kRows - 1 + offset;          // last visible key
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kTile + 1);
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;
    for (int e = tid; e < kTile * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Lk;
      Ks[e] = in ? to_f(kb[(long long)(k0 + j) * ks.l + d]) : 0.f;
      Vs[e] = in ? to_f(vb[(long long)(k0 + j) * vs.l + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      const float* kr = Ks + j * D + t;
      const float* vr = Vs + j * D + t;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < kDpt; ++e) {
        s += qr[e] * kr[kLanes * e];
        dp += dor[e] * vr[kLanes * e];
      }
      s = lane_sum<kLanes>(s);
      dp = lane_sum<kLanes>(dp);
      const int key = k0 + j;
      const bool valid =
          row_in && key < Lk && (!causal || key <= row + offset);
      const float p = valid ? expf(s * scale - lse_r) : 0.f;
      const float ds = round_to<T>(p * (dp - delta_r) * scale);
#pragma unroll
      for (int e = 0; e < kDpt; ++e) acc[e] += ds * kr[kLanes * e];
    }
    __syncthreads();
  }

  if (row_in) {
    T* dst = dq + (((long long)b * Lq + row) * Hq + h) * D;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) dst[t + kLanes * e] = from_f<T>(acc[e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, int Hq, int Hkv,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     int causal, float scale) {
  constexpr int kLanes = Layout<D>::kLanes;
  constexpr int kRows = Layout<D>::kRows;
  constexpr int kDpt = Layout<D>::kDpt;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kTile][D]
  float* Os = smem + kTile * D;           // [kTile][D] of dO
  float* Ls = Os + kTile * D;             // [kTile] lse
  float* Es = Ls + kTile;                 // [kTile] delta

  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid / kLanes, t = tid % kLanes;
  const int key = k0 + r;
  const int offset = Lk - Lq;
  const bool key_in = key < Lk;

  float kr[kDpt], vr[kDpt], dka[kDpt], dva[kDpt];
  const T* kp = k + b * ks.b + (long long)key * ks.l + hk * ks.h;
  const T* vp = v + b * vs.b + (long long)key * vs.l + hk * vs.h;
#pragma unroll
  for (int e = 0; e < kDpt; ++e) {
    kr[e] = key_in ? to_f(kp[t + kLanes * e]) : 0.f;
    vr[e] = key_in ? to_f(vp[t + kLanes * e]) : 0.f;
    dka[e] = 0.f;
    dva[e] = 0.f;
  }

  // causal: query row i sees key j iff i >= j - offset, so the query tiles
  // before the one holding row k0 - offset see none of this block's keys
  const int first = causal ? max(0, k0 - offset) : 0;
  const int n_qt = (Lq + kTile - 1) / kTile;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * os.b + h * os.h;
    const float* lb = lse + ((long long)b * Hq + h) * Lq;
    const float* eb = delta + ((long long)b * Hq + h) * Lq;
    for (int it = first / kTile; it < n_qt; ++it) {
      const int i0 = it * kTile;
      for (int e = tid; e < kTile * D; e += kThreads) {
        const int i = e / D, d = e % D;
        const bool in = i0 + i < Lq;
        Qs[e] = in ? to_f(qb[(long long)(i0 + i) * qs.l + d]) : 0.f;
        Os[e] = in ? to_f(ob[(long long)(i0 + i) * os.l + d]) : 0.f;
      }
      if (tid < kTile) {
        const bool in = i0 + tid < Lq;
        Ls[tid] = in ? lb[i0 + tid] : 0.f;
        Es[tid] = in ? eb[i0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        const float* qrow = Qs + i * D + t;
        const float* orow = Os + i * D + t;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int e = 0; e < kDpt; ++e) {
          s += kr[e] * qrow[kLanes * e];
          dp += vr[e] * orow[kLanes * e];
        }
        s = lane_sum<kLanes>(s);
        dp = lane_sum<kLanes>(dp);
        const int qi = i0 + i;
        const bool valid =
            key_in && qi < Lq && (!causal || key <= qi + offset);
        const float p = valid ? expf(s * scale - Ls[i]) : 0.f;
        const float ds = p * (dp - Es[i]) * scale;
        const float pr = round_to<T>(p), dsr = round_to<T>(ds);
#pragma unroll
        for (int e = 0; e < kDpt; ++e) {
          dva[e] += pr * orow[kLanes * e];
          dka[e] += dsr * qrow[kLanes * e];
        }
      }
      __syncthreads();
    }
  }

  if (key_in) {
    const long long o = (((long long)b * Lk + key) * Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) {
      dk[o + t + kLanes * e] = from_f<T>(dka[e]);
      dv[o + t + kLanes * e] = from_f<T>(dva[e]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, Lq, Lk, Hq, Hkv;
  Strides qs, ks, vs, os;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const size_t smem = 2 * kTile * D * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = Layout<D>::kRows;
  const dim3 grid((a.Lq + rows - 1) / rows, a.B * a.Hq);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.Lq, a.Lk, a.Hq, a.Hkv, a.qs, a.ks,
      a.vs, a.os, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = (2 * kTile * D + 2 * kTile) * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int rows = Layout<D>::kRows;
  const dim3 grid((a.Lk + rows - 1) / rows, a.B * a.Hkv);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dk), static_cast<T*>(dv), a.Lq, a.Lk, a.Hq,
      a.Hkv, a.qs, a.ks, a.vs, a.os, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dq_t(const Args& a, int D, void* dq) {
  switch (D) {
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: return launch_dq<T, 64>(a, dq);
    case 128: return launch_dq<T, 128>(a, dq);
    case 256: return launch_dq<T, 256>(a, dq);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_t(const Args& a, int D, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: return launch_dkv<T, 64>(a, dk, dv);
    case 128: return launch_dkv<T, 128>(a, dk, dv);
    case 256: return launch_dkv<T, 256>(a, dk, dv);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int Lq, int Lk,
               int Hq, int Hkv, const long long* st, int causal, float scale,
               void* stream) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, Lq, Lk, Hq, Hkv,
              Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
              Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
              causal, scale, static_cast<cudaStream_t>(stream)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/dout are device pointers with
// element strides (batch, seq, head) and a contiguous head dim; lse and
// delta are contiguous fp32 [B, Hq, Lq]; dq is a contiguous
// [B, Lq, Hq, D], dk/dv contiguous [B, Lk, Hkv, D]. Each returns
// cudaGetLastError() after its launch.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Lq, int Lk,
    int Hq, int Hkv, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, int causal, float scale, int dtype, void* stream) {
  if (B == 0 || Lq == 0) return cudaGetLastError();
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, Lq, Lk, Hq, Hkv, st,
                           causal, scale, stream);
  const cudaError_t err = dtype == 1 ? dq_t<__nv_bfloat16>(a, D, dq)
                                     : dq_t<float>(a, D, dq);
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Lq,
    int Lk, int Hq, int Hkv, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int causal, float scale, int dtype,
    void* stream) {
  if (B == 0 || Lk == 0) return cudaGetLastError();
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, Lq, Lk, Hq, Hkv, st,
                           causal, scale, stream);
  const cudaError_t err = dtype == 1 ? dkv_t<__nv_bfloat16>(a, D, dk, dv)
                                     : dkv_t<float>(a, D, dk, dv);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variants (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

constexpr float kLog2e = 1.4426950408889634f;

template <int D, bool DKV = false>
struct BwdCfg {
  static constexpr int kSwizzle = D == 32 ? 64 : 128;   // bytes per row
  static constexpr int kPanel = kSwizzle / 2;           // bf16 per row
  static constexpr int kPanels = D / kPanel;            // panels of D
  static constexpr int kGroups = 2;                     // consumer WGs
  // dq: query rows per block; dk/dv: keys per block (resident operands)
  static constexpr int kRows = 64 * kGroups;
  // dq: keys per ring tile; dk/dv: query rows per ring tile
  static constexpr int kTile = 64;
  static constexpr int kStages = 2;
  // dq: + a producer warp (9 warps: ptxas caps a thread at 168 registers,
  // above dq's ~155); dk/dv: 8 warps, up to 255 registers a thread (its
  // dK, dV, S^T and dP^T alone take 192), its first warp feeding the ring
  static constexpr int kThreads = 128 * kGroups + (DKV ? 0 : 32);
  static constexpr int kBlockBytes = kPanels * kRows * kSwizzle;
  static constexpr int kTileBytes = kPanels * kTile * kSwizzle;
  static constexpr int kSmem = 1024 + 2 * kBlockBytes +
                               kStages * (2 * kTileBytes + 2 * kTile * 4) +
                               128;
};

// lse log2(e) of a row, kept finite: a row that sees no key has
// lse = -0.7 FLT_MAX, whose product with log2(e) overflows to -inf
__device__ __forceinline__ float row_term(float lse) {
  return fmaxf(lse, -1e30f) * kLog2e;
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::kThreads, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int Lq, int Lk,
                       int Hq, int Hkv, int causal, float scale,
                       float scale_log2) {
  using C = BwdCfg<D>;
  constexpr int SW = C::kSwizzle, PANEL = C::kPanel, NP = C::kPanels;
  constexpr int BQ = C::kRows, BK = C::kTile, ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Os = Qs + C::kBlockBytes;              // dO
  uint8_t* Ks = Os + C::kBlockBytes;              // [ST][kTileBytes]
  uint8_t* Vs = Ks + ST * C::kTileBytes;          // [ST][kTileBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + ST * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                      // [ST]
  uint64_t* empty = bars + 1 + ST;                // [ST]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the heaviest causal tiles (the last rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int offset = Lk - Lq;
  int n_tiles = (Lk + BK - 1) / BK;
  if (causal) {
    const int last = q0 + BQ - 1 + offset;        // last visible key
    n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * C::kGroups);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * C::kGroups) {
    // ---- producer warp: one thread keeps the K/V ring full ----
    if (threadIdx.x == 128 * C::kGroups && n_tiles > 0) {
      hopper::mbar_expect_tx(q_full, 2 * C::kBlockBytes);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_4d(Qs + p * BQ * SW, &tq, q_full, p * PANEL, h, q0,
                            b);
        hopper::tma_load_4d(Os + p * BQ * SW, &tdo, q_full, p * PANEL, h,
                            q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
        uint8_t* kd = Ks + s * C::kTileBytes;
        uint8_t* vd = Vs + s * C::kTileBytes;
        for (int p = 0; p < NP; ++p) {
          hopper::tma_load_4d(kd + p * BK * SW, &tk, &full[s], p * PANEL, hk,
                              it * BK, b);
          hopper::tma_load_4d(vd + p * BK * SW, &tv, &full[s], p * PANEL, hk,
                              it * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup g owns query rows q0 + 64 g .. + 63 ----
    const int g = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * g + 16 * warp + lane / 4;   // and row0 + 8
    const int g_first = q0 + 64 * g;
    // shared addresses of this WG's rows of Q and dO, and of the K/V ring
    const uint32_t qa = hopper::smem_u32(Qs) + g * 64 * SW;
    const uint32_t oa = hopper::smem_u32(Os) + g * 64 * SW;
    float lt[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long idx = ((long long)b * Hq + h) * Lq + row;
      lt[r] = row < Lq ? row_term(lse[idx]) : 0.f;
      dl[r] = row < Lq ? delta[idx] : 0.f;
    }
    float acc[NP][PANEL / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PANEL / 2; ++i) acc[p][i] = 0.f;
    if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
    // the tiles this WG computes; the block's later tiles lie wholly above
    // its rows' diagonal: it releases them, in ring order, after its own
    int n_mine = n_tiles;
    if (causal) {
      const int last = g_first + 63 + offset;
      n_mine = last < 0 ? 0 : min(n_tiles, last / BK + 1);
    }

    for (int it = 0; it < n_mine; ++it) {
      const int s = it % ST;
      const int k0 = it * BK;
      hopper::mbar_wait(&full[s], (it / ST) & 1);
      const uint32_t kt = hopper::smem_u32(Ks) + s * C::kTileBytes;
      const uint32_t vt = hopper::smem_u32(Vs) + s * C::kTileBytes;

      // S = Q K^T and dP = dO V^T (all operands K-major), BK keys
      float sc[BK / 2], dp[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / (PANEL / 16), w = kk % (PANEL / 16);
        hopper::wgmma_ss_n64<0>(
            sc, hopper::desc_at(qa, p * BQ * SW + w * 32, 8 * SW, SW),
            hopper::desc_at(kt, p * BK * SW + w * 32, 8 * SW, SW), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / (PANEL / 16), w = kk % (PANEL / 16);
        hopper::wgmma_ss_n64<0>(
            dp, hopper::desc_at(oa, p * BQ * SW + w * 32, 8 * SW, SW),
            hopper::desc_at(vt, p * BK * SW + w * 32, 8 * SW, SW), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(dp);

      // p and ds on the accumulators; ds rounded to bf16 is dQ's A operand
      uint32_t dsa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) % 2;
        const int row = row0 + 8 * r;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + e;
          const bool masked = key >= Lk || (causal && key > row + offset);
          const float x = masked ? hopper::neg_inf()
                                 : fmaf(sc[i + e], scale_log2, -lt[r]);
          const float pr = hopper::exp2_approx(x);
          ds[e] = pr * (dp[i + e] - dl[r]) * scale;
        }
        dsa[i / 8][(i % 8) / 2] = hopper::pack_bf16(ds[0], ds[1]);
      }

      // dQ += dS K (dS from registers, K MN-major), one wgmma per D panel
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t db =
              hopper::desc_at(kt, p * BK * SW + kk * 16 * SW, 8 * SW, SW);
          if constexpr (PANEL == 64)
            hopper::wgmma_rs_n64<1>(acc[p], dsa[kk], db, 1);
          else
            hopper::wgmma_rs_n32<1>(acc[p], dsa[kk], db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) hopper::fence_regs(acc[p]);
      hopper::mbar_arrive(&empty[s]);
    }
    for (int it = n_mine; it < n_tiles; ++it) {
      hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
      hopper::mbar_arrive(&empty[it % ST]);
    }

    // epilogue: dQ in bf16 straight from the registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Lq) continue;
      __nv_bfloat16* dst = dq + (((long long)b * Lq + row) * Hq + h) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PANEL / 8; ++j) {
          const int col = p * PANEL + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(dst + col) = hopper::pack_bf16(
              acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
        }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(BwdCfg<D, true>::kThreads, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int Lq, int Lk,
                        int Hq, int Hkv, int causal, float scale,
                        float scale_log2) {
  using C = BwdCfg<D, true>;
  constexpr int SW = C::kSwizzle, PANEL = C::kPanel, NP = C::kPanels;
  constexpr int BKEY = C::kRows, BQ = C::kTile, ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Ks = base;
  uint8_t* Vs = Ks + C::kBlockBytes;
  uint8_t* Qs = Vs + C::kBlockBytes;              // [ST][kTileBytes]
  uint8_t* Os = Qs + ST * C::kTileBytes;          // [ST][kTileBytes] of dO
  float* Lt = reinterpret_cast<float*>(Os + ST * C::kTileBytes);  // [ST][BQ]
  float* Dl = Lt + ST * BQ;                       // [ST][BQ] delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(Dl + ST * BQ);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                      // [ST]
  uint64_t* empty = bars + 1 + ST;                // [ST]

  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * BKEY;
  const int offset = Lk - Lq;
  const int n_qt = (Lq + BQ - 1) / BQ;
  // causal: query row i sees key j iff i >= j - offset, so the query tiles
  // before the one holding row k0 - offset see none of the block's keys
  const int first = causal ? max(0, k0 - offset) / BQ : 0;

  const int per_head = n_qt - first;             // ring tiles per head
  const int n_it = group * per_head;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 32);            // the loader warp
      hopper::mbar_init(&empty[s], C::kThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // warp 0 feeds the ring: ring tile `it` is query tile first + it %
  // per_head of the group's head it / per_head. Its lanes stage the tile's
  // lse log2(e) and delta with plain loads and arrive; lane 0 also arms the
  // stage's barrier and issues the TMA loads of Q and dO
  const int lane = threadIdx.x % 32;
  const bool loader = threadIdx.x < 32;
  auto load_tile = [&](int it) {
    const int s = it % ST;
    const int h = hk * group + it / per_head;
    const int i0 = (first + it % per_head) * BQ;
    const float* lb = lse + ((long long)b * Hq + h) * Lq;
    const float* eb = delta + ((long long)b * Hq + h) * Lq;
    for (int j = lane; j < BQ; j += 32) {
      const bool in = i0 + j < Lq;
      Lt[s * BQ + j] = in ? row_term(lb[i0 + j]) : 0.f;
      Dl[s * BQ + j] = in ? eb[i0 + j] : 0.f;
    }
    if (lane == 0) {
      hopper::mbar_expect_tx(&full[s], 2 * C::kTileBytes);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_4d(Qs + s * C::kTileBytes + p * BQ * SW, &tq,
                            &full[s], p * PANEL, h, i0, b);
        hopper::tma_load_4d(Os + s * C::kTileBytes + p * BQ * SW, &tdo,
                            &full[s], p * PANEL, h, i0, b);
      }
    } else {
      hopper::mbar_arrive(&full[s]);
    }
  };
  // after the block released ring tile `it`, its stage takes tile it + ST
  auto refill = [&](int it) {
    if (loader && it + ST < n_it) {
      hopper::mbar_wait(&empty[it % ST], (it / ST) & 1);
      load_tile(it + ST);
    }
  };
  if (loader) {
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * C::kBlockBytes);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_4d(Ks + p * BKEY * SW, &tk, kv_full, p * PANEL, hk,
                            k0, b);
        hopper::tma_load_4d(Vs + p * BKEY * SW, &tv, kv_full, p * PANEL, hk,
                            k0, b);
      }
    }
    for (int it = 0; it < min(ST, n_it); ++it) load_tile(it);
  }

  {
    // ---- warpgroup g owns keys k0 + 64 g .. + 63 ----
    const int g = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int kg = k0 + 64 * g;
    const int key0 = kg + 16 * warp + lane / 4;            // and key0 + 8
    // shared addresses of this WG's keys of K and V
    const uint32_t ka = hopper::smem_u32(Ks) + g * 64 * SW;
    const uint32_t va = hopper::smem_u32(Vs) + g * 64 * SW;
    // the first query tile that sees a key of this WG (its earlier tiles
    // of each head are only released, in ring order)
    const int mine = causal ? min(n_qt, max(0, kg - offset) / BQ) : first;
    float dka[NP][PANEL / 2], dva[NP][PANEL / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PANEL / 2; ++i) {
        dka[p][i] = 0.f;
        dva[p][i] = 0.f;
      }
    hopper::mbar_wait(kv_full, 0);

    int it = 0;
    for (int gi = 0; gi < group; ++gi) {
      for (int t = first; t < mine; ++t, ++it) {
        hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
        hopper::mbar_arrive(&empty[it % ST]);
        refill(it);
      }
      for (int t = mine; t < n_qt; ++t, ++it) {
        const int s = it % ST;
        const int i0 = t * BQ;
        hopper::mbar_wait(&full[s], (it / ST) & 1);
        const uint32_t qt = hopper::smem_u32(Qs) + s * C::kTileBytes;
        const uint32_t ot = hopper::smem_u32(Os) + s * C::kTileBytes;

        // S^T = K Q^T and dP^T = V dO^T (all operands K-major), BQ queries
        float st[BQ / 2], dpt[BQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / (PANEL / 16), w = kk % (PANEL / 16);
          const uint64_t da =
              hopper::desc_at(ka, p * BKEY * SW + w * 32, 8 * SW, SW);
          const uint64_t db =
              hopper::desc_at(qt, p * BQ * SW + w * 32, 8 * SW, SW);
          hopper::wgmma_ss_n64<0>(st, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int p = kk / (PANEL / 16), w = kk % (PANEL / 16);
          const uint64_t da =
              hopper::desc_at(va, p * BKEY * SW + w * 32, 8 * SW, SW);
          const uint64_t db =
              hopper::desc_at(ot, p * BQ * SW + w * 32, 8 * SW, SW);
          hopper::wgmma_ss_n64<0>(dpt, da, db, kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(st);
        hopper::fence_regs(dpt);

        // P^T and dS^T on the accumulators (row: key, column: query),
        // rounded to bf16: the A operands of dV and dK
        const float* lt = Lt + s * BQ;
        const float* dl = Dl + s * BQ;
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < BQ / 2; i += 2) {
          const int key = key0 + 8 * ((i / 2) % 2);
          const int col = 8 * (i / 4) + 2 * (lane % 4);
          const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
          const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int query = i0 + col + e;
            const bool masked = query >= Lq || key >= Lk ||
                                (causal && key > query + offset);
            const float x = masked ? hopper::neg_inf()
                                   : fmaf(st[i + e], scale_log2,
                                          -(e ? l2.y : l2.x));
            pr[e] = hopper::exp2_approx(x);
            ds[e] = pr[e] * (dpt[i + e] - (e ? d2.y : d2.x)) * scale;
          }
          pa[i / 8][(i % 8) / 2] = hopper::pack_bf16(pr[0], pr[1]);
          dsa[i / 8][(i % 8) / 2] = hopper::pack_bf16(ds[0], ds[1]);
        }

        // dV += P^T dO and dK += dS^T Q (dO and Q MN-major), per D panel
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const uint64_t dbo =
                hopper::desc_at(ot, p * BQ * SW + kk * 16 * SW, 8 * SW, SW);
            const uint64_t dbq =
                hopper::desc_at(qt, p * BQ * SW + kk * 16 * SW, 8 * SW, SW);
            if constexpr (PANEL == 64) {
              hopper::wgmma_rs_n64<1>(dva[p], pa[kk], dbo, 1);
              hopper::wgmma_rs_n64<1>(dka[p], dsa[kk], dbq, 1);
            } else {
              hopper::wgmma_rs_n32<1>(dva[p], pa[kk], dbo, 1);
              hopper::wgmma_rs_n32<1>(dka[p], dsa[kk], dbq, 1);
            }
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          hopper::fence_regs(dva[p]);
          hopper::fence_regs(dka[p]);
        }
        hopper::mbar_arrive(&empty[s]);
        refill(it);
      }
    }

    // epilogue: dK and dV in bf16 straight from the registers, once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= Lk) continue;
      const long long o = (((long long)b * Lk + key) * Hkv + hk) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PANEL / 8; ++j) {
          const int col = p * PANEL + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(dk + o + col) = hopper::pack_bf16(
              dka[p][4 * j + 2 * r], dka[p][4 * j + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dv + o + col) = hopper::pack_bf16(
              dva[p][4 * j + 2 * r], dva[p][4 * j + 2 * r + 1]);
        }
    }
  }
}

// a [B, L, H, D] operand as a 4-d tensor map (d, head, seq, batch): one
// box is one panel of a tile, `rows` sequence positions of one head
cudaError_t map_4d(CUtensorMap* map, const void* ptr, int D, int H, int L,
                   int B, const Strides& st, int panel, int rows,
                   int swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.l * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)panel, 1, (cuuint32_t)rows, 1};
  return hopper::encode_bf16(map, ptr, 4, dims, strides, box, swizzle);
}

// the four operands' maps: q and dO with `q_rows`-row boxes, k and v with
// `kv_rows`-row boxes
template <int D>
cudaError_t tc_maps(const Args& a, CUtensorMap* m, int q_rows, int kv_rows) {
  using C = BwdCfg<D>;      // swizzle and panel only
  cudaError_t err = map_4d(&m[0], a.q, D, a.Hq, a.Lq, a.B, a.qs, C::kPanel,
                           q_rows, C::kSwizzle);
  if (err == cudaSuccess)
    err = map_4d(&m[1], a.k, D, a.Hkv, a.Lk, a.B, a.ks, C::kPanel, kv_rows,
                 C::kSwizzle);
  if (err == cudaSuccess)
    err = map_4d(&m[2], a.v, D, a.Hkv, a.Lk, a.B, a.vs, C::kPanel, kv_rows,
                 C::kSwizzle);
  if (err == cudaSuccess)
    err = map_4d(&m[3], a.dout, D, a.Hq, a.Lq, a.B, a.os, C::kPanel, q_rows,
                 C::kSwizzle);
  return err;
}

template <int D>
cudaError_t launch_dq_tc(const Args& a, void* dq) {
  using C = BwdCfg<D>;
  CUtensorMap m[4];
  cudaError_t err = tc_maps<D>(a, m, C::kRows, C::kTile);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dq_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + C::kRows - 1) / C::kRows, a.B * a.Hq);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dq), a.Lq, a.Lk, a.Hq, a.Hkv, a.causal,
      a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a, void* dk, void* dv) {
  using C = BwdCfg<D, true>;
  CUtensorMap m[4];
  cudaError_t err = tc_maps<D>(a, m, C::kTile, C::kRows);
  if (err != cudaSuccess) return err;
  auto kern = flash_bwd_dkv_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lk + C::kRows - 1) / C::kRows, a.B * a.Hkv);
  kern<<<grid, C::kThreads, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      a.Lq, a.Lk, a.Hq, a.Hkv, a.causal, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core variants, same arguments as flash_attention_bwd_dq
// and flash_attention_bwd_dkv (dtype must be 1, D 32, 64 or 128). The
// caller guarantees what TMA needs: 16-byte aligned q/k/v/dO, element
// strides that are multiples of 8, nested (head inside sequence inside
// batch). Each returns cudaGetLastError(), or the error of a tensor map
// that could not be made.
extern "C" int flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Lq, int Lk,
    int Hq, int Hkv, int D, long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, long long o_sb, long long o_sl,
    long long o_sh, int causal, float scale, int dtype, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0) return cudaGetLastError();
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, Lq, Lk, Hq, Hkv, st,
                           causal, scale, stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_dq_tc<32>(a, dq); break;
    case 64: err = launch_dq_tc<64>(a, dq); break;
    case 128: err = launch_dq_tc<128>(a, dq); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Lq,
    int Lk, int Hq, int Hkv, int D, long long q_sb, long long q_sl,
    long long q_sh, long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, long long o_sb,
    long long o_sl, long long o_sh, int causal, float scale, int dtype,
    void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lk == 0) return cudaGetLastError();
  const long long st[12] = {q_sb, q_sl, q_sh, k_sb, k_sl, k_sh,
                            v_sb, v_sl, v_sh, o_sb, o_sl, o_sh};
  const Args a = make_args(q, k, v, dout, lse, delta, B, Lq, Lk, Hq, Hkv, st,
                           causal, scale, stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_dkv_tc<32>(a, dk, dv); break;
    case 64: err = launch_dkv_tc<64>(a, dk, dv); break;
    case 128: err = launch_dkv_tc<128>(a, dk, dv); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
