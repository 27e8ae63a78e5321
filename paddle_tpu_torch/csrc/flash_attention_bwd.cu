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
// What the designs do about that, and what they do not yet:
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
//  - the products are plain fp32 FMAs on the CUDA cores, as the forward
//    kernel's: right first. mma/wgmma tiles with TMA staging, and one pass
//    that shares the recompute between dq and dk/dv, are the later changes
//    that move them toward their bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                 // keys (dq) / query rows (dk/dv)
constexpr float kMaskValue = -0.7f * FLT_MAX;

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
