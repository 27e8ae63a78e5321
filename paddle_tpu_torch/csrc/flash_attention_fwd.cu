// Flash attention forward: online-softmax attention that never writes the
// [Lq, Lk] score matrix to device memory.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_attention.py:_fwd
// (_fwd_kernel). Same contract: q [B, Lq, Hq, D], k/v [B, Lk, Hkv, D]
// (paddle layout, read through strides, so no transpose copy); causal is
// bottom-right aligned (query row i sees keys j <= i + Lk - Lq); GQA maps
// query head h onto kv head h / (Hq / Hkv); returns out [B, Lq, Hq, D] in
// q's dtype and lse [B, Hq, Lq] in fp32 (ring attention and the backward
// kernels consume lse).
//
// What bounds it on the H100: by shape. The work is ~4 * Lq * Lk * D FLOPs
// (half that when causal) per (batch, head) against ~2 * (Lq + Lk) * D
// elements moved, so at the main path's L = 512..2048 and D = 64..128 it
// is FLOP-bound on the bf16 tensor cores (hundreds of FLOPs per byte).
//
// Two variants, chosen by the wrapper (ops/flash_attention.py:_variant)
// before the launch from dtype, strides and alignment alone:
//
// tensor cores (flash_attention_fwd_tc, bf16), the main path's variant:
//  - a block owns 128 query rows (64 for D = 256) of one (batch, head):
//    one consumer warpgroup per 64 rows, plus one producer warp;
//  - the producer's single thread loads the Q tile once and then keeps a
//    2-stage ring of K/V tiles (64 keys for D >= 128, 128 below; 64 at
//    D = 128 is also the fastest of 64/128 keys and 2/3/4 stages on the
//    H100, and keeps it within its 168 registers) full with TMA
//    (cp.async.bulk.tensor, 4-d tensor maps over (d, head, seq, batch), so
//    strided q/k/v cost no copy) into 128-byte-swizzled shared memory
//    (64-byte for D = 32), each stage guarded by a full and an empty
//    mbarrier: the next tile's load overlaps this tile's math;
//  - S = Q K^T is wgmma m64nBKk16 from shared memory (K is [keys, D] with
//    D contiguous: the K-major B operand); the row max and exp-sum run on
//    the accumulator registers with two quad shuffles per row, in the
//    log2 domain (ex2.approx); a masked score is -inf there, so p = 0,
//    while the running max starts at the TPU kernel's finite
//    -0.7 * FLT_MAX: a fully masked row gives out = 0 and lse = that
//    constant, never NaN; l sums the unrounded fp32 p (the JAX l_next);
//  - O += P V: p is rounded to bf16 in registers (the TPU kernel's
//    p.astype(v.dtype)) and fed as wgmma's register A operand (the S
//    accumulator's layout is the A fragment's, no shuffle); V is the
//    MN-major B operand (transpose bit), one m64n64k16 per 64-wide panel
//    of D; O stays in fp32 registers, rescaled by alpha per tile;
//  - tiles wholly above the causal diagonal are never loaded (nor
//    computed by a warpgroup whose rows they are above); every score is
//    tested against the mask (causal diagonal, ragged Lk edge) by a
//    predicate, not a branch (see the softmax); TMA loads the ragged
//    edges as zeros; blocks with the most key tiles (the last query rows)
//    are scheduled first;
//  - the epilogue divides by l and stores bf16 pairs and lse straight from
//    the registers.
//
// CUDA cores (flash_attention_fwd, fp32 and bf16): the first version. Every
// fp32 call takes it: the tensor cores would compute fp32 in TF32, and the
// fp32 checks (token identity, the 1e-4 parity) need full fp32 products.
// bf16 takes it only where TMA cannot read the operands (a base not 16-byte
// aligned, strides not multiples of 16 bytes or not nested). One block per
// (64-row query tile, batch * head), 256 threads = 64 rows x 4 lanes (a
// quad per row, lane t owning head dims t, t + 4, ...), 32-key K/V tiles
// staged in shared memory as fp32, scalar FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;                 // query rows per block
constexpr int kThreads = kRows * 4;
constexpr int kKeys = 32;                 // keys per K/V tile
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int Hq, int Hkv,
                 Strides qs, Strides ks, Strides vs, int causal,
                 float scale) {
  constexpr int DPT = D / 4;              // dims per thread
  extern __shared__ float smem[];
  float* Ks = smem;                       // [kKeys][D]
  float* Vs = smem + kKeys * D;           // [kKeys][D]

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, r = tid / 4, t = tid % 4;
  const int row = q0 + r;
  const int offset = Lk - Lq;

  float qr[DPT], acc[DPT];
  const bool row_in = row < Lq;
  const T* qp = q + b * qs.b + (long long)row * qs.l + h * qs.h;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    qr[e] = row_in ? to_f(qp[t + 4 * e]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kMaskValue, l = 0.f;

  // key tiles with any key at or below the block's last row's diagonal
  int n_tiles = (Lk + kKeys - 1) / kKeys;
  if (causal) {
    const int last = q0 + kRows - 1 + offset;          // last visible key
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kKeys + 1);
  }
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    for (int e = tid; e < kKeys * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool in = k0 + j < Lk;
      Ks[e] = in ? to_f(kb[(long long)(k0 + j) * ks.l + d]) : 0.f;
      Vs[e] = in ? to_f(vb[(long long)(k0 + j) * vs.l + d]) : 0.f;
    }
    __syncthreads();

    float s[kKeys];
    float mt = kMaskValue;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float* kr = Ks + j * D + t;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DPT; ++e) part += qr[e] * kr[4 * e];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool valid = key < Lk && (!causal || key <= row + offset);
      s[j] = valid ? part * scale : kMaskValue;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int key = k0 + j;
      const bool valid = key < Lk && (!causal || key <= row + offset);
      const float p = valid ? expf(s[j] - m_new) : 0.f;
      l += p;
      const float pr = round_to<T>(p);
      const float* vr = Vs + j * D + t;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[e] += pr * vr[4 * e];
    }
    m = m_new;
    __syncthreads();
  }

  if (row_in) {
    const float safe_l = l > 0.f ? l : 1.f;
    T* op = out + (((long long)b * Lq + row) * Hq + h) * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) op[t + 4 * e] = from_f<T>(acc[e] / safe_l);
    if (t == 0)
      lse[((long long)b * Hq + h) * Lq + row] = m + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Lq, int Lk, int Hq, int Hkv,
                   Strides qs, Strides ks, Strides vs, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = 2 * kKeys * D * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Lq + kRows - 1) / kRows, B * Hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Lq, Lk, Hq, Hkv,
      qs, ks, vs, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int Lq, int Lk, int Hq, int Hkv,
                     int D, Strides qs, Strides ks, Strides vs, int causal,
                     float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lse, B, Lq, Lk, Hq, Hkv,
                                  qs, ks, vs, causal, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, lse, B, Lq, Lk, Hq, Hkv,
                                  qs, ks, vs, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, B, Lq, Lk, Hq, Hkv,
                                    qs, ks, vs, causal, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, lse, B, Lq, Lk, Hq, Hkv,
                                    qs, ks, vs, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v are device pointers with
// element strides (batch, seq, head) and a contiguous head dim; out is a
// contiguous [B, Lq, Hq, D], lse a contiguous fp32 [B, Hq, Lq]. Returns
// cudaGetLastError().
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Lq, int Lk, int Hq, int Hkv, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (B == 0 || Lq == 0) return cudaGetLastError();
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh},
      vs{v_sb, v_sl, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 1)
    err = launch_t<__nv_bfloat16>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, D,
                                  qs, ks, vs, causal, scale, st);
  else
    err = launch_t<float>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, D, qs, ks, vs,
                          causal, scale, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

template <int D>
struct TcCfg {
  static constexpr int kSwizzle = D == 32 ? 64 : 128;   // bytes per row
  static constexpr int kPanel = kSwizzle / 2;           // bf16 per row
  static constexpr int kPanels = D / kPanel;            // panels of D
  static constexpr int kGroups = D == 256 ? 1 : 2;      // consumer WGs
  static constexpr int kBQ = 64 * kGroups;              // query rows
  // keys per tile: 64 from D = 128 up, where a 128-key S tile and its P
  // fragments would not fit beside O in the 168 registers a thread gets
  // (9 warps on 4 schedulers: 3 share one scheduler's 64K registers)
  static constexpr int kBK = D >= 128 ? 64 : 128;
  static constexpr int kStages = 2;                     // K/V ring
  static constexpr int kThreads = 128 * kGroups + 32;   // + producer warp
  static constexpr int kQBytes = kPanels * kBQ * kSwizzle;
  static constexpr int kKVBytes = kPanels * kBK * kSwizzle;   // K or V
  static constexpr int kSmem = 1024 + kQBytes + kStages * 2 * kKVBytes + 64;
};


template <int D>
__global__ void __launch_bounds__(TcCfg<D>::kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int Lq, int Lk, int Hq, int Hkv, int causal,
                    float scale_log2) {
  using C = TcCfg<D>;
  constexpr int SW = C::kSwizzle, PANEL = C::kPanel, NP = C::kPanels;
  constexpr int BQ = C::kBQ, BK = C::kBK, ST = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + C::kQBytes;                  // [ST][kKVBytes]
  uint8_t* Vs = Ks + ST * C::kKVBytes;            // [ST][kKVBytes]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + ST * C::kKVBytes);
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
    // ---- producer: one thread keeps the K/V ring full ----
    if (threadIdx.x == 128 * C::kGroups && n_tiles > 0) {
      hopper::mbar_expect_tx(q_full, C::kQBytes);
      for (int p = 0; p < NP; ++p)
        hopper::tma_load_4d(Qs + p * BQ * SW, &tq, q_full, p * PANEL, h, q0,
                            b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        hopper::mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        uint8_t* kd = Ks + s * C::kKVBytes;
        uint8_t* vd = Vs + s * C::kKVBytes;
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
    const int g_first = q0 + 64 * g;                       // this WG's rows
    float o[NP][PANEL / 2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < PANEL / 2; ++i) o[p][i] = 0.f;
    float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
    if (n_tiles > 0) hopper::mbar_wait(q_full, 0);
    // the tiles this WG computes; the block's later tiles lie wholly above
    // its rows' diagonal: it only releases them, in ring order, after the
    // main loop (a `continue` inside the main loop cost the wgmma
    // pipelining)
    int n_mine = n_tiles;
    if (causal) {
      const int last = g_first + 63 + offset;
      n_mine = last < 0 ? 0 : min(n_tiles, last / BK + 1);
    }

    for (int it = 0; it < n_mine; ++it) {
      const int s = it % ST;
      const int k0 = it * BK;
      hopper::mbar_wait(&full[s], (it / ST) & 1);
      const uint8_t* kt = Ks + s * C::kKVBytes;
      const uint8_t* vt = Vs + s * C::kKVBytes;

      // S = Q K^T (K-major A and B), BK keys
      float sc[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / (PANEL / 16), w = kk % (PANEL / 16);
        const uint64_t da = hopper::make_desc(
            Qs + p * BQ * SW + g * 64 * SW + w * 32, 8 * SW, SW);
        const uint64_t db =
            hopper::make_desc(kt + p * BK * SW + w * 32, 8 * SW, SW);
        if constexpr (BK == 128)
          hopper::wgmma_ss_n128<0>(sc, da, db, kk > 0);
        else
          hopper::wgmma_ss_n64<0>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);

      // online softmax in the log2 domain. A masked score is -inf here, so
      // that p = 2^(s - m) is 0 without a select: m starts at the finite
      // kMaskValue and never falls, so s - m is never -inf - -inf. Every
      // score is tested against the mask, as a predicate and not a branch:
      // a select on p made ptxas serialize the wgmmas (its warning C7520),
      // and a branch that skipped the test inside the diagonal made the
      // loop markedly slower on the H100
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        const bool masked = key >= Lk || (causal && key > row + offset);
        sc[i] = masked ? hopper::neg_inf() : sc[i] * scale_log2;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = hopper::exp2_approx(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = hopper::exp2_approx(sc[i] - m[r]);
        const float p1 = hopper::exp2_approx(sc[i + 1] - m[r]);
        l[r] += p0 + p1;                 // the unrounded p, as l_next
        pa[i / 8][(i % 8) / 2] = hopper::pack_bf16(p0, p1);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < PANEL / 2; ++i) o[p][i] *= alpha[(i / 2) % 2];

      // O += P V (P from registers, V MN-major), one wgmma per D panel
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint64_t db = hopper::make_desc(
              vt + p * BK * SW + kk * 16 * SW, 8 * SW, SW);
          if constexpr (PANEL == 64)
            hopper::wgmma_rs_n64<1>(o[p], pa[kk], db, 1);
          else
            hopper::wgmma_rs_n32<1>(o[p], pa[kk], db, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) hopper::fence_regs(o[p]);
      hopper::mbar_arrive(&empty[s]);
    }
    for (int it = n_mine; it < n_tiles; ++it) {
      hopper::mbar_wait(&full[it % ST], (it / ST) & 1);
      hopper::mbar_arrive(&empty[it % ST]);
    }

    // epilogue: out = O / l in bf16, lse = m ln 2 + log l
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    constexpr float kLn2 = 0.69314718055994531f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Lq) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 1.f;
      __nv_bfloat16* op = out + (((long long)b * Lq + row) * Hq + h) * D;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < PANEL / 8; ++j) {
          const int col = p * PANEL + 8 * j + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(op + col) = hopper::pack_bf16(
              o[p][4 * j + 2 * r] * inv, o[p][4 * j + 2 * r + 1] * inv);
        }
      if (lane % 4 == 0)
        lse[((long long)b * Hq + h) * Lq + row] =
            l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kMaskValue;
    }
  }
}

// q/k/v as 4-d tensor maps (d, head, seq, batch): one box is one panel of
// a tile, `rows` sequence positions of one head.
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

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int B, int Lq, int Lk, int Hq, int Hkv,
                      Strides qs, Strides ks, Strides vs, int causal,
                      float scale, cudaStream_t stream) {
  using C = TcCfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = map_4d(&tq, q, D, Hq, Lq, B, qs, C::kPanel, C::kBQ,
                           C::kSwizzle);
  if (err == cudaSuccess)
    err = map_4d(&tk, k, D, Hkv, Lk, B, ks, C::kPanel, C::kBK, C::kSwizzle);
  if (err == cudaSuccess)
    err = map_4d(&tv, v, D, Hkv, Lk, B, vs, C::kPanel, C::kBK, C::kSwizzle);
  if (err != cudaSuccess) return err;
  auto kern = flash_fwd_tc_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + C::kBQ - 1) / C::kBQ, B * Hq);
  constexpr float kLog2e = 1.4426950408889634f;
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Lq, Lk, Hq, Hkv,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core variant, same arguments as flash_attention_fwd
// (dtype must be 1). The caller guarantees what TMA needs: 16-byte aligned
// q/k/v, element strides that are multiples of 8, nested (head inside
// sequence inside batch). Returns cudaGetLastError(), or the error of a
// tensor map that could not be made.
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int Lq, int Lk, int Hq, int Hkv, int D,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    int causal, float scale, int dtype, void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Lq == 0) return cudaGetLastError();
  const Strides qs{q_sb, q_sl, q_sh}, ks{k_sb, k_sl, k_sh},
      vs{v_sb, v_sl, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  switch (D) {
    case 32: err = launch_tc<32>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, qs, ks,
                                 vs, causal, scale, st); break;
    case 64: err = launch_tc<64>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, qs, ks,
                                 vs, causal, scale, st); break;
    case 128: err = launch_tc<128>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, qs,
                                   ks, vs, causal, scale, st); break;
    case 256: err = launch_tc<256>(q, k, v, out, l, B, Lq, Lk, Hq, Hkv, qs,
                                   ks, vs, causal, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
