// Paged flash-decode: one-token attention over a block-paged KV pool.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/flash_decode.py:flash_decode
// (_kernel). Same contract: q [S, H, hd] (slot s's row at q + s *
// q_stride, its heads and dims contiguous: GPT's q is a view of the fused
// qkv projection, row stride 3h, read as it is) attends, through the
// per-slot block tables [S, mb] (int32), the pool positions 0..write_pos[s]
// of kv head h // (H / n_kv); online softmax in fp32; p rounded to v's
// dtype before the PV product (the TPU kernel's p.astype(v.dtype)); the
// finite mask value -0.7 * FLT_MAX; a slot that attends nothing writes
// zeros; output [S, H, hd], contiguous, in q's dtype.
//
// Two kernels, picked by ops/flash_decode.py:_variant:
//  - flash_decode_split_kernel ("split", every operand on the main path):
//    split-K over each slot's cache, pages staged by bulk async copies;
//  - flash_decode_kernel ("one_pass", the first version): one block per
//    (slot, kv head) walking the whole cache; kept for the timing beside
//    the new one (its note is beside it, below).
//
// What bounds it on the H100: bytes. Each attended position is read once
// (K and V rows, 2 * hd * sizeof(T) per kv head) and used by `group` query
// rows only, so the work is ~2 * group FLOPs per byte -- far below the
// ~295 FLOP/byte the card needs before the tensor cores matter, so the
// CUDA cores do the arithmetic and no tensor core is used. The kernel is
// as fast as it keeps HBM busy: ~25 KB in flight per SM at 3.35 TB/s.
// The first kernel fell short of that three ways: one block per (slot, kv
// head) -- 256 blocks for 132 SMs at the engine's shape, the slot with the
// longest cache walking it alone while short slots' SMs idle; a dependent
// chain per 64-position chunk (table entry -> K rows -> scores -> table
// entry -> V rows, three block barriers); and at most ~16 KB of loads in
// flight per block.
//
// What the split design does about that:
//  - grid (split, kv head, slot): each block takes P consecutive positions
//    of its slot's view (the host plans P, a multiple of 64, and n_split =
//    ceil(mb * bs / P) <= kMaxSplits from the table width alone:
//    ops/flash_decode.py:split_plan; write_pos is never read on the host).
//    A block whose split starts past write_pos[s] exits at once. At the
//    engine's table (mb * bs = 512, P = 64) a slot of ~290 positions puts
//    5 blocks per kv head to work, and the 8-slot engine step up to ~830
//    live blocks on 132 SMs (1,120 at the 512-position timing shape): more
//    than two per SM, with 6 resident per SM (32 KB of shared memory each;
//    at GPT-2's hd = 64 a stage is 16 KB and the 12 heads of an 8-slot step
//    give up to 1,536 blocks at 1,024 positions), so long and short slots
//    spread over the whole card
//    (tools/torch_decode_probe.py times other split lengths);
//  - pages are staged in shared memory by the copy engine: each of the 128
//    threads issues one cp.async.bulk per 64-position chunk (thread t the K
//    row of position t % 64 for t < 64, else its V row; one row of hd
//    elements per position -- 256 bytes at hd = 128 bf16, 128 bytes at
//    GPT-2's hd = 64, 64 at hd = 32, always a multiple of the copy's 16 --
//    whatever the block size, so P need not be a multiple of bs), all
//    completing on the chunk's mbarrier. K and V are requested together,
//    so V's bytes arrive while the scores are computed, and a block has its
//    whole chunk (a stage: 2 * 64 rows, 32 KB at hd = 128 bf16, 16 KB at
//    hd = 64 bf16 or hd = 32 fp32) in flight from its first instruction
//    on. The table entries of the first chunks are read before any copy is
//    issued, and each later chunk's entry one chunk ahead, so no table read
//    waits in the chunk loop;
//  - a split longer than one chunk (tables over 1,024 positions: P grows
//    so that n_split stays <= 16) runs a 2-stage ring: chunk c + 2 is
//    issued into the stage chunk c leaves;
//  - each warp keeps its own online softmax over the rows it owns (m, l in
//    every lane, acc over its lanes' dims), so a chunk needs no block
//    barrier between scores, softmax and PV -- only the ring's refill
//    waits for the block. The warps merge once at the end of the split;
//  - the merge across splits is in the same launch: a split writes its
//    partial (m, l, acc[hd]) in fp32 to scratch, and the last block of its
//    (slot, kv head) to finish -- counted by an atomic counter after
//    __threadfence(), which it resets -- rescales and sums the partials:
//    M = max m_i, L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / L.
//    A slot whose cache one split covers writes its output directly. Only
//    splits with a position take part, so every partial has l >= 1 and no
//    inf - inf or 0 / 0 reaches the output.
//
// Layout (split kernel): 128 threads = 8 half-warps of 16 lanes; in a chunk
// half-warp w owns rows w, w + 8, ..., w + 56; lane l owns kNV vectors of
// kVE head dims (vector v: dims [(16 v + l) kVE, +kVE)), so a half-warp
// reads each row as one contiguous run of shared memory (no bank
// conflict). At hd = 128 bf16 a lane holds 8 dims as one 16-byte vector;
// at hd = 64 it holds 4 (one 8-byte vector in bf16, one 16-byte vector in
// fp32); at hd = 32, 2. The merges at the end loop over the G * hd
// outputs of a block with its 128 threads (threads past G * hd idle when
// G * hd < 128, as at (64, 1)), so every (g, d) is covered. Scores: per row, a partial q.k over the lane's dims reduced
// over the 16 lanes with shuffles; the warp's two half-warps then agree on
// the running max and sum with one shuffle each.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

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
// p rounded to the value dtype before the PV product (as the TPU kernel's
// p.astype(v.dtype)); identity for fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int N>
struct alignas(N * sizeof(T) >= 16 ? 16 : N * sizeof(T)) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(x.v[i]);
}

// ============================================================================
// split-K kernel ("split")
// ============================================================================

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kRows = kSplitThreads / 2;     // positions per chunk
constexpr int kRowsPerHalfWarp = kRows / 8;  // 8
constexpr int kStages = 2;                   // ring depth of a long split
constexpr int kMaxSplits = 16;

template <typename T, int HD>
struct SplitShape {
  static constexpr int kDPL = HD / 16;                    // dims per lane
  static constexpr int kVE = kDPL < 16 / (int)sizeof(T)   // dims per vector
                                 ? kDPL : 16 / (int)sizeof(T);
  static constexpr int kNV = kDPL / kVE;                  // vectors per lane
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * kRows * kRowBytes;   // K | V
};

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kSplitThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                          const T* __restrict__ vc,
                          const int* __restrict__ tables,
                          const int* __restrict__ write_pos,
                          T* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ counters, int H, int n_kv,
                          int bs, int mb, int P, int n_split, int stages,
                          int q_stride, float scale) {
  using Sh = SplitShape<T, HD>;
  constexpr int kNV = Sh::kNV, kVE = Sh::kVE;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kStages];
  __shared__ float red[kSplitWarps][G][HD];
  __shared__ float ml_s[kSplitWarps][G][2];
  __shared__ float wt_s[G][kMaxSplits];
  __shared__ float L_s[G];
  __shared__ int last_s;

  const int j = blockIdx.x, kvh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hw = tid / 16, ln = tid % 16;
  T* orow = out + ((size_t)s * H + kvh * G) * HD;

  // positions 0..n_keys-1 attend; a write_pos past the table clamps to its
  // end; splits with no position do nothing (split 0 of a slot that
  // attends nothing writes its zeros)
  const int n_keys = min(write_pos[s], mb * bs - 1) + 1;
  const int n_live = n_keys <= 0 ? 0 : min(n_split, (n_keys + P - 1) / P);
  if (j >= n_live) {
    if (j == 0)
      for (int e = tid; e < G * HD; e += kSplitThreads)
        orow[e] = from_f<T>(0.f);
    return;
  }
  const int p0 = j * P, p1 = min(p0 + P, n_keys);   // this split: [p0, p1)
  const int n_ch = (p1 - p0 + kRows - 1) / kRows;
  const int* trow = tables + (size_t)s * mb;
  const size_t row_stride = (size_t)n_kv * HD;      // one pool position
  // thread t stages row t % kRows of each chunk: K for t < kRows, else V
  const int my_row = tid % kRows;
  const T* my_src = (tid < kRows ? kc : vc) + (size_t)kvh * HD;
  const int my_off = (tid < kRows ? 0 : kRows * Sh::kRowBytes)
                     + my_row * Sh::kRowBytes;

  // the pool block of this thread's row of chunk c, or -1 past the split
  auto entry = [&](int c) -> int {
    const int pos = p0 + c * kRows + my_row;
    return c < n_ch && pos < p1 ? trow[pos / bs] : -1;
  };
  // thread 0 arms chunk c's stage with the chunk's bytes (its one arrival)
  // before a block barrier, and every thread copies its row after it, so
  // the expected count is in place before any copy completes
  auto expect = [&](int c) {
    if (tid == 0)
      hopper::mbar_expect_tx(
          &full[c % stages],
          2 * min(kRows, p1 - p0 - c * kRows) * Sh::kRowBytes);
  };
  auto copy = [&](int c, int blk) {
    const int pos = p0 + c * kRows + my_row;
    if (blk >= 0)
      hopper::bulk_load(ring + (c % stages) * Sh::kStageBytes + my_off,
                        my_src + ((size_t)blk * bs + pos % bs) * row_stride,
                        Sh::kRowBytes, &full[c % stages]);
  };
  const int e0 = entry(0), e1 = entry(1);
  int pf = entry(stages);                  // the next chunk to issue
  const bool two = stages > 1 && n_ch > 1;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) hopper::mbar_init(&full[i], 1);
    hopper::mbar_fence_init();
  }
  expect(0);
  if (two) expect(1);
  __syncthreads();                         // barriers initialised and armed
  copy(0, e0);
  if (two) copy(1, e1);

  float qr[G][kNV][kVE], acc[G][kNV][kVE], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qg = q + (size_t)s * q_stride + (kvh * G + g) * HD;
#pragma unroll
    for (int v = 0; v < kNV; ++v) {
      load_vec<T, kVE>(qg + (v * 16 + ln) * kVE, qr[g][v]);
#pragma unroll
      for (int e = 0; e < kVE; ++e) acc[g][v][e] = 0.f;
    }
    m[g] = kMaskValue;
    l[g] = 0.f;
  }

  for (int c = 0; c < n_ch; ++c) {
    const int st = c % stages;
    hopper::mbar_wait(&full[st], (c / stages) & 1);
    const T* ks = reinterpret_cast<const T*>(ring + st * Sh::kStageBytes);
    const T* vs = ks + kRows * HD;
    const int rows = min(kRows, p1 - p0 - c * kRows);   // valid rows
    // ---- scores of this half-warp's rows (rows past `rows` hold stale
    //      bytes: computed, then replaced by the mask value) -------------
    float sc[G][kRowsPerHalfWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerHalfWarp; ++i) {
      const int r = hw + 8 * i;
      float kf[kNV][kVE];
#pragma unroll
      for (int v = 0; v < kNV; ++v)
        load_vec<T, kVE>(ks + r * HD + (v * 16 + ln) * kVE, kf[v]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part_dot = 0.f;
#pragma unroll
        for (int v = 0; v < kNV; ++v)
#pragma unroll
          for (int e = 0; e < kVE; ++e) part_dot += qr[g][v][e] * kf[v][e];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, o);
        sc[g][i] = r < rows ? part_dot * scale : kMaskValue;
      }
    }
    // ---- the warp's online-softmax update; p replaces the score --------
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mt = sc[g][0];
#pragma unroll
      for (int i = 1; i < kRowsPerHalfWarp; ++i) mt = fmaxf(mt, sc[g][i]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
      const float m_new = fmaxf(m[g], mt);
      const float alpha = expf(m[g] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerHalfWarp; ++i) {
        const float p = hw + 8 * i < rows ? expf(sc[g][i] - m_new) : 0.f;
        ps += p;
        sc[g][i] = round_to<T>(p);
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 16);
      l[g] = l[g] * alpha + ps;
      m[g] = m_new;
#pragma unroll
      for (int v = 0; v < kNV; ++v)
#pragma unroll
        for (int e = 0; e < kVE; ++e) acc[g][v][e] *= alpha;
    }
    // ---- acc += p . v over the valid rows -------------------------------
#pragma unroll
    for (int i = 0; i < kRowsPerHalfWarp; ++i) {
      const int r = hw + 8 * i;
      if (r < rows) {
        float vf[kNV][kVE];
#pragma unroll
        for (int v = 0; v < kNV; ++v)
          load_vec<T, kVE>(vs + r * HD + (v * 16 + ln) * kVE, vf[v]);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int v = 0; v < kNV; ++v)
#pragma unroll
            for (int e = 0; e < kVE; ++e) acc[g][v][e] += sc[g][i] * vf[v][e];
      }
    }
    // ---- refill the stage this chunk leaves -----------------------------
    const int nxt = c + stages;
    if (nxt < n_ch) {
      expect(nxt);             // thread 0 has seen this stage's phase end
      __syncthreads();         // every warp is done with the stage
      copy(nxt, pf);
      pf = entry(nxt + 1);
    }
  }

  // ---- merge the warps: the two half-warps share m and l ----------------
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int v = 0; v < kNV; ++v)
#pragma unroll
      for (int e = 0; e < kVE; ++e) {
        const float a = acc[g][v][e]
                        + __shfl_xor_sync(0xffffffffu, acc[g][v][e], 16);
        if (lane < 16) red[warp][g][(v * 16 + ln) * kVE + e] = a;
      }
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      ml_s[warp][g][0] = m[g];
      ml_s[warp][g][1] = l[g];
    }
  __syncthreads();
  const size_t head0 = (size_t)s * H + kvh * G;     // this block's first head
  float* pacc = part;                                // [S*H][n_split][HD]
  float* pml = part + (size_t)gridDim.z * H * n_split * HD;   // [..][2]
  for (int e = tid; e < G * HD; e += kSplitThreads) {
    const int g = e / HD, d = e % HD;
    float M = kMaskValue;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, ml_s[w][g][0]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float wt = expf(ml_s[w][g][0] - M);   // 0 for a warp with no row
      L += wt * ml_s[w][g][1];
      A += wt * red[w][g][d];
    }
    if (n_live == 1) {
      orow[e] = from_f<T>(A / L);                  // L >= 1: p0 attends
    } else {
      const size_t at = (head0 + g) * n_split + j;
      pacc[at * HD + d] = A;
      if (d == 0) {
        pml[at * 2] = M;
        pml[at * 2 + 1] = L;
      }
    }
  }
  if (n_live == 1) return;

  // ---- the last split of this (slot, kv head) to finish merges ----------
  __threadfence();                         // partials visible card-wide
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + (size_t)s * n_kv + kvh;
    last_s = atomicAdd(cnt, 1) == n_live - 1;
    if (last_s) *cnt = 0;                  // every split is in: reset
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid < G) {
    const float* ml = pml + (head0 + tid) * n_split * 2;
    float M = kMaskValue;
    for (int i = 0; i < n_live; ++i) M = fmaxf(M, __ldcg(ml + 2 * i));
    float L = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float wt = expf(__ldcg(ml + 2 * i) - M);
      wt_s[tid][i] = wt;
      L += wt * __ldcg(ml + 2 * i + 1);
    }
    L_s[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += kSplitThreads) {
    const int g = e / HD, d = e % HD;
    const float* pa = pacc + (head0 + g) * n_split * HD + d;
    float A = 0.f;
    for (int i = 0; i < n_live; ++i) A += wt_s[g][i] * __ldcg(pa + i * HD);
    orow[e] = from_f<T>(A / L_s[g]);
  }
}

// ============================================================================
// one-pass kernel ("one_pass", the first version)
// ============================================================================
//
// One block per (slot, kv head); the `group` query rows of that kv head
// share every K/V row the block loads. The block walks its slot's table up
// to block write_pos[s] / bs in chunks of 64 positions, each finding its
// pool row through tables[s, c / bs]. K and V rows go straight from device
// memory into registers, every lane issuing all its 16-byte K (then V)
// loads of the chunk before using any. Scores and probabilities stay in
// shared memory, the running max, sum and output accumulator in fp32
// registers.
//
// Layout: 128 threads = 8 half-warps of 16 lanes. In a chunk, half-warp w
// owns positions w, w + 8, ...; lane l owns head dims [l * hd/16, (l+1) *
// hd/16). Pass 1: per position, partial q.k over the lane's dims, reduced
// over the 16 lanes with shuffles. Softmax update: one warp per query row.
// Pass 2: each lane accumulates p * v over its positions and dims; the 8
// half-warp partial sums are added in shared memory at the end.

constexpr int kThreads = 128;
constexpr int kHalfWarps = kThreads / 16;
constexpr int kChunk = 64;                      // positions per chunk
constexpr int kPerHalfWarp = kChunk / kHalfWarps;   // 8

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ tables,
                    const int* __restrict__ write_pos, T* __restrict__ out,
                    int H, int n_kv, int bs, int mb, int q_stride,
                    float scale) {
  constexpr int DPL = HD / 16;                  // dims per lane
  constexpr int PRE = sizeof(T) == 2 ? 8 : 4;   // loads in flight per lane
  __shared__ float sc[G][kChunk];               // scores, then p
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ float red[kHalfWarps][G][HD];

  const int s = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, hw = tid / 16, ln = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  float qr[G][DPL], acc[G][DPL];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    load_vec<T, DPL>(
        q + (size_t)s * q_stride + (kvh * G + r) * HD + ln * DPL, qr[r]);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }
  // positions 0..wp attend; a write_pos past the table clamps to its end
  const int wp = min(write_pos[s], mb * bs - 1);
  const int n_keys = wp + 1;
  const int* trow = tables + (size_t)s * mb;
  const size_t row_stride = (size_t)n_kv * HD;   // one pool position

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    // ---- pass 1: scores of this chunk -------------------------------
#pragma unroll
    for (int i0 = 0; i0 < kPerHalfWarp; i0 += PRE) {
      float kf[PRE][DPL];
#pragma unroll
      for (int j = 0; j < PRE; ++j) {
        const int c = c0 + hw + kHalfWarps * (i0 + j);
        if (c < n_keys) {
          const int blk = trow[c / bs];
          load_vec<T, DPL>(kc + ((size_t)blk * bs + c % bs) * row_stride
                               + (size_t)kvh * HD + ln * DPL, kf[j]);
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) kf[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < PRE; ++j) {
        const int cc = hw + kHalfWarps * (i0 + j);
        const bool valid = c0 + cc < n_keys;
#pragma unroll
        for (int r = 0; r < G; ++r) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part += qr[r][i] * kf[j][i];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          if (ln == 0) sc[r][cc] = valid ? part * scale : kMaskValue;
        }
      }
    }
    __syncthreads();
    // ---- online-softmax update: one warp per query row ----------------
    for (int r = warp; r < G; r += kThreads / 32) {
      const float s0 = sc[r][lane], s1 = sc[r][lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = c0 + lane < n_keys ? expf(s0 - m_new) : 0.f;
      const float p1 = c0 + lane + 32 < n_keys ? expf(s1 - m_new) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      sc[r][lane] = round_to<T>(p0);
      sc[r][lane + 32] = round_to<T>(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // ---- pass 2: acc = acc * alpha + p . v ----------------------------
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= a;
    }
#pragma unroll
    for (int i0 = 0; i0 < kPerHalfWarp; i0 += PRE) {
      float vf[PRE][DPL];
#pragma unroll
      for (int j = 0; j < PRE; ++j) {
        const int c = c0 + hw + kHalfWarps * (i0 + j);
        if (c < n_keys) {
          const int blk = trow[c / bs];
          load_vec<T, DPL>(vc + ((size_t)blk * bs + c % bs) * row_stride
                               + (size_t)kvh * HD + ln * DPL, vf[j]);
        } else {
#pragma unroll
          for (int i = 0; i < DPL; ++i) vf[j][i] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < PRE; ++j) {
        const int cc = hw + kHalfWarps * (i0 + j);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float p = sc[r][cc];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += p * vf[j][i];
        }
      }
    }
    __syncthreads();
  }

  // ---- sum the half-warp partials, normalise, store ---------------------
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[hw][r][ln * DPL + i] = acc[r][i];
  __syncthreads();
  for (int e = tid; e < G * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kHalfWarps; ++w) o += red[w][r][d];
    const float l = l_s[r];
    const float safe_l = l > 0.f ? l : 1.f;
    out[((size_t)s * H + kvh * G + r) * HD + d] = from_f<T>(o / safe_l);
  }
}

// ============================================================================
// launches
// ============================================================================

struct Args {
  const void *q, *kc, *vc;
  const int *tables, *write_pos;
  void* out;
  float* part;
  int* counters;
  int S, H, n_kv, bs, mb, P, n_split, q_stride;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int G>
cudaError_t launch_split(const Args& a) {
  using Sh = SplitShape<T, HD>;
  const int stages = a.P > kRows ? kStages : 1;
  const int smem = stages * Sh::kStageBytes;
  auto kern = flash_decode_split_kernel<T, HD, G>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.n_split, a.n_kv, a.S), kSplitThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.tables, a.write_pos,
      static_cast<T*>(a.out), a.part, a.counters, a.H, a.n_kv, a.bs, a.mb,
      a.P, a.n_split, stages, a.q_stride, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, int G>
cudaError_t launch_one_pass(const Args& a) {
  flash_decode_kernel<T, HD, G><<<dim3(a.S, a.n_kv), kThreads, 0,
                                  a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kc),
      static_cast<const T*>(a.vc), a.tables, a.write_pos,
      static_cast<T*>(a.out), a.H, a.n_kv, a.bs, a.mb, a.q_stride, a.scale);
  return cudaGetLastError();
}

// Only the (head dim, group) pairs of ops/flash_decode.py SHAPES are
// instantiated: LLAMA_TINY's (32, 2), GPT-2's (64, 1) (every size: small,
// medium, large and XL have 64-dim heads and no GQA), Llama-2-7B/13B's
// (128, 1) and the GQA parity case (128, 4). Another pair returns
// cudaErrorInvalidValue (the wrapper rejects it first).
template <bool kSplit, typename T>
cudaError_t launch_t(const Args& a, int hd) {
  const int group = a.H / a.n_kv;
#define FD_LAUNCH(HD, G) \
  return kSplit ? launch_split<T, HD, G>(a) : launch_one_pass<T, HD, G>(a)
  if (hd == 32 && group == 2) FD_LAUNCH(32, 2);
  if (hd == 64 && group == 1) FD_LAUNCH(64, 1);
  if (hd == 128 && group == 1) FD_LAUNCH(128, 1);
  if (hd == 128 && group == 4) FD_LAUNCH(128, 4);
#undef FD_LAUNCH
  return cudaErrorInvalidValue;
}

template <bool kSplit>
int launch(const Args& a, int hd, int dtype) {
  if (a.S == 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t err = dtype == 1 ? launch_t<kSplit, __nv_bfloat16>(a, hd)
                                     : launch_t<kSplit, float>(a, hd);
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers are device pointers: q [S, H,
// hd] with slot rows q_stride elements apart (heads and dims contiguous;
// q_stride * sizeof(T) a multiple of 16), contiguous out [S, H, hd] and
// kc/vc [nb, bs, n_kv, hd] (q, kc, vc 16-byte aligned), tables [S, mb]
// int32, write_pos [S] int32. Return cudaGetLastError().

// The first version: one block per (slot, kv head).
extern "C" int flash_decode(const void* q, const void* kc, const void* vc,
                            const void* tables, const void* write_pos,
                            void* out, int S, int H, int n_kv, int hd,
                            int bs, int mb, int q_stride, float scale,
                            int dtype, void* stream) {
  const Args a{q, kc, vc, static_cast<const int*>(tables),
               static_cast<const int*>(write_pos), out, nullptr, nullptr,
               S, H, n_kv, bs, mb, 0, 0, q_stride, scale,
               static_cast<cudaStream_t>(stream)};
  return launch<false>(a, hd, dtype);
}

// The split-K kernel: P positions per split (a multiple of 64), n_split =
// ceil(mb * bs / P) <= 16 splits (ops/flash_decode.py:split_plan). `part`
// is fp32 scratch of S * H * n_split * (hd + 2) floats (unused, may be
// null, when n_split == 1); `counters` S * n_kv int32 that are 0 on entry
// and are 0 again when the kernel ends.
extern "C" int flash_decode_split(const void* q, const void* kc,
                                  const void* vc, const void* tables,
                                  const void* write_pos, void* out,
                                  void* part, void* counters, int S, int H,
                                  int n_kv, int hd, int bs, int mb, int P,
                                  int n_split, int q_stride, float scale,
                                  int dtype, void* stream) {
  const long long T = (long long)mb * bs;
  if (P <= 0 || P % kRows || n_split > kMaxSplits
      || n_split != (T > 0 ? (T + P - 1) / P : 1)
      || (n_split > 1 && (part == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kc, vc, static_cast<const int*>(tables),
               static_cast<const int*>(write_pos), out,
               static_cast<float*>(part), static_cast<int*>(counters),
               S, H, n_kv, bs, mb, P, n_split, q_stride, scale,
               static_cast<cudaStream_t>(stream)};
  return launch<true>(a, hd, dtype);
}
