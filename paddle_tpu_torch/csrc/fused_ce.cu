// Fused LM-head cross-entropy statistics: per-row online log-sum-exp of
// hidden @ w and the label's logit, in one pass over the vocabulary, with
// logits only ever held as a register tile.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused_ce.py:fused_ce_stats
// (_stats_kernel, pallas_call at :114). Same contract: hidden [N, H] and
// w [H, V] (the paddle Linear layout [in, out], V contiguous) in bf16 or
// fp32, int64 labels [N] -> fp32 (m, s, lab) [N] with
//     m   = max_v logit[n, v]
//     s   = sum_v exp(logit[n, v] - m)
//     lab = logit[n, labels[n]]   (0 if the label is not a column here)
// so nll = log(s) + m - lab. vocab_offset places this w's columns in the
// global vocabulary: column c is vocabulary id vocab_offset + c. The
// ragged V edge is masked, and a label that falls on a padding column
// contributes 0 (the TPU kernel insists on the same); rows past N are
// computed but never stored.
//
// What bounds it on the H100: operations. 2 * N * H * V FLOPs against
// (N * H + H * V) elements read: at the training head (N = 4094, H = 4096,
// V = 32000) about 4,000 FLOPs per byte, far above the card's ~295: a
// bf16 GEMM with an epilogue that must never write a logit.
//
// Both variants split the vocabulary across blocks (grid = row tiles x
// splits, the wrapper picks the splits) and merge each row's per-split
// triples in a second, tiny kernel (merge_splits_kernel, the same merge as
// the TPU kernel's shard ring). The wrapper (ops/fused_ce.py:_variant)
// picks the variant before the launch from dtype, strides and alignment:
//
// tensor cores (fused_ce_stats_tc, bf16), the main path's variant:
//  - a block owns 128 hidden rows (two consumer warpgroups of 64) and
//    walks its split in 128-column vocabulary tiles; per tile, H is walked
//    64 deep through a 4-stage ring in 128-byte-swizzled shared memory,
//    loaded by TMA (one producer thread, full/empty mbarriers per stage);
//  - wgmma m64n64k16 bf16 -> fp32: hidden [N, H] is the K-major A
//    operand, w [H, V] (V contiguous) the MN-major B operand (transpose
//    bit); each warpgroup keeps one chunk's products in flight while it
//    issues the next;
//  - the epilogue runs on the accumulator registers: per row the tile's
//    max, the exp-sum below it and the label's logit (counted only where
//    the column is valid, as _stats_kernel's hit = col == label & valid),
//    reduced with quad shuffles (a warpgroup holds whole rows of the
//    tile), merged online into the row's (m, s, lab) in registers;
//  - block order for L2: the row tile is blockIdx.x, the fastest index,
//    so the 32 row tiles of one split run side by side and each w tile
//    (5x L2 in all, 262 MB) comes from HBM about once and then from L2;
//    read once per row tile it would cost 8.4 GB, 2.3x the whole bound;
//  - TMA loads the ragged N, H and V edges as zeros; the V edge is masked.
//
// CUDA cores (fused_ce_stats, fp32 and bf16): the first version. Every
// fp32 call takes it (the tensor cores would compute fp32 in TF32, and
// the fp32 checks need full fp32 products), and bf16 takes it where TMA
// cannot read the operands: a row stride that is not a multiple of 16
// bytes (V = 301, or GPT-2's 50257) or a base not 16-byte aligned. One
// block per (32-row tile, split), 256 threads each computing a 4-row x
// 4-column register tile of a 128-column vocabulary tile, H staged 32 deep
// in shared memory as fp32, scalar FMAs; a warp owns 4 whole rows, so the
// per-tile max, exp-sum and label pick reduce with warp shuffles only.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // hidden rows per block
constexpr int kCols = 128;                // vocabulary columns per tile
constexpr int kDepth = 32;                // H per staged chunk
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ce_stats_kernel(const T* __restrict__ hid, const T* __restrict__ w,
                      const long long* __restrict__ labels,
                      float* __restrict__ part, int N, int H, int V,
                      long long h_ld, long long w_ld, long long vocab_offset,
                      int split_cols) {
  // hidden chunk transposed, rows padded to 36 so each k-row starts on a
  // 16-byte boundary (one vector load gives a thread its 4 rows)
  __shared__ __align__(16) float Hs[kDepth][kRows + 4];
  __shared__ float Ws[kDepth][kCols];

  const int n0 = blockIdx.x * kRows;
  const int c_begin = blockIdx.y * split_cols;           // this split's
  const int c_end = min(V, c_begin + split_cols);        // columns
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;  // warp owns rows 4w..4w+3
  float m[4], s[4], lab[4];
  long long lbl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + 4 * warp + i;
    m[i] = kMaskValue;
    s[i] = 0.f;
    lab[i] = 0.f;
    lbl[i] = row < N ? labels[row] : -1;
  }

  for (int v0 = c_begin; v0 < c_end; v0 += kCols) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < H; k0 += kDepth) {
      for (int e = tid; e < kRows * kDepth; e += kThreads) {
        const int rr = e / kDepth, kk = e % kDepth;
        const int n = n0 + rr, kd = k0 + kk;
        Hs[kk][rr] = (n < N && kd < H)
                         ? to_f(hid[(long long)n * h_ld + kd]) : 0.f;
      }
      for (int e = tid; e < kDepth * kCols; e += kThreads) {
        const int kk = e / kCols, cc = e % kCols;
        const int kd = k0 + kk, c = v0 + cc;
        Ws[kk][cc] = (kd < H && c < c_end)
                         ? to_f(w[(long long)kd * w_ld + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 hv = *reinterpret_cast<const float4*>(&Hs[kk][4 * warp]);
        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
        float w4[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w4[j] = Ws[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += h4[i] * w4[j];
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + lane + 32 * j < c_end) tmax = fmaxf(tmax, acc[i][j]);
      tmax = warp_max(tmax);
      const float m_new = fmaxf(m[i], tmax);
      float ps = 0.f, hit = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = v0 + lane + 32 * j;
        if (c < c_end) {
          ps += expf(acc[i][j] - m_new);
          if (vocab_offset + c == lbl[i]) hit += acc[i][j];
        }
      }
      ps = warp_sum(ps);
      hit = warp_sum(hit);
      s[i] = s[i] * expf(m[i] - m_new) + ps;
      m[i] = m_new;
      lab[i] += hit;
    }
  }

  if (lane == 0) {                 // this split's triples: part[split][3][N]
    float* pb = part + (long long)blockIdx.y * 3 * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + 4 * warp + i;
      if (row < N) {
        pb[row] = m[i];
        pb[N + row] = s[i];
        pb[2 * N + row] = lab[i];
      }
    }
  }
}

// Merges each row's per-split (m, s, lab): m = max, s rescaled to it and
// summed, lab summed (a label lies in at most one split).
__global__ void merge_splits_kernel(const float* __restrict__ part,
                                    int splits, int N, float* __restrict__ m,
                                    float* __restrict__ s,
                                    float* __restrict__ lab) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float mx = kMaskValue;
  for (int k = 0; k < splits; ++k) mx = fmaxf(mx, part[3LL * k * N + row]);
  float sum = 0.f, hit = 0.f;
  for (int k = 0; k < splits; ++k) {
    const float* pb = part + 3LL * k * N;
    sum += pb[N + row] * expf(pb[row] - mx);
    hit += pb[2 * N + row];
  }
  m[row] = mx;
  s[row] = sum;
  lab[row] = hit;
}

template <typename T>
cudaError_t launch(const void* hid, const void* w, const void* labels,
                   float* part, int splits, float* m, float* s, float* lab,
                   int N, int H, int V, long long h_ld, long long w_ld,
                   long long vocab_offset, cudaStream_t stream) {
  const int tiles = (V + kCols - 1) / kCols;
  const int split_cols = (tiles + splits - 1) / splits * kCols;
  const dim3 grid((N + kRows - 1) / kRows, splits);
  fused_ce_stats_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(hid), static_cast<const T*>(w),
      static_cast<const long long*>(labels), part, N, H, V, h_ld, w_ld,
      vocab_offset, split_cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_splits_kernel<<<(N + 255) / 256, 256, 0, stream>>>(part, splits, N,
                                                           m, s, lab);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. hidden is [N, H] with row stride h_ld
// and w [H, V] with row stride w_ld, both with a contiguous last dim;
// labels are contiguous int64 [N]; part is fp32 scratch [splits, 3, N]
// (1 <= splits <= ceil(V / 128)); m, s, lab are contiguous fp32 [N].
// Returns cudaGetLastError() after the launches.
extern "C" int fused_ce_stats(const void* hidden, const void* w,
                              const void* labels, void* part, int splits,
                              void* m, void* s, void* lab, int N, int H,
                              int V, long long h_ld, long long w_ld,
                              long long vocab_offset, int dtype,
                              void* stream) {
  if (N == 0) return cudaGetLastError();
  if (splits < 1 || splits > (V + kCols - 1) / kCols)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  float* mp = static_cast<float*>(m);
  float* sp = static_cast<float*>(s);
  float* lp = static_cast<float*>(lab);
  const cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(hidden, w, labels, pp, splits, mp,
                                         sp, lp, N, H, V, h_ld, w_ld,
                                         vocab_offset, st)
                 : launch<float>(hidden, w, labels, pp, splits, mp, sp, lp,
                                 N, H, V, h_ld, w_ld, vocab_offset, st);
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// bf16 tensor-core variant (see the note at the top)
// ---------------------------------------------------------------------------

namespace {

constexpr int kTcGroups = 2;                      // consumer warpgroups
constexpr int kTcRows = 64 * kTcGroups;           // hidden rows per block
constexpr int kTcDepth = 64;                      // H per stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128 * kTcGroups + 32;  // + producer warp
constexpr int kTcABytes = kTcRows * 128;          // [128 rows][64 k] bf16
constexpr int kTcBBytes = 2 * kTcDepth * 128;     // 2 x [64 k][64 cols]
constexpr int kTcSmem = 1024 + kTcStages * (kTcABytes + kTcBBytes) + 64;

__global__ void __launch_bounds__(kTcThreads, 1)
fused_ce_stats_tc_kernel(const __grid_constant__ CUtensorMap th,
                         const __grid_constant__ CUtensorMap tw,
                         const long long* __restrict__ labels,
                         float* __restrict__ part, int N, int H, int V,
                         long long vocab_offset, int split_cols) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = base;                                   // [stage][A]
  uint8_t* Bs = As + kTcStages * kTcABytes;             // [stage][B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kTcStages * kTcBBytes);
  uint64_t* empty = full + kTcStages;

  // row tile fastest in the grid: the 32 row tiles that share a w tile
  // run together, so w is read from HBM about once and then from L2
  const int n0 = blockIdx.x * kTcRows;
  const int c_begin = blockIdx.y * split_cols;
  const int c_end = min(V, c_begin + split_cols);
  const int n_vtiles = (c_end - c_begin + kCols - 1) / kCols;
  const int n_k = (H + kTcDepth - 1) / kTcDepth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128 * kTcGroups);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * kTcGroups) {
    // ---- producer: one thread streams (hidden, w) chunks through the ring
    if (threadIdx.x != 128 * kTcGroups) return;
    int it = 0;
    for (int t = 0; t < n_vtiles; ++t) {
      const int v0 = c_begin + t * kCols;
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int s = it % kTcStages;
        hopper::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], kTcABytes + kTcBBytes);
        uint8_t* a = As + s * kTcABytes;
        uint8_t* bt = Bs + s * kTcBBytes;
        hopper::tma_load_2d(a, &th, &full[s], kc * kTcDepth, n0);
        hopper::tma_load_2d(bt, &tw, &full[s], v0, kc * kTcDepth);
        hopper::tma_load_2d(bt + kTcDepth * 128, &tw, &full[s], v0 + 64,
                            kc * kTcDepth);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g owns rows n0 + 64 g .. + 63, all 128
  // columns of each vocabulary tile (two 64-wide accumulators)
  const int g = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = n0 + 64 * g + 16 * warp + lane / 4;   // and row0 + 8
  float m[2], s[2], lab[2];
  long long lbl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    m[r] = kMaskValue;
    s[r] = 0.f;
    lab[r] = 0.f;
    lbl[r] = row < N ? labels[row] : -1;
  }

  float acc[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
  int it = 0;
  for (int t = 0; t < n_vtiles; ++t) {
    const int v0 = c_begin + t * kCols;
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int st = it % kTcStages;
      hopper::mbar_wait(&full[st], (it / kTcStages) & 1);
      const uint8_t* a = As + st * kTcABytes + g * 64 * 128;
      const uint8_t* bt = Bs + st * kTcBBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcDepth / 16; ++kk) {
        const uint64_t da = hopper::make_desc(a + kk * 32, 1024, 128);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint64_t db = hopper::make_desc(
              bt + p * kTcDepth * 128 + kk * 16 * 128, 1024, 128);
          hopper::wgmma_ss_n64<1>(acc[p], da, db, kc > 0 || kk > 0);
        }
      }
      hopper::wgmma_commit();
      // keep one chunk's products in flight; release the chunk before it
      hopper::wgmma_wait<1>();
      if (kc > 0) hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc[0]);
    hopper::fence_regs(acc[1]);
    hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);

    // epilogue on the accumulators: per row the tile's max, the exp-sum
    // below it and the label's logit, merged online into (m, s, lab)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = kMaskValue;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i / 2) % 2 != r) continue;
          const int c = v0 + 64 * p + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (c < c_end) tmax = fmaxf(tmax, acc[p][i]);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[r], tmax);
      float ps = 0.f, hit = 0.f;
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if ((i / 2) % 2 != r) continue;
          const int c = v0 + 64 * p + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
          if (c < c_end) {
            ps += expf(acc[p][i] - m_new);
            if (vocab_offset + c == lbl[r]) hit += acc[p][i];
          }
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
        hit += __shfl_xor_sync(0xffffffffu, hit, o);
      }
      s[r] = s[r] * expf(m[r] - m_new) + ps;
      m[r] = m_new;
      lab[r] += hit;
    }
  }

  if (lane % 4 == 0) {             // this split's triples: part[split][3][N]
    float* pb = part + (long long)blockIdx.y * 3 * N;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < N) {
        pb[row] = m[r];
        pb[N + row] = s[r];
        pb[2 * N + row] = lab[r];
      }
    }
  }
}

}  // namespace

// The bf16 tensor-core variant, same arguments as fused_ce_stats (dtype
// must be 1). The caller guarantees what TMA needs: 16-byte aligned hidden
// and w, row strides that are multiples of 8 elements. Returns
// cudaGetLastError() after the launches, or the error of a tensor map that
// could not be made.
extern "C" int fused_ce_stats_tc(const void* hidden, const void* w,
                                 const void* labels, void* part, int splits,
                                 void* m, void* s, void* lab, int N, int H,
                                 int V, long long h_ld, long long w_ld,
                                 long long vocab_offset, int dtype,
                                 void* stream) {
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return cudaGetLastError();
  const int tiles = (V + kCols - 1) / kCols;
  if (splits < 1 || splits > tiles) return cudaErrorInvalidValue;
  CUtensorMap th, tw;
  const cuuint64_t hdims[2] = {(cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t hstr[1] = {(cuuint64_t)h_ld * 2};
  const cuuint32_t hbox[2] = {kTcDepth, kTcRows};
  const cuuint64_t wdims[2] = {(cuuint64_t)V, (cuuint64_t)H};
  const cuuint64_t wstr[1] = {(cuuint64_t)w_ld * 2};
  const cuuint32_t wbox[2] = {64, kTcDepth};
  cudaError_t err = hopper::encode_bf16(&th, hidden, 2, hdims, hstr, hbox,
                                        128);
  if (err == cudaSuccess)
    err = hopper::encode_bf16(&tw, w, 2, wdims, wstr, wbox, 128);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(fused_ce_stats_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int split_cols = (tiles + splits - 1) / splits * kCols;
  const int used = (tiles + split_cols / kCols - 1) / (split_cols / kCols);
  const dim3 grid((N + kTcRows - 1) / kTcRows, used);
  fused_ce_stats_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
      th, tw, static_cast<const long long*>(labels),
      static_cast<float*>(part), N, H, V, vocab_offset, split_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_splits_kernel<<<(N + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), used, N, static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(lab));
  return static_cast<int>(cudaGetLastError());
}
