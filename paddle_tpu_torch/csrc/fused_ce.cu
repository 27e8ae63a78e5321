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
// V = 32000) about 4,000 FLOPs per byte, far above the card's ~295.
//
// What the design does about that, and what it does not yet:
//  - one block per (32-row tile of hidden, vocabulary split); a loop
//    inside the block walks its split in 128-column tiles (the TPU's
//    sequential grid axis) and keeps (m, s, lab) of its rows in registers
//    across tiles, so no logit ever reaches device memory. The splits
//    exist because 32-row tiles alone give only 128 blocks at N = 4094,
//    one 8-warp block per SM, too few warps to hide the loads; the wrapper
//    picks enough splits for ~4 blocks per SM. A second, tiny kernel
//    merges each row's per-split triples (the same merge as the TPU
//    kernel's shard ring);
//  - each tile's product runs over H in 32-deep chunks staged in shared
//    memory (fp32): 256 threads, each computing a 4-row x 4-column register
//    tile; a warp owns 4 whole rows, so the per-tile max, exp-sum and label
//    pick reduce with warp shuffles only;
//  - the w tile is read by every block: the blocks walk the vocabulary in
//    step, so most of those reads hit the 50 MB L2;
//  - the products are plain fp32 FMAs on the CUDA cores (one kernel for
//    bf16 and fp32): right first. mma/wgmma tiles fed by TMA are the
//    later change that moves it toward its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cfloat>
#include <cstdint>

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
