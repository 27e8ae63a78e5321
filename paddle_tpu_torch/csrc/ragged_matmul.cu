// Ragged grouped matmul for the MoE expert FFNs: per group g,
//     out[g, r, :] = x[g, r, :] @ w[g]    for r < counts[g]
//     out[g, r, :] = 0                    for counts[g] <= r < C
// accumulated in fp32 and stored in the output dtype.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/ragged_matmul.py:
// ragged_group_matmul (_kernel, pallas_call at :86). Same contract: x
// [G, C, K], w [G, K, N], counts [G] int32 (read from device memory, never
// by the host) -> [G, C, N]. Row tiles wholly past counts[g] write zeros
// and skip their product, so the work scales with the live rows and not
// with the capacity C; a partly live tile masks its tail rows to exact
// zeros. The TPU wrapper pads C and N to its blocks; here the edges of C,
// K and N are bounds-checked instead, so nothing is padded or copied.
//
// w is read through its strides (g, k, n), so the MoE backward's dx =
// dy @ w^T passes w.transpose(1, 2) as a view: the staging loop reads
// along whichever of k and n is contiguous. x needs a contiguous K.
//
// What bounds it on the H100: operations. At the ERNIE-MoE expert shape
// (E=8, C=2560, K=1024, N=4096, bf16, 15,360 live rows) it does
// 1.29e11 FLOPs against 277 MB moved: ~465 FLOPs per byte, above the
// card's ~295, so the tensor cores are the roof (0.130 ms).
//
// What the design does about that, and what it does not yet:
//  - bf16: one 256-thread block per (128-column tile, 128-row tile,
//    group); 8 warps as 2 x 4, each warp a 64 x 32 sub-tile of
//    mma.sync.m16n8k16 (bf16 in, fp32 accumulate) from shared memory,
//    K walked 32 deep. Tiles are staged with 16-byte loads where the
//    strides and pointer allow it, element by element otherwise;
//  - fp32: the same tiling on the CUDA cores (64 x 64 tiles, 4 x 4 FMAs
//    per thread), so fp32 keeps full precision (no TF32);
//  - one stage, synchronous: the loads of the next K chunk do not overlap
//    the products of this one. A cp.async/TMA ring feeding wgmma is the
//    later change that moves it toward its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// bf16 path: tensor cores
constexpr int kThreads = 256;
constexpr int kMmaBM = 128, kMmaBN = 128, kMmaBK = 32;
constexpr int kMmaLD = kMmaBK + 8;   // 80-byte rows: 16-byte aligned, and
                                     // the fragment loads hit 32 banks
// fp32 path: CUDA cores
constexpr int kFmaBM = 64, kFmaBN = 64, kFmaBK = 16;
constexpr int kFmaLD = kFmaBK + 4;   // 80-byte rows

struct Args {
  const void* x;
  const void* w;
  const int* counts;
  void* out;
  int C, K, N;
  long long xs_g, xs_c;              // x strides in elements (K is 1)
  long long ws_g, ws_k, ws_n;        // w strides in elements
  bool vec_x, vec_w;                 // 16-byte staging loads allowed
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Stages a ROWS x BK tile into dst[row][depth]: element (r, k) of the
// source lies at p[r * s_r + k * s_k]; rows >= lim and depths >= K read
// as 0. The loop runs along the source's contiguous axis, 16 bytes per
// load when `vec` (the caller checked pointer and stride alignment).
template <int ROWS, int BK, int LD, typename T>
__device__ __forceinline__ void stage(T (*dst)[LD], const T* __restrict__ p,
                                      long long s_r, long long s_k, int r0,
                                      int lim, int k0, int K, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const T zero = from_f<T>(0.f);
  if (s_k == 1) {                              // depth contiguous
    for (int e = threadIdx.x; e < ROWS * (BK / V); e += kThreads) {
      const int rr = e / (BK / V), kk = e % (BK / V) * V;
      const int r = r0 + rr, k = k0 + kk;
      const T* src = p + r * s_r + k;
      if (vec && r < lim && k + V <= K) {
        *reinterpret_cast<uint4*>(&dst[rr][kk]) =
            __ldg(reinterpret_cast<const uint4*>(src));
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          dst[rr][kk + i] = (r < lim && k + i < K) ? src[i] : zero;
      }
    }
  } else if (s_r == 1) {                       // rows contiguous
    // depth fastest across the lanes: a lane's V rows go to V smem rows,
    // and neighbouring lanes write neighbouring depths of each (lanes
    // along the rows would put all their stores in one bank)
    for (int e = threadIdx.x; e < (ROWS / V) * BK; e += kThreads) {
      const int kk = e % BK, rr = e / BK * V;
      const int r = r0 + rr, k = k0 + kk;
      const T* src = p + r + k * s_k;
      if (vec && r + V <= lim && k < K) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < V; ++i) dst[rr + i][kk] = t[i];
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
          dst[rr + i][kk] = (r + i < lim && k < K) ? src[i] : zero;
      }
    }
  } else {                                     // neither: element-wise
    for (int e = threadIdx.x; e < ROWS * BK; e += kThreads) {
      const int rr = e / BK, kk = e % BK;
      const int r = r0 + rr, k = k0 + kk;
      dst[rr][kk] = (r < lim && k < K) ? p[r * s_r + k * s_k] : zero;
    }
  }
}

// The tile of rows [r0, r0 + BM) x columns [n0, n0 + BN) of a dead row
// tile: zeros, bounds-checked.
template <int BM, int BN, typename OutT>
__device__ __forceinline__ void zero_tile(OutT* out, int r0, int n0, int C,
                                          int N) {
  const OutT z = from_f<OutT>(0.f);
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int r = r0 + e / BN, n = n0 + e % BN;
    if (r < C && n < N) out[(long long)r * N + n] = z;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
ragged_mma_kernel(Args a) {
  __shared__ __align__(16) bf16 As[kMmaBM][kMmaLD];   // [row][k]
  __shared__ __align__(16) bf16 Bs[kMmaBN][kMmaLD];   // [col][k]
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int live = min(max(a.counts[g], 0), a.C);
  OutT* out = static_cast<OutT*>(a.out) + (long long)g * a.C * a.N;
  if (r0 >= live) {                  // dead tile: no product, zeros
    zero_tile<kMmaBM, kMmaBN>(out, r0, n0, a.C, a.N);
    return;
  }
  const bf16* x = static_cast<const bf16*>(a.x) + g * a.xs_g;
  const bf16* w = static_cast<const bf16*>(a.w) + g * a.ws_g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;      // 2 x 4 warps
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += kMmaBK) {
    stage<kMmaBM, kMmaBK, kMmaLD>(As, x, a.xs_c, 1, r0, live, k0, a.K,
                                  a.vec_x);
    stage<kMmaBN, kMmaBK, kMmaLD>(Bs, w, a.ws_n, a.ws_k, n0, a.N, k0, a.K,
                                  a.vec_w);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kMmaBK; ks += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + gid;
        af[i][0] = ld32(&As[r][ks + 2 * tig]);
        af[i][1] = ld32(&As[r + 8][ks + 2 * tig]);
        af[i][2] = ld32(&As[r][ks + 2 * tig + 8]);
        af[i][3] = ld32(&As[r + 8][ks + 2 * tig + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + gid;
        bfr[j][0] = ld32(&Bs[c][ks + 2 * tig]);
        bfr[j][1] = ld32(&Bs[c][ks + 2 * tig + 8]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // accumulator (i, j, c) holds row gid (+8 for c >= 2), column
  // 2 * tig (+1 for odd c) of the warp's (i, j) 16 x 8 sub-tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + wm * 64 + i * 16 + gid + (c >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + j * 8 + 2 * tig + (c & 1);
        if (r < a.C && n < a.N)
          out[(long long)r * a.N + n] =
              from_f<OutT>(r < live ? acc[i][j][c] : 0.f);
      }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
ragged_fma_kernel(Args a) {
  __shared__ __align__(16) float As[kFmaBM][kFmaLD];  // [row][k]
  __shared__ __align__(16) float Bs[kFmaBN][kFmaLD];  // [col][k]
  const int g = blockIdx.z;
  const int r0 = blockIdx.y * kFmaBM, n0 = blockIdx.x * kFmaBN;
  const int live = min(max(a.counts[g], 0), a.C);
  OutT* out = static_cast<OutT*>(a.out) + (long long)g * a.C * a.N;
  if (r0 >= live) {
    zero_tile<kFmaBM, kFmaBN>(out, r0, n0, a.C, a.N);
    return;
  }
  const float* x = static_cast<const float*>(a.x) + g * a.xs_g;
  const float* w = static_cast<const float*>(a.w) + g * a.ws_g;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += kFmaBK) {
    stage<kFmaBM, kFmaBK, kFmaLD>(As, x, a.xs_c, 1, r0, live, k0, a.K,
                                  a.vec_x);
    stage<kFmaBN, kFmaBK, kFmaLD>(Bs, w, a.ws_n, a.ws_k, n0, a.N, k0, a.K,
                                  a.vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (r < a.C && n < a.N)
        out[(long long)r * a.N + n] = from_f<OutT>(r < live ? acc[i][j] : 0.f);
    }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename OutT>
cudaError_t launch(const Args& a, int G, bool bf16_in, cudaStream_t st) {
  if (bf16_in) {
    const dim3 grid((a.N + kMmaBN - 1) / kMmaBN, (a.C + kMmaBM - 1) / kMmaBM,
                    G);
    ragged_mma_kernel<OutT><<<grid, kThreads, 0, st>>>(a);
  } else {
    const dim3 grid((a.N + kFmaBN - 1) / kFmaBN, (a.C + kFmaBM - 1) / kFmaBM,
                    G);
    ragged_fma_kernel<OutT><<<grid, kThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype (of x and w) and out_dtype: 0 = float32, 1 = bfloat16. x is
// [G, C, K] with strides (xs_g, xs_c, 1); w is [G, K, N] with strides
// (ws_g, ws_k, ws_n), any of them; counts is contiguous int32 [G] on the
// device; out is contiguous [G, C, N]. Strides are in elements. Returns
// cudaGetLastError() after the launch.
extern "C" int ragged_group_matmul(const void* x, const void* w,
                                   const void* counts, void* out, int G,
                                   int C, int K, int N, long long xs_g,
                                   long long xs_c, long long ws_g,
                                   long long ws_k, long long ws_n,
                                   int dtype, int out_dtype, void* stream) {
  if (G == 0 || C == 0 || N == 0) return cudaGetLastError();
  if (G > 65535 || (C + 63) / 64 > 65535) return cudaErrorInvalidValue;
  const int v = dtype == 1 ? 8 : 4;            // elements per 16 bytes
  Args a;
  a.x = x;
  a.w = w;
  a.counts = static_cast<const int*>(counts);
  a.out = out;
  a.C = C;
  a.K = K;
  a.N = N;
  a.xs_g = xs_g;
  a.xs_c = xs_c;
  a.ws_g = ws_g;
  a.ws_k = ws_k;
  a.ws_n = ws_n;
  a.vec_x = aligned16(x) && xs_g % v == 0 && xs_c % v == 0;
  a.vec_w = aligned16(w) && ws_g % v == 0 &&
            ((ws_k == 1 && ws_n % v == 0) || (ws_n == 1 && ws_k % v == 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_dtype == 1 ? launch<bf16>(a, G, dtype == 1, st)
                     : launch<float>(a, G, dtype == 1, st);
  return static_cast<int>(err);
}
