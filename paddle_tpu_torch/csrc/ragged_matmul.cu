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
// with the capacity C; a partly live tile sets its tail rows to exact
// zeros. Nothing is padded or copied: the edges of C, K and N are masked
// by the kernels (TMA's bounds, or bounds checks).
//
// w is read through its strides (g, k, n), so the MoE backward's dx =
// dy @ w^T passes w.transpose(1, 2) as a view.
//
// What bounds it on the H100: operations. At the ERNIE-MoE expert shape
// (E=8, C=2560, K=1024, N=4096, bf16, 15,360 live rows) it does
// 1.29e11 FLOPs against 277 MB moved: ~465 FLOPs per byte, above the
// card's ~295, so the tensor cores are the roof (0.130 ms). The bytes are
// not far below it (0.083 ms), and most of them are the output (168 MB,
// dead rows' zeros included), so the stores have to overlap the products.
// Inside the card the tighter limit is L2 to shared memory: a tile reads
// its A and B chunks from L2 once per tile, hence wide tiles.
//
// Three variants; the wrapper (ops/ragged_matmul.py:_variant) picks one
// before the launch from dtype, strides and alignment:
//
// tensor cores (ragged_group_matmul_tc, bf16 in, bf16 or fp32 out), the
// main path's variant:
//  - a block owns one group's 128-row tile (two consumer warpgroups of 64
//    rows) and walks a run of 256-column tiles; the wrapper
//    (_col_runs) cuts the columns into runs of equal length, about 4
//    blocks per SM were every row tile live. Per tile, K is walked 64 deep
//    through a 4-stage ring in 128-byte-swizzled shared memory (48 KB a
//    stage), loaded by TMA: one producer thread in a ninth warp, full /
//    empty mbarriers per stage. The ring runs on across the run's tiles,
//    so the producer loads tile t+1 while the consumers store tile t;
//  - x is the K-major A operand through a 3-d tensor map [G, C, K], so TMA
//    fills the C and K edges with zeros. w takes one of two forms, fixed
//    before the launch: MN-major (n contiguous: the forward's up and down
//    projections) as four [64 k][64 n] boxes, one 128-byte swizzle atom
//    each, read by one wgmma m64n256k16 with the transpose bit and the
//    boxes' distance as its leading offset (LBO); K-major (k contiguous:
//    dx's w^T) as one [256 n][64 k] box;
//  - each warpgroup keeps one chunk's products in flight while it issues
//    the next; descriptors are made where they are used (hopper::desc_at);
//  - epilogue: row r of the tile gets `r < live ? acc : 0`, a select and
//    never a multiply, so NaN that TMA loaded from the dead rows of a
//    partly live tile stays in those rows' accumulators. In passes of 256
//    bytes a row, each warpgroup writes its 64 rows into 128-byte-swizzled
//    shared memory (conflict-free 4-byte writes) and one thread TMA-stores
//    them, clipped at C and N, without waiting: a store drains while the
//    next pass is written and the next tile's products run;
//  - a row tile wholly past min(max(counts[g], 0), C) issues no load and no
//    wgmma: one thread TMA-stores one zeroed box over its run and exits.
//
// Why 128 x 256 and not 128 x 128: a 128-column tile reads 64 FLOPs per
// byte from L2, a 256-column one 85, and a wider wgmma reads A from
// shared memory once for twice the columns; on the H100 the 128-column
// kernel was slower at every ERNIE-MoE shape, and slower than cuBLAS's
// bmm. 128 fp32 accumulators a consumer thread fit the 168 registers
// that 9 warps leave, with the epilogue's addresses made in the pass.
// More ring stages than 4 gained nothing there; 3 were slower.
//
// mma.sync (ragged_group_matmul_mma, bf16): the first version, kept for
// the bf16 operands TMA cannot read (a base not 16-byte aligned, a stride
// not a multiple of 8 elements, neither of w's k and n strides 1, N not a
// multiple of 8). One 256-thread block per (128-column tile, 128-row
// tile, group); 8 warps as 2 x 4, each warp a 64 x 32 sub-tile of
// mma.sync.m16n8k16 from padded shared memory, K walked 32 deep in one
// synchronous stage, operands staged by all threads (16-byte loads where
// the strides allow it).
//
// CUDA cores (ragged_group_matmul_fma, fp32): the same tiling with 64 x 64
// tiles and 4 x 4 FMAs per thread, so fp32 keeps full precision (the tensor
// cores would round it to TF32).
//
// What is left: the two consumer warpgroups work on the same tile, so the
// tensor cores idle while both write their epilogue (a ping-pong of the
// warpgroups over two tiles would hide it); no cluster shares a TMA load
// between blocks; at the down shape (4 column tiles of 256) the last wave
// of blocks is short.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

// mma.sync variant (bf16)
constexpr int kThreads = 256;
constexpr int kMmaBM = 128, kMmaBN = 128, kMmaBK = 32;
constexpr int kMmaLD = kMmaBK + 8;   // 80-byte rows: 16-byte aligned, and
                                     // the fragment loads hit 32 banks
// CUDA-core variant (fp32)
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

// ---------------------------------------------------------------------------
// tensor-core variant (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                      // rows per block
constexpr int kTcCols = 256;                      // columns per tile
constexpr int kTcDepth = 64;                      // K per stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 256 + 32;              // 2 warpgroups + producer
constexpr int kTcABytes = kTcRows * kTcDepth * 2;     // [128 rows][64 k]
constexpr int kTcBBytes = kTcCols * kTcDepth * 2;     // 4 x [64 k][64 n] or
                                                      // [256 n][64 k]
constexpr int kBoxBytes = 64 * 128;               // [64 rows][128 bytes]
constexpr int kOutBytes = 2 * 2 * kBoxBytes;      // 2 boxes per warpgroup
constexpr int kTcSmem = 1024 + kTcStages * (kTcABytes + kTcBBytes) +
                        kOutBytes + 2 * kTcStages * 8;

// two neighbouring outputs to shared address a, in the output dtype
__device__ __forceinline__ void store_pair(uint32_t a, float x, float y,
                                           bf16*) {
  asm volatile("st.shared.b32 [%0], %1;\n"
               :: "r"(a), "r"(hopper::pack_bf16(x, y)) : "memory");
}

__device__ __forceinline__ void store_pair(uint32_t a, float x, float y,
                                           float*) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n"
               :: "r"(a), "f"(x), "f"(y) : "memory");
}

// KMajorW: w's k stride is 1 (dx's w^T); else its n stride is 1
template <typename OutT, bool KMajorW>
__global__ void __launch_bounds__(kTcThreads, 1)
ragged_tc_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap to,
                 const int* __restrict__ counts, int C, int K, int N,
                 int col_runs) {
  constexpr int kBoxCols = 128 / sizeof(OutT);    // output box width
  constexpr int kPassCols = 2 * kBoxCols;         // columns per store pass
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = base;                               // [stage][A]
  uint8_t* Bs = As + kTcStages * kTcABytes;         // [stage][B]
  uint8_t* Os = Bs + kTcStages * kTcBBytes;         // [warpgroup][box]
  uint64_t* full = reinterpret_cast<uint64_t*>(Os + kOutBytes);
  uint64_t* empty = full + kTcStages;

  const int g = blockIdx.z, r0 = blockIdx.y * kTcRows;
  const int n_ct = (N + kTcCols - 1) / kTcCols;
  const int t_begin = blockIdx.x * n_ct / col_runs;
  const int t_end = (blockIdx.x + 1) * n_ct / col_runs;
  const int live = min(max(counts[g], 0), C);

  if (r0 >= live) {
    // dead row tile: no load, no product; one zeroed box stored over the
    // run's tiles
    for (int e = threadIdx.x; e < kBoxBytes / 16; e += kTcThreads)
      reinterpret_cast<uint4*>(Os)[e] = make_uint4(0, 0, 0, 0);
    hopper::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int t = t_begin; t < t_end; ++t)
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < kTcCols; c += kBoxCols)
            hopper::tma_store_3d(&to, Os, t * kTcCols + c, r0 + 64 * h, g);
      hopper::bulk_commit();
      hopper::bulk_wait();
    }
    return;
  }

  const int n_k = (K + kTcDepth - 1) / kTcDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread streams (x, w) chunks through the ring,
    // tile after tile of the run
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const int n0 = t * kTcCols;
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int s = it % kTcStages;
        hopper::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], kTcABytes + kTcBBytes);
        uint8_t* b = Bs + s * kTcBBytes;
        hopper::tma_load_3d(As + s * kTcABytes, &tx, &full[s],
                            kc * kTcDepth, r0, g);
        if constexpr (KMajorW) {
          hopper::tma_load_3d(b, &tw, &full[s], kc * kTcDepth, n0, g);
        } else {
#pragma unroll
          for (int q = 0; q < kTcCols / 64; ++q)
            hopper::tma_load_3d(b + q * kBoxBytes, &tw, &full[s],
                                n0 + 64 * q, kc * kTcDepth, g);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows r0 + 64 wg .. + 63 of every
  // tile, all 256 columns (acc element i: row 16 warp + lane / 4 +
  // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool leader = threadIdx.x % 128 == 0;
  const uint32_t a_base = hopper::smem_u32(As) + wg * 64 * 128;
  const uint32_t b_base = hopper::smem_u32(Bs);
  uint8_t* out_tile = Os + wg * 2 * kBoxBytes;
  const uint32_t out_base = hopper::smem_u32(out_tile);
  const int row = 16 * warp + lane / 4;          // and row + 8
  const bool ok0 = r0 + 64 * wg + row < live;
  const bool ok1 = r0 + 64 * wg + row + 8 < live;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int st = it % kTcStages;
      hopper::mbar_wait(&full[st], (it / kTcStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcDepth / 16; ++kk) {
        const uint64_t da =
            hopper::desc_at(a_base, st * kTcABytes + kk * 32, 1024, 128);
        if constexpr (KMajorW)
          hopper::wgmma_ss_n256<0>(
              acc, da,
              hopper::desc_at(b_base, st * kTcBBytes + kk * 32, 1024, 128),
              kc > 0 || kk > 0);
        else     // four 64-column boxes, kBoxBytes apart: the LBO
          hopper::wgmma_ss_n256<1>(
              acc, da,
              hopper::desc_at(b_base, st * kTcBBytes + kk * 16 * 128, 1024,
                              128, kBoxBytes),
              kc > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      // keep one chunk's products in flight; release the chunk before it
      hopper::wgmma_wait<1>();
      if (kc > 0) hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);

    // epilogue, in passes of 256 bytes a row: the previous store has read
    // the buffer; rows past `live` get 0 by a select; 128-byte swizzle:
    // the 16-byte chunk c of a box row r lies at chunk c ^ (r % 8). The
    // addresses are made in the pass (the empty asm keeps the compiler
    // from hoisting 64 of them out of the tile loop into registers)
#pragma unroll
    for (int pass = 0; pass < kTcCols / kPassCols; ++pass) {
      if (leader) hopper::bulk_wait_read();
      hopper::bar_sync(1 + wg, 128);
      uint32_t ob = out_base;
      asm volatile("" : "+r"(ob));
#pragma unroll
      for (int jj = 0; jj < kPassCols / 8; ++jj) {
        const int j = pass * (kPassCols / 8) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          const bool ok = h == 0 ? ok0 : ok1;
          const int c = 8 * jj + 2 * (lane % 4);
          const int cb = (c % kBoxCols) * static_cast<int>(sizeof(OutT));
          store_pair(ob + (c / kBoxCols) * kBoxBytes + r * 128 +
                         (((cb / 16) ^ (r % 8)) * 16) + cb % 16,
                     ok ? acc[4 * j + 2 * h] : 0.f,
                     ok ? acc[4 * j + 2 * h + 1] : 0.f,
                     static_cast<OutT*>(nullptr));
        }
      }
      hopper::fence_proxy_async();
      hopper::bar_sync(1 + wg, 128);
      if (leader) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          hopper::tma_store_3d(&to, out_tile + b * kBoxBytes,
                               t * kTcCols + pass * kPassCols + b * kBoxCols,
                               r0 + 64 * wg, g);
        hopper::bulk_commit();
      }
    }
  }
  if (leader) hopper::bulk_wait();
}

template <typename OutT, bool KMajorW>
cudaError_t launch_tc(const CUtensorMap& tx, const CUtensorMap& tw,
                      const CUtensorMap& to, const int* counts, int G, int C,
                      int K, int N, int col_runs, cudaStream_t st) {
  auto kernel = ragged_tc_kernel<OutT, KMajorW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(col_runs, (C + kTcRows - 1) / kTcRows, G);
  kernel<<<grid, kTcThreads, kTcSmem, st>>>(tx, tw, to, counts, C, K, N,
                                            col_runs);
  return cudaGetLastError();
}

}  // namespace

// The variants' entries, one signature. dtype (of x and w) and out_dtype:
// 0 = float32, 1 = bfloat16. x is [G, C, K] with strides (xs_g, xs_c, 1);
// w is [G, K, N] with strides (ws_g, ws_k, ws_n); counts is contiguous
// int32 [G] on the device; out is contiguous [G, C, N]. Strides are in
// elements. col_runs (the tensor-core variant's blocks along N, 1 to
// ceil(N / 256)) is ignored by the others. Each returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// operands it does not take.

// tensor cores: bf16 x and w that TMA can read (16-byte aligned bases;
// xs_c, xs_g, N and w's strides other than its unit one multiples of 8)
extern "C" int ragged_group_matmul_tc(const void* x, const void* w,
                                      const void* counts, void* out, int G,
                                      int C, int K, int N, long long xs_g,
                                      long long xs_c, long long ws_g,
                                      long long ws_k, long long ws_n,
                                      int dtype, int out_dtype, int col_runs,
                                      void* stream) {
  if (G == 0 || C == 0 || N == 0) return cudaGetLastError();
  const int n_ct = (N + kTcCols - 1) / kTcCols;
  const bool k_major = ws_k == 1;
  if (dtype != 1 || K < 1 || N % 8 != 0 || !(k_major || ws_n == 1) ||
      col_runs < 1 || col_runs > n_ct || G > 65535 ||
      (C + kTcRows - 1) / kTcRows > 65535 || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t e = 2;                           // bytes per bf16
  CUtensorMap tx, tw, to;
  const cuuint64_t xdims[3] = {(cuuint64_t)K, (cuuint64_t)C, (cuuint64_t)G};
  const cuuint64_t xstr[2] = {(cuuint64_t)xs_c * e, (cuuint64_t)xs_g * e};
  const cuuint32_t xbox[3] = {kTcDepth, kTcRows, 1};
  cudaError_t err = hopper::encode_bf16(&tx, x, 3, xdims, xstr, xbox, 128);
  if (err == cudaSuccess) {
    if (k_major) {               // [G][N][K]: box [256 n][64 k]
      const cuuint64_t d[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)G};
      const cuuint64_t s[2] = {(cuuint64_t)ws_n * e, (cuuint64_t)ws_g * e};
      const cuuint32_t b[3] = {kTcDepth, kTcCols, 1};
      err = hopper::encode_bf16(&tw, w, 3, d, s, b, 128);
    } else {                     // [G][K][N]: box [64 k][64 n]
      const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)G};
      const cuuint64_t s[2] = {(cuuint64_t)ws_k * e, (cuuint64_t)ws_g * e};
      const cuuint32_t b[3] = {64, kTcDepth, 1};
      err = hopper::encode_bf16(&tw, w, 3, d, s, b, 128);
    }
  }
  if (err == cudaSuccess) {
    const cuuint64_t oe = out_dtype == 1 ? 2 : 4;
    const cuuint64_t d[3] = {(cuuint64_t)N, (cuuint64_t)C, (cuuint64_t)G};
    const cuuint64_t s[2] = {(cuuint64_t)N * oe, (cuuint64_t)C * N * oe};
    const cuuint32_t b[3] = {static_cast<cuuint32_t>(128 / oe), 64, 1};
    err = hopper::encode(&to,
                         out_dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         out, 3, d, s, b, 128);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* cnt = static_cast<const int*>(counts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    err = k_major ? launch_tc<bf16, true>(tx, tw, to, cnt, G, C, K, N,
                                          col_runs, st)
                  : launch_tc<bf16, false>(tx, tw, to, cnt, G, C, K, N,
                                           col_runs, st);
  else
    err = k_major ? launch_tc<float, true>(tx, tw, to, cnt, G, C, K, N,
                                           col_runs, st)
                  : launch_tc<float, false>(tx, tw, to, cnt, G, C, K, N,
                                            col_runs, st);
  return static_cast<int>(err);
}

namespace {

// the first versions' arguments; cudaErrorInvalidValue for a grid they
// cannot launch
cudaError_t first_args(Args* a, const void* x, const void* w,
                       const void* counts, void* out, int G, int C, int K,
                       int N, long long xs_g, long long xs_c, long long ws_g,
                       long long ws_k, long long ws_n, int dtype) {
  if (G > 65535 || (C + 63) / 64 > 65535) return cudaErrorInvalidValue;
  const int v = dtype == 1 ? 8 : 4;            // elements per 16 bytes
  a->x = x;
  a->w = w;
  a->counts = static_cast<const int*>(counts);
  a->out = out;
  a->C = C;
  a->K = K;
  a->N = N;
  a->xs_g = xs_g;
  a->xs_c = xs_c;
  a->ws_g = ws_g;
  a->ws_k = ws_k;
  a->ws_n = ws_n;
  a->vec_x = aligned16(x) && xs_g % v == 0 && xs_c % v == 0;
  a->vec_w = aligned16(w) && ws_g % v == 0 &&
             ((ws_k == 1 && ws_n % v == 0) || (ws_n == 1 && ws_k % v == 0));
  return cudaSuccess;
}

}  // namespace

// mma.sync: bf16 x and w, any strides
extern "C" int ragged_group_matmul_mma(const void* x, const void* w,
                                       const void* counts, void* out, int G,
                                       int C, int K, int N, long long xs_g,
                                       long long xs_c, long long ws_g,
                                       long long ws_k, long long ws_n,
                                       int dtype, int out_dtype, int,
                                       void* stream) {
  if (G == 0 || C == 0 || N == 0) return cudaGetLastError();
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  cudaError_t err = first_args(&a, x, w, counts, out, G, C, K, N, xs_g, xs_c,
                               ws_g, ws_k, ws_n, dtype);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kMmaBN - 1) / kMmaBN, (C + kMmaBM - 1) / kMmaBM, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    ragged_mma_kernel<bf16><<<grid, kThreads, 0, st>>>(a);
  else
    ragged_mma_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// CUDA cores: fp32 x and w, any strides
extern "C" int ragged_group_matmul_fma(const void* x, const void* w,
                                       const void* counts, void* out, int G,
                                       int C, int K, int N, long long xs_g,
                                       long long xs_c, long long ws_g,
                                       long long ws_k, long long ws_n,
                                       int dtype, int out_dtype, int,
                                       void* stream) {
  if (G == 0 || C == 0 || N == 0) return cudaGetLastError();
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  cudaError_t err = first_args(&a, x, w, counts, out, G, C, K, N, xs_g, xs_c,
                               ws_g, ws_k, ws_n, dtype);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kFmaBN - 1) / kFmaBN, (C + kFmaBM - 1) / kFmaBM, G);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    ragged_fma_kernel<bf16><<<grid, kThreads, 0, st>>>(a);
  else
    ragged_fma_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
