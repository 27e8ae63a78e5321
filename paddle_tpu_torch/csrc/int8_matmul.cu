// int8 x int8 -> int32 matmul with a per-row x per-column fp32 rescale:
//     out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n]
// stored as bf16 or fp32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py:
// int8_matmul_rescale (_kernel :22, pallas_call :50). Same contract: xq
// [M, K] int8 (activations quantized per row), xs [M, 1] fp32, wq [K, N]
// int8 (the weight in the paddle [in, out] layout), ws [1, N] fp32 ->
// [M, N]. The TPU kernel kept K whole in VMEM; 227 KB of shared memory
// cannot hold that, so K is walked in chunks. The TPU wrapper pads M and N
// to its blocks; here the M, N and K edges are masked by the kernels (TMA
// bounds or bounds checks), so nothing is padded or copied.
//
// Exactness: the int32 sums are exact (overflow needs K > 133,000: 127 *
// 127 * K < 2^31, far past every width here), and the epilogue is
// __int2float_rn(acc) * xs[m] * ws[n] in that order, two IEEE products
// with no FMA contraction (explicit __fmul_rn; no --use_fast_math), then
// one rounding to the output dtype. The plain version computes the same
// products in the same order, so every variant agrees with it bit for bit.
//
// What bounds it on the H100: operations. At the Llama-2-7B shapes the
// main path launches (M = 512 rows; K x N = 4096 x 4096 for q/k/v/o,
// 4096 x 11008 for gate/up, 11008 x 4096 for down, 4096 x 32000 for the
// head) it does about 790 int8 operations per byte it must move (4.62e10
// against 58 MB at the up shape), above the card's ~590, so the tensor
// cores are the roof (0.0233 ms at up and down, 0.0087 at q/k/v/o). At
// decode-like M the weight read bounds it instead.
//
// The layout: Hopper's int8 wgmma reads both operands K-major (the
// reduction axis contiguous) and only so: the transpose bits exist for
// 16-bit types alone. xq [M, K] is K-major as it lies. The weight is
// therefore stored K-major too: Int8Linear.qweight is the [in, out] view
// of [out, in] storage (nn/quant/__init__.py), so wq^T [N, K] is
// contiguous and TMA reads it as it lies; the shape, values and state_dict
// key stay the JAX package's, and no byte is added or copied.
//
// Two variants; the wrapper (ops/int8_matmul.py:_variant) picks one before
// the launch from the operands' layout and alignment:
//
// tensor cores (int8_matmul_rescale_tc, int8_tc_kernel), the main path's:
//  - a persistent grid, at most one block per SM; block b takes the
//    128 x 128 output tiles b, b + grid, ... in M-fastest order, so the
//    4 row tiles of M = 512 that share a weight tile run side by side and
//    the weight is read from device memory about once;
//  - per tile, K is walked 128 deep (one 128-byte swizzle row, 4 k32
//    steps) through a 6-stage ring of [128 rows][128 bytes] A (xq) and B
//    (wq^T) tiles, 32 KB a stage, loaded by TMA through 2-d tensor maps
//    that fill the M, N and K edges with zeros: one producer thread in a
//    ninth warp, full / empty mbarriers per stage. The ring runs on
//    across a block's tiles, so the next tile's loads overlap this
//    tile's epilogue;
//  - two consumer warpgroups, 64 rows each, issue
//    wgmma.mma_async.m64n128k32.s32.s8.s8 with both operands from shared
//    memory and 64 int32 accumulators a thread, keeping one stage's
//    products in flight while they wait for the next;
//  - the epilogue forms the bit-exact products in registers and stores
//    them straight to the output, two neighbouring columns per store,
//    predicated at M and N (any N, odd ones included).
//
// mma.sync (int8_matmul_rescale_mma, int8_mma_kernel): the first version,
// for a row-major wq ([K, N] contiguous, n-major, which the tensor-core
// kernel cannot read). A K-major wq that TMA cannot read (K not a multiple
// of 16, or a base off 16 bytes) is copied to row-major by the wrapper
// first (ops/int8_matmul.py), and then runs here too. One 256-thread block
// per 128 x 128 output tile; 8 warps as 2 x 4, each a 64 x 32 sub-tile of
// mma.sync.m16n8k32 from shared memory; K walked 64 deep through two
// buffers and a register prefetch, one __syncthreads per chunk. A is
// staged as it lies at an 80-byte pitch; wq is byte-transposed by each
// thread, 4 k x 8 n at a time, into k-packed words placed with an XOR
// swizzle over 128-byte units so that both the staging stores and the
// fragment loads hit 32 distinct banks. Ragged or unaligned operands are
// staged byte by byte with the same zero fill.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kALd = kBK + 16;        // 80-byte rows of the A tile
constexpr int kBWords = kBN * kBK / 4;  // 32-bit words of the B tile

struct Args {
  const int8_t* xq;
  const float* xs;
  const int8_t* wq;
  const float* ws;
  void* out;
  int M, N, K;
  bool vec_a, vec_b;                  // 16-byte A / 8-byte B loads allowed
};

// Position of word kw (k = 4 kw .. 4 kw + 3) of column n in the B tile.
// Columns 2u and 2u + 1 share the 32-word unit u; inside it the word
// (n & 1, kw) is XORed with h(u), whose bits 2-3 follow u & 3 (fragment
// loads: 8 columns in 4 units) and whose bits 0-2 and 4 follow n >> 3
// (staging stores: 16 columns 8 apart at one kw).
__device__ __forceinline__ int b_word(int n, int kw) {
  const int u = n >> 1, ng = n >> 3;
  const int h = ((u & 3) << 2) ^ (ng & 7) ^ ((ng & 8) << 1);
  return u * 32 + ((((n & 1) << 4) | kw) ^ h);
}

// 4 rows of 4 bytes (a = row 0 ... d = row 3) -> 4 columns of 4 bytes.
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c,
                                           uint32_t d, uint32_t* o) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140);   // a0 b0 a1 b1
  const uint32_t ab_hi = __byte_perm(a, b, 0x7362);   // a2 b2 a3 b3
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140);
  const uint32_t cd_hi = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(ab_lo, cd_lo, 0x5410);           // a0 b0 c0 d0
  o[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  o[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  o[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

__device__ __forceinline__ uint32_t byte_at(const int8_t* p, bool ok) {
  return ok ? static_cast<uint32_t>(static_cast<uint8_t>(*p)) : 0u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename OutT> __device__ __forceinline__ OutT to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 to_out<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// A staging: thread e (two per thread) owns row e / 4, 16 bytes at depth
// 16 * (e % 4) of the 64-deep tile.
__device__ __forceinline__ void load_a(const Args& a, int m0, int k0,
                                       uint4 (&ra)[2]) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = m0 + (e >> 2), k = k0 + (e & 3) * 16;
    const int8_t* src = a.xq + (long long)r * a.K + k;
    if (a.vec_a && r < a.M && k + 16 <= a.K) {
      ra[it] = __ldg(reinterpret_cast<const uint4*>(src));
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          w[q] |= byte_at(src + 4 * q + b, r < a.M && k + 4 * q + b < a.K)
                  << (8 * b);
      }
      ra[it] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ void store_a(int8_t (*As)[kALd],
                                        const uint4 (&ra)[2]) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int e = threadIdx.x + it * kThreads;
    *reinterpret_cast<uint4*>(&As[e >> 2][(e & 3) * 16]) = ra[it];
  }
}

// B staging: lane l of warp w owns the 8 columns 8 * (l % 16) .. + 7 and
// the 4 depths 4 * kg .. + 3 with kg = w + 8 * (l / 16): each load
// instruction reads two full 128-byte rows.
__device__ __forceinline__ int b_kg() {
  return (threadIdx.x >> 5) + (((threadIdx.x & 31) >> 4) << 3);
}

__device__ __forceinline__ void load_b(const Args& a, int n0, int k0,
                                       uint2 (&rb)[4]) {
  const int n = n0 + 8 * (threadIdx.x & 15);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + 4 * b_kg() + r;
    const int8_t* src = a.wq + (long long)k * a.N + n;
    if (a.vec_b && k < a.K && n + 8 <= a.N) {
      rb[r] = __ldg(reinterpret_cast<const uint2*>(src));
    } else {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        lo |= byte_at(src + b, k < a.K && n + b < a.N) << (8 * b);
        hi |= byte_at(src + 4 + b, k < a.K && n + 4 + b < a.N) << (8 * b);
      }
      rb[r] = make_uint2(lo, hi);
    }
  }
}

__device__ __forceinline__ void store_b(uint32_t* Bs, const uint2 (&rb)[4]) {
  uint32_t w[8];
  transpose4(rb[0].x, rb[1].x, rb[2].x, rb[3].x, w);
  transpose4(rb[0].y, rb[1].y, rb[2].y, rb[3].y, w + 4);
  const int nl = 8 * (threadIdx.x & 15), kg = b_kg();
#pragma unroll
  for (int i = 0; i < 8; ++i) Bs[b_word(nl + i, kg)] = w[i];
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_mma_kernel(Args a) {
  __shared__ __align__(16) int8_t As[2][kBM][kALd];
  __shared__ __align__(16) uint32_t Bs[2][kBWords];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;      // 2 x 4 warps
  const int gid = lane >> 2, tig = lane & 3;   // mma fragment coordinates
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

  uint4 ra[2];
  uint2 rb[4];
  load_a(a, m0, 0, ra);
  load_b(a, n0, 0, rb);
  store_a(As[0], ra);
  store_b(Bs[0], rb);
  __syncthreads();

  const int nk = (a.K + kBK - 1) / kBK;
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {                                // prefetch tile kt + 1
      load_a(a, m0, (kt + 1) * kBK, ra);
      load_b(a, n0, (kt + 1) * kBK, rb);
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + gid;
        af[i][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r][ks + 4 * tig]);
        af[i][1] =
            *reinterpret_cast<const uint32_t*>(&As[cur][r + 8][ks + 4 * tig]);
        af[i][2] =
            *reinterpret_cast<const uint32_t*>(&As[cur][r][ks + 16 + 4 * tig]);
        af[i][3] = *reinterpret_cast<const uint32_t*>(
            &As[cur][r + 8][ks + 16 + 4 * tig]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn * 32 + j * 8 + gid;
        bfr[j][0] = Bs[cur][b_word(c, ks / 4 + tig)];
        bfr[j][1] = Bs[cur][b_word(c, ks / 4 + 4 + tig)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    if (more) {                                // the other buffer is free
      store_a(As[cur ^ 1], ra);
      store_b(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }

  // accumulator (i, j, c) holds row gid (+8 for c >= 2), column
  // 2 * tig (+1 for odd c) of the warp's (i, j) 16 x 8 sub-tile
  OutT* out = static_cast<OutT*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) {
      const int r = m0 + wm * 64 + i * 16 + gid + 8 * c2;
      if (r >= a.M) continue;
      const float xs = a.xs[r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c1 = 0; c1 < 2; ++c1) {
          const int n = n0 + wn * 32 + j * 8 + 2 * tig + c1;
          if (n < a.N)
            out[(long long)r * a.N + n] = to_out<OutT>(__fmul_rn(
                __fmul_rn(__int2float_rn(acc[i][j][2 * c2 + c1]), xs),
                a.ws[n]));
        }
    }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ---------------------------------------------------------------------------
// tensor-core variant (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 128;                  // output rows per tile
constexpr int kTcCols = 128;                  // output columns per tile
constexpr int kTcDepth = 128;                 // K per stage: 128 bytes
constexpr int kTcStages = 6;
constexpr int kTcThreads = 256 + 32;          // 2 warpgroups + producer
constexpr int kTcABytes = kTcRows * kTcDepth;     // [128 rows][128 k]
constexpr int kTcBBytes = kTcCols * kTcDepth;     // [128 n][128 k]
constexpr int kTcSmem = 1024 + kTcStages * (kTcABytes + kTcBBytes) +
                        2 * kTcStages * 8;

// the epilogue's products, in the plain version's order
__device__ __forceinline__ float rescale(int acc, float xs, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
}

// columns n and n + 1 of row r (n < N): one store of both where N is even
// (then r * N + n is even and the pair aligned), else one each
__device__ __forceinline__ void store_pair(bf16* out, long long i, float x,
                                           float y, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<uint32_t*>(out + i) = hopper::pack_bf16(x, y);
  } else {
    out[i] = __float2bfloat16_rn(x);
    if (second) out[i + 1] = __float2bfloat16_rn(y);
  }
}

__device__ __forceinline__ void store_pair(float* out, long long i, float x,
                                           float y, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(out + i) = make_float2(x, y);
  } else {
    out[i] = x;
    if (second) out[i + 1] = y;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
int8_tc_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const float* __restrict__ xs, const float* __restrict__ ws,
               OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* As = base;                               // [stage][A]
  uint8_t* Bs = As + kTcStages * kTcABytes;         // [stage][B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kTcStages * kTcBBytes);
  uint64_t* empty = full + kTcStages;

  const int m_tiles = (M + kTcRows - 1) / kTcRows;
  const int tiles = m_tiles * ((N + kTcCols - 1) / kTcCols);
  const int n_k = (K + kTcDepth - 1) / kTcDepth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);     // lane 0 of each consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer: one thread streams (xq, wq^T) chunks through the
    // ring, tile after tile
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * kTcRows, n0 = (t / m_tiles) * kTcCols;
      for (int kc = 0; kc < n_k; ++kc, ++it) {
        const int s = it % kTcStages;
        hopper::mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], kTcABytes + kTcBBytes);
        hopper::tma_load_2d(As + s * kTcABytes, &ta, &full[s],
                            kc * kTcDepth, m0);
        hopper::tma_load_2d(Bs + s * kTcBBytes, &tb, &full[s],
                            kc * kTcDepth, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of every
  // tile, all 128 columns (acc element i: row 16 warp + lane / 4 +
  // 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2)
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t a_base = hopper::smem_u32(As) + wg * 64 * kTcDepth;
  const uint32_t b_base = hopper::smem_u32(Bs);
  const bool pair = N % 2 == 0;

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t % m_tiles) * kTcRows, n0 = (t / m_tiles) * kTcCols;
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int st = it % kTcStages;
      hopper::mbar_wait(&full[st], (it / kTcStages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcDepth / 32; ++kk)
        hopper::wgmma_s8_n128(
            acc,
            hopper::desc_at(a_base, st * kTcABytes + kk * 32, 1024, 128),
            hopper::desc_at(b_base, st * kTcBBytes + kk * 32, 1024, 128),
            kc > 0 || kk > 0);
      hopper::wgmma_commit();
      // keep one stage's products in flight; this warp is done with the
      // stage before
      hopper::wgmma_wait<1>();
      if (kc > 0 && lane == 0)
        hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[(it - 1) % kTcStages]);

    // epilogue: the plain version's products, stored at rows < M and
    // columns < N
    const int r0 = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      const float x = xs[r];
      OutT* row = out + (long long)r * N;
#pragma unroll
      for (int j = 0; j < kTcCols / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (n >= N) continue;
        const bool second = n + 1 < N;
        const float w0 = ws[n], w1 = second ? ws[n + 1] : 0.f;
        store_pair(row, n, rescale(acc[4 * j + 2 * h], x, w0),
                   rescale(acc[4 * j + 2 * h + 1], x, w1), pair, second);
      }
    }
  }
}

template <typename OutT>
cudaError_t launch_tc(const CUtensorMap& ta, const CUtensorMap& tb,
                      const float* xs, const float* ws, void* out, int M,
                      int N, int K, int blocks, cudaStream_t st) {
  auto kernel = int8_tc_kernel<OutT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kTcThreads, kTcSmem, st>>>(
      ta, tb, xs, ws, static_cast<OutT*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The variants' entries, one signature. xq [M, K] contiguous int8; xs [M]
// and ws [N] contiguous fp32; out [M, N] contiguous, out_dtype 0 =
// float32, 1 = bfloat16. Each returns cudaGetLastError() after its launch,
// or cudaErrorInvalidValue for operands it does not take.

// tensor cores: wq [K, N] the view of a contiguous wq^T [N, K] (K-major),
// K a multiple of 16, both bases 16-byte aligned (what TMA reads). The
// persistent grid: one block per SM of the current device, or one per
// output tile where there are fewer.
extern "C" int int8_matmul_rescale_tc(const void* xq, const void* xs,
                                      const void* wq, const void* ws,
                                      void* out, int M, int N, int K,
                                      int out_dtype, void* stream) {
  if (M == 0 || N == 0) return cudaGetLastError();
  if (K < 16 || K % 16 != 0 || !aligned(xq, 16) || !aligned(wq, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (long long)((M + kTcRows - 1) / kTcRows) *
                          ((N + kTcCols - 1) / kTcCols);
  const int blocks = static_cast<int>(tiles < sms ? tiles : sms);
  CUtensorMap ta, tb;
  const cuuint32_t box[2] = {kTcDepth, kTcRows};   // kTcRows == kTcCols
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint64_t adims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t bdims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  err = hopper::encode(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, 2, adims,
                       stride, box, 128);
  if (err == cudaSuccess)
    err = hopper::encode(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, 2, bdims,
                         stride, box, 128);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* fxs = static_cast<const float*>(xs);
  const float* fws = static_cast<const float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = out_dtype == 1
            ? launch_tc<bf16>(ta, tb, fxs, fws, out, M, N, K, blocks, st)
            : launch_tc<float>(ta, tb, fxs, fws, out, M, N, K, blocks, st);
  return static_cast<int>(err);
}

// mma.sync: wq [K, N] contiguous (row-major); any K, any alignment
extern "C" int int8_matmul_rescale_mma(const void* xq, const void* xs,
                                       const void* wq, const void* ws,
                                       void* out, int M, int N, int K,
                                       int out_dtype, void* stream) {
  if (M == 0 || N == 0) return cudaGetLastError();
  if ((M + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  Args a;
  a.xq = static_cast<const int8_t*>(xq);
  a.xs = static_cast<const float*>(xs);
  a.wq = static_cast<const int8_t*>(wq);
  a.ws = static_cast<const float*>(ws);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.vec_a = aligned(xq, 16) && K % 16 == 0;
  a.vec_b = aligned(wq, 8) && N % 8 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    int8_mma_kernel<bf16><<<grid, kThreads, 0, st>>>(a);
  else
    int8_mma_kernel<float><<<grid, kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
