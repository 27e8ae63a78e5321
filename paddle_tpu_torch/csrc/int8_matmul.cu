// int8 x int8 -> int32 matmul with a per-row x per-column fp32 rescale:
//     out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * xs[m] * ws[n]
// stored as bf16 or fp32.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/int8_matmul.py:
// int8_matmul_rescale (_kernel :22, pallas_call :50). Same contract: xq
// [M, K] int8 (activations quantized per row), xs [M, 1] fp32, wq [K, N]
// int8 (the weight in the paddle [in, out] layout), ws [1, N] fp32 ->
// [M, N]. The TPU kernel kept K whole in VMEM; 227 KB of shared memory
// cannot hold that, so K is walked in 64-deep tiles, the K tail staged as
// zeros. The TPU wrapper pads M and N to its blocks; here the M and N
// edges are bounds-checked instead, so nothing is padded or copied.
//
// Exactness: the int32 sums are exact (overflow needs K > 133,000: 127 *
// 127 * K < 2^31, far past every width here), and the epilogue is
// __int2float_rn(acc) * xs[m] * ws[n] in that order, two IEEE products
// with no FMA contraction (explicit __fmul_rn; no --use_fast_math), then
// one rounding to bf16. The plain version computes the same products in
// the same order, so the two agree bit for bit.
//
// What bounds it on the H100: at the Llama-2-7B FFN shapes (M=512,
// K=4096, N=11008 and back) it does 4.62e10 int8 operations against 58 MB
// moved, ~790 operations per byte, above the card's ~590 int8 operations
// per byte, so the tensor cores are the roof (0.0233 ms). At decode-like
// M the weight read bounds it instead.
//
// Design:
//  - one 256-thread block per 128 x 128 output tile; 8 warps as 2 x 4,
//    each warp a 64 x 32 sub-tile of mma.sync.m16n8k32 (s8 in, s32
//    accumulate) read from shared memory;
//  - two shared-memory buffers and a register prefetch: the global loads
//    of K tile t + 1 are issued before the products of tile t, stored
//    after them, one __syncthreads per tile;
//  - A (xq) is staged as it lies, [row][k] at an 80-byte pitch (16-byte
//    loads and stores; the fragment loads hit 32 distinct banks);
//  - B (wq) lies with n contiguous, but the .col operand wants 4
//    consecutive k of one column in each 32-bit word. Each thread reads
//    4 rows (k) x 8 columns (n) with 8-byte loads, transposes them into 8
//    words with byte permutes and stores one word per column. Those words
//    are placed with an XOR swizzle over 128-byte units (two columns
//    each), chosen so that both the staging stores (lanes along n, two k
//    groups per warp) and the fragment loads (8 columns x 4 k words) hit
//    32 distinct banks: a plain [n][k] layout would put the 16 lanes of a
//    staging store in one bank;
//  - unaligned or ragged operands (K % 16 or N % 8 not 0, or a pointer
//    off 16 bytes) are staged byte by byte with the same zero fill.
// A TMA/wgmma pipeline with more stages in flight is the later change
// that moves it toward its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

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

}  // namespace

// xq [M, K] and wq [K, N] contiguous int8, xs [M] and ws [N] contiguous
// fp32, out [M, N] contiguous, out_dtype 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int int8_matmul_rescale(const void* xq, const void* xs,
                                   const void* wq, const void* ws, void* out,
                                   int M, int N, int K, int out_dtype,
                                   void* stream) {
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
