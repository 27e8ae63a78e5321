// Stochastic rounding on the card: fp32 -> bf16, and fp32 -> int8 with a
// per-tensor abs-max scale.
//
// Replaces the TPU kernels of paddle_tpu/nn/quant/__init__.py:
//  - stochastic_round (kernel :81, pallas_call :98): add the top 16 bits
//    of a random word to the int32 view of x, zero the low 16 bits. A
//    carry into the kept bits happens with probability equal to the
//    dropped fraction: stochastic rounding to bf16. The TPU kernel writes
//    the fp32 result and casts outside; the truncated value is exactly a
//    bf16, so this kernel writes the bf16 bits directly (2 B per element
//    stored instead of 4, the same values);
//  - quantize_int8_stochastic (kernel :119, pallas_call :142): per-tensor
//    s = max(max|x| / 127, 1e-10), q = int8(clip(floor(x / s + u), +-127))
//    with u = (word >> 8) * 2^-24 in [0, 1), so E[q s] = x inside the
//    range. The TPU kernel holds the whole tensor in VMEM and reduces it
//    there; blocks here see only their slice, so pass 1 reduces |x| across
//    blocks with atomicMax on the int view of |x| (order-free: for
//    non-negative floats the int order is the float order, so the max is
//    exact), and pass 2 reads the max from device memory (no host sync),
//    forms s, writes it, and rounds. x / s is IEEE division (__fdiv_rn),
//    as in the TPU kernel, not a multiply by a reciprocal. The TPU (and
//    XLA on the CPU) computes f32 with subnormals flushed to zero, so a
//    subnormal x, or a subnormal x / s, counts as a zero of its sign
//    here too (floor(-tiny) would give -1 where the reference gives 0).
//
// Random words: the TPU kernels draw from the TPU's own generator; here a
// counter-based threefry2x32 (20 rounds, the Random123 / JAX constants)
// keyed by (k0, k1) = (seed >> 32, seed) & 0xFFFFFFFF. Element i takes
// word (i % 2) of the block for counter (x0, x1) = (i / 2 low 32 bits,
// i / 2 high 32 bits): the words depend on the element index only, never
// on the launch shape, and the plain PyTorch version in
// ops/stochastic_round.py draws the same ones, so the two agree bit for
// bit.
//
// What bounds them on the H100: bytes at first sight (6 B per element for
// stochastic_round, 5 B for the quantizer, single read), but threefry
// costs ~70 32-bit integer operations per pair of elements and Hopper's
// SM issues 64 integer operations per clock (half its fp32 rate): at
// 4096 x 11008 that is ~1.6e9 operations, ~0.1 ms at 1.98 GHz against a
// byte bound of 0.08 ms, so both may come out issue-bound. The quantizer
// also reads x twice (pass 1 and pass 2). One grid-stride pass each, one
// threefry call per two elements.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ void round_(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r);
  x1 ^= x0;
}

// threefry2x32 with 20 rounds: counter (x0, x1), key (k0, k1) -> 2 words.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  round_(x0, x1, 17); round_(x0, x1, 29); round_(x0, x1, 16);
  round_(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  round_(x0, x1, 17); round_(x0, x1, 29); round_(x0, x1, 16);
  round_(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  round_(x0, x1, 13); round_(x0, x1, 15); round_(x0, x1, 26);
  round_(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

// The words of elements 2p and 2p + 1.
__device__ __forceinline__ void words(uint32_t k0, uint32_t k1, long long p,
                                      uint32_t& w0, uint32_t& w1) {
  w0 = static_cast<uint32_t>(p);
  w1 = static_cast<uint32_t>(static_cast<unsigned long long>(p) >> 32);
  threefry2x32(k0, k1, w0, w1);
}

__device__ __forceinline__ uint16_t sr_bf16(float v, uint32_t w) {
  // uint32 add wraps as the TPU kernel's int32 add does
  return static_cast<uint16_t>((__float_as_uint(v) + (w >> 16)) >> 16);
}

__global__ void __launch_bounds__(kThreads)
sr_bf16_kernel(const float* __restrict__ x, uint16_t* __restrict__ out,
               long long n, uint32_t k0, uint32_t k1) {
  const long long pairs = (n + 1) / 2;
  for (long long p = blockIdx.x * (long long)kThreads + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * kThreads) {
    uint32_t w0, w1;
    words(k0, k1, p, w0, w1);
    const long long i = 2 * p;
    out[i] = sr_bf16(x[i], w0);
    if (i + 1 < n) out[i + 1] = sr_bf16(x[i + 1], w1);
  }
}

__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, long long n,
              unsigned int* amax_bits) {
  __shared__ float part[kThreads / 32];
  float m = 0.f;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads)
    m = fmaxf(m, fabsf(x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, part[w]);
    atomicMax(amax_bits, __float_as_uint(m));
  }
}

// a subnormal as a zero of its sign
__device__ __forceinline__ float ftz(float v) {
  return fabsf(v) < 1.17549435e-38f ? copysignf(0.f, v) : v;
}

__device__ __forceinline__ int8_t sr_int8(float v, float scale, uint32_t w) {
  const float u = __fmul_rn(__uint2float_rn(w >> 8), 5.9604644775390625e-08f);
  const float q = floorf(__fadd_rn(ftz(__fdiv_rn(ftz(v), scale)), u));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(q, -127.f), 127.f)));
}

__global__ void __launch_bounds__(kThreads)
quant_sr_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale_out,
                const unsigned int* __restrict__ amax_bits, long long n,
                uint32_t k0, uint32_t k1) {
  const float scale =
      fmaxf(__fdiv_rn(__uint_as_float(*amax_bits), 127.f), 1e-10f);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const long long pairs = (n + 1) / 2;
  for (long long p = blockIdx.x * (long long)kThreads + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * kThreads) {
    uint32_t w0, w1;
    words(k0, k1, p, w0, w1);
    const long long i = 2 * p;
    q[i] = sr_int8(x[i], scale, w0);
    if (i + 1 < n) q[i + 1] = sr_int8(x[i + 1], scale, w1);
  }
}

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// x [n] contiguous fp32 -> out [n] bf16 bits. Returns cudaGetLastError().
extern "C" int stochastic_round_bf16(const void* x, void* out, long long n,
                                     unsigned int k0, unsigned int k1,
                                     void* stream) {
  if (n == 0) return cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sr_bf16_kernel<<<blocks_for((n + 1) / 2), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<uint16_t*>(out), n, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

// x [n] contiguous fp32 -> q [n] int8 and scale [1] fp32; amax_bits is one
// zeroed uint32 of scratch. Two launches on the stream. Returns
// cudaGetLastError().
extern "C" int quantize_int8_stochastic(const void* x, void* q, void* scale,
                                        void* amax_bits, long long n,
                                        unsigned int k0, unsigned int k1,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  unsigned int* am = static_cast<unsigned int*>(amax_bits);
  absmax_kernel<<<blocks_for(n), kThreads, 0, st>>>(xf, n, am);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_sr_kernel<<<blocks_for((n + 1) / 2), kThreads, 0, st>>>(
      xf, static_cast<int8_t*>(q), static_cast<float*>(scale), am, n, k0, k1);
  return static_cast<int>(cudaGetLastError());
}
