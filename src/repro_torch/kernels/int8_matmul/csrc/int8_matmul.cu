// INT8 x INT8 -> INT32 GEMM for Hopper (sm_90a), CUDA C++, with two
// epilogues: the raw int32 sums, or f32(acc) * scale[n] rounded once to
// fp32, bf16 or f16.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py, function
// int8_matmul_mkn (pl.pallas_call at line 51), and computes what it
// computes: x (M, K) int8 times w (K, N) int8 with an int32 accumulator,
// then (float)acc * scale[n] cast to the output dtype (scale already folds
// in the activation scale). The int32-out epilogue serves the integer
// opcodes GEMM_I8 and CONV2D_I8 (im2col in the wrapper), which the JAX
// package leaves to XLA. No float touches an accumulator, so the result
// equals the plain version (ref.py) bit for bit in every output dtype.
//
// Layout: x, w, out row-major and contiguous, read in place. Unlike the TPU
// kernel, M, N and K need not be multiples of any tile: every load and
// store is masked (the stem conv of ResNet-18 has K = 7*7*3 = 147).
//
// What bounds it. At 512 x 1536 x 8960 with fp32 out (qwen2-1.5B's MLP
// up-projection at S=512) one call must read x (786,432 bytes), w
// (13,762,560) and scale (35,840) and write out (18,350,080): 32,934,912
// bytes, 9.83 us at 3.35 TB/s; its 14.09 G operations take 7.12 us at the
// tensor cores' 1,979 int8 TOPS. So the card's bound is the memory's. This
// simple design does not reach it: it multiplies on the CUDA cores with
// __dp4a (four int8 products summed into an int32 per instruction), whose
// issue rate is about 15x below the tensor cores' int8 rate, so it is bound
// by dp4a issue. Tensor cores (mma.sync s8.s8.s32, then wgmma) are the
// redesign's work.
//
// Design. A block of 256 threads owns a 128 x 128 tile of out and walks K
// in steps of 32 inside the block (the TPU kernel's sequential K grid axis
// becomes a loop; its VMEM accumulator becomes 64 int32 registers a thread,
// an 8 x 8 sub-tile). Each step stages x's (128, 32) tile and w's (32, 128)
// tile through shared memory as packed words: four consecutive k of a row
// of x are already adjacent bytes; for w, which is (K, N) row-major, each
// thread reads four rows of four columns and transposes the 4 x 4 bytes so
// that a word holds four consecutive k of one column. The next step's tiles
// load into registers while the current one computes. Where there are
// fewer output tiles than SMs (ResNet-18's late stages: M = 49 at B=1) the
// K range is split over gridDim.z and the partial sums meet in int32
// atomics: integer addition is exact in any order, so the result does not
// depend on the order the blocks finish in; a scaled output is then
// written by a second, elementwise kernel from those sums.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;

constexpr int BM = 128, BN = 128, BK = 32;   // block tile (BK in int8 k)
constexpr int KQ = BK / 4;                   // packed k-quads per step
constexpr int NT = 256;                      // 16 x 16 threads
constexpr int TM = 8, TN = 8;                // outputs a thread owns

enum Epilogue { kStoreI32 = 0, kAtomicI32 = 1, kScaled = 2 };

// four int8 of four rows (one word each, byte j = column j) -> four words,
// word j holding column j's four k in bytes 0..3
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t c[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = ((r[0] >> (8 * j)) & 0xffu) | (((r[1] >> (8 * j)) & 0xffu) << 8) |
           (((r[2] >> (8 * j)) & 0xffu) << 16) |
           (((r[3] >> (8 * j)) & 0xffu) << 24);
  }
}

// x rows [m0, m0+128) x k [k0, k0+32): thread t reads 16 bytes of row t/2
template <bool AV>
__device__ __forceinline__ void load_x(const int8_t* __restrict__ x, int M,
                                       int K, int m0, int k0, int kend,
                                       uint32_t a[4]) {
  const int t = threadIdx.x;
  const int gm = m0 + (t >> 1);
  const int gk = k0 + (t & 1) * 16;
  if (AV) {   // K % 16 == 0, x 16-byte aligned, kend a multiple of 16
    if (gm < M && gk < kend) {
      const int4 v = *reinterpret_cast<const int4*>(x + (long long)gm * K + gk);
      a[0] = (uint32_t)v.x; a[1] = (uint32_t)v.y;
      a[2] = (uint32_t)v.z; a[3] = (uint32_t)v.w;
    } else {
      a[0] = a[1] = a[2] = a[3] = 0u;
    }
  } else {
    const int8_t* row = x + (long long)gm * K;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = gk + 4 * q + i;
        const uint32_t byte =
            (gm < M && k < kend) ? (uint32_t)(uint8_t)row[k] : 0u;
        word |= byte << (8 * i);
      }
      a[q] = word;
    }
  }
}

// w k [k0, k0+32) x columns [n0, n0+128): thread t reads rows
// k0 + 4*(t/32) + 0..3, columns n0 + 4*(t%32) + 0..3
template <bool BV>
__device__ __forceinline__ void load_w(const int8_t* __restrict__ w, int N,
                                       int n0, int k0, int kend,
                                       uint32_t b[4]) {
  const int t = threadIdx.x;
  const int gk = k0 + 4 * (t >> 5);
  const int gn = n0 + 4 * (t & 31);
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = gk + i;
    const int8_t* row = w + (long long)k * N;
    if (BV) {   // N % 4 == 0, w 4-byte aligned
      r[i] = (k < kend && gn < N) ? *reinterpret_cast<const uint32_t*>(row + gn)
                                  : 0u;
    } else {
      uint32_t word = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte =
            (k < kend && gn + j < N) ? (uint32_t)(uint8_t)row[gn + j] : 0u;
        word |= byte << (8 * j);
      }
      r[i] = word;
    }
  }
  transpose4x4(r, b);
}

// a thread's rows and columns: two runs of four, 64 apart, so that a
// quarter warp reads 128 contiguous bytes of a shared tile (no bank
// conflicts) and sixteen threads store 64 contiguous outputs of a row
__device__ __forceinline__ int sub(int base, int i) {
  return (i < 4 ? 0 : 64 - 4) + base * 4 + i;
}

template <bool AV, bool BV>
__global__ void __launch_bounds__(NT)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int M, int N, int K, int kchunk, int epilogue,
                   int out_code) {
  __shared__ __align__(16) uint32_t xs[KQ][BM];   // xs[q][m]: k 4q..4q+3
  __shared__ __align__(16) uint32_t ws[KQ][BN];   // ws[q][n]: k 4q..4q+3

  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  uint32_t a[4], b[4];
  if (kbeg < kend) {
    load_x<AV>(x, M, K, m0, kbeg, kend, a);
    load_w<BV>(w, N, n0, kbeg, kend, b);
  }
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) xs[(t & 1) * 4 + q][t >> 1] = a[q];
    *reinterpret_cast<uint4*>(&ws[t >> 5][4 * (t & 31)]) =
        make_uint4(b[0], b[1], b[2], b[3]);
    __syncthreads();
    if (k0 + BK < kend) {           // the next step's tiles, in flight
      load_x<AV>(x, M, K, m0, k0 + BK, kend, a);
      load_w<BV>(w, N, n0, k0 + BK, kend, b);
    }
#pragma unroll
    for (int q = 0; q < KQ; ++q) {
      const uint4 xa = *reinterpret_cast<const uint4*>(&xs[q][ty * 4]);
      const uint4 xb = *reinterpret_cast<const uint4*>(&xs[q][64 + ty * 4]);
      const uint4 wa = *reinterpret_cast<const uint4*>(&ws[q][tx * 4]);
      const uint4 wb = *reinterpret_cast<const uint4*>(&ws[q][64 + tx * 4]);
      const int av[TM] = {(int)xa.x, (int)xa.y, (int)xa.z, (int)xa.w,
                          (int)xb.x, (int)xb.y, (int)xb.z, (int)xb.w};
      const int bv[TN] = {(int)wa.x, (int)wa.y, (int)wa.z, (int)wa.w,
                          (int)wb.x, (int)wb.y, (int)wb.z, (int)wb.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + sub(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + sub(tx, j);
      if (n >= N) continue;
      const long long o = (long long)m * N + n;
      if (epilogue == kStoreI32) {
        static_cast<int*>(out)[o] = acc[i][j];
      } else if (epilogue == kAtomicI32) {
        atomicAdd(static_cast<int*>(out) + o, acc[i][j]);
      } else {
        const float v = __int2float_rn(acc[i][j]) * scale[n];
        if (out_code == 0) static_cast<float*>(out)[o] = v;
        else if (out_code == 1) static_cast<__nv_bfloat16*>(out)[o] = from_f<__nv_bfloat16>(v);
        else static_cast<__half*>(out)[o] = from_f<__half>(v);
      }
    }
  }
}

// the scaled epilogue of a split-K call, from the int32 sums
template <typename T>
__global__ void int8_scale_kernel(const int* __restrict__ acc,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, long long mn, int N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < mn) out[i] = from_f<T>(__int2float_rn(acc[i]) * scale[i % N]);
}

template <bool AV, bool BV>
cudaError_t launch_gemm(const void* x, const void* w, const void* scale,
                        void* out, int M, int N, int K, int splits,
                        int kchunk, int epilogue, int out_code,
                        cudaStream_t st) {
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
            (unsigned)splits);
  int8_matmul_kernel<AV, BV><<<grid, NT, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, M, N, K, kchunk, epilogue,
      out_code);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scale(const void* acc, const void* scale, void* out,
                         long long mn, int N, cudaStream_t st) {
  const int threads = 256;
  int8_scale_kernel<T><<<(unsigned)((mn + threads - 1) / threads), threads,
                         0, st>>>(static_cast<const int*>(acc),
                                  static_cast<const float*>(scale),
                                  static_cast<T*>(out), mn, N);
  return cudaGetLastError();
}

}  // namespace

// out_code: -1 = int32 sums, 0 = float32, 1 = bfloat16, 2 = float16 (then
// scale is (N,) float32). splits > 1 splits K over gridDim.z; the sums then
// meet in int32 atomics in ``out`` (int32 out) or in ``acc``, an (M, N)
// int32 workspace the caller provides (scaled out). Returns a cudaError_t.
extern "C" int aeg_int8_matmul(const void* x, const void* w,
                               const void* scale, void* out, void* acc,
                               int M, int N, int K, int splits, int out_code,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || splits > 65535 ||
      (M + BM - 1) / BM > 65535 || out_code < -1 || out_code > 2 ||
      (splits > 1 && out_code >= 0 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // each split takes a whole number of BK steps
  const int steps = (K + BK - 1) / BK;
  const int kchunk = ((steps + splits - 1) / splits) * BK;
  const bool av = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bv = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  int epilogue = out_code < 0 ? kStoreI32 : kScaled;
  void* target = out;
  if (splits > 1) {
    epilogue = kAtomicI32;
    target = out_code < 0 ? out : acc;
    cudaError_t e = cudaMemsetAsync(target, 0, (size_t)M * N * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e;
  if (av && bv) e = launch_gemm<true, true>(x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  else if (av) e = launch_gemm<true, false>(x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  else if (bv) e = launch_gemm<false, true>(x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  else e = launch_gemm<false, false>(x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  if (e != cudaSuccess || splits == 1 || out_code < 0) return (int)e;
  const long long mn = (long long)M * N;
  switch (out_code) {
    case 0: return (int)launch_scale<float>(acc, scale, out, mn, N, st);
    case 1: return (int)launch_scale<__nv_bfloat16>(acc, scale, out, mn, N, st);
    default: return (int)launch_scale<__half>(acc, scale, out, mn, N, st);
  }
}
