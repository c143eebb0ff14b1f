// INT8 x INT8 -> INT32 GEMM for Hopper (sm_90a), CUDA C++, on the int8
// tensor cores (mma.sync m16n8k32 s8.s8.s32), with two epilogues: the raw
// int32 sums, or f32(acc) * scale[n] rounded once to fp32, bf16 or f16.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul/kernel.py, function
// int8_matmul_mkn (pl.pallas_call at line 51), and computes what it
// computes: x (M, K) int8 times w (K, N) int8 with an int32 accumulator,
// then (float)acc * scale[n] cast to the output dtype (scale already folds
// in the activation scale). The int32-out epilogue serves the integer
// opcodes GEMM_I8 and CONV2D_I8 (im2col in the wrapper), which the JAX
// package leaves to XLA. No float touches an accumulator and mma.sync sums
// exactly in int32 (no .satfinite: the sums stay below 2^31 while
// K * 128 * 128 < 2^31), so the result equals the plain version (ref.py)
// bit for bit in every output dtype.
//
// Layout: x, w, out row-major and contiguous, read in place. Unlike the TPU
// kernel, M, N and K need not be multiples of any tile: every load and
// store is masked, nothing is padded (the stem conv of ResNet-18 has
// K = 7*7*3 = 147).
//
// What bounds it on an H100 (3.35 TB/s, 1,979 int8 TOPS dense), each input
// read once and each output written once, at the three shapes that
// chip_smoke.py times:
//   512 x 1536 x 8960, fp32 out (qwen2-1.5B's MLP up-projection at S=512):
//     32,934,912 bytes = 9.83 us, 14.09 G operations = 7.12 us -> bytes;
//   12544 x 147 x 64, int32 out (ResNet-18's stem): 5,064,640 bytes =
//     1.51 us, 0.236 G operations = 0.12 us -> bytes;
//   49 x 4608 x 512, int32 out (ResNet-18's s3 conv2): 2,685,440 bytes =
//     0.80 us, 0.231 G operations = 0.12 us -> bytes.
// This design does not reach those bounds (its times are in PERF.md). At
// the first shape its 560 blocks of 128 x 64 read each row of x once per
// 64 columns and each column of w once per 128 rows: 165 MB from L2, five
// times the bytes above, over 1.41 waves of 3 blocks an SM; mma.sync
// reaches only part of the tensor cores' rate. wgmma with larger tiles and
// TMA multicast of the shared tiles is the way past both. The two small
// shapes are bound by the launch, the first loads and, for a split K, the
// memset and the atomics.
//
// Design, and what it does about the four limits of the __dp4a kernel it
// replaces (CUDA-core products, register-only staging, one 128 x 128 tile
// for every shape, a scalar masked epilogue):
//
// * Tensor cores. A warp owns a 64 x 32 tile of out: 4 m16 x 4 n8 tiles of
//   mma.sync.m16n8k32 s8, 64 int32 sums a thread. The A fragment (four
//   consecutive k of one row of x a register) comes from one ldmatrix.x4 a
//   m16 tile. B wants four k of one column a register, and w is (K, N)
//   row-major, so the transpose is the kernel's own work: a lane reads one
//   4 x 4 byte block of w (four k rows of four adjacent columns, four
//   32-bit loads) and turns it with eight prmt (__byte_perm) into four B
//   registers, one for each of the warp's four n8 tiles. So n8 tile j holds
//   the columns 4c + j (c = 0..7) of the warp's 32: the order of N inside
//   a warp tile is free, and the epilogue puts each sum where it belongs.
//   Each fragment feeds four mma: a k32 step is 4 ldmatrix.x4, 8 LDS.32,
//   16 prmt and 16 mma a warp.
// * Asynchronous copies. x's (BM, 64) and w's (64, BN) tiles of a k step go
//   through a ring of 4 stages in dynamic shared memory, filled by 16-byte
//   cp.async.cg (a src-size of 0 zero-fills rows past M and columns past
//   N), so the loads of steps k+1 to k+3 are in flight while step k
//   multiplies: one cp.async.wait_group and one __syncthreads a step. Both
//   tiles are XOR-swizzled in 16-byte chunks so that ldmatrix (8 rows of
//   one chunk) and the B loads (4 k rows 4 apart, 8 lanes a row) read
//   every bank once. Where x or w cannot be read in aligned 16-byte rows
//   (K or N not a multiple of 16, or a view at an odd storage offset: the
//   stem's x, K = 147, is the served case) a second template instance
//   loads that operand with masked byte loads into the same ring instead.
// * A tile plan per shape class. The wrapper (ops.py, plan_for) picks the
//   block tile, 128 x 64 (4 warps) where it gives every SM a block, else
//   64 x 64 (2 warps), and the number of K splits from (M, N, K, SM count),
//   and passes both. Where the output has fewer tiles than SMs (ResNet-18's
//   late stages: M = 196, 49 at B=1) K is split over gridDim.z and the
//   partial sums meet in int32 atomics: integer addition is exact in any
//   order, so the result does not depend on the order the blocks finish
//   in; a scaled output is then written by a second, elementwise kernel
//   from those sums.
// * Epilogue. The sums (converted and scaled for a scaled output) are
//   staged through shared memory, then each thread writes 16 bytes of a row
//   of out; the ragged edge and a row that cannot take 16-byte stores fall
//   back to masked scalar stores inside the same kernel.
//
// Registers. The launch bounds ask for 2 blocks of 128 threads (4 of 64) an
// SM, so ptxas may use up to 255 registers a thread; a cap of 128 made the
// byte-load instances spill and the main loop slower on the card. ptxas
// (CUDA 12.8, sm_90a), registers a thread of each instance <warps M, warps
// N, x in 16-byte rows, w in 16-byte rows>, no spills, no stack in any:
//   128 x 64 tile: <2,2,1,1> 141, <2,2,1,0> 152, <2,2,0,1> 177, <2,2,0,0> 196
//   64 x 64 tile:  <1,2,1,1> 162, <1,2,1,0> 210, <1,2,0,1> 215, <1,2,0,0> 198
// Dynamic shared memory (no static): 49,152 bytes for 128 x 64 (the ring;
// the staged fp32 tile takes 34,816), 32,768 for 64 x 64. So 3 blocks of
// <2,2,1,1> (12 warps) or 6 of <1,2,1,1> fit on an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;

constexpr int BK = 64;          // k a stage holds: 64 bytes of a row of x
constexpr int STAGES = 4;       // cp.async ring depth
constexpr int WM = 64;          // warp tile rows
constexpr int WN = 32;          // warp tile columns
constexpr int MT = WM / 16;     // m16 tiles a warp
constexpr int NT8 = WN / 8;     // n8 tiles a warp: one 4 x 4 byte block

enum Epilogue { kStoreI32 = 0, kAtomicI32 = 1, kScaled = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes = 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four words of four k rows (byte j = column j) -> four words, word j
// holding column j's four k in bytes 0..3
__device__ __forceinline__ void transpose4x4(const uint32_t r[4],
                                             uint32_t c[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The four bytes at p, of which the first `valid` (at most 4) are read and
// the rest are zero, from the aligned words that hold them: one load, or
// two and a funnel shift where they straddle a word boundary.
__device__ __forceinline__ uint32_t load_bytes4(const int8_t* p, int valid) {
  if (valid <= 0) return 0u;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int sh = (int)(a & 3);
  uint32_t v = lo[0] >> (8 * sh);
  if (sh != 0 && valid > 4 - sh) v = __funnelshift_r(lo[0], lo[1], 8 * sh);
  if (valid < 4) v &= 0xffffffffu >> (8 * (4 - valid));
  return v;
}

// Byte offset of 16-byte chunk c (0..3) of row `row` in a stage's x tile
// (rows of BK = 64 bytes, two to a 128-byte line): the chunk index inside
// the line is XORed with the line's low two bits, so the 8 rows an
// ldmatrix reads at one chunk fall on 8 different chunks of the banks.
__device__ __forceinline__ int x_off(int row, int c) {
  const int line = row >> 1;
  const int ch = ((row & 1) << 2) | c;
  return (line << 7) | ((ch ^ (line & 3)) << 4);
}

// Byte offset of (k row, byte column col) in a stage's w tile (BK rows of
// BN bytes): the chunk index inside each 128-byte line is XORed with
// 2 * ((k / 4) % 4), so the four k rows 4 apart that one B load reads (8
// lanes each, 32 bytes a row) fall on four different pairs of chunks.
template <int BN>
__device__ __forceinline__ int w_off(int k, int col) {
  const int off = k * BN + col;
  const int ch = (off >> 4) & 7;
  return (off & ~0x7f) | ((ch ^ (((k >> 2) & 3) << 1)) << 4) | (off & 15);
}

// x rows [m0, m0+BM) x k [k0, k0+BK) into a stage
template <int BM, int NT, bool AV>
__device__ __forceinline__ void load_x(uint8_t* xs,
                                       const int8_t* __restrict__ x, int M,
                                       int K, int m0, int k0, int kend) {
  const int t = threadIdx.x;
  if constexpr (AV) {   // K % 16 == 0, x 16-byte aligned: whole chunks
#pragma unroll
    for (int i = 0; i < BM * 4 / NT; ++i) {
      const int c = t + i * NT;
      const int row = c >> 2, ch = c & 3;
      const int gm = m0 + row, gk = k0 + ch * 16;
      const bool ok = gm < M && gk < kend;
      cp_async16(smem_u32(xs + x_off(row, ch)),
                 ok ? x + (size_t)gm * K + gk : x, ok ? 16 : 0);
    }
  } else {              // masked words of any alignment
#pragma unroll
    for (int i = 0; i < BM * 16 / NT; ++i) {
      const int c = t + i * NT;
      const int row = c >> 4, q = c & 15;   // word q: k 4q .. 4q+3
      const int gm = m0 + row, gk = k0 + 4 * q;
      const uint32_t word = load_bytes4(x + (size_t)gm * K + gk,
                                        gm < M ? min(4, kend - gk) : 0);
      *reinterpret_cast<uint32_t*>(xs + x_off(row, q >> 2) + 4 * (q & 3)) =
          word;
    }
  }
}

// w k [k0, k0+BK) x columns [n0, n0+BN) into a stage
template <int BN, int NT, bool BV>
__device__ __forceinline__ void load_w(uint8_t* ws,
                                       const int8_t* __restrict__ w, int N,
                                       int n0, int k0, int kend) {
  const int t = threadIdx.x;
  if constexpr (BV) {   // N % 16 == 0, w 16-byte aligned: whole chunks
    constexpr int CPR = BN / 16;
#pragma unroll
    for (int i = 0; i < BK * CPR / NT; ++i) {
      const int c = t + i * NT;
      const int k = c / CPR, col = (c % CPR) * 16;
      const int gk = k0 + k, gn = n0 + col;
      const bool ok = gk < kend && gn < N;
      cp_async16(smem_u32(ws + w_off<BN>(k, col)),
                 ok ? w + (size_t)gk * N + gn : w, ok ? 16 : 0);
    }
  } else {              // masked words of any alignment
    constexpr int WPR = BN / 4;
#pragma unroll
    for (int i = 0; i < BK * WPR / NT; ++i) {
      const int c = t + i * NT;
      const int k = c / WPR, col = (c % WPR) * 4;
      const int gk = k0 + k, gn = n0 + col;
      const uint32_t word = load_bytes4(w + (size_t)gk * N + gn,
                                        gk < kend ? min(4, N - gn) : 0);
      *reinterpret_cast<uint32_t*>(ws + w_off<BN>(k, col)) = word;
    }
  }
}

// The block's sums through shared memory into out: stage 1 puts each
// thread's sums (as E: int32, or the scaled output type) at their row and
// column, stage 2 writes 16 bytes of a row a thread (scalar and masked at
// the ragged edge, or one int32 atomic an element for a split K).
template <typename E, int BM, int BN, int NT, int WARPS_N>
__device__ __forceinline__ void store_tile(uint8_t* smem,
                                           const int (&acc)[MT][NT8][4],
                                           const float* __restrict__ scale,
                                           void* out_, int M, int N, int m0,
                                           int n0, int epilogue) {
  constexpr int VEC = 16 / (int)sizeof(E);
  constexpr int STRIDE = BN + VEC;        // elements a staged row
  E* tile = reinterpret_cast<E*>(smem);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * WN + 8 * q + 4 * e + j;  // n8 tile j, slot 2q+e
      float s = 0.f;
      if (epilogue == kScaled && n0 + col < N) s = scale[n0 + col];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * WM + mi * 16 + g + 8 * h;
          const int v = acc[mi][j][2 * h + e];
          E val;
          if constexpr (std::is_same<E, int>::value) {
            val = v;
          } else {
            val = from_f<E>(__int2float_rn(v) * s);
          }
          tile[row * STRIDE + col] = val;
        }
      }
    }
  }
  __syncthreads();
  E* out = static_cast<E*>(out_);
  const bool vec_ok = N % VEC == 0 &&
                      (reinterpret_cast<uintptr_t>(out_) & 15) == 0;
  constexpr int VPR = BN / VEC;           // 16-byte pieces a row
  for (int i = t; i < BM * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const E* src = tile + r * STRIDE + c;
    E* dst = out + (size_t)gm * N + gn;
    if (epilogue == kAtomicI32) {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (gn + e < N)
          atomicAdd(reinterpret_cast<int*>(dst) + e,
                    reinterpret_cast<const int*>(src)[e]);
    } else if (vec_ok && gn + VEC <= N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (gn + e < N) dst[e] = src[e];
    }
  }
}

template <int WARPS_M, int WARPS_N>
constexpr int smem_bytes() {
  constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  constexpr int ring = STAGES * (BM * BK + BK * BN);
  constexpr int staged = BM * (BN + 4) * 4;   // the widest epilogue, 4-byte
  return ring > staged ? ring : staged;
}

template <int WARPS_M, int WARPS_N, bool AV, bool BV>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32,
                                  256 / (WARPS_M * WARPS_N * 32))
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out,
                   int M, int N, int K, int kchunk, int epilogue,
                   int out_code) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  constexpr int X_BYTES = BM * BK, STAGE_BYTES = X_BYTES + BK * BN;
  extern __shared__ __align__(128) uint8_t smem[];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int steps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  int acc[MT][NT8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) {
      uint8_t* st = smem + s * STAGE_BYTES;
      load_x<BM, NT, AV>(st, x, M, K, m0, kbeg + s * BK, kend);
      load_w<BN, NT, BV>(st + X_BYTES, w, N, n0, kbeg + s * BK, kend);
    }
    cp_async_commit();
  }

  // this lane's ldmatrix row and chunk half, and its B column
  const int a_row = wm * WM + (lane & 15), a_half = lane >> 4;
  const int b_col = wn * WN + 4 * g;

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();     // step's stage has landed
    __syncthreads();                 // ... for every thread; and the slot
                                     // refilled below is no longer read
    const int next = step + STAGES - 1;
    if (next < steps) {
      uint8_t* st = smem + (next % STAGES) * STAGE_BYTES;
      load_x<BM, NT, AV>(st, x, M, K, m0, kbeg + next * BK, kend);
      load_w<BN, NT, BV>(st + X_BYTES, w, N, n0, kbeg + next * BK, kend);
    }
    cp_async_commit();
    const uint8_t* xs = smem + (step % STAGES) * STAGE_BYTES;
    const uint8_t* ws = xs + X_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        ldsm_x4(smem_u32(xs + x_off(a_row + mi * 16, 2 * kk + a_half)),
                a[mi]);
      uint32_t b[NT8][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const uint32_t*>(
              ws + w_off<BN>(32 * kk + 16 * h + 4 * q + i, b_col));
        transpose4x4(r, c);
#pragma unroll
        for (int j = 0; j < NT8; ++j) b[j][h] = c[j];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < NT8; ++j) mma_s8(acc[mi][j], a[mi], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free for the epilogue

  if (epilogue != kScaled) {
    store_tile<int, BM, BN, NT, WARPS_N>(smem, acc, scale, out, M, N, m0, n0,
                                         epilogue);
  } else if (out_code == 0) {
    store_tile<float, BM, BN, NT, WARPS_N>(smem, acc, scale, out, M, N, m0,
                                           n0, epilogue);
  } else if (out_code == 1) {
    store_tile<__nv_bfloat16, BM, BN, NT, WARPS_N>(smem, acc, scale, out, M,
                                                   N, m0, n0, epilogue);
  } else {
    store_tile<__half, BM, BN, NT, WARPS_N>(smem, acc, scale, out, M, N, m0,
                                            n0, epilogue);
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

template <int WARPS_M, int WARPS_N, bool AV, bool BV>
cudaError_t launch_instance(const void* x, const void* w, const void* scale,
                            void* out, int M, int N, int K, int splits,
                            int kchunk, int epilogue, int out_code,
                            cudaStream_t st) {
  constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  constexpr int smem = smem_bytes<WARPS_M, WARPS_N>();
  static_assert(smem <= 48 * 1024, "above 48 KB needs the opt-in attribute");
  auto* kern = int8_matmul_kernel<WARPS_M, WARPS_N, AV, BV>;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
            (unsigned)splits);
  kern<<<grid, WARPS_M * WARPS_N * 32, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), out, M, N, K, kchunk, epilogue,
      out_code);
  return cudaGetLastError();
}

template <int WARPS_M, int WARPS_N>
cudaError_t launch_tile(bool av, bool bv, const void* x, const void* w,
                        const void* scale, void* out, int M, int N, int K,
                        int splits, int kchunk, int epilogue, int out_code,
                        cudaStream_t st) {
  if (av && bv)
    return launch_instance<WARPS_M, WARPS_N, true, true>(
        x, w, scale, out, M, N, K, splits, kchunk, epilogue, out_code, st);
  if (av)
    return launch_instance<WARPS_M, WARPS_N, true, false>(
        x, w, scale, out, M, N, K, splits, kchunk, epilogue, out_code, st);
  if (bv)
    return launch_instance<WARPS_M, WARPS_N, false, true>(
        x, w, scale, out, M, N, K, splits, kchunk, epilogue, out_code, st);
  return launch_instance<WARPS_M, WARPS_N, false, false>(
      x, w, scale, out, M, N, K, splits, kchunk, epilogue, out_code, st);
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

// tile: the block tile, 0 = 128 x 64, 1 = 64 x 64 (rows x columns of out;
// ops.py TILES). out_code: -1 = int32
// sums, 0 = float32, 1 = bfloat16, 2 = float16 (then scale is (N,)
// float32). splits > 1 splits K over gridDim.z, each split a whole number
// of 64-deep k steps; the sums then meet in int32 atomics in ``out`` (int32
// out) or in ``acc``, an (M, N) int32 workspace the caller provides (scaled
// out). Returns a cudaError_t.
extern "C" int aeg_int8_matmul(const void* x, const void* w,
                               const void* scale, void* out, void* acc,
                               int M, int N, int K, int tile, int splits,
                               int out_code, void* stream) {
  static const int kRows[2] = {128, 64};
  if (M <= 0 || N <= 0 || K <= 0 || tile < 0 || tile > 1 || splits <= 0 ||
      splits > 65535 || (M + kRows[tile] - 1) / kRows[tile] > 65535 ||
      out_code < -1 || out_code > 2 ||
      (splits > 1 && out_code >= 0 && acc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = (K + BK - 1) / BK;
  const int kchunk = ((steps + splits - 1) / splits) * BK;
  const bool av = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool bv = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  int epilogue = out_code < 0 ? kStoreI32 : kScaled;
  void* target = out;
  if (splits > 1) {
    epilogue = kAtomicI32;
    target = out_code < 0 ? out : acc;
    cudaError_t e = cudaMemsetAsync(target, 0, (size_t)M * N * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
  }
  cudaError_t e;
  if (tile == 0)
    e = launch_tile<2, 2>(av, bv, x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  else
    e = launch_tile<1, 2>(av, bv, x, w, scale, target, M, N, K, splits, kchunk, epilogue, out_code, st);
  if (e != cudaSuccess || splits == 1 || out_code < 0) return (int)e;
  const long long mn = (long long)M * N;
  switch (out_code) {
    case 0: return (int)launch_scale<float>(acc, scale, out, mn, N, st);
    case 1: return (int)launch_scale<__nv_bfloat16>(acc, scale, out, mn, N, st);
    default: return (int)launch_scale<__half>(acc, scale, out, mn, N, st);
  }
}
