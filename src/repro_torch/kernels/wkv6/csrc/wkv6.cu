// RWKV-6 WKV recurrence (data-dependent decay) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py, function
// wkv6_bhtk (pl.pallas_call at line 76), and computes what it computes:
// from a zero (K, K) state S per (b, h), for t = 0 .. T-1,
//   y[t,o] = sum_i r[t,i] * (S[i,o] + u[i] k[t,i] v[t,o])
//   S[i,o] = exp(lw[t,i]) * S[i,o] + k[t,i] v[t,o]
// with fp32 math (expf, no fast math) and y in r's dtype. lw <= 0, so every
// decay exp(lw) is <= 1 and the per-token form cannot overflow; lw = -80
// gives 1.8e-35, still a normal float. Like the TPU kernel it needs neither
// T nor H to be a multiple of anything.
//
// Layout: r, k, v, lw, y (B, T, H, K), contiguous and read in place; u
// (H, K) fp32 (the wrapper casts it, exactly). For each (b, t, h) the K
// values of an operand are one contiguous run.
//
// What bounds it. At the rwkv6-1.6B slice's shape (B=1, T=512, H=32, K=64,
// fp32) one launch must read r, k, v, lw (4 x 4,194,304 bytes) and u
// (8,192 bytes) and write y (4,194,304 bytes): 20,979,712 bytes, 6.26 us at
// 3.35 TB/s. Its arithmetic is 5 operations per (b, t, h, i, o) (k*v, the
// multiply-add into y, the multiply-add of the state update) and about 4
// per (b, t, h, i) (the exp and the bonus term): 5 K^2 T H + 4 K T H =
// 339.7 M operations, 5.07 us at the 67 TFLOP/s fp32 rate. So device
// memory bounds it, narrowly: r, k, v and lw are streamed once, and the
// state never leaves the registers.
//
// Design. The TPU kernel walks T in chunks over sequential grid steps,
// keeps S in VMEM scratch and builds a (C, C, K) pairwise-decay tensor per
// chunk. Here the recurrence runs token by token inside one block, as the
// oracle does, so nothing carries over between blocks:
//  - each value column o of a head's S is split over G = min(K, 16)
//    adjacent lanes; each lane keeps R = K / G rows of that column in
//    registers through a loop over all of T. y[t,o] is the sum over those
//    G lanes by xor-shuffles in a fixed order (no atomics: the result is the
//    same on every run). A block holds CB = 16 columns (all K for K <= 16),
//    so at the slice's shape a head is K / CB = 4 blocks of 8 warps and the
//    launch has 128 blocks, 1024 warps: about one block on each of the 132
//    SMs. Smaller G would give each lane more rows and fewer shuffles but
//    halve the warps; with G = 16 a lane reads its 4 rows of r, k and
//    exp(lw) as one 16-byte load each, without bank conflicts.
//  - the block stages CH steps of r, k, exp(lw) (all K rows) and of v (its
//    CB columns) in shared memory. exp(lw[t,i]) is computed there once per
//    block, not by each column's lanes (CB = 16 times fewer expf), and so
//    is the bonus coefficient sum_i r u k of each step, by a shuffle
//    reduction. A row of a column then costs k*v and two fmaf a step.
//  - a step's loads do not depend on S: each thread loads the next CH
//    steps into registers while the block computes the current CH from
//    shared memory (double-buffered), so the recurrence waits on memory
//    once per CH steps. y goes through shared memory and is written as
//    runs of CB contiguous values. A ragged T tail loads r = k = v = lw = 0
//    (identity steps: exp(0) = 1 keeps S) and stores nothing.
#include <cuda_runtime.h>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;
using aeg::to_f;

constexpr int NT_MAX = 256;       // threads per block at most (8 warps)
constexpr int CH = 16;            // time steps staged in shared memory

template <int K>
struct Tile {
  static constexpr int G = K < 16 ? K : 16;           // lanes per column
  static constexpr int R = K / G;                     // state rows per lane
  static constexpr int NT = K * G < NT_MAX ? K * G : NT_MAX;   // threads
  static constexpr int CB = NT / G;                   // columns per block
  static constexpr int NE = CH * K / NT;     // r/k/lw values a thread stages
  static constexpr int NV = CH * CB / NT;    // v (and y) values a thread moves
  static constexpr int W = K < 32 ? K : 32;  // lanes summing one step's bonus
  static constexpr int P = K / W;            // bonus partial sums per step
  static_assert(32 % G == 0 && NT % 32 == 0 && NT % K == 0, "tile");
  static_assert((CH * K) % NT == 0 && (CH * CB) % NT == 0, "staging");
};

// R consecutive floats of shared memory in one load.
template <int R> __device__ __forceinline__ void load_rows(const float* p,
                                                           float (&x)[R]);
template <> __device__ __forceinline__ void load_rows<1>(const float* p,
                                                         float (&x)[1]) {
  x[0] = *p;
}
template <> __device__ __forceinline__ void load_rows<2>(const float* p,
                                                         float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}
template <> __device__ __forceinline__ void load_rows<4>(const float* p,
                                                         float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}

template <typename T, int K>
__global__ void __launch_bounds__(Tile<K>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ lw,
            const float* __restrict__ u, T* __restrict__ y, int Tn, int H) {
  using C = Tile<K>;
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int TS = C::NT / K;       // steps between a thread's r/k/lw values
  constexpr int VS = C::NT / C::CB;   // steps between a thread's v/y values
  __shared__ __align__(16) float s_r[2][CH][K];
  __shared__ __align__(16) float s_k[2][CH][K];
  __shared__ __align__(16) float s_w[2][CH][K];
  __shared__ float s_v[2][CH][C::CB];
  __shared__ float s_y[2][CH][C::CB];
  __shared__ float s_c[2][CH][C::P];  // partial sums of sum_i r u k

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * C::CB;
  const int h = blockIdx.y;
  const long long hk = (long long)H * K;
  const long long base = (long long)blockIdx.z * Tn * hk + (long long)h * K;
  // staging roles: row si of steps st + n * TS; column vc of steps vt + n * VS
  const int si = tid % K, st = tid / K;
  const int vc = tid % C::CB, vt = tid / C::CB;
  const float us = u[(long long)h * K + si];
  // compute role: lane g of column c, rows g * R .. g * R + R - 1
  const int c = tid / C::G, g = tid % C::G;

  float pr[C::NE], pk[C::NE], pl[C::NE], pv[C::NV];
  auto load = [&](int t0) {
#pragma unroll
    for (int n = 0; n < C::NE; ++n) {
      const int t = t0 + st + n * TS;
      const bool ok = t < Tn;
      const long long off = base + t * hk + si;
      pr[n] = ok ? to_f(r[off]) : 0.f;
      pk[n] = ok ? to_f(k[off]) : 0.f;
      pl[n] = ok ? to_f(lw[off]) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      const int t = t0 + vt + n * VS;
      pv[n] = t < Tn ? to_f(v[base + t * hk + o0 + vc]) : 0.f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int n = 0; n < C::NE; ++n) {
      const int tl = st + n * TS;
      s_r[buf][tl][si] = pr[n];
      s_k[buf][tl][si] = pk[n];
      s_w[buf][tl][si] = expf(pl[n]);
      float p = pr[n] * us * pk[n];
#pragma unroll
      for (int o = C::W / 2; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
      if (si % C::W == 0) s_c[buf][tl][si / C::W] = p;
    }
#pragma unroll
    for (int n = 0; n < C::NV; ++n) s_v[buf][vt + n * VS][vc] = pv[n];
  };

  load(0);
  stage(0);
  __syncthreads();
  float S[C::R];
#pragma unroll
  for (int q = 0; q < C::R; ++q) S[q] = 0.f;
  for (int t0 = 0, buf = 0; t0 < Tn; t0 += CH, buf ^= 1) {
    const bool more = t0 + CH < Tn;             // the same in the whole block
    if (more) load(t0 + CH);                    // in flight during the steps
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float rr[C::R], kk[C::R], ww[C::R];
      load_rows<C::R>(&s_r[buf][j][g * C::R], rr);
      load_rows<C::R>(&s_k[buf][j][g * C::R], kk);
      load_rows<C::R>(&s_w[buf][j][g * C::R], ww);
      const float vv = s_v[buf][j][c];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < C::R; ++q) {
        acc = fmaf(rr[q], S[q], acc);
        S[q] = fmaf(ww[q], S[q], kk[q] * vv);
      }
#pragma unroll
      for (int o = C::G / 2; o > 0; o >>= 1)
        acc += __shfl_xor_sync(FULL, acc, o);
      if (g == 0) {
        float coef = s_c[buf][j][0];
#pragma unroll
        for (int p = 1; p < C::P; ++p) coef += s_c[buf][j][p];
        s_y[buf][j][c] = fmaf(coef, vv, acc);
      }
    }
    if (more) stage(buf ^ 1);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      const int tl = vt + n * VS;
      const int t = t0 + tl;
      if (t < Tn) y[base + t * hk + o0 + vc] = from_f<T>(s_y[buf][tl][vc]);
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* y, int B, int Tn,
                   int H, cudaStream_t stream) {
  using C = Tile<K>;
  dim3 grid(K / C::CB, H, B);
  wkv6_kernel<T, K><<<grid, C::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const float*>(u), static_cast<T*>(y), Tn, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* lw, const void* u, void* y, int B, int Tn,
                     int H, int K, cudaStream_t stream) {
  switch (K) {
    case 8: return launch<T, 8>(r, k, v, lw, u, y, B, Tn, H, stream);
    case 16: return launch<T, 16>(r, k, v, lw, u, y, B, Tn, H, stream);
    case 32: return launch<T, 32>(r, k, v, lw, u, y, B, Tn, H, stream);
    case 64: return launch<T, 64>(r, k, v, lw, u, y, B, Tn, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v, lw and y): 0 = float32, 1 = bfloat16, 2 = float16;
// u is float32. Returns a cudaError_t.
extern "C" int aeg_wkv6(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, void* y, int B, int T,
                        int H, int K, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_k<float>(r, k, v, lw, u, y, B, T, H, K, st);
    case 1:
      return (int)launch_k<__nv_bfloat16>(r, k, v, lw, u, y, B, T, H, K, st);
    case 2: return (int)launch_k<__half>(r, k, v, lw, u, y, B, T, H, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
