// Selective-SSM scan (the Mamba recurrence) for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py, function
// ssm_scan_btdn (pl.pallas_call at line 50), and computes what it computes:
// from h0 = 0, for t = 0 .. T-1,
//   h[d,n] = exp(da[t,d,n]) * h[d,n] + bx[t,d,n],   y[t,d] = sum_n h[d,n] c[t,n]
// with fp32 math (expf, no fast math) and y in da's dtype. Like the TPU
// kernel it needs neither T nor Di to be a multiple of anything.
//
// Layout: da, bx (B, T, Di, N), c (B, T, N), y (B, T, Di), all contiguous
// and read in place. For each t, the (Di, N) slice of da and of bx is one
// contiguous run, so a warp reads 32 consecutive elements of each.
//
// What bounds it. At the hybrid slice's shape (B=1, T=512, Di=1600, N=16,
// fp32) one launch must read da and bx (2 x 52,428,800 bytes) and c
// (32,768 bytes) and write y (3,276,800 bytes): 108,167,168 bytes, 32.3 us
// at 3.35 TB/s. It does about 5 operations per (t, d, n) (an exp, the
// multiply-add of the recurrence, the product with c and its share of the
// sum): 65.5 M, about 1 us at the 67 TFLOP/s fp32 rate. So device memory
// bounds it: da and bx are streamed once and the state never leaves the
// registers.
//
// Design. The TPU kernel walks T in sequential grid steps and keeps a
// (d_block, N) state tile in VMEM scratch. Here one lane owns one (b, d, n)
// and keeps h in a register through a loop over all of T inside the block,
// so nothing carries over between blocks. The N lanes of a channel are
// adjacent in a warp; y[t,d] is their sum by xor-shuffles in a fixed order
// (no atomics: the result is the same on every run). N is a template
// parameter (4, 8, 16, 32), so a warp holds whole channels and a ragged Di
// only leaves whole idle lane groups, which still join the shuffles.
// The loads of a step do not depend on h: each lane loads CH steps of da,
// bx and c into registers while it computes the previous CH steps, so the
// recurrence waits on memory once per CH steps, not once per step. A ragged
// T tail loads da = 0, bx = 0 (identity steps) and stores nothing.
#include <cuda_runtime.h>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;
using aeg::to_f;

constexpr int NT = 128;           // threads per block (4 warps)
constexpr int CH = 16;            // time steps held in registers ahead

template <typename T, int N>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const T* __restrict__ da, const T* __restrict__ bx,
                const T* __restrict__ c, T* __restrict__ y, int Tn, int Di) {
  const int idx = blockIdx.x * NT + threadIdx.x;     // over Di * N
  const int d = idx / N, n = idx % N;
  const bool live = d < Di;
  const long long dn = (long long)Di * N;
  const long long b = blockIdx.y;
  const T* dap = da + b * Tn * dn + idx;
  const T* bxp = bx + b * Tn * dn + idx;
  const T* cp = c + b * Tn * N + n;
  T* yp = y + b * Tn * Di + d;

  float a_cur[CH], b_cur[CH], c_cur[CH];
  float a_nxt[CH], b_nxt[CH], c_nxt[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const bool ok = live && j < Tn;
    a_cur[j] = ok ? to_f(dap[(long long)j * dn]) : 0.f;
    b_cur[j] = ok ? to_f(bxp[(long long)j * dn]) : 0.f;
    c_cur[j] = ok ? to_f(cp[(long long)j * N]) : 0.f;
  }
  float h = 0.f;
  for (int t0 = 0; t0 < Tn; t0 += CH) {
    // the next CH steps, in flight while this chunk computes
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int t = t0 + CH + j;
      const bool ok = live && t < Tn;
      a_nxt[j] = ok ? to_f(dap[(long long)t * dn]) : 0.f;
      b_nxt[j] = ok ? to_f(bxp[(long long)t * dn]) : 0.f;
      c_nxt[j] = ok ? to_f(cp[(long long)t * N]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      h = expf(a_cur[j]) * h + b_cur[j];
      float p = h * c_cur[j];
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      const int t = t0 + j;
      if (live && n == 0 && t < Tn) yp[(long long)t * Di] = from_f<T>(p);
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      a_cur[j] = a_nxt[j];
      b_cur[j] = b_nxt[j];
      c_cur[j] = c_nxt[j];
    }
  }
}

template <typename T, int N>
cudaError_t launch(const void* da, const void* bx, const void* c, void* y,
                   int B, int Tn, int Di, cudaStream_t stream) {
  const long long lanes = (long long)Di * N;
  dim3 grid((unsigned)((lanes + NT - 1) / NT), B);
  ssm_scan_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(bx),
      static_cast<const T*>(c), static_cast<T*>(y), Tn, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_n(const void* da, const void* bx, const void* c, void* y,
                     int B, int Tn, int Di, int N, cudaStream_t stream) {
  switch (N) {
    case 4: return launch<T, 4>(da, bx, c, y, B, Tn, Di, stream);
    case 8: return launch<T, 8>(da, bx, c, y, B, Tn, Di, stream);
    case 16: return launch<T, 16>(da, bx, c, y, B, Tn, Di, stream);
    case 32: return launch<T, 32>(da, bx, c, y, B, Tn, Di, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int aeg_ssm_scan(const void* da, const void* bx, const void* c,
                            void* y, int B, int T, int Di, int N, int dtype,
                            void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_n<float>(da, bx, c, y, B, T, Di, N, st);
    case 1: return (int)launch_n<__nv_bfloat16>(da, bx, c, y, B, T, Di, N, st);
    case 2: return (int)launch_n<__half>(da, bx, c, y, B, T, Di, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
