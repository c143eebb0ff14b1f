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
// contiguous row of Di*N lanes.
//
// What bounds it. At the hybrid slice's shape (B=1, T=512, Di=1600, N=16,
// fp32) one launch must read da and bx (2 x 52,428,800 bytes) and c
// (32,768 bytes) and write y (3,276,800 bytes): 108,167,168 bytes, 32.3 us
// at 3.35 TB/s. It does about 5 operations per (t, d, n) (an exp, the
// multiply-add of the recurrence, the product with c and its share of the
// sum): 65.5 M, about 1 us at the 67 TFLOP/s fp32 rate. So device memory
// bounds it. Two things stood between the first kernel and that bound:
// loads capped by registers (16 steps a lane), and, with one lane per
// (b, d, n), only 25,600 lanes: 6 warps an SM, so every warp's own chain
// of dependent instructions shows in the time.
//
// Two hand-written instances, both with one lane per (b, d, n) that keeps
// h in a register through a loop over all of T inside its block (nothing
// carries over between blocks), and both with the same arithmetic, so they
// give the same bits on every input:
//   - each step is h = expf(a) * h + b (one contracted FMA), then p = h * c;
//   - y[t,d] is the xor tree over the N lanes of a channel: the sums of
//     lanes l and l^(N/2), then of l^(N/4), ..., then of l^1.
//
// The ring instance (ssm_scan_ring_kernel, the wrapper's choice). A block
// of W threads owns W consecutive lanes of the (Di*N) row. Its operands
// stream through a ring of D stages in dynamic shared memory; a stage
// holds S steps x W lanes of da and of bx and S x N of c. Every thread
// issues its share of a stage as 16-byte cp.async.cg copies (consecutive
// threads on consecutive bytes), one commit group a stage, D - 1 stages
// ahead; the block waits for stage s, meets at a __syncthreads (so the
// slot of stage s - 1 is free), refills that slot and computes stage s
// from shared memory while the copies fly. A group of N steps loads and
// exps all its operands first (none depends on h), then runs the chain of
// FMAs; the xor tree is taken over the N steps at once: at each level a
// lane keeps half of its sums and trades the other half with its partner,
// so after N steps lane n holds y of step n, with the same additions in
// the same tree (15 shuffles for 16 steps, not 64), and writes it. The
// levels are template recursion, so the sums stay in registers. A ragged
// T ends the last stage early: rows past T are neither copied nor
// computed. Lanes past Di*N in the last block (whole idle channels) read
// zeros and still join the shuffles. The copies need 16-byte rows:
// operands at 16-byte aligned addresses and N * sizeof(element) a multiple
// of 16 (every fp32 N; N >= 8 in bf16 and f16), which also makes every
// row of Di*N lanes and of N a whole number of 16-byte units. The plan
// (ops.plan_for) takes S = 32 and D = 2: on the card, rings deeper than
// some 32 to 48 steps ahead were slower, and bulk copies (cp.async.bulk
// on an mbarrier, from one thread or a producer warp) were no faster.
//
// The row-wise instance (ssm_scan_rowwise_kernel, the port's first kernel)
// stays for what the ring cannot copy: bf16/f16 with N = 4 (rows of c of 8
// bytes; with an odd Di, rows of da of 8 bytes too) and operands whose
// base is not 16-byte aligned (a view at a storage offset). It loads CH
// steps of da, bx and c into registers, one element a lane, while it
// computes the previous CH, and sums y per step with the xor butterfly.
#include <cuda_runtime.h>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;
using aeg::to_f;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;      // 227 KB: the most a block may have
constexpr int MAX_W = 128;            // lanes (threads) of a ring block
constexpr int MAX_DEPTH = 16;         // stages of a ring

// ---- the ring instance --------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// one 16-byte global -> shared copy by this thread, around L1
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait_k() {
  asm volatile("cp.async.wait_group %0;" :: "n"(K) : "memory");
}

// wait until at most ``pending`` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
#define AEG_WAIT(K) case K: cp_async_wait_k<K>(); break
    AEG_WAIT(1); AEG_WAIT(2); AEG_WAIT(3); AEG_WAIT(4); AEG_WAIT(5);
    AEG_WAIT(6); AEG_WAIT(7); AEG_WAIT(8); AEG_WAIT(9); AEG_WAIT(10);
    AEG_WAIT(11); AEG_WAIT(12); AEG_WAIT(13); AEG_WAIT(14);
#undef AEG_WAIT
    default: cp_async_wait_k<0>();
  }
}

// Shared memory of one block: D slots of S x (2W + N) elements.
template <typename T>
__host__ __device__ constexpr long long ring_smem_bytes(int W, int S, int D,
                                                        int N) {
  return (long long)D * S * (2 * W + N) * sizeof(T);
}

// Issue this thread's share of the copies of stage rows (b, t0) .. (b, t0 +
// rows - 1) into ``slot``, 16 bytes each, consecutive threads on
// consecutive bytes: ``live`` lanes of da and of bx a row, at rows r * W
// and S * W + r * W, then rows * N of c at 2 * S * W. ``row0`` = b * T + t0.
template <typename T, int N>
__device__ __forceinline__ void fill_slot(T* slot, const T* da, const T* bx,
                                          const T* c, long long row0,
                                          int rows, long long dn,
                                          long long lane0, int live, int W,
                                          int S, int tid) {
  constexpr int E = 16 / sizeof(T);      // elements a 16-byte copy
  const int per_row = live / E;
  for (int i = tid; i < rows * per_row; i += W) {
    const int r = i / per_row, k = (i - r * per_row) * E;
    const long long off = (row0 + r) * dn + lane0 + k;
    cp_async16(smem_addr(slot + r * W + k), da + off);
    cp_async16(smem_addr(slot + S * W + r * W + k), bx + off);
  }
  for (int i = tid; i < rows * N / E; i += W)
    cp_async16(smem_addr(slot + 2 * S * W + i * E), c + row0 * N + i * E);
}

// The xor tree over the N lanes of a channel for N steps at once: v[j] is
// this lane's h * c of step j. At level O (N/2, ..., 1) the lane keeps the
// half of its sums whose step has bit O equal to its own lane bit O, and
// adds its partner's (lane ^ O) sums of the same steps. Leaves y of step n
// in v[0]: the same pairs added in the same order as the per-step
// butterfly. The levels are template recursion, so every index is a
// constant and v stays in registers.
template <int N, int O = N / 2>
__device__ __forceinline__ void tree_sum(float (&v)[N], int n) {
  if constexpr (O > 0) {
    const bool up = (n & O) != 0;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, O);
    }
    tree_sum<N, O / 2>(v, n);
  }
}

// N steps of the recurrence from rows g .. g+N-1 of a slot: the loads and
// exps of the group first (none depends on h), then the chain of FMAs.
// With CHECK, rows at or past ``rows`` give p = 0 and leave h alone.
template <typename T, int N, bool CHECK>
__device__ __forceinline__ void steps(const T* A, const T* Bv, const T* C,
                                      int g, int rows, int W, int tid, int n,
                                      float& h, float (&v)[N]) {
  float e[N], bb[N], cc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = g + j;
    if (!CHECK || r < rows) {
      e[j] = expf(to_f(A[r * W + tid]));
      bb[j] = to_f(Bv[r * W + tid]);
      cc[j] = to_f(C[r * N + n]);
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (!CHECK || g + j < rows) {
      h = e[j] * h + bb[j];
      v[j] = h * cc[j];
    } else {
      v[j] = 0.f;
    }
  }
}

// The S steps of one stage from its slot; lane n of a channel writes y of
// step t0 + g + n after each group of N steps.
template <typename T, int N>
__device__ __forceinline__ void compute_stage(const T* A, int rows, int W,
                                              int S, int tid, int n, int d,
                                              int Di, float& h, T* yrow) {
  const T* Bv = A + S * W;
  const T* C = A + 2 * S * W;
  for (int g = 0; g < rows; g += N) {
    float v[N];
    if (g + N <= rows)
      steps<T, N, false>(A, Bv, C, g, rows, W, tid, n, h, v);
    else
      steps<T, N, true>(A, Bv, C, g, rows, W, tid, n, h, v);
    tree_sum<N>(v, n);
    if (g + n < rows && d < Di)
      yrow[(long long)(g + n) * Di] = from_f<T>(v[0]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(MAX_W)
ssm_scan_ring_kernel(const T* __restrict__ da, const T* __restrict__ bx,
                     const T* __restrict__ c, T* __restrict__ y, int Tn,
                     int Di, int S, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int n = tid % N;                 // W and lane0 are multiples of N
  const long long dn = (long long)Di * N;
  const long long lane0 = (long long)blockIdx.x * W;
  const int live = (int)min((long long)W, dn - lane0);
  const int d = (int)(lane0 / N) + tid / N;
  const long long b = blockIdx.y;
  const int nst = (Tn + S - 1) / S;
  const int slot_elems = S * (2 * W + N);
  T* ring = reinterpret_cast<T*>(smem);
  T* yb = y + b * Tn * Di + d;           // y of (b, t = 0, d)

  if (tid >= live) {                     // idle lanes read zeros, always
    for (int i = 0; i < D * S; ++i) {
      T* slot = ring + (i / S) * slot_elems + (i % S) * W + tid;
      slot[0] = from_f<T>(0.f);
      slot[S * W] = from_f<T>(0.f);
    }
  }
  // D - 1 stages ahead; one commit group a stage, empty ones included, so
  // waiting for all but the newest D - 2 groups finds this thread's stage s
  for (int k = 0; k < D - 1; ++k) {
    if (k < nst)
      fill_slot<T, N>(ring + k * slot_elems, da, bx, c, b * Tn + k * S,
                      min(S, Tn - k * S), dn, lane0, live, W, S, tid);
    cp_async_commit();
  }
  float h = 0.f;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait(D - 2);
    __syncthreads();                     // stage s landed; s - 1 was read
    const int k = s + D - 1;             // refills the slot of stage s - 1
    if (k < nst)
      fill_slot<T, N>(ring + (k % D) * slot_elems, da, bx, c, b * Tn + k * S,
                      min(S, Tn - k * S), dn, lane0, live, W, S, tid);
    cp_async_commit();
    compute_stage<T, N>(ring + (s % D) * slot_elems, min(S, Tn - s * S), W,
                        S, tid, n, d, Di, h, yb + (long long)s * S * Di);
  }
}

template <typename T, int N>
cudaError_t launch_ring(const void* da, const void* bx, const void* c,
                        void* y, int B, int Tn, int Di, int W, int S, int D,
                        cudaStream_t stream) {
  // dynamic shared memory above 48 KB: raise the instance's cap once a card
  static unsigned long long configured = 0;      // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1ULL)) {
    err = cudaFuncSetAttribute(ssm_scan_ring_kernel<T, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured |= 1ULL << dev;
  }
  const long long lanes = (long long)Di * N;
  dim3 grid((unsigned)((lanes + W - 1) / W), B);
  const size_t smem = (size_t)ring_smem_bytes<T>(W, S, D, N);
  ssm_scan_ring_kernel<T, N><<<grid, W, smem, stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(bx),
      static_cast<const T*>(c), static_cast<T*>(y), Tn, Di, S, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ring_n(const void* da, const void* bx, const void* c,
                          void* y, int B, int Tn, int Di, int N, int W, int S,
                          int D, cudaStream_t stream) {
  // the plan's limits: whole warps of whole channels, stages of whole
  // N-step groups, 16-byte rows, 2 to MAX_DEPTH stages within 227 KB
  const auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  if (W <= 0 || W > MAX_W || W % 32 || S < N || S % N || D < 2 ||
      D > MAX_DEPTH || (N * sizeof(T)) % 16 || !aligned(da) ||
      !aligned(bx) || !aligned(c) ||
      ring_smem_bytes<T>(W, S, D, N) > MAX_SMEM)
    return cudaErrorInvalidValue;
  switch (N) {
    case 4: return launch_ring<T, 4>(da, bx, c, y, B, Tn, Di, W, S, D, stream);
    case 8: return launch_ring<T, 8>(da, bx, c, y, B, Tn, Di, W, S, D, stream);
    case 16: return launch_ring<T, 16>(da, bx, c, y, B, Tn, Di, W, S, D,
                                       stream);
    case 32: return launch_ring<T, 32>(da, bx, c, y, B, Tn, Di, W, S, D,
                                       stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- the row-wise instance ----------------------------------------------

constexpr int NT = 128;           // threads per block (4 warps)
constexpr int CH = 16;            // time steps held in registers ahead

template <typename T, int N>
__global__ void __launch_bounds__(NT)
ssm_scan_rowwise_kernel(const T* __restrict__ da, const T* __restrict__ bx,
                        const T* __restrict__ c, T* __restrict__ y, int Tn,
                        int Di) {
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
        p += __shfl_xor_sync(FULL, p, o);
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
cudaError_t launch_rowwise(const void* da, const void* bx, const void* c,
                           void* y, int B, int Tn, int Di,
                           cudaStream_t stream) {
  const long long lanes = (long long)Di * N;
  dim3 grid((unsigned)((lanes + NT - 1) / NT), B);
  ssm_scan_rowwise_kernel<T, N><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(da), static_cast<const T*>(bx),
      static_cast<const T*>(c), static_cast<T*>(y), Tn, Di);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rowwise_n(const void* da, const void* bx, const void* c,
                             void* y, int B, int Tn, int Di, int N,
                             cudaStream_t stream) {
  switch (N) {
    case 4: return launch_rowwise<T, 4>(da, bx, c, y, B, Tn, Di, stream);
    case 8: return launch_rowwise<T, 8>(da, bx, c, y, B, Tn, Di, stream);
    case 16: return launch_rowwise<T, 16>(da, bx, c, y, B, Tn, Di, stream);
    case 32: return launch_rowwise<T, 32>(da, bx, c, y, B, Tn, Di, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Each returns a cudaError_t.

// The ring instance with the plan (W lanes a block, S steps a stage, D
// stages); refuses a plan or operands it cannot take with
// cudaErrorInvalidValue.
extern "C" int aeg_ssm_scan_ring(const void* da, const void* bx,
                                 const void* c, void* y, int B, int T, int Di,
                                 int N, int dtype, int W, int S, int D,
                                 void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_ring_n<float>(da, bx, c, y, B, T, Di, N, W, S,
                                             D, st);
    case 1: return (int)launch_ring_n<__nv_bfloat16>(
        da, bx, c, y, B, T, Di, N, W, S, D, st);
    case 2: return (int)launch_ring_n<__half>(da, bx, c, y, B, T, Di, N, W, S,
                                              D, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The row-wise instance: any alignment, N in {4, 8, 16, 32}.
extern "C" int aeg_ssm_scan_rowwise(const void* da, const void* bx,
                                    const void* c, void* y, int B, int T,
                                    int Di, int N, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || Di <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_rowwise_n<float>(da, bx, c, y, B, T, Di, N, st);
    case 1: return (int)launch_rowwise_n<__nv_bfloat16>(da, bx, c, y, B, T, Di,
                                                        N, st);
    case 2: return (int)launch_rowwise_n<__half>(da, bx, c, y, B, T, Di, N,
                                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}
