// Blocked causal/GQA flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function flash_attention_bhsd (pl.pallas_call at line 86), and computes
// what it computes: softmax(q k^T * scale) v with an online softmax whose
// running max m, sum l and accumulator live in fp32; GQA (kv head =
// q head / group); causal masking top-left aligned (kpos <= qpos); masked
// scores -1e30; rows with l == 0 emit zeros; output in q's dtype. Unlike
// the Pallas kernel it masks a ragged key tail itself, causal or not, so
// no shape needs the plain version.
//
// Layout: the public (B, S, H, D) layout is read in place (row stride H*D
// for q/o, Hkv*D for k/v); no transpose is materialised.
//
// What bounds it. At the dense slice's shape (B=1, S=512, H=12, Hkv=2,
// D=128, bf16, causal) one launch must move q, k, v and o once: 3.67 MB,
// 1.10 us at 3.35 TB/s. It does 4*D*H*S(S+1)/2 = 0.807 GFLOP, 0.82 us at the
// 989 TFLOP/s bf16 tensor-core rate. So device memory bounds it, and the
// design keeps every score and probability on chip: one block stages its
// q tile and each k/v tile in shared memory once and never writes scores
// back to device memory.
//
// Design. One thread block per (q tile of BQ rows, b*H + h); it walks the
// k/v tiles of BK keys in shared memory up to the causal limit of its last
// row, so causal blocks stop early. All math is fp32 on the CUDA cores
// (fp32 inputs are held to 2e-6, and TF32 would not meet that). That is
// simple and right, and far from the bound: tensor-core tiles (mma/wgmma
// for bf16), TMA staging and warp specialisation are later work.
//
//   scores  S = Q K^T : thread t owns key column t % BK and BQ/(NT/BK) rows
//   softmax           : one warp per BQ/(NT/32) rows, warp-shuffle max/sum
//   output  O += P V  : thread t owns head-dim column t % D and
//                       BQ*D/NT rows, accumulated in registers
#include <cuda_runtime.h>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;
using aeg::to_f;

constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int NT = 128;           // threads per block (4 warps)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // Q tile, K tile (rows padded by one to spread banks), V tile,
  // probabilities (padded), then m, l, alpha per row
  return BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int Sk, int H, int Hkv, float scale, int causal) {
  static_assert(NT % D == 0 && (BQ * D) % NT == 0, "D must divide NT");
  static_assert(NT % BK == 0 && BQ % (NT / BK) == 0, "score tiling");
  static_assert(BK == 64, "softmax assumes two columns per lane");
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][D]
  float* Ks = Qs + BQ * D;               // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);         // [BK][D]
  float* Ps = Vs + BK * D;               // [BQ][BK + 1]
  float* m_s = Ps + BQ * (BK + 1);       // [BQ]
  float* l_s = m_s + BQ;                 // [BQ]
  float* a_s = l_s + BQ;                 // [BQ]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const long q_stride = (long)H * D;     // between consecutive positions
  const long k_stride = (long)Hkv * D;
  const T* qb = q + (long)b * S * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * k_stride + (long)hk * D;
  const T* vb = v + (long)b * Sk * k_stride + (long)hk * D;
  T* ob = o + (long)b * S * q_stride + (long)h * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D, d = e % D, s = q0 + i;
    Qs[e] = s < S ? to_f(qb[s * q_stride + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // output ownership: column od, rows orow0 + ORS * r
  constexpr int ORS = NT / D;
  constexpr int RPT = BQ * D / NT;
  const int od = tid % D;
  const int orow0 = tid / D;
  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  // score ownership: column sj, rows si0 + SRS * r
  constexpr int SRS = NT / BK;
  constexpr int SPT = BQ / SRS;
  const int sj = tid % BK;
  const int si0 = tid / BK;

  constexpr int RPW = BQ / (NT / 32);    // softmax rows per warp
  const int warp = tid / 32, lane = tid % 32;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                     // last tile's V and P are consumed
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D, s = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (s < Sk) {
        kv = to_f(kb[s * k_stride + d]);
        vv = to_f(vb[s * k_stride + d]);
      }
      Ks[j * (D + 1) + d] = kv;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    float sc[SPT];
#pragma unroll
    for (int r = 0; r < SPT; ++r) sc[r] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = Ks[sj * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < SPT; ++r) sc[r] = fmaf(Qs[(si0 + SRS * r) * D + d], kd, sc[r]);
    }
    const int kpos = k0 + sj;
#pragma unroll
    for (int r = 0; r < SPT; ++r) {
      const int i = si0 + SRS * r;
      const bool ok = kpos < Sk && (!causal || kpos <= q0 + i);
      Ps[i * (BK + 1) + sj] = ok ? sc[r] * scale : kNegInf;
    }
    __syncthreads();

    for (int rr = 0; rr < RPW; ++rr) {
      const int i = warp * RPW + rr;
      float* row = Ps + i * (BK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      // a masked score contributes exactly nothing
      const float p0 = x0 == kNegInf ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == kNegInf ? 0.f : expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] *= a_s[orow0 + ORS * r];
    const int jn = min(BK, k_end - k0);
    for (int j = 0; j < jn; ++j) {
      const float vd = Vs[j * D + od];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] = fmaf(Ps[(orow0 + ORS * r) * (BK + 1) + j], vd, acc[r]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int i = orow0 + ORS * r, s = q0 + i;
    if (s < S) {
      float l = l_s[i];
      if (l == 0.f) l = 1.f;             // a fully masked row emits zeros
      ob[s * q_stride + od] = from_f<T>(acc[r] / l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int Hkv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto* kern = flash_attention_kernel<T, D>;
  // Above 48 KB of shared memory needs an opt-in. It holds for the current
  // device only, so it is set on every launch (a cheap host call) rather
  // than cached once per process.
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, H, Hkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Sk, int H, int Hkv, int D, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Sk, H, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Sk, H, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Sk, H, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int aeg_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int Sk, int H,
                                   int Hkv, int D, int dtype, float scale,
                                   int causal, void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_d<float>(q, k, v, o, B, S, Sk, H, Hkv, D, scale, causal, st);
    case 1: return (int)launch_d<__nv_bfloat16>(q, k, v, o, B, S, Sk, H, Hkv, D, scale, causal, st);
    case 2: return (int)launch_d<__half>(q, k, v, o, B, S, Sk, H, Hkv, D, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
