// Blocked causal/GQA flash attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function flash_attention_bhsd (pl.pallas_call at line 86), and computes
// what it computes: softmax(q k^T * scale) v with an online softmax whose
// running max m, sum l and accumulator live in fp32; GQA (kv head =
// q head / group); causal masking top-left aligned (kpos <= qpos); masked
// scores -1e30 that contribute exactly nothing; rows with l == 0 emit
// zeros; output in q's dtype. Like the Pallas kernel it rounds the
// probabilities to the value dtype before the PV product. Unlike it, it
// masks a ragged key tail itself, causal or not, so no shape needs the
// plain version.
//
// Layout: the public (B, S, H, D) layout is read in place (row stride H*D
// for q/o, Hkv*D for k/v); no transpose is materialised.
//
// What bounds it. At the dense slice's shape (B=1, S=512, H=12, Hkv=2,
// D=128, bf16, causal) one launch must move q, k, v and o once: 3.67 MB,
// 1.10 us at 3.35 TB/s. It does 4*D*H*S(S+1)/2 = 0.807 GFLOP, 0.82 us at the
// 989 TFLOP/s bf16 tensor-core rate. So device memory bounds it, and both
// designs keep every score and probability on chip: q and each k/v tile are
// staged once and no score goes back to device memory. At this size the
// launch, the first loads and the causal walk of the last q tile (512 keys
// for its last row) cost far more than either bound; what the bf16/f16
// design below does about them is to keep the walk on the tensor cores and
// split it over two warps.
//
// bf16 and f16: tensor cores, FlashAttention-2 style on mma.sync.
//   grid      one block per (b*H + h, q tile of 64 rows); q tiles run last
//             row first, so the longest causal walks start first. 8 warps:
//             4 row warps of 16 query rows, times 2 key splits. At step t
//             split ks takes keys [128 t + 64 ks, + 64), so the last tile's
//             walk is 4 steps a warp, not 8. Keys are never split across
//             blocks, and split 1 hands its fp32 (m, l, O) to split 0
//             through shared memory, merged in one fixed order: outputs are
//             bit-identical from run to run. (4 warps without a key split,
//             and 2 warps of 32 rows, were slower at both served shapes.)
//   staging   16-byte cp.async into rows padded by 16 bytes, so the eight
//             rows an ldmatrix phase reads fall in eight distinct bank
//             groups; ragged rows load zeros (source size 0) and are masked.
//             The Q tile and each split's first K tile are waited for first.
//             Each split owns slots of a two-stage ring: at its step t it
//             holds K of t and t+1 and V of t, and loads K of t+2 and V of
//             t+1. A split waits only for its own loads, at a named barrier
//             of its own 128 threads, so the splits drift apart and one's
//             exponentials run beside the other's mma.sync.
//   S = QK^T  Q is held in registers as ldmatrix A fragments for the whole
//             walk (D/16 k-steps), K comes as B fragments by ldmatrix,
//             m16n8k16 into fp32. Scores stay unscaled; the causal mask is
//             applied only on tiles that cross the warp's diagonal, the
//             key-tail mask only where a tile passes Sk. The next tile's
//             scores are computed in the same basic block as this tile's
//             O += P V.
//   softmax   in registers: a row lives on the four lanes of a quad; the
//             max is taken by xor-shuffles 1 and 2, p = 2^(s * scale * log2 e
//             - m) by one FFMA and ex2.approx.ftz, and a score equal to
//             -1e30 gives p = 0 (a row whose running max is still -1e30
//             would otherwise give exp(0) = 1). Each lane keeps its partial
//             l; the quad sums it once, at the end.
//   O += P V  P is rounded to bf16/f16 in registers: two n8 accumulator
//             fragments of S make one m16k16 A fragment, so P never touches
//             shared memory; V comes as B fragments by ldmatrix.trans. O is
//             rescaled by alpha in registers.
//   epilogue  o = acc * (1 / l) (l == 0 -> 1), converted, staged through the
//             warp's own Q rows in shared memory and stored 16 bytes a lane.
//   limits    a warp runs its instructions in order, so its exponentials
//             and its mma.sync overlap only with another warp's; every
//             ldmatrix feeds two m16n8k16. wgmma (asynchronous, B read from shared memory by a
//             warpgroup), TMA and warp specialisation are the next design.
//
// fp32: the CUDA-core kernel of the first port, unchanged. fp32 attention is
// held to 2e-6, which TF32 (10 mantissa bits) cannot meet, and only the
// two-layer fp32 parity programs run it, no served path. One block per
// (q tile of 32 rows, b*H + h) walks the k/v tiles of 64 keys in shared
// memory; thread t owns key column t % 64 of the scores and head-dim column
// t % D of the output; one warp per 8 rows runs the softmax.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;
using aeg::to_f;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- fp32
namespace simt {

constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int NT = 128;           // threads per block (4 warps)

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

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int S, int Sk, int H, int Hkv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<D>() * sizeof(float);
  auto* kern = flash_attention_kernel<float, D>;
  // Above 48 KB of shared memory needs an opt-in. It holds for the current
  // device only, so it is set on every launch (a cheap host call) rather
  // than cached once per process.
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(q, k, v, o, S, Sk, H, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace simt

// ------------------------------------------------------- bf16 and f16
namespace tc {

constexpr int BK = 64;            // keys per k/v tile of a warp
constexpr int RW = 4;             // row warps of 16 query rows a block
constexpr int KS = 2;             // key splits: warps sharing a step's keys
constexpr float kLog2e = 1.4426950408889634f;

// Two fp32 values -> one register of two 16-bit values, the first in the
// low half (the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(__half*, float a, float b) {
  __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// c += a b for one m16n8k16 tile: a row-major 16x16, b column-major 16x8,
// c 16x8 in fp32.
__device__ __forceinline__ void mma16816(__nv_bfloat16*, float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16816(__half*, float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 matrices of 16-bit values; lanes 8i..8i+7 give the row
// addresses of matrix i, and register i of lane l holds row l/4, columns
// 2(l%4) and 2(l%4)+1 of matrix i (with .trans: rows 2(l%4), 2(l%4)+1 of
// column l/4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
// (source size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {  // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Barrier `id` (1..15; 0 is __syncthreads) among `n` threads, whole warps.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Stage rows [row0, row0 + ROWS) of a (positions, stride) operand into a
// shared tile with row stride LD; positions at or past `limit` load zeros.
// Thread t copies 16-byte chunk t % CPR of rows t / CPR, + NT / CPR, ...
template <typename T, int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long stride,
                                          int row0, int limit, int tid) {
  constexpr int LD = D + 8, CPR = D / 8;          // 16-byte chunks a row
  constexpr int RPP = NT / CPR;                   // rows a pass
  static_assert(NT % CPR == 0, "a pass covers whole rows");
  const int r = tid / CPR, c = tid % CPR;
  const T* g = src + (long)(row0 + r) * stride + c * 8;
  T* d = dst + r * LD + c * 8;
#pragma unroll
  for (int i = 0; i < (ROWS + RPP - 1) / RPP; ++i) {
    if (ROWS % RPP != 0 && r + i * RPP >= ROWS) break;
    const bool ok = row0 + r + i * RPP < limit;
    cp_async16(d + i * RPP * LD, ok ? g + (long)i * RPP * stride : src, ok);
  }
}

// 2^x on the special-function unit; an output below 2^-126 flushes to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One warp's share of attention: 16 query rows, with Q held as A fragments
// and the running m (scaled by log2 e), this lane's part of l, and O.
template <typename T, int D>
struct Rows {
  static constexpr int KD = D / 16;      // k-steps of S = Q K^T
  static constexpr int NB = BK / 8;      // n8 fragments of S
  static constexpr int ND = D / 8;       // n8 fragments of O
  static constexpr int LD = D + 8;       // padded smem row stride, elements
  uint32_t qf[KD][4];
  float acc[ND][4];
  float m_lo, m_hi, l_lo, l_hi;          // rows g and g + 8 of the 16

  // s = Q K^T (unscaled) for the 64 keys of a K tile in shared memory
  __device__ __forceinline__ void scores(float (&s)[NB][4], const T* Kt,
                                         int lane) const {
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t (&qa)[4] = qf[kk];
#pragma unroll
      for (int j2 = 0; j2 < NB / 2; ++j2) {
        uint32_t kf[4];
        ldsm_x4(kf, Kt + (16 * j2 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        16 * kk + ((lane >> 3) & 1) * 8);
        mma16816(static_cast<T*>(nullptr), s[2 * j2], qa, kf[0], kf[1]);
        mma16816(static_cast<T*>(nullptr), s[2 * j2 + 1], qa, kf[2], kf[3]);
      }
    }
  }

  // The online softmax of one tile's scores (masked ones are kNegInf):
  // rescale O and l, return p rounded to T as A fragments of P V (S
  // fragments 2i and 2i+1 make k-step i). A row lives on a lane quad.
  __device__ __forceinline__ void softmax(const float (&s)[NB][4],
                                          uint32_t (&pf)[NB / 2][4],
                                          float scale_log2) {
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // scale_log2 > 0, so the max of the scaled scores is the scaled max
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float alpha_lo = exp2_ftz(m_lo - mn_lo);
    const float alpha_hi = exp2_ftz(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      // a masked score contributes exactly nothing (a row whose running
      // max is still kNegInf would otherwise get exp(0) = 1)
      const float p0 = s[j][0] == kNegInf ? 0.f : exp2_ftz(fmaf(s[j][0], scale_log2, -mn_lo));
      const float p1 = s[j][1] == kNegInf ? 0.f : exp2_ftz(fmaf(s[j][1], scale_log2, -mn_lo));
      const float p2 = s[j][2] == kNegInf ? 0.f : exp2_ftz(fmaf(s[j][2], scale_log2, -mn_hi));
      const float p3 = s[j][3] == kNegInf ? 0.f : exp2_ftz(fmaf(s[j][3], scale_log2, -mn_hi));
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[j / 2][(j & 1) * 2] = pack2(static_cast<T*>(nullptr), p0, p1);
      pf[j / 2][(j & 1) * 2 + 1] = pack2(static_cast<T*>(nullptr), p2, p3);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha_lo;
      acc[j][1] *= alpha_lo;
      acc[j][2] *= alpha_hi;
      acc[j][3] *= alpha_hi;
    }
  }

  // O += P V for the 64 keys of a V tile in shared memory
  __device__ __forceinline__ void pv(const uint32_t (&pf)[NB / 2][4],
                                     const T* Vt, int lane) {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, Vt + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              16 * j2 + (lane >> 4) * 8);
        mma16816(static_cast<T*>(nullptr), acc[2 * j2], pf[i], vf[0], vf[1]);
        mma16816(static_cast<T*>(nullptr), acc[2 * j2 + 1], pf[i], vf[2], vf[3]);
      }
    }
  }

  // One step of the walk: softmax of this tile's scores, the next tile's
  // scores (when NEXT), and O += P V, in one basic block, so that ptxas
  // can interleave the two products' ldmatrix and mma.sync.
  template <bool NEXT>
  __device__ __forceinline__ void step(float (&s)[NB][4], const T* Kn,
                                       const T* Vt, float scale_log2,
                                       int lane) {
    uint32_t pf[NB / 2][4];
    softmax(s, pf, scale_log2);
    if (NEXT) scores(s, Kn, lane);
    pv(pf, Vt, lane);
  }
};

// Keys at or past Sk, and (causal) past the query's own position, get
// kNegInf. Only tiles that cross Sk or the warp's diagonal call it.
template <int NB>
__device__ __forceinline__ void mask_scores(float (&s)[NB][4], int k0, int Sk,
                                            int causal, int row_lo,
                                            int row_hi, int col) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + 8 * j + col + (e & 1);
      const int qpos = e < 2 ? row_lo : row_hi;
      if (kpos >= Sk || (causal && kpos > qpos)) s[j][e] = kNegInf;
    }
  }
}

// RW warps of 16 query rows each, times KS warps that split each step's
// KS * BK keys among them.
template <typename T, int D>
constexpr size_t smem_bytes() {
  // Q tile, then a two-stage ring of K steps and one of V steps; after the
  // walk the ring holds the fp32 partials of key splits 1..KS-1
  constexpr size_t ring = (size_t)4 * KS * BK * (D + 8) * sizeof(T);
  constexpr size_t parts = (size_t)(KS - 1) * RW * (D * 16 + 4 * 32) * 4;
  static_assert(parts <= ring, "the partials must fit in the k/v ring");
  return (size_t)16 * RW * (D + 8) * sizeof(T) + ring;
}

template <typename T, int D>
__global__ void __launch_bounds__(RW * KS * 32, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int S, int Sk, int H, int Hkv, float scale_log2,
                       int causal) {
  using W = Rows<T, D>;
  constexpr int NT = RW * KS * 32;
  constexpr int BQ = 16 * RW;            // query rows per block
  constexpr int BKS = BK * KS;           // keys staged per step
  constexpr int LD = W::LD;
  constexpr int NB = W::NB;
  constexpr int ND = W::ND;
  constexpr int CPR = D / 8;             // 16-byte chunks a row
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                   // [2][BKS][LD]
  T* Vs = Ks + 2 * BKS * LD;              // [2][BKS][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % RW;              // this warp's 16 rows ...
  const int ks = warp / RW;              // ... and its share of each step
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // last rows first
  const long q_stride = (long)H * D;     // between consecutive positions
  const long k_stride = (long)Hkv * D;
  const T* qb = q + (long)b * S * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * k_stride + (long)hk * D;
  const T* vb = v + (long)b * Sk * k_stride + (long)hk * D;
  T* ob = o + (long)b * S * q_stride + (long)h * D;

  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;

  // Key split ks walks keys [t * BKS + ks * BK, + BK) at its step t, in its
  // own slots of a two-stage ring: at step t it holds K of steps t and t+1
  // and V of step t, and loads K of t+2 and V of t+1. The splits share no
  // barrier until the merge, so one split's exponentials can run beside
  // the other's mma.sync.
  constexpr int NTG = RW * 32;            // threads of a split
  const int gt = tid - ks * NTG;
  const int kbase = ks * BK;
  const int n_steps = k_end > kbase ? (k_end - kbase + BKS - 1) / BKS : 0;
  T* Kg = Ks + kbase * LD;                // stage st at Kg + st * BKS * LD
  T* Vg = Vs + kbase * LD;

  load_rows<T, D, BQ, NT>(Qs, qb, q_stride, q0, S, tid);
  if (n_steps > 0) load_rows<T, D, BK, NTG>(Kg, kb, k_stride, kbase, Sk, gt);
  cp_async_commit();                      // Q and the first K ...
  if (n_steps > 0) load_rows<T, D, BK, NTG>(Vg, vb, k_stride, kbase, Sk, gt);
  if (n_steps > 1)
    load_rows<T, D, BK, NTG>(Kg + BKS * LD, kb, k_stride, BKS + kbase, Sk, gt);
  cp_async_commit();                      // ... before the first V, next K
  cp_async_wait_one();
  __syncthreads();

  W w;
  const int wrow = 16 * rg;
#pragma unroll
  for (int kk = 0; kk < W::KD; ++kk)
    ldsm_x4(w.qf[kk], Qs + (wrow + (lane & 15)) * LD + 16 * kk + (lane >> 4) * 8);
#pragma unroll
  for (int j = 0; j < ND; ++j) w.acc[j][0] = w.acc[j][1] = w.acc[j][2] = w.acc[j][3] = 0.f;
  w.m_lo = w.m_hi = kNegInf;
  w.l_lo = w.l_hi = 0.f;

  // this lane's rows (g and g + 8 of the warp's 16) and first column
  const int row_lo = q0 + wrow + (lane >> 2), row_hi = row_lo + 8;
  const int col = 2 * (lane & 3);
  float s[NB][4];
  if (n_steps > 0) w.scores(s, Kg, lane);

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait_all();                 // K of t+1 and V of t have landed
    named_barrier(1 + ks, NTG);          // and K of t, V of t-1 are consumed
    const int k0 = t * BKS + kbase;      // this step's 64 keys
    if (t + 2 < n_steps)
      load_rows<T, D, BK, NTG>(Kg + (t & 1) * BKS * LD, kb, k_stride, k0 + 2 * BKS, Sk, gt);
    if (t + 1 < n_steps)
      load_rows<T, D, BK, NTG>(Vg + ((t + 1) & 1) * BKS * LD, vb, k_stride, k0 + BKS, Sk, gt);
    cp_async_commit();
    // mask only where the keys cross Sk or the warp's diagonal
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + wrow))
      mask_scores(s, k0, Sk, causal, row_lo, row_hi, col);
    const T* Kn = Kg + ((t + 1) & 1) * BKS * LD;
    const T* Vt = Vg + (t & 1) * BKS * LD;
    if (t + 1 < n_steps)
      w.template step<true>(s, Kn, Vt, scale_log2, lane);
    else
      w.template step<false>(s, Kn, Vt, scale_log2, lane);
  }

  // Splits 1..KS-1 hand their fp32 (m, l, acc) to split 0 through the
  // ring, in fragment order (lane-contiguous, free of bank conflicts);
  // split 0 merges them in that fixed order.
  constexpr int PART = RW * (D * 16 + 4 * 32);        // floats a split
  float* part = reinterpret_cast<float*>(Ks);
  cp_async_wait_all();
  __syncthreads();                     // every warp is done with the ring
  if (ks > 0) {
    float* p = part + (ks - 1) * PART + rg * (D * 16 + 4 * 32);
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[(j * 4 + e) * 32 + lane] = w.acc[j][e];
    p += D * 16;
    p[lane] = w.m_lo;
    p[32 + lane] = w.m_hi;
    p[64 + lane] = w.l_lo;
    p[96 + lane] = w.l_hi;
  }
  __syncthreads();
  if (ks > 0) return;                  // no block barrier follows
#pragma unroll
  for (int s2 = 1; s2 < KS; ++s2) {
    const float* p = part + (s2 - 1) * PART + rg * (D * 16 + 4 * 32);
    const float* st = p + D * 16;
    const float m2_lo = st[lane], m2_hi = st[32 + lane];
    const float mn_lo = fmaxf(w.m_lo, m2_lo), mn_hi = fmaxf(w.m_hi, m2_hi);
    const float a_lo = exp2_ftz(w.m_lo - mn_lo), b_lo = exp2_ftz(m2_lo - mn_lo);
    const float a_hi = exp2_ftz(w.m_hi - mn_hi), b_hi = exp2_ftz(m2_hi - mn_hi);
    w.l_lo = w.l_lo * a_lo + st[64 + lane] * b_lo;
    w.l_hi = w.l_hi * a_hi + st[96 + lane] * b_hi;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      w.acc[j][0] = w.acc[j][0] * a_lo + p[(j * 4 + 0) * 32 + lane] * b_lo;
      w.acc[j][1] = w.acc[j][1] * a_lo + p[(j * 4 + 1) * 32 + lane] * b_lo;
      w.acc[j][2] = w.acc[j][2] * a_hi + p[(j * 4 + 2) * 32 + lane] * b_hi;
      w.acc[j][3] = w.acc[j][3] * a_hi + p[(j * 4 + 3) * 32 + lane] * b_hi;
    }
    w.m_lo = mn_lo;
    w.m_hi = mn_hi;
  }

  // the quad's row sums, then o = acc / l through the warp's own Q rows
  float l_lo = w.l_lo, l_hi = w.l_hi;
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  // a fully masked row emits zeros
  const float inv_lo = 1.f / (l_lo == 0.f ? 1.f : l_lo);
  const float inv_hi = 1.f / (l_hi == 0.f ? 1.f : l_hi);
  T* Os = Qs + wrow * LD;                 // only this row group read these
  const int r = lane >> 2;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(Os + r * LD + 8 * j + col) = pack2(
        static_cast<T*>(nullptr), w.acc[j][0] * inv_lo, w.acc[j][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(Os + (r + 8) * LD + 8 * j + col) = pack2(
        static_cast<T*>(nullptr), w.acc[j][2] * inv_hi, w.acc[j][3] * inv_hi);
  }
  __syncwarp();
#pragma unroll
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int i = e / CPR, c = e % CPR, s = q0 + wrow + i;
    if (s < S)
      *reinterpret_cast<uint4*>(ob + s * q_stride + c * 8) =
          *reinterpret_cast<const uint4*>(Os + i * LD + c * 8);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int Hkv, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  auto* kern = flash_attention_kernel<T, D>;
  // the shared-memory opt-in above 48 KB, as in simt::launch
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + 16 * RW - 1) / (16 * RW));
  kern<<<grid, RW * KS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, H, Hkv,
      scale * kLog2e, causal);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Sk, int H, int Hkv, int dtype,
                     float scale, int causal, cudaStream_t st) {
  switch (dtype) {
    case 0:
      return simt::launch<D>(static_cast<const float*>(q),
                             static_cast<const float*>(k),
                             static_cast<const float*>(v),
                             static_cast<float*>(o), B, S, Sk, H, Hkv, scale,
                             causal, st);
    case 1:
      return tc::launch<__nv_bfloat16, D>(q, k, v, o, B, S, Sk, H, Hkv, scale,
                                          causal, st);
    case 2:
      return tc::launch<__half, D>(q, k, v, o, B, S, Sk, H, Hkv, scale,
                                   causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; bf16/f16 operands must
// start on 16-byte boundaries. Returns a cudaError_t.
extern "C" int aeg_flash_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int S, int Sk, int H,
                                   int Hkv, int D, int dtype, float scale,
                                   int causal, void* stream) {
  if (B <= 0 || S <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch_d<16>(q, k, v, o, B, S, Sk, H, Hkv, dtype, scale, causal, st);
    case 64: return (int)launch_d<64>(q, k, v, o, B, S, Sk, H, Hkv, dtype, scale, causal, st);
    case 128: return (int)launch_d<128>(q, k, v, o, B, S, Sk, H, Hkv, dtype, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
