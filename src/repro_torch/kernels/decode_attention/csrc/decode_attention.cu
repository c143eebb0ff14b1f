// One-token GQA decode attention over a KV cache for Hopper (sm_90a), CUDA
// C++: split-KV ("flash decoding") on the CUDA cores.
//
// Replaces no TPU kernel. The JAX package's decode attention is plain jnp
// (src/repro/models/attention.py, decode_attention), and the port's stock
// ops for it cast every cache row of every lane to fp32, permute copies of
// K and V and mask the scores with a `where` over every row. This kernel
// computes what those ops compute, for one new token per lane:
//   o[b, h*G+g] = sum_t softmax_t(q[b, h*G+g] . k[b, t, h] / sqrt(D)) v[b, t, h]
// over the lane's valid rows t < n_valid = min(pos[b] + 1, S) (in a sliding
// window's ring every row once pos >= S). A masked row's weight is exactly 0
// in the plain version's fp32 softmax, so skipping it gives the same sum.
//
// What bounds it. A (lane, kv head) pair reads 2 * n_valid * D elements of
// K and V once and does 2 * G * D multiply-adds a row for G query heads:
// for bf16 that is G / 2 FMA a byte (2 for mistral-nemo's G = 4), far below
// the ~295 operations a byte at which the H100's tensor cores, let alone
// its CUDA cores, would bound it. Device memory bounds it: mistral-nemo's
// 32 lanes x 8 kv heads at 1,400 valid rows of 4,096 read 183 MB a layer,
// 55 us at 3.35 TB/s. So the design reads each valid row once, in the
// cache's dtype, 16 bytes a load, keeps every score and probability in
// registers, and keeps enough bytes in flight to cover the latency.
//
// Layout: q and o (B, 1, H, D), H = Hkv * G, head h*G+g in kv group h. The
// cache is read in place: dense (B, S, Hkv, D), lane b's row t at
// (b * S + t); or a block pool (N, bs, Hkv, D) addressed through tables
// (lanes, W) int32, lane b's logical row t at (tables[b, t / bs] * bs +
// t % bs), S = W * bs. Every operand starts on a 16-byte boundary and rows
// are Hkv * D elements apart.
//
//   grid     (split, kv head, lane): fixed by the shapes, so a captured step
//            replays one graph. A block takes rows [split * split_len, +
//            split_len) of its lane, cut at n_valid; it reads n_valid from
//            the device `pos` and returns before any load when its split
//            starts past it.
//   lanes    128 threads. A row's D elements are LPR = D / EPL lanes of 16
//            bytes (EPL = 8 bf16/f16 or 4 fp32 elements), so a warp takes
//            RPW = 32 / LPR rows a step, and each of the block's SLOTS = 4 *
//            RPW row streams walks every SLOTS-th row. Each lane holds its
//            D-chunk of the group's G queries and of the G partial outputs
//            in fp32 registers: each
//            K and V row is loaded once for all G heads of its group.
//   loads    cp.async of 16 bytes into a ring of NST = 3 stages in shared
//            memory, U = 4 rows of K and of V a lane a stage: two stages
//            (32 KB a block) in flight while the third is computed. A lane
//            reads back only what it copied itself, so no barrier is needed
//            in the walk. Rows past the split's end load zeros and weigh 0.
//   scores   fp32 products of the inputs (exact for bf16/f16), summed in
//            fp32 along the lane's chunk, then across the row's LPR lanes by
//            xor shuffles (every lane ends with the same bits).
//   softmax  online, per row stream: the stage's max rescales the stream's
//            running sum and outputs once a stage. bf16/f16 work in the log2
//            domain (q pre-scaled by log2(e) / sqrt(D), p = 2^(s - m)), fp32
//            in the natural one (s divided by sqrt(D), p = e^(s - m)) as the
//            plain version does. p stays in fp32 (the plain version rounds its
//            normalised weights to the value dtype: p here is finer).
//   merge    the block's SLOTS streams combine through shared memory in slot
//            order into the split's (max, sum, unnormalised output), fp32,
//            written to scratch.
//   combine  a second small kernel, one block a (kv head, lane), merges the
//            lane's active splits in split order and rounds o = O / L once to
//            the output dtype. No atomics anywhere: the bits depend only on
//            the logical rows and split_len, never on the cache's layout, so
//            the dense and the paged cache give the same output bit for bit
//            when they hold the same rows and take the same split length.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::from_f;

constexpr int NT = 128;           // threads a block
constexpr int NW = NT / 32;       // warps a block
constexpr int U = 4;              // rows of K and V a lane copies a stage
constexpr int NST = 3;            // ring stages
constexpr int MAX_G = 8;          // query heads a kv head, at most
constexpr float kLog2e = 1.4426950408889634f;

// The softmax's exponential. fp32 caches work in the natural domain, as the
// plain version does (a score near 100 would otherwise move its weight by
// the rounding of s * log2(e), ~6e-6); 16-bit caches in the log2 domain, one
// ex2 a weight, far below their inputs' precision.
template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (sizeof(T) == 4) {
    return expf(x);
  } else {
    return exp2f(x);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes as EPL floats
__device__ __forceinline__ void to_floats(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void to_floats_bf16(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {           // element 2i is the low half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void to_floats_f16(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __half2 h2;
    *reinterpret_cast<uint32_t*>(&h2) = w[i];
    const float2 x = __half22float2(h2);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
template <typename T, int EPL>
__device__ __forceinline__ void load_floats(const uint4& r, float (&f)[EPL]) {
  if constexpr (sizeof(T) == 4) {
    to_floats(r, f);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    to_floats_bf16(r, f);
  } else {
    to_floats_f16(r, f);
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const int* __restrict__ tables,
                        float* __restrict__ part_o,
                        float2* __restrict__ part_ml, int S, int Hkv, int bs,
                        int W, int split_len, int n_splits, float scale) {
  constexpr int EPL = 16 / (int)sizeof(T);   // elements a 16-byte load
  constexpr int LPR = D / EPL;               // lanes a row
  constexpr int RPW = 32 / LPR;              // rows a warp step
  constexpr int SLOTS = NW * RPW;            // row streams a block
  constexpr int RPS = SLOTS * U;             // rows a stage
  static_assert(D % EPL == 0 && LPR >= 1 && LPR <= 32 && 32 % LPR == 0,
                "a row must be a power-of-two number of lanes of a warp");
  static_assert(SLOTS * G * D + 2 * SLOTS * G <= NST * U * 2 * NT * 4,
                "the merge reuses the ring");
  __shared__ __align__(16) uint4 ring[NST][U][2][NT];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_valid = min(pos[b] + 1, S);
  const int r0 = split * split_len;
  if (r0 >= n_valid) return;
  const int r1 = min(r0 + split_len, n_valid);

  const int tid = threadIdx.x, lane = tid % 32;
  const int slot = (tid / 32) * RPW + lane / LPR;
  const int c = lane % LPR;
  const long row_stride = (long)Hkv * D;
  const long col = (long)h * D + c * EPL;
  const int H = Hkv * G;

  float qf[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        q + ((long)b * H + (long)h * G + g) * D + c * EPL);
    load_floats<T, EPL>(raw, qf[g]);
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] *= scale;
    }
  }

  auto row_offset = [&](int t) -> long {
    if (tables == nullptr) return ((long)b * S + t) * row_stride + col;
    const long blk = tables[(long)b * W + t / bs];
    return (blk * bs + t % bs) * row_stride + col;
  };

  const int n_stages = (r1 - r0 + RPS - 1) / RPS;
  auto load_stage = [&](int i) {
    if (i < n_stages) {
      const int sb = i % NST;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = r0 + i * RPS + u * SLOTS + slot;
        const bool ok = t < r1;
        const long off = row_offset(ok ? t : r0);
        cp_async16(&ring[sb][u][0][tid], k + off, ok);
        cp_async16(&ring[sb][u][1][tid], v + off, ok);
      }
    }
    cp_async_commit();                    // empty past the end: uniform counts
  };

  float m[G], l[G], o[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[g][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) load_stage(i);
  for (int i = 0; i < n_stages; ++i) {
    load_stage(i + NST - 1);              // into the stage read at i - 1
    cp_async_wait<NST - 1>();             // stage i has landed
    const int sb = i % NST;
    float s[U][G];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      valid[u] = r0 + i * RPS + u * SLOTS + slot < r1;
      float kf[EPL];
      load_floats<T, EPL>(ring[sb][u][0][tid], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) a = fmaf(qf[g][e], kf[e], a);
        s[u][g] = a;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
      }
    }
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] /= scale;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (valid[u]) mx = fmaxf(mx, s[u][g]);
      // a stream with no valid row yet has m = -inf, l = 0 and o = 0
      const float alpha = m[g] == -CUDART_INF_F ? 0.f : softmax_exp<T>(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      load_floats<T, EPL>(ring[sb][u][1][tid], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = valid[u] ? softmax_exp<T>(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) o[g][e] = fmaf(p, vf[e], o[g][e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring becomes the merge buffer

  float* acc_s = reinterpret_cast<float*>(&ring[0][0][0][0]);  // [SLOTS][G][D]
  float* m_s = acc_s + SLOTS * G * D;                          // [SLOTS][G]
  float* l_s = m_s + SLOTS * G;                                // [SLOTS][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc_s[(slot * G + g) * D + c * EPL + e] = o[g][e];
    if (c == 0) {
      m_s[slot * G + g] = m[g];
      l_s[slot * G + g] = l[g];
    }
  }
  __syncthreads();
  const long part = ((long)b * Hkv + h) * n_splits + split;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = -CUDART_INF_F;
    for (int sl = 0; sl < SLOTS; ++sl) mx = fmaxf(mx, m_s[sl * G + g]);
    float acc = 0.f, sum = 0.f;
    for (int sl = 0; sl < SLOTS; ++sl) {
      const float ms = m_s[sl * G + g];
      const float w = ms == -CUDART_INF_F ? 0.f : softmax_exp<T>(ms - mx);
      acc = fmaf(w, acc_s[(sl * G + g) * D + d], acc);
      sum = fmaf(w, l_s[sl * G + g], sum);
    }
    part_o[(part * G + g) * D + d] = acc;
    if (d == 0) part_ml[part * G + g] = make_float2(mx, sum);
  }
}

// One block a (kv head, lane): the lane's active splits merged in split
// order, o = O / L rounded once to T.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
decode_attention_combine(const float* __restrict__ part_o,
                         const float2* __restrict__ part_ml,
                         const int* __restrict__ pos, T* __restrict__ out,
                         int S, int Hkv, int split_len, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_valid = min(pos[b] + 1, S);
  const int n_act = (n_valid + split_len - 1) / split_len;
  const long part0 = ((long)b * Hkv + h) * n_splits;
  const int H = Hkv * G;
  for (int idx = threadIdx.x; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = -CUDART_INF_F;
    for (int sp = 0; sp < n_act; ++sp)
      mx = fmaxf(mx, part_ml[(part0 + sp) * G + g].x);
    float acc = 0.f, sum = 0.f;
    for (int sp = 0; sp < n_act; ++sp) {
      const float2 ml = part_ml[(part0 + sp) * G + g];
      const float w = softmax_exp<T>(ml.x - mx);
      acc = fmaf(w, part_o[((part0 + sp) * G + g) * D + d], acc);
      sum = fmaf(w, ml.y, sum);
    }
    out[((long)b * H + (long)h * G + g) * D + d] = from_f<T>(acc / sum);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* pos, const int* tables, float* part_o,
                   float2* part_ml, void* o, int B, int S, int Hkv, int bs,
                   int W, int split_len, int n_splits, cudaStream_t st) {
  // fp32: the divisor sqrt(D), the plain version's fp32 sqrt(D); 16-bit:
  // the factor log2(e) / sqrt(D) folded into q
  const float scale = sizeof(T) == 4 ? (float)sqrt((double)D)
                                     : kLog2e / sqrtf((float)D);
  decode_attention_kernel<T, D, G><<<dim3(n_splits, Hkv, B), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, tables, part_o, part_ml, S, Hkv, bs, W,
      split_len, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_combine<T, D, G><<<dim3(Hkv, B), NT, 0, st>>>(
      part_o, part_ml, pos, static_cast<T*>(o), S, Hkv, split_len, n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* k, const void* v,
                     const int* pos, const int* tables, float* part_o,
                     float2* part_ml, void* o, int B, int S, int Hkv, int bs,
                     int W, int split_len, int n_splits, cudaStream_t st) {
#define AEG_DA_G(g)                                                         \
  case g:                                                                   \
    return launch<T, D, g>(q, k, v, pos, tables, part_o, part_ml, o, B, S,  \
                           Hkv, bs, W, split_len, n_splits, st);
  switch (G) {
    AEG_DA_G(1) AEG_DA_G(2) AEG_DA_G(3) AEG_DA_G(4)
    AEG_DA_G(5) AEG_DA_G(6) AEG_DA_G(7) AEG_DA_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef AEG_DA_G
}

template <typename T>
cudaError_t launch_d(int D, int G, const void* q, const void* k,
                     const void* v, const int* pos, const int* tables,
                     float* part_o, float2* part_ml, void* o, int B, int S,
                     int Hkv, int bs, int W, int split_len, int n_splits,
                     cudaStream_t st) {
  switch (D) {
    case 16: return launch_g<T, 16>(G, q, k, v, pos, tables, part_o, part_ml,
                                    o, B, S, Hkv, bs, W, split_len, n_splits, st);
    case 64: return launch_g<T, 64>(G, q, k, v, pos, tables, part_o, part_ml,
                                    o, B, S, Hkv, bs, W, split_len, n_splits, st);
    case 128: return launch_g<T, 128>(G, q, k, v, pos, tables, part_o, part_ml,
                                      o, B, S, Hkv, bs, W, split_len, n_splits, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o (B, 1, Hkv * G, D); k, v dense (B, S, Hkv, D) with tables null and
// bs = S, or a pool (N, bs, Hkv, D) through tables (>= B lanes, W blocks
// each; S = W * bs); pos (B,) int32. part_o holds B * Hkv * n_splits * G * D
// floats and part_ml B * Hkv * n_splits * G float2s. dtype: 0 = float32,
// 1 = bfloat16, 2 = float16; D in {16, 64, 128}, G in 1..8; every operand on
// a 16-byte boundary. Returns a cudaError_t.
extern "C" int aeg_decode_attention(const void* q, const void* k, const void* v,
                                    const void* pos, const void* tables,
                                    void* part_o, void* part_ml, void* o, int B,
                                    int S, int Hkv, int G, int D, int bs, int W,
                                    int split_len, int n_splits, int dtype,
                                    void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || G > MAX_G || bs <= 0 ||
      W <= 0 || split_len <= 0 || n_splits <= 0 ||
      (long long)split_len * n_splits < S || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(tables);
  float* po = static_cast<float*>(part_o);
  float2* pm = static_cast<float2*>(part_ml);
  switch (dtype) {
    case 0: return (int)launch_d<float>(D, G, q, k, v, p, t, po, pm, o, B, S,
                                        Hkv, bs, W, split_len, n_splits, st);
    case 1: return (int)launch_d<__nv_bfloat16>(D, G, q, k, v, p, t, po, pm, o,
                                                B, S, Hkv, bs, W, split_len,
                                                n_splits, st);
    case 2: return (int)launch_d<__half>(D, G, q, k, v, p, t, po, pm, o, B, S,
                                         Hkv, bs, W, split_len, n_splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
