// RWKV-6 WKV recurrence (data-dependent decay) for Hopper (sm_90a), CUDA C++:
// a chunked scan whose products run on the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py, function
// wkv6_bhtk (pl.pallas_call at line 76), and computes what it computes:
// from a zero (K, K) state S per (b, h), for t = 0 .. T-1,
//   y[t,o] = sum_i r[t,i] * (S[i,o] + u[i] k[t,i] v[t,o])
//   S[i,o] = exp(lw[t,i]) * S[i,o] + k[t,i] v[t,o]
// with fp32 math and y in r's dtype, in the chunked form of the TPU kernel
// (kernel.py:22-62). Any T and any H: a ragged tail is masked, never padded.
//
// Layout: r, k, v, lw, y (B, T, H, K), contiguous and read in place, each
// starting on a 16-byte boundary (the wrapper copies a view that does not);
// u (H, K) fp32. Scratch: B*H*NC*(K*K + K) floats from the wrapper
// (aeg_wkv6_scratch_floats), NC = ceil(T / 64) chunks.
//
// The chunked form, for one (b, h) and one chunk of C = 64 steps, with p the
// inclusive cumsum of lw over the chunk and pprev[t] = p[t-1] (0 at t = 0):
//   att[t,j] = sum_i r[t,i] k[j,i] exp(pprev[t,i] - p[j,i])      (j < t)
//   y        = att v + (sum_i r u k)[t] v[t] + (r * exp(pprev)) S
//   S'       = exp(p[C-1]) * S + (k * exp(p[C-1] - p))^T v
// lw <= 0, so p falls along the chunk and every exponent written here is
// <= 0: no exponential can overflow, at any decay. In particular
// exp(pprev[t] - p[j]) is never split into exp(pprev[t]) * exp(-p[j])
// (at lw = -80 the second factor is exp(+5000)).
//
// Three kernels, one wrapper call. The serial dependency comes once a chunk:
//  1. states (grid NC x H x B): chunk c's local state U_c = (k * exp(p_last
//     - p))^T v and its decay d_c = exp(p_last), into the scratch.
//  2. carry (only when NC > max_inblock, 11 from the wrapper; grid
//     K*K/1024 x H x B): per head, one thread per 4 entries of S walks the
//     chunks in order, S_{c+1} = d_c * S_c + U_c, and replaces U_c by S_c,
//     the state entering chunk c, in place.
//  3. output (grid NC x H x B): chunk c's y. Up to max_inblock chunks each
//     block builds its entering state itself from U_0 .. U_{c-1} by the
//     same recurrence in the same order (the same bits as the carry
//     kernel); above, it reads S_c. The in-block build costs O(NC^2) in
//     all, the carry kernel a third launch.
// So a call is two kernel launches, three above 11 chunks (T > 704). No
// block waits on another inside a launch, and no kernel uses atomics: two
// calls give the same bits. The states kernel also writes the last chunk's
// U, which nothing reads: it keeps both grids at NC x H x B blocks.
//
// Inside a chunk. Four sub-chunks of 16 steps. For a pair of sub-chunks
// a > b, att factors through b's last step m:
//   exp(pprev[t] - p[j]) = exp(pprev[t] - p[m]) * exp(p[m] - p[j]),
// both exponents <= 0 (t - 1 >= m >= j), so the 16 x 16 block is the
// product (r * exp(pprev - p[m])) (k * exp(p[m] - p))^T over K. A factor
// that underflows to 0 stands for an exact value smaller still (below
// 1e-38 of one term), which no tolerance can see. The four diagonal blocks
// are exact on the CUDA cores, one exponential per (t, j, i) with j < t
// (none for j = t - 1, whose factor is exp(0) = 1), in 2 x 2 tiles of pairs
// so that each row read from shared memory serves two pairs. p is kept in
// log2 units (times log2 e), so each exponential is one ex2.approx.ftz on
// the MUFU (relative error about 2^-22).
//
// Tensor cores. The off-diagonal att blocks, att v, (r * exp(pprev)) S and
// (k * exp(p_last - p))^T v are mma.sync.aligned.m16n8k8 with TF32
// operands and fp32 sums. TF32 keeps 10 mantissa bits, which the fp32 gate
// of 5e-4 would not survive (in a numpy emulation of this scan, single
// TF32 products miss it), so each operand x is split into hi (x's top 10
// mantissa bits) and lo = x - hi (exact) cut to its own top 10, and a
// product is hi*hi + (lo*hi + hi*lo) (3xTF32: what it drops is about
// 3 x 2^-20 of a product). The masks are two LOP3; the mma of one pass
// over a warp's n8 tiles are independent, so none waits on the one before.
// Operand factors with exponentials are formed in registers as fragments
// are loaded. fp32, bf16 and f16 load into fp32 and share this one path.
//
// K. The instances are K = 8, 16, 32 and 64, all with C = 64 and
// sub-chunks of 16 (the steps are the mma's m and k dimensions; K is its n
// and the k of the att blocks). At K = 8 the states kernel's product has
// M = K = 8 rows: its A fragment's rows 8..15 are zero.
//
// Shared memory: tiles [t][i] in fp32, rows padded so that every fragment
// load is free of bank conflicts: a row stride of 4 (mod 8) words where
// lanes read (row = lane / 4, column = lane % 4) (A fragments, and B
// fragments of a transposed operand), of 8 or 24 (mod 32) where they read
// (row = lane % 4, column = lane / 4) (B fragments of v and S, the states
// kernel's A). fp32 tiles arrive by 16-byte cp.async straight into their
// padded rows, in groups each waited for just before its first use (lw for
// the cumsum, then r and k, then v); bf16 and f16 into a packed staging
// area, then widened. A src-size of 0 past T loads r = k = v = lw = 0:
// identity steps (exp(0) = 1, no k v^T) that store nothing. 108,304 bytes
// (output) and 56,320 bytes (states; 80,896 with 16-bit staging) at K = 64:
// two blocks of 8 warps an SM.
//
// Work at K = 64, a chunk: 28,672 exponentials in the diagonal blocks,
// 12,288 for the off-diagonal factors, 8,192 for r * exp(pprev) (the two
// warps of a sub-chunk each form its 16 rows), 4,096 + 64 in the states
// kernel, whose warps split the steps so that each factor is formed once;
// 2,304 m16n8k8 (768 in the states kernel, 1,536 in the output kernel, a
// third of a 3xTF32 product each): 589,824 at the slice's shape.
//
// What bounds it. At the rwkv6-1.6B slice's shape (B=1, T=512, H=32, K=64,
// fp32) a call must read r, k, v, lw (4 x 4,194,304 bytes) and u (8,192)
// and write y (4,194,304): 20,979,712 bytes, 6.26 us at 3.35 TB/s. Its
// per-token operations (5 K^2 T H + 4 K T H = 339.7 M) take 5.07 us at the
// 67 TFLOP/s fp32 rate. The plan moves more: the states kernel reads k, v
// and lw (12,582,912 bytes) and writes U and d (4,259,840); the output
// kernel reads r, k, v, lw again (k, v, lw mostly from the 50 MB L2), u, 28
// of the 32 x 8 U_c and d_c a head (14,909,440 bytes, from L2) and writes
// y: 52,731,904 bytes in all, 21.0 MB of it to or from device memory at
// the least. Each kernel is one wave of blocks that load, compute and
// store in turn, so a block's load, its dependent phases and its stores
// add up; see PERF.md for the measured split.
//
// What it does about the limits of the per-token kernel it replaces:
//  - the 512-step dependent chain: a block's steps are matrix products
//    and the only serial walk is the state's, one step a chunk (in-block
//    build or the carry kernel);
//  - the shuffle tree each step: sums over i run inside mma.sync; the
//    bonus sum is one 4-lane shuffle pair a row per chunk;
//  - the nearly empty card (128 blocks): both main kernels have NC x H x B
//    blocks, 256 at the slice's shape, and every block is independent.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "../../common/csrc/common.cuh"

namespace {

using aeg::to_f;

constexpr int C = 64;              // steps a chunk
constexpr int SUB = 16;            // steps a sub-chunk
constexpr int NSUB = C / SUB;
constexpr int NT = 256;            // threads a block: 8 warps
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;
// the diagonal blocks: a thread pair for each of a sub-chunk's 28 2 x 2
// tiles of pairs and a thread for each of its 8 lone pairs
static_assert(NT == NSUB * (2 * 28 + 8), "diagonal threads");

template <int K>
struct Geo {
  static constexpr int S4 = K + 4;                    // 4 (mod 8)
  static constexpr int S8 = K == 8 ? K + 16 : K + 8;  // 8 or 24 (mod 32)
  static constexpr int SA = C + 4;                    // att rows
  static constexpr int NPART = NT / K;     // threads summing one column
  static constexpr int PROWS = C / NPART;  // rows of each
  static constexpr int NTILE = K / 8;      // n8 tiles over K
  static constexpr int MT = K >= 16 ? K / 16 : 1;     // m16 tiles over K
  static_assert(S4 % 32 % 8 == 4 && (S8 % 32 == 8 || S8 % 32 == 24), "pad");
  static_assert(NT % K == 0 && C % NPART == 0, "cumsum split");
};

template <typename T, int K>
constexpr int output_smem_floats() {
  using G = Geo<K>;
  return 3 * C * G::S4 + G::S4 + C * G::S8 + K * G::S8 + C * G::SA + NT + C +
         K;
}
template <typename T, int K>
constexpr size_t output_smem_bytes() {
  return output_smem_floats<T, K>() * sizeof(float);
}
template <typename T, int K>
constexpr size_t states_smem_bytes() {
  using G = Geo<K>;
  return (3 * C * G::S8 + NT) * sizeof(float) +
         (std::is_same<T, float>::value ? 0 : 3 * C * K * sizeof(T));
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
// Wait until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Steps [t0, t0 + C) of one (B, T, H, K) operand, head `base`, into shared
// memory: step t at dst + t * ld elements. Steps at or past Tn load zeros.
template <typename T, int K>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      long long base, long long hk, int t0,
                                      int Tn) {
  constexpr int E = 16 / sizeof(T);        // elements a 16-byte piece
  constexpr int PIECES = K / E;            // pieces a step
  for (int n = threadIdx.x; n < C * PIECES; n += NT) {
    const int t = n / PIECES, e = n % PIECES * E;
    const bool ok = t0 + t < Tn;
    cp_async16(dst + t * ld + e,
               ok ? src + base + (t0 + t) * hk + e : src, ok);
  }
}

// A packed (C, K) staging tile into a padded fp32 tile.
template <typename T, int K>
__device__ __forceinline__ void widen(float* dst, int ld, const T* src) {
  for (int n = threadIdx.x; n < C * K; n += NT)
    dst[n / K * ld + n % K] = to_f(src[n]);
}

// p[t][i] <- (lw[0][i] + ... + lw[t][i]) * log2(e), in place: NPART
// threads a column each sum PROWS steps, then add the totals of the parts
// before theirs, in order, and scale. Both kernels run it, so both see the
// same bits of p. In log2 units each exponential below is one ex2.
template <int K>
__device__ __forceinline__ void cumsum(float* p, int ld, float* tot) {
  using G = Geo<K>;
  const int i = threadIdx.x % K, part = threadIdx.x / K;
  float* col = p + part * G::PROWS * ld + i;
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < G::PROWS; ++t) {
    s += col[t * ld];
    col[t * ld] = s;
  }
  tot[part * K + i] = s;
  __syncthreads();
  float off = 0.f;
  for (int q = 0; q < part; ++q) off += tot[q * K + i];
#pragma unroll
  for (int t = 0; t < G::PROWS; ++t) col[t * ld] = (col[t * ld] + off) * LOG2E;
  __syncthreads();
}

// 2^x for x <= 0 on the MUFU: one ex2.approx.ftz (relative error about
// 2^-22). A result below 2^-126 is flushed to 0: it stands for a term
// smaller still.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// fp32 -> (hi, lo) TF32 pair by truncation: hi keeps x's top 10 mantissa
// bits, lo = x - hi (exact in fp32) keeps the next 10 of its own; what lo
// drops is below 2^-20 of x. Two LOP3 and an FADD.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x 8, row-major) of TF32 pairs: lane (g, q) holds rows
// g and g + 8, columns q and q + 4.
struct FragA {
  uint32_t hi[4], lo[4];
  // the fp32 values at (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
  // from a row-major tile; p points at (g, q), rows ld apart
  __device__ __forceinline__ void load(const float* p, int ld) {
    set(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
  }
};

// A B fragment (8 x 8, k by n): lane (g, q) holds k = q and q + 4 of
// column g.
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
  // from a k-major tile; p points at (q, g), k rows ld apart
  __device__ __forceinline__ void load(const float* p, int ld) {
    set(p[0], p[4 * ld]);
  }
};

// acc[x] += a b[x] for NX n8 tiles by 3xTF32: lo*hi and hi*lo into lo[x],
// hi*hi into hi[x] (acc = hi + lo at the end). Pass by pass, so that no
// mma waits on the one before it: 2 NX independent chains.
template <int NX>
__device__ __forceinline__ void mma3(float (&hi)[NX][4], float (&lo)[NX][4],
                                     const FragA& a, const FragB (&b)[NX]) {
#pragma unroll
  for (int x = 0; x < NX; ++x) mma_tf32(lo[x], a.lo, b[x].hi[0], b[x].hi[1]);
#pragma unroll
  for (int x = 0; x < NX; ++x) mma_tf32(lo[x], a.hi, b[x].lo[0], b[x].lo[1]);
#pragma unroll
  for (int x = 0; x < NX; ++x) mma_tf32(hi[x], a.hi, b[x].hi[0], b[x].hi[1]);
}

// Two adjacent outputs (p even, so 8- or 4-byte aligned) in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ float4 fma4(float d, float4 s, float4 u) {
  return make_float4(fmaf(d, s.x, u.x), fmaf(d, s.y, u.y),
                     fmaf(d, s.z, u.z), fmaf(d, s.w, u.w));
}

// The states kernel: U_c and d_c of chunk c = blockIdx.x of head
// (b, h) = (blockIdx.z, blockIdx.y). U_c[i][o] = sum_t k[t][i] exp(p[C-1][i]
// - p[t][i]) v[t][o] is an (i x t) by (t x o) product: m16 tiles over i, n8
// tiles over o, k8 steps over t.
template <typename T, int K>
__global__ void __launch_bounds__(NT, 2)
wkv6_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ lw, float* __restrict__ states,
                   float* __restrict__ decays, int Tn, int H, int nc) {
  using G = Geo<K>;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + C * G::S8;
  float* s_p = s_v + C * G::S8;
  float* s_tot = s_p + C * G::S8;
  T* raw = reinterpret_cast<T*>(s_tot + NT);      // 16-bit staging

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const long long hk = (long long)H * K;
  const long long base = (long long)b * Tn * hk + (long long)h * K;
  const long long slot = ((long long)b * H + h) * nc + c;
  const int t0 = c * C;

  // fp32: lw first (the cumsum), then k and v (the product)
  if constexpr (F32) {
    stage<T, K>(s_p, G::S8, lw, base, hk, t0, Tn);
    cp_async_commit();
    stage<T, K>(s_k, G::S8, k, base, hk, t0, Tn);
    stage<T, K>(s_v, G::S8, v, base, hk, t0, Tn);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    stage<T, K>(raw, K, k, base, hk, t0, Tn);
    stage<T, K>(raw + C * K, K, v, base, hk, t0, Tn);
    stage<T, K>(raw + 2 * C * K, K, lw, base, hk, t0, Tn);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if constexpr (!F32) {
    widen<T, K>(s_k, G::S8, raw);
    widen<T, K>(s_v, G::S8, raw + C * K);
    widen<T, K>(s_p, G::S8, raw + 2 * C * K);
    __syncthreads();
  }
  cumsum<K>(s_p, G::S8, s_tot);
  if constexpr (F32) {
    cp_async_wait<0>();
    __syncthreads();
  }
  const float* plast = s_p + (C - 1) * G::S8;

  // Warp (mt, kh) takes the m16 tile mt of i, every n8 tile of o and the
  // k8 steps kh * NKS .. of t: each A fragment (with its exponentials) is
  // formed once. The KS partial sums meet in shared memory, in order.
  constexpr int KS = NW / G::MT;                       // warps along t
  constexpr int NKS = C / 8 / KS;                      // k8 steps a warp
  constexpr int PS = K + 8;                            // partial row stride
  static_assert(KS * K * PS <= 3 * C * G::S8, "partials");
  const int mt = warp % G::MT, kh = warp / G::MT;
  const int i0 = mt * 16 + g;     // A rows i0, i0 + 8 (zeros past K = 8)
  float hi[G::NTILE][4] = {}, lo[G::NTILE][4] = {};
  {
    const float* kp = s_k + q * G::S8 + i0;       // (t = q, i = i0)
    const float* pp = s_p + q * G::S8 + i0;
    const float* vp = s_v + q * G::S8 + g;        // (t = q, o = g)
    const float pl0 = plast[i0], pl8 = K >= 16 ? plast[i0 + 8] : 0.f;
#pragma unroll
    for (int n = 0; n < NKS; ++n) {
      const int o0 = (kh * NKS + n) * 8 * G::S8, o4 = o0 + 4 * G::S8;
      FragA fa;
      fa.set(kp[o0] * ex2(pl0 - pp[o0]),
             K >= 16 ? kp[o0 + 8] * ex2(pl8 - pp[o0 + 8]) : 0.f,
             kp[o4] * ex2(pl0 - pp[o4]),
             K >= 16 ? kp[o4 + 8] * ex2(pl8 - pp[o4 + 8]) : 0.f);
      FragB fb[G::NTILE];
#pragma unroll
      for (int x = 0; x < G::NTILE; ++x) fb[x].load(vp + o0 + x * 8, G::S8);
      mma3(hi, lo, fa, fb);
    }
  }
  const float pl = tid < K ? plast[tid] : 0.f;
  __syncthreads();                        // the tiles are read: reuse them
  float* part = s_k;                      // [KS][K][PS]
#pragma unroll
  for (int x = 0; x < G::NTILE; ++x) {
    float* at = part + (kh * K + i0) * PS + x * 8 + 2 * q;
    *reinterpret_cast<float2*>(at) =
        make_float2(hi[x][0] + lo[x][0], hi[x][1] + lo[x][1]);
    if (K >= 16)
      *reinterpret_cast<float2*>(at + 8 * PS) =
          make_float2(hi[x][2] + lo[x][2], hi[x][3] + lo[x][3]);
  }
  __syncthreads();
  float4* u_c = reinterpret_cast<float4*>(states + slot * K * K);
  for (int e = tid; e < K * K / 4; e += NT) {
    const float* at = part + 4 * e / K * PS + 4 * e % K;
    float4 sum = *reinterpret_cast<const float4*>(at);
    for (int kk = 1; kk < KS; ++kk) {
      const float4 more = *reinterpret_cast<const float4*>(at + kk * K * PS);
      sum = make_float4(sum.x + more.x, sum.y + more.y, sum.z + more.z,
                        sum.w + more.w);
    }
    u_c[e] = sum;
  }
  if (tid < K) decays[slot * K + tid] = ex2(pl);
}

// The carry kernel: for head (blockIdx.z, blockIdx.y), entries 4 e .. 4 e +
// 3 of the state, e = blockIdx.x * NT + threadIdx.x, walk the chunks in
// order and replace U_c by S_c (the state entering chunk c) in place.
// Loads come four chunks at a time, ahead of the dependent updates.
template <int K>
__global__ void __launch_bounds__(NT)
wkv6_carry_kernel(float* __restrict__ states,
                  const float* __restrict__ decays, int H, int nc) {
  constexpr int E4 = K * K / 4;                      // float4 a state
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= E4) return;
  const long long slot = ((long long)blockIdx.z * H + blockIdx.y) * nc;
  float4* st = reinterpret_cast<float4*>(states + slot * K * K) + e;
  const float* d = decays + slot * K + 4 * e / K;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 u[4];
    float dd[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < nc) {
        u[j] = st[(long long)(c0 + j) * E4];
        dd[j] = d[(long long)(c0 + j) * K];
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < nc) {
        st[(long long)(c0 + j) * E4] = s;
        s = fma4(dd[j], s, u[j]);
      }
  }
}

// The output kernel: y of chunk c = blockIdx.x of head (blockIdx.z,
// blockIdx.y). `built`: the scratch holds S_c (the carry kernel ran), else
// U_c, from which the block builds S_c itself.
template <typename T, int K>
__global__ void __launch_bounds__(NT, 2)
wkv6_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ lw,
                   const float* __restrict__ u,
                   const float* __restrict__ states,
                   const float* __restrict__ decays, T* __restrict__ y,
                   int Tn, int H, int nc, int built) {
  using G = Geo<K>;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* s_r = smem;                    // [t][i], stride S4
  float* s_k = s_r + C * G::S4;         // [t][i], stride S4
  float* s_p = s_k + C * G::S4 + G::S4; // lw, then p: [t][i], stride S4,
                                        // after a row of zeros (t = -1)
  float* s_v = s_p + C * G::S4;         // [t][o], stride S8
  float* s_s = s_v + C * G::S8;         // S entering the chunk, [i][o], S8
  float* s_a = s_s + K * G::S8;         // att [t][j], stride SA
  float* s_tot = s_a + C * G::SA;
  float* s_coef = s_tot + NT;
  float* s_u = s_coef + C;
  T* raw = reinterpret_cast<T*>(s_s);   // 16-bit staging, over s_s and s_a
  static_assert(F32 || 4 * C * K * sizeof(T) <=
                           (K * G::S8 + C * G::SA) * sizeof(float),
                "staging");

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const long long hk = (long long)H * K;
  const long long base = (long long)b * Tn * hk + (long long)h * K;
  const long long slot0 = ((long long)b * H + h) * nc;
  const int t0 = c * C;

  // fp32 tiles come in three groups, each waited for just before its first
  // use: lw (the cumsum), r and k (att), v (the products). bf16 and f16
  // come in one, into the staging area over s_s and s_a.
  if constexpr (F32) {
    stage<T, K>(s_p, G::S4, lw, base, hk, t0, Tn);
    cp_async_commit();
    stage<T, K>(s_r, G::S4, r, base, hk, t0, Tn);
    stage<T, K>(s_k, G::S4, k, base, hk, t0, Tn);
    cp_async_commit();
    stage<T, K>(s_v, G::S8, v, base, hk, t0, Tn);
    cp_async_commit();
  } else {
    stage<T, K>(raw, K, r, base, hk, t0, Tn);
    stage<T, K>(raw + C * K, K, k, base, hk, t0, Tn);
    stage<T, K>(raw + 2 * C * K, K, lw, base, hk, t0, Tn);
    stage<T, K>(raw + 3 * C * K, K, v, base, hk, t0, Tn);
    cp_async_commit();
  }

  // The entering state, while the tiles are in flight: S_c as the carry
  // kernel left it, or S = d_c' * S + U_c' for c' < c.
  constexpr int E4 = K * K / 4;
  constexpr int NS = (E4 + NT - 1) / NT;
  float4 st[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const int e = tid + n * NT;
    st[n] = built && e < E4
                ? reinterpret_cast<const float4*>(states +
                                                  (slot0 + c) * K * K)[e]
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (!built) {
#pragma unroll 2
    for (int cc = 0; cc < c; ++cc) {
      const float4* uc =
          reinterpret_cast<const float4*>(states + (slot0 + cc) * K * K);
      const float* dc = decays + (slot0 + cc) * K;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int e = tid + n * NT;
        if (e < E4) st[n] = fma4(dc[4 * e / K], st[n], uc[e]);
      }
    }
  }
  auto store_state = [&] {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int e = tid + n * NT;
      if (e < E4)
        *reinterpret_cast<float4*>(s_s + 4 * e / K * G::S8 + 4 * e % K) =
            st[n];
    }
  };
  if (tid < K) s_u[tid] = u[(long long)h * K + tid];
  if (tid < G::S4) s_p[tid - G::S4] = 0.f;      // pprev of step 0
  if constexpr (F32) {
    store_state();                     // s_s is not a staging area here
    cp_async_wait<2>();                // lw
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
  if constexpr (!F32) {
    widen<T, K>(s_r, G::S4, raw);
    widen<T, K>(s_k, G::S4, raw + C * K);
    widen<T, K>(s_p, G::S4, raw + 2 * C * K);
    widen<T, K>(s_v, G::S8, raw + 3 * C * K);
    __syncthreads();                    // the staging is read: s_s is free
    store_state();
  }
  cumsum<K>(s_p, G::S4, s_tot);         // its barriers publish s_s too
  if constexpr (F32) {
    cp_async_wait<1>();                 // r and k
    __syncthreads();
  }

  // The bonus coefficient sum_i r u k of each step: 4 lanes a step, i
  // interleaved, summed by two shuffles in a fixed order.
  {
    const int t = tid / 4, part = tid % 4;
    float acc = 0.f;
    for (int i = part; i < K; i += 4)
      acc = fmaf(s_r[t * G::S4 + i] * s_u[i], s_k[t * G::S4 + i], acc);
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    if (part == 0) s_coef[t] = acc;
  }
  // The diagonal blocks: zeros on and above the diagonal ...
  for (int n = tid; n < NSUB * SUB * SUB; n += NT) {
    const int a = n / (SUB * SUB), tt = n / SUB % SUB, jj = n % SUB;
    if (jj >= tt) s_a[(a * SUB + tt) * G::SA + a * SUB + jj] = 0.f;
  }
  // ... and below it, exact, in 2 x 2 tiles of pairs (t, j < t), so that
  // each row loaded from shared memory serves two pairs. A sub-chunk has 28
  // whole tiles (rows 2 rho, 2 rho + 1 by columns 2 gam, 2 gam + 1, gam <
  // rho), each taken by two adjacent threads over alternate runs of 4 i and
  // summed by one shuffle; threads 224 .. 255 take the 32 lone pairs
  // (2 rho + 1, 2 rho), all of i.
  if (tid < 224) {
    const int unit = tid / 2, half = tid % 2, a = unit / 28;
    int rho = 1, gam = unit % 28;
    while (gam >= rho) gam -= rho++;
    const int t = a * SUB + 2 * rho, j = a * SUB + 2 * gam;
    const float* rt = s_r + t * G::S4;
    const float* pt = s_p + (t - 1) * G::S4;
    const float* kj = s_k + j * G::S4;
    const float* pj = s_p + j * G::S4;
    float acc[2][2] = {};
#pragma unroll 2
    for (int i = 4 * half; i < K; i += 8) {
      float4 r4[2], p4[2], k4[2], q4[2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        r4[d] = *reinterpret_cast<const float4*>(rt + d * G::S4 + i);
        p4[d] = *reinterpret_cast<const float4*>(pt + d * G::S4 + i);
        k4[d] = *reinterpret_cast<const float4*>(kj + d * G::S4 + i);
        q4[d] = *reinterpret_cast<const float4*>(pj + d * G::S4 + i);
      }
#pragma unroll
      for (int dt = 0; dt < 2; ++dt)
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          const float4 &rr = r4[dt], &pp = p4[dt], &kk = k4[dj], &qq = q4[dj];
          float s2 = acc[dt][dj];
          s2 = fmaf(rr.x * kk.x, ex2(pp.x - qq.x), s2);
          s2 = fmaf(rr.y * kk.y, ex2(pp.y - qq.y), s2);
          s2 = fmaf(rr.z * kk.z, ex2(pp.z - qq.z), s2);
          s2 = fmaf(rr.w * kk.w, ex2(pp.w - qq.w), s2);
          acc[dt][dj] = s2;
        }
    }
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int dj = 0; dj < 2; ++dj)
        acc[dt][dj] += __shfl_xor_sync(FULL, acc[dt][dj], 1);
    s_a[(t + half) * G::SA + j] = half ? acc[1][0] : acc[0][0];
    s_a[(t + half) * G::SA + j + 1] = half ? acc[1][1] : acc[0][1];
  } else {                              // exp(pprev[t] - p[t - 1]) = 1
    const int lone = tid - 224, a = lone / 8;
    const int t = a * SUB + 2 * (lone % 8) + 1;
    const float* rt = s_r + t * G::S4;
    const float* kj = s_k + (t - 1) * G::S4;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < K; i += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(rt + i);
      const float4 k4 = *reinterpret_cast<const float4*>(kj + i);
      acc = fmaf(r4.x, k4.x, acc);
      acc = fmaf(r4.y, k4.y, acc);
      acc = fmaf(r4.z, k4.z, acc);
      acc = fmaf(r4.w, k4.w, acc);
    }
    s_a[t * G::SA + t - 1] = acc;
  }
  // The off-diagonal blocks on the tensor cores: warp w < 6 takes the pair
  // of sub-chunks (a, b), a > b, numbered in order (1,0) (2,0) (2,1) (3,0)
  // (3,1) (3,2), both n8 tiles of b's 16 steps, K / 8 k-steps over i.
  if (warp < 6) {
    const int a = 1 + (warp >= 1) + (warp >= 3), bb = warp - a * (a - 1) / 2;
    constexpr int R8 = 8 * G::S4;
    const float* pm = s_p + (bb * SUB + SUB - 1) * G::S4 + q;  // b's last
    const float* rt = s_r + (a * SUB + g) * G::S4 + q;   // A: t = 16 a + g
    const float* pt = rt - s_r + s_p - G::S4;            //    and t - 1
    const float* kj = s_k + (bb * SUB + g) * G::S4 + q;  // B: j = 16 b + g
    const float* pj = kj - s_k + s_p;
    float hi[2][4] = {}, lo[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const int c0 = ks * 8, c4 = c0 + 4;
      const float m0 = pm[c0], m4 = pm[c4];
      FragA fa;
      fa.set(rt[c0] * ex2(pt[c0] - m0), rt[R8 + c0] * ex2(pt[R8 + c0] - m0),
             rt[c4] * ex2(pt[c4] - m4), rt[R8 + c4] * ex2(pt[R8 + c4] - m4));
      FragB fb[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = nt * R8;
        fb[nt].set(kj[j + c0] * ex2(m0 - pj[j + c0]),
                   kj[j + c4] * ex2(m4 - pj[j + c4]));
      }
      mma3(hi, lo, fa, fb);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* at = s_a + (a * SUB + g) * G::SA + bb * SUB + nt * 8 + 2 * q;
      at[0] = hi[nt][0] + lo[nt][0];
      at[1] = hi[nt][1] + lo[nt][1];
      at[8 * G::SA] = hi[nt][2] + lo[nt][2];
      at[8 * G::SA + 1] = hi[nt][3] + lo[nt][3];
    }
  }
  if constexpr (F32) cp_async_wait<0>();  // v
  __syncthreads();

  // y = att v + (r * exp(pprev)) S + coef v: warp w takes the 16 steps of
  // sub-chunk w % 4 and the n8 tiles w / 4, w / 4 + 2, ... of K.
  {
    constexpr int NTW = (G::NTILE + 1) / 2;
    const int a = warp % NSUB, nw = warp / NSUB;
    // a warp has all its NTW tiles (nw + 2 x < NTILE) or none (K = 8)
    const bool busy = nw < G::NTILE;
    float hi[NTW][4] = {}, lo[NTW][4] = {};
    if (busy) {
      const float* at = s_a + (a * SUB + g) * G::SA + q;     // (t, j = q)
      const float* vp = s_v + q * G::S8 + nw * 8 + g;        // (j = q, o)
      for (int ks = 0; ks < 2 * (a + 1); ++ks) {    // att is 0 past j = t
        FragA fa;
        fa.load(at + ks * 8, G::SA);
        FragB fb[NTW];
#pragma unroll
        for (int x = 0; x < NTW; ++x)
          fb[x].load(vp + ks * 8 * G::S8 + x * 16, G::S8);
        mma3(hi, lo, fa, fb);
      }
      constexpr int R8 = 8 * G::S4;
      const float* rt = s_r + (a * SUB + g) * G::S4 + q;     // (t, i = q)
      const float* pt = rt - s_r + s_p - G::S4;              // row t - 1
      const float* sp = s_s + q * G::S8 + nw * 8 + g;        // (i = q, o)
#pragma unroll
      for (int ks = 0; ks < K / 8; ++ks) {
        const int c0 = ks * 8, c4 = c0 + 4;
        FragA fa;
        fa.set(rt[c0] * ex2(pt[c0]), rt[R8 + c0] * ex2(pt[R8 + c0]),
               rt[c4] * ex2(pt[c4]), rt[R8 + c4] * ex2(pt[R8 + c4]));
        FragB fb[NTW];
#pragma unroll
        for (int x = 0; x < NTW; ++x)
          fb[x].load(sp + ks * 8 * G::S8 + x * 16, G::S8);
        mma3(hi, lo, fa, fb);
      }
#pragma unroll
      for (int x = 0; x < NTW; ++x) {
        const int o = (nw + 2 * x) * 8 + 2 * q;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = a * SUB + g + 8 * half;
          if (t0 + t < Tn) {
            const float cf = s_coef[t];
            const float* vt = s_v + t * G::S8 + o;
            const int e = 2 * half;
            store2(y + base + (t0 + t) * hk + o,
                   fmaf(cf, vt[0], hi[x][e] + lo[x][e]),
                   fmaf(cf, vt[1], hi[x][e + 1] + lo[x][e + 1]));
          }
        }
      }
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* lw, const void* u, void* y, float* scratch,
                   int B, int Tn, int H, int max_inblock,
                   cudaStream_t stream) {
  const int nc = (Tn + C - 1) / C;
  float* states = scratch;
  float* decays = scratch + (size_t)B * H * nc * K * K;
  const bool built = nc > max_inblock;
  // Above 48 KB of shared memory needs an opt-in, which holds per device:
  // it is set at the first launch on each device (bit `dev` of `ready`).
  auto* states_k = wkv6_states_kernel<T, K>;
  auto* output_k = wkv6_output_kernel<T, K>;
  constexpr size_t s_bytes = states_smem_bytes<T, K>();
  constexpr size_t o_bytes = output_smem_bytes<T, K>();
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load() & bit)) {
    err = cudaFuncSetAttribute(
        states_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        output_k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)o_bytes);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit);
  }
  const dim3 grid(nc, H, B);
  states_k<<<grid, NT, s_bytes, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(lw), states, decays, Tn, H, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (built) {
    const dim3 cgrid((K * K / 4 + NT - 1) / NT, H, B);
    wkv6_carry_kernel<K><<<cgrid, NT, 0, stream>>>(states, decays, H, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  output_k<<<grid, NT, o_bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(lw),
      static_cast<const float*>(u), states, decays, static_cast<T*>(y), Tn,
      H, nc, built ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* r, const void* k, const void* v,
                     const void* lw, const void* u, void* y, float* scratch,
                     int B, int Tn, int H, int K, int max_inblock,
                     cudaStream_t st) {
  switch (K) {
    case 8:
      return launch<T, 8>(r, k, v, lw, u, y, scratch, B, Tn, H, max_inblock,
                          st);
    case 16:
      return launch<T, 16>(r, k, v, lw, u, y, scratch, B, Tn, H, max_inblock,
                           st);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, y, scratch, B, Tn, H, max_inblock,
                           st);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, y, scratch, B, Tn, H, max_inblock,
                           st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Floats of scratch a call needs: U_c (K*K) and d_c (K) per chunk and head.
extern "C" long long aeg_wkv6_scratch_floats(int B, int T, int H, int K) {
  return (long long)B * H * ((T + C - 1) / C) * ((long long)K * K + K);
}

// dtype (of r, k, v, lw and y): 0 = float32, 1 = bfloat16, 2 = float16;
// u is float32; scratch holds aeg_wkv6_scratch_floats floats. Above
// max_inblock chunks the carry kernel builds the entering states. Returns a
// cudaError_t.
extern "C" int aeg_wkv6(const void* r, const void* k, const void* v,
                        const void* lw, const void* u, void* y, void* scratch,
                        int B, int T, int H, int K, int dtype,
                        int max_inblock, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || T <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch_k<float>(r, k, v, lw, u, y, s, B, T, H, K,
                                  max_inblock, st);
    case 1:
      return (int)launch_k<__nv_bfloat16>(r, k, v, lw, u, y, s, B, T, H, K,
                                          max_inblock, st);
    case 2:
      return (int)launch_k<__half>(r, k, v, lw, u, y, s, B, T, H, K,
                                   max_inblock, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
