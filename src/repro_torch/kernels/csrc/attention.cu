// Hand-written Hopper (sm_90a) kernels for training's causal attention: a
// forward and a backward in two kernels, over q, k, v of shape (B, S, H, hd)
// (k and v expanded to the q heads), hd = 64, 80 or 128.
//
// They replace no TPU kernel: the reference leaves its blockwise attention
// to XLA.  They were added because the port's plain attention held the
// whole (B, H, S, S) score matrix in f32 and made about ten passes over it
// each way (a step of h2o-danube-1.8b wrote 2.15 GB score tensors 48 times
// and spent most of its time on them).  Here no score leaves the SM:
//
// attention_fwd        one CTA per (b, h, 64-query tile) walks its key
//                      tiles (64 keys) with an online softmax;
// attention_bwd_dq     one CTA per (b, h, 64-query tile) walks its key
//                      tiles; it also writes D = rowsum(dO * O) and q
//                      scaled, which the next kernel reads;
// attention_bwd_dkdv   one CTA per (b, h, 64-key tile) walks the query
//                      tiles that see it (32 or 64 queries a step).
//
// Each output element is summed by one thread in a fixed order, with no
// atomics, so a backward gives the same bits every time.
//
// Bound on the H100: the tensor cores.  One causal attention needs 4 hd
// flops per visible (query, key) pair forward and 10 hd backward (the
// kernels do 4, 6 and 8: the backward recomputes the scores twice) against
// 8 hd + 4 bytes per row of device memory, far above the card's 295 flops
// per byte.  The kernels use mma.sync m16n8k16 (bf16 in, f32 accumulate),
// ldmatrix from shared tiles whose rows are padded by 16 bytes (no bank
// conflicts), and cp.async with the next K/V (or Q/dO) tile loading while
// the current one is used (two stages).  Four warps, 16 rows each; tiles
// wholly above the diagonal or before the window are never visited, and
// only tiles that cross an edge are masked.  mma.sync reaches about two
// thirds of the card's wgmma peak, and the softmax's exponentials and
// masks share the SM's issue slots with it.
//
// Numerics (those of the plain path, models/common.blockwise_attention
// with every key in one block): q is scaled as bf16(f32(q) * scale); the
// scores are bf16 products summed in f32; masked scores are -inf; the
// running max, p = exp(s - m) and l = sum(p) of the unrounded p are f32;
// p is rounded to bf16 for the value product, summed in f32; the output
// is bf16(acc / l) (an IEEE division).  exp is ex2.approx of
// fma(s, log2 e, -m log2 e): its error (~2 ulp, and the product's one
// rounding, shared by a whole row) is far below the bf16 rounding of p
// that follows.  The forward saves lse = m log2 e + log2(l) per row, and
// the backward recomputes P = 2^(s log2 e - lse), dP = dO V^T in f32,
// dS = P (dP - D) in f32 (D from the bf16 output), dV = bf16(P)^T dO;
// dS enters the dQ and dK products as a hi + lo pair of bf16 (hi =
// bf16(dS), lo = bf16(dS - hi), two products into one f32 sum), so it is
// not rounded to bf16 once; dq = bf16(f32(bf16(dQ')) * scale) as the
// plain path rounds it, dk = bf16(dK), dv = bf16(dV).
//
// Plain C interface for ctypes; every entry point returns the launch's
// cudaError_t.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// A (B, S, H, hd) tensor read or written through its strides (elements);
// hd is contiguous.
struct View {
  bf16* p;
  long long sb, ss, sh;
  __device__ bf16* at(int b, int h) const { return p + b * sb + h * sh; }
};

struct Args {
  View q, k, v, o, dout, dq, dk, dv;
  float* lse;   // (B * H, S): m log2 e + log2(l) of each query row
  float* dsum;  // (B * H, S): rowsum(dO * O), written by attention_bwd_dq
  bf16* qs;     // (B * H, S, hd): q scaled, written by attention_bwd_dq
  int B, H, S, window;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 sum
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16(x) in *h, and x - bf16(x) (exact in f32) returned
__device__ __forceinline__ float split(float x, bf16* h) {
  *h = __float2bfloat16_rn(x);
  return __fsub_rn(x, __bfloat162float(*h));
}

// hi and lo bf16 pairs of (x0, x1)
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t* hi,
                                           uint32_t* lo) {
  bf16 h0, h1;
  const float r0 = split(x0, &h0), r1 = split(x1, &h1);
  __nv_bfloat162 hv = __halves2bfloat162(h0, h1);
  *hi = *reinterpret_cast<uint32_t*>(&hv);
  *lo = pack(r0, r1);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// query i sees key j: causal, inside the window, and a real key
__device__ __forceinline__ bool visible(int i, int j, int S, int W) {
  return j <= i && j > i - W && j < S;
}

// rows [row0, row0 + ROWS) of an (S, HD) slab with row stride rs into
// shared rows of HD + 8 elements; rows past S are zero
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int row0, int S) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * (HD + 8) + col, src + (ok ? row : 0) * rs + col,
               ok);
  }
}

template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const int row = row0 + r;
    const bool ok = row < S;
    cp_async4(dst + r, src + (ok ? row : 0), ok);
  }
}

// rows [q0, q0 + ROWS) of q, scaled as the plain path scales them, into
// shared memory (zero past S), and into qs when it is given
template <int HD, int ROWS>
__device__ __forceinline__ void load_scaled_q(bf16* dst, const bf16* src,
                                              long long rs, int q0, int S,
                                              float scale, bf16* qs) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8, row = q0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (row < S) raw = *reinterpret_cast<const uint4*>(src + row * rs + col);
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16_rn(__fmul_rn(__bfloat162float(e[i]), scale));
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + col) = raw;
    if (qs != nullptr && row < S)
      *reinterpret_cast<uint4*>(qs + static_cast<long long>(row) * HD + col) =
          raw;
  }
}

// The key tiles of size BN that the query rows [q0, q0 + BM) see.
template <int BM, int BN>
__device__ __forceinline__ void key_tiles(int q0, int S, int W, int* t0,
                                          int* t1) {
  *t0 = max(0, q0 - W + 1) / BN;
  *t1 = (min(S, q0 + BM) + BN - 1) / BN;
}

// Every key of [k0, k0 + BN) is seen by every query of [q0, q0 + BM).
template <int BM, int BN>
__device__ __forceinline__ bool whole_tile(int q0, int k0, int S, int W) {
  return k0 + BN - 1 <= q0 && k0 > q0 + BM - 1 - W && k0 + BN <= S &&
         q0 + BM <= S;
}

// s += a b^T over the 16 columns ks * 16.. of HD: a (16 x 16) A
// fragments, b the shared tile of NN * 8 rows; s[n] the 16 x 8 block of
// rows n * 8.. of b.
template <int HD, int NN>
__device__ __forceinline__ void scores_step(float (&s)[NN][4],
                                            const uint32_t (&a)[4],
                                            const bf16* b, int ks) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int np = 0; np < NN / 2; ++np) {
    uint32_t r[4];
    ldsm4(r, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * (HD + 8) +
                 ks * 16 + ((lane >> 3) & 1) * 8);
    mma(s[2 * np], a, r[0], r[1]);
    mma(s[2 * np + 1], a, r[2], r[3]);
  }
}

template <int NN>
__device__ __forceinline__ void zero(float (&s)[NN][4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
}

// S = A B^T for one warp: a (16 x HD) in registers, b the shared tile of
// NN * 8 rows
template <int HD, int NN>
__device__ __forceinline__ void scores(float (&s)[NN][4],
                                       const uint32_t (&a)[HD / 16][4],
                                       const bf16* b) {
  zero<NN>(s);
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) scores_step<HD, NN>(s, a[ks], b, ks);
}

// acc (16 x HD) += p (16 x KK * 16, A fragments) * b, b the shared tile of
// KK * 16 rows of HD (rows are the summed index)
template <int HD, int KK>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4],
                                           const uint32_t (&p)[KK][4],
                                           const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t r[4];
      ldsm4t(r, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (HD + 8) +
                    np * 16 + (lane >> 4) * 8);
      mma(acc[2 * np], p[kk], r[0], r[1]);
      mma(acc[2 * np + 1], p[kk], r[2], r[3]);
    }
}

// the same with p a hi + lo pair: two products into one sum
template <int HD, int KK>
__device__ __forceinline__ void accumulate2(float (&acc)[HD / 8][4],
                                            const uint32_t (&hi)[KK][4],
                                            const uint32_t (&lo)[KK][4],
                                            const bf16* b) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t r[4];
      ldsm4t(r, b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * (HD + 8) +
                    np * 16 + (lane >> 4) * 8);
      mma(acc[2 * np], hi[kk], r[0], r[1]);
      mma(acc[2 * np], lo[kk], r[0], r[1]);
      mma(acc[2 * np + 1], hi[kk], r[2], r[3]);
      mma(acc[2 * np + 1], lo[kk], r[2], r[3]);
    }
}

// the A fragment (16 x 16) of the warp's 16 rows of a shared tile at
// columns ks * 16..
template <int HD>
__device__ __forceinline__ void row_a(uint32_t (&a)[4], const bf16* tile,
                                      int warp, int ks) {
  const int lane = threadIdx.x & 31;
  ldsm4(a, tile + (warp * 16 + (lane & 15)) * (HD + 8) + ks * 16 +
               (lane >> 4) * 8);
}

template <int HD>
__device__ __forceinline__ void rows_a(uint32_t (&a)[HD / 16][4],
                                       const bf16* tile, int warp) {
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) row_a<HD>(a[ks], tile, warp, ks);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int HD>
struct Fwd {
  static constexpr int BM = 64, BN = 64, LD = HD + 8;
  static constexpr int kSmem = (BM + 4 * BN) * LD * 2;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const Args a) {
  constexpr int BM = Fwd<HD>::BM, BN = Fwd<HD>::BN, LD = Fwd<HD>::LD;
  constexpr int ND = HD / 8, NN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BM * LD;      // two stages
  bf16* sV = sK + 2 * BN * LD;  // two stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int S = a.S, W = a.window;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // longest rows first
  const bf16* gk = a.k.at(b, h);
  const bf16* gv = a.v.at(b, h);
  int kt0, kt1;
  key_tiles<BM, BN>(q0, S, W, &kt0, &kt1);

  load_rows<HD, BN>(sK, gk, a.k.ss, kt0 * BN, S);
  load_rows<HD, BN>(sV, gv, a.v.ss, kt0 * BN, S);
  cp_commit();
  load_scaled_q<HD, BM>(sQ, a.q.at(b, h), a.q.ss, q0, S, a.scale, nullptr);

  const int ra = q0 + warp * 16 + g, rb = ra + 8;  // this thread's rows
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float base[2] = {0.f, 0.f};  // m log2 e, 0 while m is -inf
  uint32_t qf[HD / 16][4];

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_rows<HD, BN>(sK + (st ^ 1) * BN * LD, gk, a.k.ss, (kt + 1) * BN, S);
      load_rows<HD, BN>(sV + (st ^ 1) * BN * LD, gv, a.v.ss, (kt + 1) * BN, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == kt0) rows_a<HD>(qf, sQ, warp);

    float s[NN][4];
    scores<HD, NN>(s, qf, sK + st * BN * LD);
    const int k0 = kt * BN;
    if (!whole_tile<BM, BN>(q0, k0, S, W)) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(e < 2 ? ra : rb, k0 + n * 8 + 2 * t + (e & 1), S, W))
            s[n][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float nb = mx[r] == -INFINITY ? 0.f : __fmul_rn(mx[r], kLog2e);
      // exp(m_old - m_new); nothing is summed yet while m_old is -inf
      const float corr = m[r] == -INFINITY ? 0.f : ex2(__fsub_rn(base[r], nb));
      m[r] = mx[r];
      base[r] = nb;
      l[r] = __fmul_rn(l[r], corr);
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        acc[d][2 * r] = __fmul_rn(acc[d][2 * r], corr);
        acc[d][2 * r + 1] = __fmul_rn(acc[d][2 * r + 1], corr);
      }
    }
    uint32_t pa[NN / 2][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float p0 = ex2(__fmaf_rn(s[n][0], kLog2e, -base[0]));
      const float p1 = ex2(__fmaf_rn(s[n][1], kLog2e, -base[0]));
      const float p2 = ex2(__fmaf_rn(s[n][2], kLog2e, -base[1]));
      const float p3 = ex2(__fmaf_rn(s[n][3], kLog2e, -base[1]));
      l[0] = __fadd_rn(l[0], __fadd_rn(p0, p1));
      l[1] = __fadd_rn(l[1], __fadd_rn(p2, p3));
      pa[n / 2][(n & 1) * 2] = pack(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack(p2, p3);
    }
    accumulate<HD, NN / 2>(acc, pa, sV + st * BN * LD);
    __syncthreads();
  }

  bf16* go = a.o.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(kFull, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(kFull, l[r], 2));
    const int row = r ? rb : ra;
    if (row >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      *reinterpret_cast<uint32_t*>(go + row * a.o.ss + d * 8 + 2 * t) =
          pack(__fdiv_rn(acc[d][2 * r], den), __fdiv_rn(acc[d][2 * r + 1], den));
    if (t == 0)
      a.lse[static_cast<long long>(blockIdx.y) * S + row] =
          __fadd_rn(base[r], log2f(l[r]));
  }
}

// ---------------------------------------------------------------------------
// backward, dq (and D, and q scaled)
// ---------------------------------------------------------------------------

template <int HD>
struct Dq {
  static constexpr int BM = 64, BN = HD == 128 ? 32 : 64, LD = HD + 8;
  static constexpr int kSmem = (2 * BM + 4 * BN) * LD * 2 + BM * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dq_kernel(const Args a) {
  constexpr int BM = Dq<HD>::BM, BN = Dq<HD>::BN, LD = Dq<HD>::LD;
  constexpr int ND = HD / 8, NN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + BM * LD;      // dO
  bf16* sK = sO + BM * LD;      // two stages
  bf16* sV = sK + 2 * BN * LD;  // two stages
  float* sD = reinterpret_cast<float*>(sV + 2 * BN * LD);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, W = a.window;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const bf16* gk = a.k.at(b, h);
  const bf16* gv = a.v.at(b, h);
  const bf16* gdo = a.dout.at(b, h);
  int kt0, kt1;
  key_tiles<BM, BN>(q0, S, W, &kt0, &kt1);

  load_rows<HD, BN>(sK, gk, a.k.ss, kt0 * BN, S);
  load_rows<HD, BN>(sV, gv, a.v.ss, kt0 * BN, S);
  load_rows<HD, BM>(sO, gdo, a.dout.ss, q0, S);
  cp_commit();
  load_scaled_q<HD, BM>(sQ, a.q.at(b, h), a.q.ss, q0, S, a.scale,
                        a.qs + static_cast<long long>(bh) * S * HD);
  static_assert(2 * BM == kThreads, "two threads a row of D");
  {  // D = rowsum(dO * O) in f32: two threads a row, each half of hd
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (row < S) {
      const bf16* po = a.o.at(b, h) + row * a.o.ss + half * (HD / 2);
      const bf16* pd = gdo + row * a.dout.ss + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(po + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(pd + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          d = __fadd_rn(d, __fmul_rn(__bfloat162float(oe[i]),
                                     __bfloat162float(de[i])));
      }
    }
    d = __fadd_rn(d, __shfl_xor_sync(kFull, d, 1));
    if (half == 0) {
      sD[r] = d;
      if (row < S) a.dsum[static_cast<long long>(bh) * S + row] = d;
    }
  }

  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const float lse[2] = {ra < S ? a.lse[static_cast<long long>(bh) * S + ra] : 0.f,
                        rb < S ? a.lse[static_cast<long long>(bh) * S + rb] : 0.f};
  float dsr[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  uint32_t qf[HD / 16][4], of[HD / 16][4];

  for (int kt = kt0; kt < kt1; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_rows<HD, BN>(sK + (st ^ 1) * BN * LD, gk, a.k.ss, (kt + 1) * BN, S);
      load_rows<HD, BN>(sV + (st ^ 1) * BN * LD, gv, a.v.ss, (kt + 1) * BN, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (kt == kt0) {
      rows_a<HD>(qf, sQ, warp);
      rows_a<HD>(of, sO, warp);
      dsr[0] = sD[warp * 16 + g];
      dsr[1] = sD[warp * 16 + g + 8];
    }
    const bf16* k_s = sK + st * BN * LD;
    float s[NN][4], dp[NN][4];
    scores<HD, NN>(s, qf, k_s);
    scores<HD, NN>(dp, of, sV + st * BN * LD);
    const int k0 = kt * BN;
    if (!whole_tile<BM, BN>(q0, k0, S, W)) {
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(e < 2 ? ra : rb, k0 + n * 8 + 2 * t + (e & 1), S, W))
            s[n][e] = -INFINITY;
    }
    uint32_t hi[NN / 2][4], lo[NN / 2][4];
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(__fmaf_rn(s[n][e], kLog2e, -lse[e >> 1]));
        ds[e] = __fmul_rn(p, __fsub_rn(dp[n][e], dsr[e >> 1]));
      }
      pack_split(ds[0], ds[1], &hi[n / 2][(n & 1) * 2], &lo[n / 2][(n & 1) * 2]);
      pack_split(ds[2], ds[3], &hi[n / 2][(n & 1) * 2 + 1],
                 &lo[n / 2][(n & 1) * 2 + 1]);
    }
    accumulate2<HD, NN / 2>(acc, hi, lo, k_s);
    __syncthreads();
  }

  bf16* gdq = a.dq.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? rb : ra;
    if (row >= S) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const float x0 = __bfloat162float(__float2bfloat16_rn(acc[d][2 * r]));
      const float x1 = __bfloat162float(__float2bfloat16_rn(acc[d][2 * r + 1]));
      *reinterpret_cast<uint32_t*>(gdq + row * a.dq.ss + d * 8 + 2 * t) =
          pack(__fmul_rn(x0, a.scale), __fmul_rn(x1, a.scale));
    }
  }
}

// ---------------------------------------------------------------------------
// backward, dk and dv
// ---------------------------------------------------------------------------

template <int HD>
struct Dkdv {
  static constexpr int BN = 64, BM = HD == 128 ? 32 : 64, LD = HD + 8;
  static constexpr int kSmem = (2 * BN + 4 * BM) * LD * 2 + 4 * BM * 4;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_dkdv_kernel(const Args a) {
  constexpr int BN = Dkdv<HD>::BN, BM = Dkdv<HD>::BM, LD = Dkdv<HD>::LD;
  constexpr int ND = HD / 8, NM = BM / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;      // q scaled, two stages
  bf16* sO = sQ + 2 * BM * LD;  // dO, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * BM * LD);  // lse, two stages
  float* sD = sL + 2 * BM;                                 // D, two stages
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int S = a.S, W = a.window;
  const int k0 = blockIdx.x * BN;
  const bf16* gqs = a.qs + static_cast<long long>(bh) * S * HD;
  const bf16* gdo = a.dout.at(b, h);
  const float* gl = a.lse + static_cast<long long>(bh) * S;
  const float* gd = a.dsum + static_cast<long long>(bh) * S;
  // the query tiles that see a key of [k0, k0 + BN)
  const int qt0 = k0 / BM;
  const int qt1 = (min(S, k0 + BN - 1 + W) + BM - 1) / BM;

  load_rows<HD, BN>(sK, a.k.at(b, h), a.k.ss, k0, S);
  load_rows<HD, BN>(sV, a.v.at(b, h), a.v.ss, k0, S);
  load_rows<HD, BM>(sQ, gqs, HD, qt0 * BM, S);
  load_rows<HD, BM>(sO, gdo, a.dout.ss, qt0 * BM, S);
  load_vec<BM>(sL, gl, qt0 * BM, S);
  load_vec<BM>(sD, gd, qt0 * BM, S);
  cp_commit();

  const int ja = k0 + warp * 16 + g, jb = ja + 8;  // this thread's keys
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int st = (qt - qt0) & 1;
    if (qt + 1 < qt1) {
      const int n0 = (qt + 1) * BM, o = (st ^ 1);
      load_rows<HD, BM>(sQ + o * BM * LD, gqs, HD, n0, S);
      load_rows<HD, BM>(sO + o * BM * LD, gdo, a.dout.ss, n0, S);
      load_vec<BM>(sL + o * BM, gl, n0, S);
      load_vec<BM>(sD + o * BM, gd, n0, S);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* q_s = sQ + st * BM * LD;
    const bf16* o_s = sO + st * BM * LD;
    const float* l_s = sL + st * BM;
    const float* d_s = sD + st * BM;
    // the transposed scores and dP: rows are this warp's keys, their A
    // fragments read from shared memory (registers are short here)
    float s[NM][4], dp[NM][4];
    zero<NM>(s);
    zero<NM>(dp);
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t ka[4], va[4];
      row_a<HD>(ka, sK, warp, ks);
      row_a<HD>(va, sV, warp, ks);
      scores_step<HD, NM>(s, ka, q_s, ks);
      scores_step<HD, NM>(dp, va, o_s, ks);
    }
    const int i0 = qt * BM;
    const bool whole = whole_tile<BM, BN>(i0, k0, S, W);
    uint32_t pa[NM / 2][4], hi[NM / 2][4], lo[NM / 2][4];
#pragma unroll
    for (int n = 0; n < NM; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        p[e] = ex2(__fmaf_rn(s[n][e], kLog2e, -l_s[c]));
        if (!whole && !(i0 + c < S && visible(i0 + c, e < 2 ? ja : jb, S, W)))
          p[e] = 0.f;
        ds[e] = __fmul_rn(p[e], __fsub_rn(dp[n][e], d_s[c]));
      }
      pa[n / 2][(n & 1) * 2] = pack(p[0], p[1]);
      pa[n / 2][(n & 1) * 2 + 1] = pack(p[2], p[3]);
      pack_split(ds[0], ds[1], &hi[n / 2][(n & 1) * 2], &lo[n / 2][(n & 1) * 2]);
      pack_split(ds[2], ds[3], &hi[n / 2][(n & 1) * 2 + 1],
                 &lo[n / 2][(n & 1) * 2 + 1]);
    }
    accumulate<HD, NM / 2>(dv, pa, o_s);
    accumulate2<HD, NM / 2>(dk, hi, lo, q_s);
    __syncthreads();
  }

  bf16* gdk = a.dk.at(b, h);
  bf16* gdv = a.dv.at(b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? jb : ja;
    if (row >= S) continue;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      *reinterpret_cast<uint32_t*>(gdk + row * a.dk.ss + d * 8 + 2 * t) =
          pack(dk[d][2 * r], dk[d][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(gdv + row * a.dv.ss + d * 8 + 2 * t) =
          pack(dv[d][2 * r], dv[d][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, int smem, int rows, int tile, const Args& a,
           void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((rows + tile - 1) / tile, a.B * a.H);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int fwd(const Args& a, void* stream) {
  return launch(attention_fwd_kernel<HD>, Fwd<HD>::kSmem, a.S, Fwd<HD>::BM, a,
                stream);
}

template <int HD>
int bwd_dq(const Args& a, void* stream) {
  return launch(attention_bwd_dq_kernel<HD>, Dq<HD>::kSmem, a.S, Dq<HD>::BM, a,
                stream);
}

template <int HD>
int bwd_dkdv(const Args& a, void* stream) {
  return launch(attention_bwd_dkdv_kernel<HD>, Dkdv<HD>::kSmem, a.S,
                Dkdv<HD>::BN, a, stream);
}

// ptrs: q, k, v, o, dout, dq, dk, dv (each (B, S, H, hd), null where the
// kernel does not use it), lse, dsum, qs; strides: (b, s, h) of each of the
// eight views, in elements.
bool make_args(void* const* ptrs, const long long* strides, int B, int S,
               int H, int window, float scale, Args* a) {
  if (B <= 0 || S <= 0 || H <= 0 || window <= 0 || B * H > 65535)
    return false;
  View* views[8] = {&a->q, &a->k,  &a->v,  &a->o,
                    &a->dout, &a->dq, &a->dk, &a->dv};
  for (int i = 0; i < 8; ++i) {
    views[i]->p = static_cast<bf16*>(ptrs[i]);
    views[i]->sb = strides[3 * i];
    views[i]->ss = strides[3 * i + 1];
    views[i]->sh = strides[3 * i + 2];
  }
  a->lse = static_cast<float*>(ptrs[8]);
  a->dsum = static_cast<float*>(ptrs[9]);
  a->qs = static_cast<bf16*>(ptrs[10]);
  a->B = B;
  a->H = H;
  a->S = S;
  a->window = window;
  a->scale = scale;
  return true;
}

template <int (*F64)(const Args&, void*), int (*F80)(const Args&, void*),
          int (*F128)(const Args&, void*)>
int dispatch(int hd, void* const* ptrs, const long long* strides, int B,
             int S, int H, int window, float scale, void* stream) {
  Args a;
  if (!make_args(ptrs, strides, B, S, H, window, scale, &a))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return F64(a, stream);
    case 80: return F80(a, stream);
    case 128: return F128(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k, v -> o, lse.  window: the keys a query sees (S for plain causal).
int attention_fwd(int hd, void* const* ptrs, const long long* strides, int B,
                  int S, int H, int window, float scale, void* stream) {
  return dispatch<fwd<64>, fwd<80>, fwd<128>>(hd, ptrs, strides, B, S, H,
                                               window, scale, stream);
}

// q, k, v, o, dout, lse -> dq, dsum, qs
int attention_bwd_dq(int hd, void* const* ptrs, const long long* strides,
                     int B, int S, int H, int window, float scale,
                     void* stream) {
  return dispatch<bwd_dq<64>, bwd_dq<80>, bwd_dq<128>>(
      hd, ptrs, strides, B, S, H, window, scale, stream);
}

// qs, k, v, dout, lse, dsum -> dk, dv
int attention_bwd_dkdv(int hd, void* const* ptrs, const long long* strides,
                       int B, int S, int H, int window, float scale,
                       void* stream) {
  return dispatch<bwd_dkdv<64>, bwd_dkdv<80>, bwd_dkdv<128>>(
      hd, ptrs, strides, B, S, H, window, scale, stream);
}

}  // extern "C"
