// Hand-written Hopper (sm_90a) kernels for the LoCo compression hot path.
//
// fused_compress  replaces src/repro/kernels/loco_quant.py::fused_compress
//                 (Pallas body _compress_kernel): error-decode + compensate
//                 + per-256-block absmax quantize (4 or 8 bit) + nibble-pack
//                 + moving-average error update + error re-encode, in one
//                 pass over the gradient.
// dequant_mean    replaces src/repro/kernels/loco_quant.py::dequant_mean:
//                 (nibble-unpack +) dequantize + mean over the D peer rows
//                 received from the all-to-all.
//
// Both are memory-bound byte shuffling, so the H100's 3.35 TB/s sets the
// bound.  fused_compress takes the gradient as it is (bf16: 2 B per element,
// or f32) and moves 4.52 B per element from a bf16 gradient (f8 error in and
// out, half a byte of payload, 4/256 B of scale); dequant_mean moves 2.52 B
// per element at D = 1 with a bf16 shard out.  Every byte is read or written
// once, and what would keep HBM from streaming is removed:
//
// * Loads in flight.  Each lane loads 16 B of gradient and 8 B of error per
//   quantizer block (one warp per block, 8 elements per lane), or 16 B of
//   payload per peer (four coalesced 4-byte words); a warp walks its blocks
//   grid-stride and loads the next block before it computes the current one,
//   so its loads stay in flight through the arithmetic.  The grid is sized
//   to the card (resident CTAs x SMs).
// * Divisions.  IEEE division is a long instruction sequence.  At 4 bits
//   every dequantized value is q/scale with q in [-8, 7], so lanes 0-15 of a
//   warp each divide one table entry (l - 8)/scale and every element fetches
//   its value with __shfl_sync: the same division on the same operands, so
//   bit-exact, one division per lane instead of one per element.  The f8
//   error decode multiplies by 2^-k when the error scale is 2^k (x/2^k and
//   x*2^-k round the same real number); any other scale divides.  The peer
//   mean multiplies by 1/D when D is a power of two, likewise.
// * The f8 conversions go two at a time (cvt ... e4m3x2): the instruction
//   the one-value intrinsics also compile to on sm_89 and later.
//
// Bit-exactness with the plain PyTorch version (and with the JAX reference):
// every multiply, add and divide is an explicit round-to-nearest intrinsic,
// so nvcc cannot contract a*b+c into an FMA nor turn a division into a
// multiply by a reciprocal; rounding to integers is half-to-even (rintf);
// the f8 error is clipped to +-448 before the saturating conversion; the
// bf16 -> f32 gradient upcast is exact, and a bf16 shard is the f32 mean
// rounded to nearest-even.
//
// The new error may be written in place (e_new == e): each element is read
// and written by the same lane, and the read comes first, so e and e_new
// carry no __restrict__.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQBlock = 256;        // quantizer block (elements per scale)
constexpr int kPerLane = 8;         // elements per lane: 32 * 8 = 256
constexpr int kWarpsPerCta = 8;
constexpr int kThreads = kWarpsPerCta * 32;
constexpr float kF8Max = 448.0f;
constexpr unsigned kFull = 0xffffffffu;

enum ErrKind { kErrF8 = 0, kErrBf16 = 1 };
enum DtypeKind { kF32 = 0, kBf16 = 1 };  // gradient in / shard out

// Resident CTAs of `kernel` on the whole card, once per kernel instance.
template <typename K>
long long card_ctas(K kernel) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<long long>(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

long long grid_for(long long warps, long long cap) {
  const long long ctas = (warps + kWarpsPerCta - 1) / kWarpsPerCta;
  return ctas < cap ? ctas : cap;
}

// ---------------------------------------------------------------------------
// fused_compress
// ---------------------------------------------------------------------------

// One lane's 8 elements of a block as loaded: the gradient (one 16-byte
// word of bf16, two of f32) and the error (8 B of f8, 16 B of bf16).
template <typename G, int ERR>
struct LaneIn {
  uint4 g[sizeof(G) / 2];
  typename std::conditional<ERR == kErrF8, uint2, uint4>::type e;
};

template <typename G, int ERR>
__device__ __forceinline__ LaneIn<G, ERR> load_lane(const G* g, const void* e,
                                                    long long base) {
  LaneIn<G, ERR> in;
  const uint4* gp = reinterpret_cast<const uint4*>(g + base);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(G) / 2); ++i)
    in.g[i] = __ldcs(gp + i);  // read once: stream past L2
  using E = decltype(in.e);
  in.e = *reinterpret_cast<const E*>(static_cast<const char*>(e) +
                                     base * (ERR == kErrF8 ? 1 : 2));
  return in;
}

__device__ __forceinline__ float2 f8x2_to_float2(uint32_t two) {
  __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two), __NV_E4M3);
  return __half22float2(__half2(h));
}

template <int BITS, int ERR, typename G, bool EMUL>
__device__ __forceinline__ void compress_block(
    const LaneIn<G, ERR>& in, long long blk, int lane, int8_t* payload,
    float* scales, void* e_new, float beta, float one_minus_beta,
    float escale, float einv) {
  const long long base = blk * kQBlock + lane * kPerLane;
  float gv[kPerLane], ev[kPerLane];
  if constexpr (std::is_same<G, float>::value) {
    const float* f = reinterpret_cast<const float*>(in.g);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) gv[i] = f[i];
  } else {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(in.g);
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i) {
      const float2 v = __bfloat1622float2(b[i]);  // exact upcast
      gv[2 * i] = v.x;
      gv[2 * i + 1] = v.y;
    }
  }
  if constexpr (ERR == kErrF8) {
    const uint32_t w[2] = {in.e.x, in.e.y};
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i) {
      const float2 v = f8x2_to_float2(w[i / 2] >> (16 * (i % 2)));
      // decompressor(e; s_e)
      ev[2 * i] = EMUL ? __fmul_rn(v.x, einv) : __fdiv_rn(v.x, escale);
      ev[2 * i + 1] = EMUL ? __fmul_rn(v.y, einv) : __fdiv_rn(v.y, escale);
    }
  } else {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&in.e);
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i) {
      const float2 v = __bfloat1622float2(b[i]);
      ev[2 * i] = v.x;
      ev[2 * i + 1] = v.y;
    }
  }

  float h[kPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    h[i] = __fadd_rn(gv[i], ev[i]);                    // Eqn. (2)
    amax = fmaxf(amax, fabsf(h[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));

  constexpr float qmax = static_cast<float>((1 << (BITS - 1)) - 1);
  constexpr float qmin = -static_cast<float>(1 << (BITS - 1));
  const float scale = __fdiv_rn(qmax, fmaxf(amax, 1e-30f));
  // 4 bits: lane l holds (l % 16 - 8) / scale, the value of code l % 16 - 8
  float table = 0.0f;
  if (BITS == 4) table = __fdiv_rn(static_cast<float>((lane & 15) - 8), scale);

  int q[kPerLane];
  float en[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float qf = rintf(__fmul_rn(h[i], scale));          // Eqn. (3)
    qf = fminf(fmaxf(qf, qmin), qmax);
    q[i] = static_cast<int>(qf);
    float d;                                           // decompressor(q; s)
    if (BITS == 4)  // copysign keeps the sign of a -0 code, as qf / scale does
      d = copysignf(__shfl_sync(kFull, table, q[i] + 8), qf);
    else
      d = __fdiv_rn(qf, scale);
    // Eqn. (5): (1 - beta) * e + beta * (h - d), each op rounded separately
    en[i] = __fadd_rn(__fmul_rn(one_minus_beta, ev[i]),
                      __fmul_rn(beta, __fsub_rn(h[i], d)));
  }

  if (lane == 0) scales[blk] = scale;

  if (BITS == 4) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i) {
      const uint32_t lo = static_cast<uint32_t>(q[2 * i]) & 0xFu;
      const uint32_t hi = static_cast<uint32_t>(q[2 * i + 1]) & 0xFu;
      packed |= ((hi << 4) | lo) << (8 * i);
    }
    reinterpret_cast<uint32_t*>(payload)[base / 8] = packed;
  } else {
    uint2 packed;
    uint8_t* pb = reinterpret_cast<uint8_t*>(&packed);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) pb[i] = static_cast<uint8_t>(q[i]);
    *reinterpret_cast<uint2*>(payload + base) = packed;
  }

  if constexpr (ERR == kErrF8) {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i) {
      float2 x;                                        // Eqn. (7)
      x.x = fminf(fmaxf(__fmul_rn(en[2 * i], escale), -kF8Max), kF8Max);
      x.y = fminf(fmaxf(__fmul_rn(en[2 * i + 1], escale), -kF8Max), kF8Max);
      const uint32_t two = __nv_cvt_float2_to_fp8x2(x, __NV_SATFINITE,
                                                    __NV_E4M3);
      w[i / 2] |= two << (16 * (i % 2));
    }
    *reinterpret_cast<uint2*>(static_cast<uint8_t*>(e_new) + base) =
        make_uint2(w[0], w[1]);
  } else {
    uint4 out;
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < kPerLane / 2; ++i)
      ob[i] = __floats2bfloat162_rn(en[2 * i], en[2 * i + 1]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(e_new) + base) = out;
  }
}

// One warp per 256-element block, grid-stride; the next block's loads are
// started before the current block is computed.
template <int BITS, int ERR, typename G, bool EMUL>
__global__ void __launch_bounds__(kThreads)
fused_compress_kernel(const G* __restrict__ g, const void* e,
                      int8_t* __restrict__ payload, float* __restrict__ scales,
                      void* e_new, long long n_blocks, float beta,
                      float one_minus_beta, float escale, float einv) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerCta;
  long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warp exits together
  LaneIn<G, ERR> cur = load_lane<G, ERR>(g, e, blk * kQBlock + lane * kPerLane);
  for (;;) {
    const long long next = blk + stride;
    const bool more = next < n_blocks;                // warp-uniform
    LaneIn<G, ERR> nxt{};
    if (more) nxt = load_lane<G, ERR>(g, e, next * kQBlock + lane * kPerLane);
    compress_block<BITS, ERR, G, EMUL>(cur, blk, lane, payload, scales,
                                       e_new, beta, one_minus_beta, escale,
                                       einv);
    if (!more) break;
    blk = next;
    cur = nxt;
  }
}

template <int BITS, int ERR, typename G, bool EMUL>
void launch_compress(const void* g, const void* e, int8_t* payload,
                     float* scales, void* e_new, long long n, float beta,
                     float one_minus_beta, float escale, float einv,
                     cudaStream_t stream) {
  auto kernel = fused_compress_kernel<BITS, ERR, G, EMUL>;
  static const long long cap = card_ctas(kernel);
  const long long n_blocks = n / kQBlock;
  kernel<<<static_cast<unsigned>(grid_for(n_blocks, cap)), kThreads, 0,
           stream>>>(static_cast<const G*>(g), e, payload, scales, e_new,
                     n_blocks, beta, one_minus_beta, escale, einv);
}

template <int BITS, int ERR, typename G>
void launch_compress_e(const void* g, const void* e, int8_t* payload,
                       float* scales, void* e_new, long long n, float beta,
                       float one_minus_beta, float escale, float einv,
                       cudaStream_t s) {
  if constexpr (ERR == kErrF8) {
    if (einv > 0.0f) {
      launch_compress<BITS, ERR, G, true>(g, e, payload, scales, e_new, n,
                                          beta, one_minus_beta, escale, einv,
                                          s);
      return;
    }
  }
  launch_compress<BITS, ERR, G, false>(g, e, payload, scales, e_new, n, beta,
                                       one_minus_beta, escale, einv, s);
}

template <int BITS, typename G>
int launch_compress_b(const void* g, const void* e, int8_t* payload,
                      float* scales, void* e_new, long long n, int err,
                      float beta, float one_minus_beta, float escale,
                      float einv, cudaStream_t s) {
  if (err == kErrF8)
    launch_compress_e<BITS, kErrF8, G>(g, e, payload, scales, e_new, n, beta,
                                       one_minus_beta, escale, einv, s);
  else if (err == kErrBf16)
    launch_compress_e<BITS, kErrBf16, G>(g, e, payload, scales, e_new, n,
                                         beta, one_minus_beta, escale, einv,
                                         s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// ---------------------------------------------------------------------------
// dequant_mean
// ---------------------------------------------------------------------------

// A tile is 512 payload bytes of every peer row: 1,024 elements (4 blocks)
// at 4 bits, 512 (2 blocks) at 8.  Lane l loads word j (j = 0..3) of each
// row at byte 128 j + 4 l, so each load instruction reads 128 contiguous
// bytes, and word j covers elements 256 j + 8 l .. + 7 (4-bit, block j) or
// 128 j + 4 l .. + 3 (8-bit, block j / 2): a lane's outputs are contiguous
// and so are the warp's, so every store is coalesced too.
constexpr int kTileBytes = 512;
constexpr int kWords = 4;

struct PeerIn {
  uint32_t w[kWords];
  float sa, sb;  // 4-bit: scales of the lane's table blocks; 8-bit: blocks 0,1
};

template <int BITS>
__device__ __forceinline__ PeerIn load_peer(const int8_t* payload,
                                            const float* scales, long long m,
                                            long long n_scales, long long tile,
                                            int d, int lane, int nb) {
  constexpr int kBlocksPerTile = BITS == 4 ? 4 : 2;
  PeerIn in;
  const uint32_t* row = reinterpret_cast<const uint32_t*>(
      payload + d * m + tile * kTileBytes);
  const float* srow = scales + d * n_scales + tile * kBlocksPerTile;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int blk = BITS == 4 ? j : j / 2;
    in.w[j] = blk < nb ? __ldcs(row + 32 * j + lane) : 0u;
  }
  if (BITS == 4) {  // lanes 0-15 tabulate blocks 0 and 2, lanes 16-31 1 and 3
    const int a = lane >> 4, b = 2 + (lane >> 4);
    in.sa = a < nb ? __ldg(srow + a) : 1.0f;
    in.sb = b < nb ? __ldg(srow + b) : 1.0f;
  } else {
    in.sa = __ldg(srow);
    in.sb = __ldg(srow + 1);
  }
  return in;
}

template <int BITS>
__device__ __forceinline__ void accumulate(const PeerIn& in, int lane,
                                           float* acc) {
  if (BITS == 4) {
    const float ta = __fdiv_rn(static_cast<float>((lane & 15) - 8), in.sa);
    const float tb = __fdiv_rn(static_cast<float>((lane & 15) - 8), in.sb);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const float t = j < 2 ? ta : tb;
      const int src = (j & 1) * 16;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // nibble v holds code v - 16 * (v >= 8); its table lane is v ^ 8
        const int v = (in.w[j] >> (4 * k)) & 0xF;
        const float x = __shfl_sync(kFull, t, src + (v ^ 8));
        acc[8 * j + k] = __fadd_rn(acc[8 * j + k], x);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const float s = j < 2 ? in.sa : in.sb;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int v = static_cast<int8_t>(in.w[j] >> (8 * k));
        acc[4 * j + k] =
            __fadd_rn(acc[4 * j + k], __fdiv_rn(static_cast<float>(v), s));
      }
    }
  }
}

template <int BITS, typename O>
__device__ __forceinline__ void store_tile(float* acc, O* out, long long tile,
                                           int lane, int nb, int D,
                                           float inv_d) {
  constexpr int kPerWord = BITS == 4 ? 8 : 4;
  constexpr int kTileElems = kWords * 32 * kPerWord;
  const float fd = static_cast<float>(D);
  if (inv_d > 0.0f) {
#pragma unroll
    for (int i = 0; i < kWords * kPerWord; ++i) acc[i] = __fmul_rn(acc[i], inv_d);
  } else {
#pragma unroll
    for (int i = 0; i < kWords * kPerWord; ++i) acc[i] = __fdiv_rn(acc[i], fd);
  }
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int blk = BITS == 4 ? j : j / 2;
    if (blk >= nb) continue;
    O* dst = out + tile * kTileElems + 32 * kPerWord * j + kPerWord * lane;
    if constexpr (std::is_same<O, float>::value) {
#pragma unroll
      for (int k = 0; k < kPerWord; k += 4)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(acc[kPerWord * j + k], acc[kPerWord * j + k + 1],
                        acc[kPerWord * j + k + 2], acc[kPerWord * j + k + 3]);
    } else {
      using W = typename std::conditional<kPerWord == 8, uint4, uint2>::type;
      W v;
      __nv_bfloat162* vb = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int k = 0; k < kPerWord / 2; ++k)
        vb[k] = __floats2bfloat162_rn(acc[kPerWord * j + 2 * k],
                                      acc[kPerWord * j + 2 * k + 1]);
      *reinterpret_cast<W*>(dst) = v;
    }
  }
}

// One warp per tile, grid-stride over (tile, peer) in that order; the next
// (tile, peer)'s loads are started before the current one is accumulated.
// Peers are summed in order d = 0..D-1, then the sum is divided by D: the
// reference's order.
template <int BITS, typename O>
__global__ void __launch_bounds__(kThreads)
dequant_mean_kernel(const int8_t* __restrict__ payload,
                    const float* __restrict__ scales, O* __restrict__ out,
                    int D, long long n_chunk, float inv_d) {
  constexpr int kBlocksPerTile = BITS == 4 ? 4 : 2;
  constexpr int kAcc = BITS == 4 ? 32 : 16;
  const int lane = threadIdx.x & 31;
  const long long m = BITS == 4 ? n_chunk / 2 : n_chunk;  // payload row bytes
  const long long n_scales = n_chunk / kQBlock;
  const long long n_tiles = (n_scales + kBlocksPerTile - 1) / kBlocksPerTile;
  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerCta;
  long long tile =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (tile >= n_tiles) return;
  auto blocks_in = [&](long long t) {
    const long long left = n_scales - t * kBlocksPerTile;
    return static_cast<int>(left < kBlocksPerTile ? left : kBlocksPerTile);
  };
  int d = 0;
  int nb = blocks_in(tile);
  PeerIn cur = load_peer<BITS>(payload, scales, m, n_scales, tile, 0, lane, nb);
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  for (;;) {
    long long nt = tile;
    int nd = d + 1;
    if (nd == D) {
      nd = 0;
      nt = tile + stride;
    }
    const bool more = nt < n_tiles;                    // warp-uniform
    const int nnb = more ? blocks_in(nt) : 0;
    PeerIn nxt{};
    if (more)
      nxt = load_peer<BITS>(payload, scales, m, n_scales, nt, nd, lane, nnb);
    accumulate<BITS>(cur, lane, acc);
    if (d == D - 1) {
      store_tile<BITS, O>(acc, out, tile, lane, nb, D, inv_d);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
    }
    if (!more) break;
    tile = nt;
    d = nd;
    nb = nnb;
    cur = nxt;
  }
}

template <int BITS, typename O>
void launch_dequant(const void* payload, const void* scales, void* out, int D,
                    long long n_chunk, float inv_d, cudaStream_t stream) {
  auto kernel = dequant_mean_kernel<BITS, O>;
  static const long long cap = card_ctas(kernel);
  constexpr int kBlocksPerTile = BITS == 4 ? 4 : 2;
  const long long n_scales = n_chunk / kQBlock;
  const long long tiles = (n_scales + kBlocksPerTile - 1) / kBlocksPerTile;
  kernel<<<static_cast<unsigned>(grid_for(tiles, cap)), kThreads, 0,
           stream>>>(static_cast<const int8_t*>(payload),
                     static_cast<const float*>(scales), static_cast<O*>(out),
                     D, n_chunk, inv_d);
}

}  // namespace

extern "C" {

// g (n,) f32 (g_kind=0) or bf16 (g_kind=1); e / e_new (n,) f8_e4m3fn
// (err=0) or bf16 (err=1), e_new may be e; payload (n/2,) int8 at 4 bits,
// (n,) at 8; scales (n/256,) f32.  einv > 0: the f8 error decodes as
// e * einv (einv = 1/escale exactly); einv = 0: as e / escale.
// n % 512 == 0 and all pointers 16-byte aligned (checked by the wrapper).
int loco_fused_compress(const void* g, int g_kind, const void* e,
                        void* payload, void* scales, void* e_new, long long n,
                        int bits, int err, float beta, float one_minus_beta,
                        float escale, float einv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* pp = static_cast<int8_t*>(payload);
  float* sp = static_cast<float*>(scales);
  int rc;
  if (bits == 4 && g_kind == kF32)
    rc = launch_compress_b<4, float>(g, e, pp, sp, e_new, n, err, beta,
                                     one_minus_beta, escale, einv, s);
  else if (bits == 4 && g_kind == kBf16)
    rc = launch_compress_b<4, __nv_bfloat16>(g, e, pp, sp, e_new, n, err, beta,
                                             one_minus_beta, escale, einv, s);
  else if (bits == 8 && g_kind == kF32)
    rc = launch_compress_b<8, float>(g, e, pp, sp, e_new, n, err, beta,
                                     one_minus_beta, escale, einv, s);
  else if (bits == 8 && g_kind == kBf16)
    rc = launch_compress_b<8, __nv_bfloat16>(g, e, pp, sp, e_new, n, err, beta,
                                             one_minus_beta, escale, einv, s);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// payload (D, m) int8, m = n_chunk/2 at 4 bits else n_chunk;
// scales (D, n_chunk/256) f32; out (n_chunk,) f32 (out_kind=0) or bf16
// (out_kind=1).  inv_d > 0: the peer sum is multiplied by inv_d = 1/D
// (exact, D a power of two); inv_d = 0: divided by D.
int loco_dequant_mean(const void* payload, const void* scales, void* out,
                      int out_kind, int D, long long n_chunk, int bits,
                      float inv_d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits == 4 && out_kind == kF32)
    launch_dequant<4, float>(payload, scales, out, D, n_chunk, inv_d, s);
  else if (bits == 4 && out_kind == kBf16)
    launch_dequant<4, __nv_bfloat16>(payload, scales, out, D, n_chunk, inv_d,
                                     s);
  else if (bits == 8 && out_kind == kF32)
    launch_dequant<8, float>(payload, scales, out, D, n_chunk, inv_d, s);
  else if (bits == 8 && out_kind == kBf16)
    launch_dequant<8, __nv_bfloat16>(payload, scales, out, D, n_chunk, inv_d,
                                     s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
