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
// Both are memory-bound byte shuffling: fused_compress moves about 6.5 B per
// element (f32 gradient in, f8 error in and out, half a byte of payload out)
// against a handful of flops, so the H100's 3.35 TB/s sets the bound.  The
// design keeps every byte to one read or one write: one warp per quantizer
// block, 8 contiguous elements per lane (two 16-byte gradient loads, one
// 8-byte f8 error load, one 4-byte payload store), the block absmax as a
// warp shuffle reduction, nothing staged through shared memory.
//
// Bit-exactness with the plain PyTorch version (and with the JAX reference):
// every multiply, add and divide is an explicit round-to-nearest intrinsic,
// so nvcc cannot contract a*b+c into an FMA nor turn a division into a
// multiply by a reciprocal; rounding to integers is half-to-even (rintf);
// the f8 error is clipped to +-448 before the saturating conversion.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQBlock = 256;        // quantizer block (elements per scale)
constexpr int kPerLane = 8;         // elements per lane: 32 * 8 = 256
constexpr int kWarpsPerCta = 8;
constexpr float kF8Max = 448.0f;

enum ErrKind { kErrF8 = 0, kErrBf16 = 1 };

__device__ __forceinline__ float f8_to_float(uint8_t b) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(static_cast<__nv_fp8_storage_t>(b),
                                         __NV_E4M3);
  return __half2float(__half(h));
}

__device__ __forceinline__ uint8_t float_to_f8(float x) {
  return static_cast<uint8_t>(
      __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

template <int BITS, int ERR>
__global__ void __launch_bounds__(kWarpsPerCta * 32)
fused_compress_kernel(const float* __restrict__ g, const void* __restrict__ e,
                      int8_t* __restrict__ payload, float* __restrict__ scales,
                      void* __restrict__ e_new, long long n_blocks,
                      float beta, float one_minus_beta, float escale) {
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warp exits together
  const long long base = blk * kQBlock + lane * kPerLane;

  float gv[kPerLane], ev[kPerLane];
  const float4* g4 = reinterpret_cast<const float4*>(g + base);
  float4 a = g4[0], b = g4[1];
  gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
  gv[4] = b.x; gv[5] = b.y; gv[6] = b.z; gv[7] = b.w;

  if (ERR == kErrF8) {
    uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(e) + base);
    const uint8_t* eb = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      ev[i] = __fdiv_rn(f8_to_float(eb[i]), escale);  // decompressor(e; s_e)
  } else {
    uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(e) + base);
    const __nv_bfloat16* eb = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) ev[i] = __bfloat162float(eb[i]);
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
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  constexpr float qmax = static_cast<float>((1 << (BITS - 1)) - 1);
  constexpr float qmin = -static_cast<float>(1 << (BITS - 1));
  const float scale = __fdiv_rn(qmax, fmaxf(amax, 1e-30f));

  int q[kPerLane];
  float en[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    float qf = rintf(__fmul_rn(h[i], scale));          // Eqn. (3)
    qf = fminf(fmaxf(qf, qmin), qmax);
    q[i] = static_cast<int>(qf);
    const float d = __fdiv_rn(qf, scale);              // decompressor(q; s)
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

  if (ERR == kErrF8) {
    uint2 out;
    uint8_t* ob = reinterpret_cast<uint8_t*>(&out);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float x = fminf(fmaxf(__fmul_rn(en[i], escale), -kF8Max), kF8Max);
      ob[i] = float_to_f8(x);                          // Eqn. (7)
    }
    *reinterpret_cast<uint2*>(static_cast<uint8_t*>(e_new) + base) = out;
  } else {
    uint4 out;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) ob[i] = __float2bfloat16_rn(en[i]);
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(e_new) + base) = out;
  }
}

// One thread per pair of output elements (one payload byte at 4 bits, two
// at 8 bits); the D peer rows are summed in order d = 0..D-1 and the sum is
// divided by D, the reference's sum-then-divide order.
template <int BITS>
__global__ void dequant_mean_kernel(const int8_t* __restrict__ payload,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, int D,
                                    long long n_chunk) {
  const long long pair = static_cast<long long>(blockIdx.x) * blockDim.x +
                         threadIdx.x;
  const long long i0 = pair * 2;
  if (i0 >= n_chunk) return;
  const long long m = BITS == 4 ? n_chunk / 2 : n_chunk;  // payload row length
  const long long n_scales = n_chunk / kQBlock;
  const long long sblk = i0 / kQBlock;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int d = 0; d < D; ++d) {
    const int8_t* row = payload + d * m;
    float v0, v1;
    if (BITS == 4) {
      const uint8_t byte = static_cast<uint8_t>(row[pair]);
      int lo = byte & 0xF, hi = (byte >> 4) & 0xF;
      lo = lo >= 8 ? lo - 16 : lo;                     // sign-extend nibbles
      hi = hi >= 8 ? hi - 16 : hi;
      v0 = static_cast<float>(lo);
      v1 = static_cast<float>(hi);
    } else {
      const char2 two = reinterpret_cast<const char2*>(row)[pair];
      v0 = static_cast<float>(two.x);
      v1 = static_cast<float>(two.y);
    }
    const float s = scales[d * n_scales + sblk];
    acc0 = __fadd_rn(acc0, __fdiv_rn(v0, s));
    acc1 = __fadd_rn(acc1, __fdiv_rn(v1, s));
  }
  const float fd = static_cast<float>(D);
  float2 r;
  r.x = __fdiv_rn(acc0, fd);
  r.y = __fdiv_rn(acc1, fd);
  reinterpret_cast<float2*>(out)[pair] = r;
}

template <int BITS, int ERR>
void launch_compress(const float* g, const void* e, int8_t* payload,
                     float* scales, void* e_new, long long n, float beta,
                     float one_minus_beta, float escale, cudaStream_t stream) {
  const long long n_blocks = n / kQBlock;
  const long long grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  fused_compress_kernel<BITS, ERR>
      <<<static_cast<unsigned>(grid), kWarpsPerCta * 32, 0, stream>>>(
          g, e, payload, scales, e_new, n_blocks, beta, one_minus_beta,
          escale);
}

}  // namespace

extern "C" {

// g (n,) f32; e / e_new (n,) f8_e4m3fn (err=0) or bf16 (err=1);
// payload (n/2,) int8 at 4 bits, (n,) at 8; scales (n/256,) f32.
// n % 512 == 0 and all pointers 16-byte aligned (checked by the wrapper).
int loco_fused_compress(const void* g, const void* e, void* payload,
                        void* scales, void* e_new, long long n, int bits,
                        int err, float beta, float one_minus_beta,
                        float escale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  int8_t* pp = static_cast<int8_t*>(payload);
  float* sp = static_cast<float*>(scales);
  if (bits == 4 && err == kErrF8)
    launch_compress<4, kErrF8>(gp, e, pp, sp, e_new, n, beta, one_minus_beta,
                               escale, s);
  else if (bits == 8 && err == kErrF8)
    launch_compress<8, kErrF8>(gp, e, pp, sp, e_new, n, beta, one_minus_beta,
                               escale, s);
  else if (bits == 4 && err == kErrBf16)
    launch_compress<4, kErrBf16>(gp, e, pp, sp, e_new, n, beta,
                                 one_minus_beta, escale, s);
  else if (bits == 8 && err == kErrBf16)
    launch_compress<8, kErrBf16>(gp, e, pp, sp, e_new, n, beta,
                                 one_minus_beta, escale, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// payload (D, m) int8, m = n_chunk/2 at 4 bits else n_chunk;
// scales (D, n_chunk/256) f32; out (n_chunk,) f32.
int loco_dequant_mean(const void* payload, const void* scales, void* out,
                      int D, long long n_chunk, int bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long pairs = n_chunk / 2;
  const unsigned grid = static_cast<unsigned>((pairs + threads - 1) / threads);
  const int8_t* pp = static_cast<const int8_t*>(payload);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  if (bits == 4)
    dequant_mean_kernel<4><<<grid, threads, 0, s>>>(pp, sp, op, D, n_chunk);
  else if (bits == 8)
    dequant_mean_kernel<8><<<grid, threads, 0, s>>>(pp, sp, op, D, n_chunk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
