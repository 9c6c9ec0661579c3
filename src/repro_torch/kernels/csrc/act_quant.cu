// Hand-written Hopper (sm_90a) kernels for the MoE activation wire.
//
// act_encode  replaces src/repro/kernels/act_quant.py::act_encode (Pallas
//             body _encode_kernel): per 512-element row,
//             scale = 127 / max(absmax, 1e-30) and
//             q = clip(round(h * scale), -128, 127) as int8.
// act_decode  replaces src/repro/kernels/act_quant.py::act_decode
//             (_decode_kernel): q / scale per row, f32 out.
//
// Both are memory-bound: encode reads 4 B and writes 1 B per element (plus
// 4 B per 512-element row), decode the reverse, against two or three flops
// per element, so the H100's HBM rate sets the bound.  Encode gives each
// row to one warp: lane l loads float4 number j of the row at element
// (32 j + l) * 4, j = 0..3, so every warp-wide load covers 512 contiguous
// bytes; the row absmax is a 5-step __shfl_xor_sync reduction; each lane
// stores its four int8 quadruples at the same offsets (128 contiguous
// bytes per warp-wide store).  Decode gives each thread 4 elements: one
// 4-byte int8 load and one 16-byte f32 store, both coalesced.
//
// Bit-exactness with the plain PyTorch versions (and with the JAX
// reference): the product and the divisions are __fmul_rn / __fdiv_rn, the
// build uses --fmad=false and no fast math, rounding is half-to-even
// (rintf) and the clip is applied before the integer conversion.
//
// Plain C interface for ctypes; every entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRow = 512;              // ACT_BLOCK: elements per scale
constexpr int kVecPerLane = kRow / (32 * 4);   // float4 loads per lane: 4
constexpr int kWarpsPerCta = 8;

__global__ void __launch_bounds__(kWarpsPerCta * 32)
act_encode_kernel(const float* __restrict__ h, int8_t* __restrict__ q,
                  float* __restrict__ scales, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together
  const float4* h4 = reinterpret_cast<const float4*>(h + row * kRow);

  float4 v[kVecPerLane];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecPerLane; ++j) {
    v[j] = h4[j * 32 + lane];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                             fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = __fdiv_rn(127.0f, fmaxf(amax, 1e-30f));

  uint32_t* q4 = reinterpret_cast<uint32_t*>(q + row * kRow);
#pragma unroll
  for (int j = 0; j < kVecPerLane; ++j) {
    const float e[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float qf = rintf(__fmul_rn(e[i], scale));
      qf = fminf(fmaxf(qf, -128.0f), 127.0f);
      packed |= (static_cast<uint32_t>(static_cast<int>(qf)) & 0xFFu)
                << (8 * i);
    }
    q4[j * 32 + lane] = packed;
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void act_decode_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long quads) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= quads) return;
  const char4 c = reinterpret_cast<const char4*>(q)[t];
  const float s = scales[(t * 4) / kRow];
  float4 r;
  r.x = __fdiv_rn(static_cast<float>(c.x), s);
  r.y = __fdiv_rn(static_cast<float>(c.y), s);
  r.z = __fdiv_rn(static_cast<float>(c.z), s);
  r.w = __fdiv_rn(static_cast<float>(c.w), s);
  reinterpret_cast<float4*>(out)[t] = r;
}

}  // namespace

extern "C" {

// h (rows, 512) f32 -> q (rows, 512) int8, scales (rows,) f32.
// Pointers 16-byte aligned and contiguous (checked by the wrapper).
int act_encode(const void* h, void* q, void* scales, long long rows,
               void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = (rows + kWarpsPerCta - 1) / kWarpsPerCta;
  act_encode_kernel<<<static_cast<unsigned>(grid), kWarpsPerCta * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<int8_t*>(q),
      static_cast<float*>(scales), rows);
  return static_cast<int>(cudaGetLastError());
}

// q (rows, 512) int8, scales (rows,) f32 -> out (rows, 512) f32.
int act_decode(const void* q, const void* scales, void* out, long long rows,
               void* stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long quads = rows * (kRow / 4);
  const long long grid = (quads + threads - 1) / threads;
  act_decode_kernel<<<static_cast<unsigned>(grid), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), quads);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
