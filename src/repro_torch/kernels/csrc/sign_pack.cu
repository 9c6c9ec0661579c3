// Hand-written Hopper (sm_90a) kernel for the onebit gradient wire.
//
// onebit_pack  replaces src/repro/kernels/sign_pack.py::onebit_pack (Pallas
//              body _sign_pack_kernel): b = h > 0; 8 signs per byte, LSB
//              first (bit j of byte k = element 8k + j); error feedback
//              e_new = h - (2b - 1) * scale rounded to bf16.
//
// Memory-bound: 4 B of f32 in, 1/8 B of signs and 2 B of bf16 error out per
// element (6.125 B) against one compare and one subtract, so the HBM rate
// sets the bound.  One thread per output byte: two 16-byte loads of its 8
// consecutive floats, one 1-byte sign store and one 16-byte bf16 store.
// The L1 scale is a device scalar (computed by the caller as mean|h|), read
// through a pointer so the host never waits for it.
//
// Bit-exactness: (2b - 1) * scale is exactly +-scale, the subtraction is
// __fsub_rn and the bf16 rounding __float2bfloat16_rn (round to nearest
// even, as the reference's cast); an exact or negative zero encodes as
// bit 0 (-scale), as the reference's codec documents.
//
// Plain C interface for ctypes; the entry point returns cudaGetLastError().
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void onebit_pack_kernel(const float* __restrict__ h,
                                   const float* __restrict__ scale,
                                   uint8_t* __restrict__ packed,
                                   __nv_bfloat16* __restrict__ e_new,
                                   long long n_bytes) {
  const long long k =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n_bytes) return;
  const float s = *scale;
  const float4* h4 = reinterpret_cast<const float4*>(h) + 2 * k;
  const float4 a = h4[0], b = h4[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  uint32_t byte = 0;
  uint4 out;
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool bit = v[j] > 0.0f;
    byte |= static_cast<uint32_t>(bit) << j;
    ob[j] = __float2bfloat16_rn(__fsub_rn(v[j], bit ? s : -s));
  }
  packed[k] = static_cast<uint8_t>(byte);
  reinterpret_cast<uint4*>(e_new)[k] = out;
}

}  // namespace

extern "C" {

// h (n,) f32, scale () f32 on the device -> packed (n/8,) u8, e_new (n,)
// bf16.  n % 512 == 0 and pointers 16-byte aligned (checked by the wrapper).
int onebit_pack(const void* h, const void* scale, void* packed, void* e_new,
                long long n, void* stream) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long n_bytes = n / 8;
  const long long grid = (n_bytes + threads - 1) / threads;
  onebit_pack_kernel<<<static_cast<unsigned>(grid), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(scale),
      static_cast<uint8_t*>(packed), static_cast<__nv_bfloat16*>(e_new),
      n_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
