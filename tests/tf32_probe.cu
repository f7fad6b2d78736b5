// tf32_probe: one wgmma m64n64k8 .tf32 product, to show on the card how the
// tensor cores read an fp32 word as a tf32 operand and that the fp32
// routes' operand layouts are right.  Built by
// tests/test_torch_kernels_cuda.py (nvcc, -I the kernels' csrc).
//
// a [64, 8] and b [64, 8] (row n of b is column n of B) fp32 as they are,
// with no split; d [64, 64] = A B in fp32.  rs = 0 stores A and B^T into
// 128-byte-swizzled K-major tiles with sw128_offset, as the fp32 routes'
// producers do, and reads both through descriptors (wgmma_tf32_ss); rs = 1
// reads A from registers in the layout hopper.cuh states (wgmma_tf32_rs).
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

__global__ void __launch_bounds__(128, 1)
probe_kernel(int rs, const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ d) {
  __shared__ __align__(1024) uint8_t tiles[2 * 64 * 128];
  uint8_t* a_s = tiles;
  uint8_t* b_s = tiles + 64 * 128;
  const int t = threadIdx.x;
  for (int idx = t; idx < 64 * 8; idx += 128) {      // (row, 16-byte chunk)
    const int r = idx / 8, c = idx % 8;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (c < 2) {
      av = *reinterpret_cast<const float4*>(a + r * 8 + 4 * c);
      bv = *reinterpret_cast<const float4*>(b + r * 8 + 4 * c);
    }
    *reinterpret_cast<float4*>(a_s + hopper::sw128_offset(r, c)) = av;
    *reinterpret_cast<float4*>(b_s + hopper::sw128_offset(r, c)) = bv;
  }
  hopper::fence_proxy_async();
  __syncthreads();
  float acc[32];
  hopper::zero(acc);
  const uint64_t db = hopper::desc_sw128(b_s, 16, 1024);
  const int lane = t % 32, g = 16 * (t / 32) + lane / 4, c = lane % 4;
  const uint32_t frag[4] = {__float_as_uint(a[g * 8 + c]),
                            __float_as_uint(a[(g + 8) * 8 + c]),
                            __float_as_uint(a[g * 8 + c + 4]),
                            __float_as_uint(a[(g + 8) * 8 + c + 4])};
  hopper::wgmma_fence();
  if (rs)
    hopper::wgmma_tf32_rs<64>(acc, frag, db);
  else
    hopper::wgmma_tf32_ss<64>(acc, hopper::desc_sw128(a_s, 16, 1024), db);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
#pragma unroll
  for (int cc = 0; cc < 8; ++cc)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        d[(g + 8 * i) * 64 + 8 * cc + 2 * c + j] = acc[4 * cc + 2 * i + j];
}

}  // namespace

extern "C" int tf32_probe(int rs, const float* a, const float* b, float* d,
                          void* stream) {
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(rs, a, b, d);
  return static_cast<int>(cudaGetLastError());
}
