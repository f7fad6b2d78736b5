// cim_matmul: the paper's AF / PF macro tiling as a blocked matmul.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cim_matmul.py
// (cim_matmul -> _kernel_af / _kernel_pf): [M, K] @ [K, N] in BM x BN x BK
// blocks, out in a's dtype (float32 or bfloat16).  The two schedules are
// the paper's two loop orders and stay two kernels here:
//
//   AF  a block owns one BM x BN output tile, loops over K with the sum in
//       fp32 registers and writes the tile once (the psum register).
//   PF  a block owns one BM-row tile of A and a range of N tiles; K is its
//       outer loop.  Per K block it keeps the A tile in shared memory while
//       it sweeps its N tiles, and read-modify-writes each output tile in
//       global memory at the output dtype: the block's fp32 partial sum is
//       rounded to the output dtype and added there, as _kernel_pf does
//       (the Output-SRAM psum traffic of the paper).  No two blocks touch
//       one output tile, so there are no atomics.  N is split across blocks
//       so that a small M (bert-large's 512 rows are four tiles) still
//       fills the card.
//
// What bounds it on an H100: operations.  At the bert-large FFN shape
// (512 x 1024 x 4096) the product is 4.3 GFLOP against 13.6 MB (bf16) or
// 27 MB (fp32) of inputs and output, far right of the ridge point for either
// type.  This first version computes on the CUDA cores in true fp32 (no
// TF32; bf16 inputs are widened to fp32 on load), so its ceiling is the
// 67 TFLOP/s fp32 rate, not the tensor cores.  The design keeps the card
// busy on that path: 256 threads per block, each holding a (BM/16) x
// (BN/16) register tile of the sum; A and B tiles staged in dynamic shared
// memory (A transposed with one column of padding, so both the transposing
// store and the broadcast reads are free of bank conflicts); every global
// load coalesced along a row.  wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, each a register tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A[m0:m0+BM, k0:k0+BK] -> As[BK][BM+1] (transposed, zero outside A)
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_a(float* As, const T* a, int M, int K,
                                       int m0, int k0) {
  for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
    const int r = idx / BK, c = idx % BK;
    const int gr = m0 + r, gc = k0 + c;
    As[c * (BM + 1) + r] =
        (gr < M && gc < K) ? to_f(a[static_cast<size_t>(gr) * K + gc]) : 0.f;
  }
}

// B[k0:k0+BK, n0:n0+BN] -> Bs[BK][BN] (zero outside B)
template <typename T, int BN, int BK>
__device__ __forceinline__ void load_b(float* Bs, const T* b, int K, int N,
                                       int k0, int n0) {
  for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
    const int r = idx / BN, c = idx % BN;
    const int gr = k0 + r, gc = n0 + c;
    Bs[idx] = (gr < K && gc < N) ? to_f(b[static_cast<size_t>(gr) * N + gc]) : 0.f;
  }
}

// acc[i][j] += sum over the staged BK of As[kk][row_i] * Bs[kk][col_j],
// row_i = ty + 16 i, col_j = tx + 16 j, k in order
template <int BM, int BN, int BK>
__device__ __forceinline__ void mma_tile(float (&acc)[BM / 16][BN / 16],
                                         const float* As, const float* Bs,
                                         int ty, int tx) {
#pragma unroll 4
  for (int kk = 0; kk < BK; ++kk) {
    float av[BM / 16], bv[BN / 16];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i) av[i] = As[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) bv[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
af_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
          int M, int N, int K) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + BK * (BM + 1);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load_a<T, BM, BK>(As, a, M, K, m0, k0);
    load_b<T, BN, BK>(Bs, b, K, N, k0, n0);
    __syncthreads();
    mma_tile<BM, BN, BK>(acc, As, Bs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) c[static_cast<size_t>(r) * N + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
pf_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ c,
          int M, int N, int K, int tiles_per_block) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Bs = smem + BK * (BM + 1);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int m0 = blockIdx.x * BM;
  const int gn = (N + BN - 1) / BN;
  const int j_lo = blockIdx.y * tiles_per_block;
  const int j_hi = min(j_lo + tiles_per_block, gn);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    load_a<T, BM, BK>(As, a, M, K, m0, k0);       // resident across the N sweep
    for (int jt = j_lo; jt < j_hi; ++jt) {
      const int n0 = jt * BN;
      __syncthreads();
      load_b<T, BN, BK>(Bs, b, K, N, k0, n0);
      __syncthreads();
      float acc[BM / 16][BN / 16];
#pragma unroll
      for (int i = 0; i < BM / 16; ++i)
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
      mma_tile<BM, BN, BK>(acc, As, Bs, ty, tx);
      // the partial sum, rounded to the output dtype, added at that dtype
#pragma unroll
      for (int i = 0; i < BM / 16; ++i) {
        const int r = m0 + ty + 16 * i;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col >= N) continue;
          T* out = c + static_cast<size_t>(r) * N + col;
          const T part = from_f<T>(acc[i][j]);
          *out = k0 == 0 ? part : from_f<T>(to_f(*out) + to_f(part));
        }
      }
    }
  }
}

template <int BM, int BN, int BK>
constexpr size_t smem_bytes() {
  return (static_cast<size_t>(BK) * (BM + 1) + static_cast<size_t>(BK) * BN) *
         sizeof(float);
}

template <typename T, int BM, int BN, int BK>
int launch(int pf, const void* a, const void* b, void* c, int M, int N, int K,
           int tiles_per_block, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM, BN, BK>();
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  if (pf) {
    auto kern = pf_kernel<T, BM, BN, BK>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid(gm, (gn + tiles_per_block - 1) / tiles_per_block);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b),
                                          static_cast<T*>(c), M, N, K,
                                          tiles_per_block);
  } else {
    auto kern = af_kernel<T, BM, BN, BK>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    const dim3 grid(gn, gm);
    kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(a),
                                          static_cast<const T*>(b),
                                          static_cast<T*>(c), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int pf, int bm, int bn, int bk, const void* a, const void* b,
             void* c, int M, int N, int K, int tiles_per_block,
             cudaStream_t stream) {
#define CIM_TILE(BM_, BN_, BK_)                                              \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                   \
    return launch<T, BM_, BN_, BK_>(pf, a, b, c, M, N, K, tiles_per_block,   \
                                    stream);
  CIM_TILE(128, 128, 128)
  CIM_TILE(128, 128, 64)
  CIM_TILE(128, 64, 128)
  CIM_TILE(128, 64, 64)
  CIM_TILE(64, 128, 128)
  CIM_TILE(64, 128, 64)
  CIM_TILE(64, 64, 128)
  CIM_TILE(64, 64, 64)
#undef CIM_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a [M, K], b [K, N] -> c [M, N], all of one dtype (0: float32, 1:
// bfloat16), contiguous.  pf = 0 runs AF, 1 runs PF (each PF block sweeps
// tiles_per_block N tiles).  bm, bn, bk in {64, 128}.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int cim_matmul(int dtype, int pf, int bm, int bn, int bk, const void* a,
               const void* b, void* c, int M, int N, int K,
               int tiles_per_block, void* stream) {
  if (M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(pf, bm, bn, bk, a, b, c, M, N, K, tiles_per_block, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(pf, bm, bn, bk, a, b, c, M, N, K,
                                   tiles_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
