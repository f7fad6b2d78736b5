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
// type.  Each dtype has its own route:
//
// bfloat16: the tensor cores (wgmma) fed by TMA.  A block is one producer
//   warpgroup, whose first thread issues TMA loads, and BM / 64 consumer
//   warpgroups, each issuing wgmma.m64nBNk16 over its 64 rows.  Tiles land
//   128-byte swizzled (hopper.cuh) in a ring of stages guarded by mbarriers
//   (full: the bytes have landed; empty: every consumer warp is done with
//   the stage), so the loads of later K blocks overlap the products of the
//   current one.  A [M, K] is K-major; B [K, N] is MN-major, read with
//   wgmma's transpose bit, as 64-wide N boxes.  The sum stays in fp32
//   registers; the epilogue rounds to bf16 once (AF) or once per K block and
//   adds at bf16 (PF), storing with masks at the ragged edges.  AF's stage
//   is one BK-wide K block of A and B.  PF keeps two A buffers (the K
//   block's A tile stays resident while the block's N tiles of B stream
//   through a 3- or 4-stage ring, and the next K block's A loads
//   meanwhile); its read-modify-write of the output goes through a staging
//   tile in shared memory, so global memory sees whole 16-byte chunks.
//   TMA needs 16-byte row strides: the wrapper pads K and N to multiples of
//   8 only where they are not, and rows past an edge load as zeros.  Its
//   ceiling is the 989 TFLOP/s bf16 tensor-core rate.
//
// float32: the first version's design (the port keeps fp32 out of TF32, and
//   TF32 wgmma takes only K-major operands).  It computes on the CUDA cores
//   in true fp32, so its ceiling is the 67 TFLOP/s fp32 rate: 256 threads
//   per block, each holding a (BM/16) x (BN/16) register tile of the sum; A
//   and B tiles staged in dynamic shared memory (A transposed with one
//   column of padding, so both the transposing store and the broadcast
//   reads are free of bank conflicts); every global load coalesced along a
//   row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;   // 16 x 16 threads, each a register tile

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---- bfloat16: wgmma + TMA ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;                      // threads of a warpgroup

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int NC = BM / 64;         // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * WG;  // + the producer warpgroup
  static constexpr int A_BYTES = BM * BK * 2;    // BK / 64 boxes [BM x 64]
  static constexpr int B_BYTES = BK * BN * 2;    // BN / 64 boxes [BK x 64]
  static constexpr int AF_STAGES = A_BYTES + B_BYTES >= 65536 ? 3 : 4;
  static constexpr size_t AF_SMEM =
      1024 + AF_STAGES * (A_BYTES + B_BYTES) + 2 * AF_STAGES * 8;
  // PF: two A buffers, the B ring, and a staging tile per consumer
  // warpgroup for the epilogue ([64][BN + 8] bf16)
  static constexpr int STAGE_BYTES = NC * 64 * (BN + 8) * 2;
  static constexpr int PF_STAGES =
      1024 + 2 * A_BYTES + 4 * B_BYTES + STAGE_BYTES + 96 <= 232448 ? 4 : 3;
  static constexpr size_t PF_SMEM = 1024 + 2 * A_BYTES + PF_STAGES * B_BYTES +
                                    STAGE_BYTES + 2 * (2 + PF_STAGES) * 8;
};

// the K block at k0 of A (rows m0..) and of B (columns n0..) into one stage
template <int BM, int BK>
__device__ __forceinline__ void load_a(uint8_t* dst, const CUtensorMap* map,
                                       uint64_t* bar, int k0, int m0) {
#pragma unroll
  for (int s = 0; s < BK / 64; ++s)
    hopper::tma_load_2d(dst + s * BM * 128, map, bar, k0 + 64 * s, m0);
}

template <int BN, int BK>
__device__ __forceinline__ void load_b(uint8_t* dst, const CUtensorMap* map,
                                       uint64_t* bar, int k0, int n0) {
#pragma unroll
  for (int c = 0; c < BN / 64; ++c)
    hopper::tma_load_2d(dst + c * BK * 128, map, bar, n0 + 64 * c, k0);
}

// acc += A[64 rows of warpgroup wg, BK] @ B[BK, BN] from one staged K block;
// issued and committed, not waited for
template <int BM, int BN, int BK>
__device__ __forceinline__ void mma_block(float (&acc)[BN / 2],
                                          const uint8_t* a, const uint8_t* b,
                                          int wg) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint8_t* ak = a + (kk / 4) * BM * 128 + wg * 64 * 128 + (kk % 4) * 32;
    hopper::wgmma_ss<1>(acc, hopper::desc_sw128(ak, 16, 1024),
                        hopper::desc_sw128(b + kk * 2048, BK * 128, 1024));
  }
  hopper::wgmma_commit();
}

// bar.sync among the 128 threads of one warpgroup (id 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WG) : "memory");
}

// Visit this thread's accumulator entries as (row, column) pairs of the
// tile: f(row, col, idx, v0, v1) with v0 = acc[idx], v1 = acc[idx + 1] the
// values at columns col, col + 1.
template <int BN, typename F>
__device__ __forceinline__ void for_pairs(const float (&acc)[BN / 2], int wg,
                                          F&& f) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x % WG) / 32;
#pragma unroll
  for (int c = 0; c < BN / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      f(wg * 64 + 16 * w + lane / 4 + 8 * i, 8 * c + 2 * (lane % 4),
        4 * c + 2 * i, acc[4 * c + 2 * i], acc[4 * c + 2 * i + 1]);
}

__device__ __forceinline__ void store_pair(bf16* c, int row, int col, int N,
                                           float v0, float v1) {
  bf16* p = c + static_cast<size_t>(row) * N + col;
  if ((N & 1) == 0 && col + 1 < N) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (col < N) p[0] = __float2bfloat16_rn(v0);
    if (col + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

// The PF epilogue: out = first ? bf16(part) : bf16(out + bf16(part)) over
// the warpgroup's 64 x BN slice of the tile, as _kernel_pf adds.  The
// rounded partial sums go through the warpgroup's staging tile in shared
// memory (rows padded by 16 bytes: free of bank conflicts), so that the
// output is read and written in whole 16-byte chunks, neighbouring threads
// on neighbouring chunks, and all of a thread's old chunks are loaded
// before any is written back.
template <int BN>
__device__ __forceinline__ void add_tile(bf16* c, const float (&acc)[BN / 2],
                                         bf16* stage, int wg, int m0, int n0,
                                         int M, int N, bool first) {
  constexpr int LD = BN + 8, CHUNKS = BN / 8, PER_THREAD = 64 * CHUNKS / WG;
  for_pairs<BN>(acc, wg, [&](int r, int col, int, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(stage + (r - wg * 64) * LD + col) =
        __floats2bfloat162_rn(v0, v1);
  });
  named_barrier(1 + wg);
  const int t = threadIdx.x % WG;
  const bool vec = N % 8 == 0;
  uint4 old[PER_THREAD];
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int r = (t + u * WG) / CHUNKS, col = n0 + (t + u * WG) % CHUNKS * 8;
    const int row = m0 + wg * 64 + r;
    old[u] = make_uint4(0, 0, 0, 0);
    if (!first && vec && row < M && col + 8 <= N)
      old[u] = *reinterpret_cast<const uint4*>(c + static_cast<size_t>(row) * N + col);
  }
#pragma unroll
  for (int u = 0; u < PER_THREAD; ++u) {
    const int r = (t + u * WG) / CHUNKS, col = n0 + (t + u * WG) % CHUNKS * 8;
    const int row = m0 + wg * 64 + r;
    if (row >= M) continue;
    const bf16* part = stage + r * LD + (t + u * WG) % CHUNKS * 8;
    bf16* out = c + static_cast<size_t>(row) * N + col;
    if (vec && col + 8 <= N) {
      uint4 sum = *reinterpret_cast<const uint4*>(part);
      if (!first) {
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&old[u]);
        auto* s2 = reinterpret_cast<__nv_bfloat162*>(&sum);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(o2[j]), y = __bfloat1622float2(s2[j]);
          s2[j] = __floats2bfloat162_rn(x.x + y.x, x.y + y.y);
        }
      }
      *reinterpret_cast<uint4*>(out) = sum;
    } else {
      for (int j = 0; j < 8 && col + j < N; ++j)
        out[j] = first ? part[j]
                       : __float2bfloat16_rn(__bfloat162float(out[j]) +
                                             __bfloat162float(part[j]));
    }
  }
  named_barrier(1 + wg);                      // the staging tile is free again
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Tile<BM, BN, BK>::THREADS, 1)
af_kernel(const __grid_constant__ CUtensorMap a_map,
          const __grid_constant__ CUtensorMap b_map, bf16* __restrict__ c,
          int M, int N, int K) {
  using T = Tile<BM, BN, BK>;
  constexpr int S = T::AF_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = hopper::align1024(smem_raw);           // [S][A_BYTES]
  uint8_t* b_s = a_s + S * T::A_BYTES;                  // [S][B_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + S * T::B_BYTES);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], T::NC * 4);      // one arrival per warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == T::NC) {                                 // producer
    if (threadIdx.x == T::NC * WG) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        hopper::mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], T::A_BYTES + T::B_BYTES);
        load_a<BM, BK>(a_s + s * T::A_BYTES, &a_map, &full[s], kt * BK, m0);
        load_b<BN, BK>(b_s + s * T::B_BYTES, &b_map, &full[s], kt * BK, n0);
      }
    }
    return;
  }
  const bool leader = threadIdx.x % 32 == 0;
  float acc[BN / 2];
  hopper::zero(acc);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % S;
    hopper::mbar_wait(&full[s], (kt / S) & 1);
    mma_block<BM, BN, BK>(acc, a_s + s * T::A_BYTES, b_s + s * T::B_BYTES, wg);
    hopper::wgmma_wait<1>();                  // the previous block is done
    if (kt > 0 && leader) hopper::mbar_arrive(&empty[(kt - 1) % S]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  for_pairs<BN>(acc, wg, [&](int r, int col, int, float v0, float v1) {
    if (m0 + r < M) store_pair(c, m0 + r, n0 + col, N, v0, v1);
  });
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(Tile<BM, BN, BK>::THREADS, 1)
pf_kernel(const __grid_constant__ CUtensorMap a_map,
          const __grid_constant__ CUtensorMap b_map, bf16* __restrict__ c,
          int M, int N, int K, int tiles_per_block) {
  using T = Tile<BM, BN, BK>;
  constexpr int S = T::PF_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = hopper::align1024(smem_raw);           // [2][A_BYTES]
  uint8_t* b_s = a_s + 2 * T::A_BYTES;                  // [S][B_BYTES]
  bf16* staging = reinterpret_cast<bf16*>(b_s + S * T::B_BYTES);
  uint64_t* a_full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(staging) + T::STAGE_BYTES);
  uint64_t* a_empty = a_full + 2;
  uint64_t* b_full = a_empty + 2;
  uint64_t* b_empty = b_full + S;
  const int m0 = blockIdx.x * BM;
  const int gn = (N + BN - 1) / BN;
  const int j_lo = blockIdx.y * tiles_per_block;
  const int j_hi = min(j_lo + tiles_per_block, gn);
  const int nk = (K + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&a_full[s], 1);
      hopper::mbar_init(&a_empty[s], T::NC * 4);
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&b_full[s], 1);
      hopper::mbar_init(&b_empty[s], T::NC * 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == T::NC) {                                 // producer
    if (threadIdx.x == T::NC * WG) {
      int it = 0;
      for (int kb = 0; kb < nk; ++kb) {
        const int a = kb & 1;
        hopper::mbar_wait(&a_empty[a], ((kb >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&a_full[a], T::A_BYTES);
        load_a<BM, BK>(a_s + a * T::A_BYTES, &a_map, &a_full[a], kb * BK, m0);
        for (int jt = j_lo; jt < j_hi; ++jt, ++it) {
          const int s = it % S;
          hopper::mbar_wait(&b_empty[s], ((it / S) & 1) ^ 1);
          hopper::mbar_expect_tx(&b_full[s], T::B_BYTES);
          load_b<BN, BK>(b_s + s * T::B_BYTES, &b_map, &b_full[s], kb * BK,
                         jt * BN);
        }
      }
    }
    return;
  }
  const bool leader = threadIdx.x % 32 == 0;
  int it = 0;
  for (int kb = 0; kb < nk; ++kb) {
    const int a = kb & 1;
    hopper::mbar_wait(&a_full[a], (kb >> 1) & 1);    // resident for the sweep
    for (int jt = j_lo; jt < j_hi; ++jt, ++it) {
      const int s = it % S;
      hopper::mbar_wait(&b_full[s], (it / S) & 1);
      float acc[BN / 2];                             // this K block only
      hopper::zero(acc);
      mma_block<BM, BN, BK>(acc, a_s + a * T::A_BYTES, b_s + s * T::B_BYTES,
                            wg);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (leader) hopper::mbar_arrive(&b_empty[s]);
      add_tile<BN>(c, acc, staging + wg * 64 * (BN + 8), wg, m0, jt * BN, M,
                   N, kb == 0);
    }
    if (leader) hopper::mbar_arrive(&a_empty[a]);
  }
}

// a [M, K] with rows lda apart, b [K, N] with rows ldb apart (lda, ldb
// multiples of 8, bases 16-byte aligned) -> c [M, N] contiguous
template <int BM, int BN, int BK>
int launch(int pf, const void* a, const void* b, void* c, int M, int N, int K,
           int lda, int ldb, int tiles_per_block, cudaStream_t stream) {
  using T = Tile<BM, BN, BK>;
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[2] = {static_cast<uint64_t>(K), static_cast<uint64_t>(M)};
  const uint64_t a_strides[1] = {static_cast<uint64_t>(lda) * 2};
  const uint32_t a_box[2] = {64, BM};
  const uint64_t b_dims[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t b_strides[1] = {static_cast<uint64_t>(ldb) * 2};
  const uint32_t b_box[2] = {64, BK};
  if (!hopper::bf16_map(&a_map, a, 2, a_dims, a_strides, a_box) ||
      !hopper::bf16_map(&b_map, b, 2, b_dims, b_strides, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gm = (M + BM - 1) / BM, gn = (N + BN - 1) / BN;
  auto* out = static_cast<bf16*>(c);
  if (pf) {
    auto kern = pf_kernel<BM, BN, BK>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(T::PF_SMEM));
    const dim3 grid(gm, (gn + tiles_per_block - 1) / tiles_per_block);
    kern<<<grid, T::THREADS, T::PF_SMEM, stream>>>(a_map, b_map, out, M, N, K,
                                                   tiles_per_block);
  } else {
    auto kern = af_kernel<BM, BN, BK>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(T::AF_SMEM));
    kern<<<dim3(gn, gm), T::THREADS, T::AF_SMEM, stream>>>(a_map, b_map, out,
                                                          M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int pf, int bm, int bn, int bk, const void* a, const void* b,
             void* c, int M, int N, int K, int lda, int ldb,
             int tiles_per_block, cudaStream_t stream) {
#define CIM_TC_TILE(BM_, BN_, BK_)                                           \
  if (bm == BM_ && bn == BN_ && bk == BK_)                                   \
    return launch<BM_, BN_, BK_>(pf, a, b, c, M, N, K, lda, ldb,             \
                                 tiles_per_block, stream);
  CIM_TC_TILE(128, 128, 128)
  CIM_TC_TILE(128, 128, 64)
  CIM_TC_TILE(128, 64, 128)
  CIM_TC_TILE(128, 64, 64)
  CIM_TC_TILE(64, 128, 128)
  CIM_TC_TILE(64, 128, 64)
  CIM_TC_TILE(64, 64, 128)
  CIM_TC_TILE(64, 64, 64)
#undef CIM_TC_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

extern "C" {

// a [M, K] (rows lda apart), b [K, N] (rows ldb apart) -> c [M, N]
// contiguous, all of one dtype (0: float32, which needs lda = K and ldb = N;
// 1: bfloat16, which needs lda and ldb multiples of 8 and 16-byte-aligned
// bases, for TMA).  pf = 0 runs AF, 1 runs PF (each PF block sweeps
// tiles_per_block N tiles).  bm, bn, bk in {64, 128}.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int cim_matmul(int dtype, int pf, int bm, int bn, int bk, const void* a,
               const void* b, void* c, int M, int N, int K, int lda, int ldb,
               int tiles_per_block, void* stream) {
  if (M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && lda == K && ldb == N)
    return dispatch<float>(pf, bm, bn, bk, a, b, c, M, N, K, tiles_per_block, s);
  if (dtype == 1 && lda % 8 == 0 && ldb % 8 == 0 && lda >= K && ldb >= N)
    return tc::dispatch(pf, bm, bn, bk, a, b, c, M, N, K, lda, ldb,
                        tiles_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
