// cim_matmul: the paper's AF / PF macro tiling as a blocked matmul.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cim_matmul.py
// (cim_matmul -> _kernel_af / _kernel_pf): [M, K] @ [K, N] in BM x BN x BK
// blocks, out in a's dtype (float32 or bfloat16).  The two schedules are
// the paper's two loop orders and stay two kernels on the bf16 route (the
// fp32 route runs both in one kernel, below):
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
// float32: the tensor cores in 3xTF32 (wgmma m64n64k8 .tf32).  Each fp32
//   operand is split into tf32 hi + lo parts and each product is lo_a hi_b
//   + hi_a lo_b + hi_a hi_b, small terms first: about 2^-21 relative per
//   product (hopper.cuh, split_tf32), where one tf32 product would be off
//   by 2^-11, beyond the fp32 tolerance.  tf32 wgmma reads both operands
//   K-major only, and B [K, N] is MN-major, so the parts cannot land by
//   TMA: a block is TM / 64 consumer warpgroups and one producer warpgroup
//   whose 128 threads load each 32-wide K stage of A and B from global
//   memory (A a 16-byte chunk a thread, B four values down a column,
//   neighbouring threads on neighbouring columns), split them in registers
//   and store the hi and lo parts K-major and 128-byte swizzled into a
//   ring of stages guarded by mbarriers (full: all 128 producer threads
//   have stored and fenced; empty: every consumer warp's products of the
//   stage are done).  B is transposed by that store, so the split costs no
//   pass of its own over shared memory, and the loads and splits of later
//   stages overlap the products.  The tensor cores add into their fp32
//   accumulator with truncation, an error of up to an ulp of the running
//   sum per product, which over K = 700 already breaks the fp32 tolerance;
//   so each stage's hi_a hi_b sum lands in a fresh accumulator and is added
//   on the CUDA cores (rounded to nearest) into the tile's sum, and the
//   small terms, 2^-10 of it, keep one accumulator (Consumer).  Three
//   accumulators of TN / 2 registers and a second stage accumulator fit a
//   consumer thread at TN = 64: blocks are TM x 64.  AF keeps the sum
//   across K and writes it once.  PF starts a fresh sum for each bk-wide K
//   block (bk / 32 stages; blocks at multiples of bk from 0, as
//   _kernel_pf) and adds it into the fp32 output in K order, a
//   read-modify-write of float2 pairs (whole 32-byte sectors) by the
//   thread that owns them; fp32 + fp32 in a register or in memory rounds
//   alike, so each output element sees _kernel_pf's additions.  For an
//   fp32 output no element's arithmetic depends on which block computes
//   it, so a block may be a split of the caller's bm x bn tile: the
//   wrapper runs bm x 64 blocks, or 64 x 64 where bm rows would leave most
//   of the card idle (cim_matmul.fp32_tiles), and every PF block owns one
//   output tile (tiles_per_block is not used).  The wrapper pads K and N to
//   multiples of 4 (16-byte A rows), as for TMA.  Ceiling: 495 TFLOP/s
//   TF32 over three products, 165 TFLOP/s of fp32 products.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---- float32: 3xTF32 wgmma -------------------------------------------------

namespace tf {

constexpr int WG = 128;                      // threads of a warpgroup
constexpr int BKS = 32;                      // K of a stage: one 128-byte row

constexpr int TN = 64;                       // columns of a block tile

template <int TM>
struct Tile {
  static constexpr int NC = TM / 64;         // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * WG;  // + the producer warpgroup
  static constexpr int A_PART = TM * 128;    // A hi (or lo): [TM rows x 32 K]
  static constexpr int B_PART = TN * 128;    // B^T hi (or lo): [TN rows x 32 K]
  static constexpr int STAGE_BYTES = 2 * (A_PART + B_PART);
  static constexpr int STAGES = 196608 / STAGE_BYTES;   // 4 or 6
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

// One K stage of A (rows m0.., a 16-byte chunk a task) and of B (columns
// n0.., four rows of K down one column a task) from global memory, split
// into hi and lo parts and stored K-major into the stage's tiles
// [A hi | A lo | B^T hi | B^T lo].  Values past M, N or K store as zeros.
template <int TM>
__device__ __forceinline__ void produce(uint8_t* st, const float* __restrict__ a,
                                        const float* __restrict__ b, int M,
                                        int N, int K, int lda, int ldb, int m0,
                                        int n0, int k0, int t) {
  using T = Tile<TM>;
  constexpr int AT = TM * 8 / WG, BT = TN * 8 / WG;
  float4 av[AT];
#pragma unroll
  for (int u = 0; u < AT; ++u) {
    const int idx = t + u * WG, r = idx / 8, c = idx % 8;
    const int row = m0 + r, col = k0 + 4 * c;      // K % 4 == 0: a whole chunk
    av[u] = row < M && col < K
                ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(row) * lda + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float bv[BT][4];
#pragma unroll
  for (int u = 0; u < BT; ++u) {
    const int idx = t + u * WG, n = idx % TN, c = idx / TN;
    const int col = n0 + n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int krow = k0 + 4 * c + i;
      bv[u][i] = col < N && krow < K ? b[static_cast<size_t>(krow) * ldb + col] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < AT; ++u) {
    const int idx = t + u * WG;
    hopper::store_split4(st, st + T::A_PART, hopper::sw128_offset(idx / 8, idx % 8),
                         av[u].x, av[u].y, av[u].z, av[u].w);
  }
  uint8_t* bt = st + 2 * T::A_PART;
#pragma unroll
  for (int u = 0; u < BT; ++u) {
    const int idx = t + u * WG;
    hopper::store_split4(bt, bt + T::B_PART, hopper::sw128_offset(idx % TN, idx / TN),
                         bv[u][0], bv[u][1], bv[u][2], bv[u][3]);
  }
}

// The products of one stage for the 64 rows of warpgroup wg, per k8 step
// lo_a hi_b and hi_a lo_b into `small`, then hi_a hi_b into `big`, which
// the stage's first step overwrites; issued and committed, not waited for
template <int TM>
__device__ __forceinline__ void mma_stage(float (&small)[TN / 2],
                                          float (&big)[TN / 2],
                                          const uint8_t* st, int wg) {
  using T = Tile<TM>;
  const uint8_t* a_hi = st + wg * 64 * 128;
  const uint8_t* a_lo = a_hi + T::A_PART;
  const uint8_t* b_hi = st + 2 * T::A_PART;
  const uint8_t* b_lo = b_hi + T::B_PART;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKS / 8; ++kk) {
    const uint64_t ah = hopper::desc_sw128(a_hi + 32 * kk, 16, 1024);
    const uint64_t al = hopper::desc_sw128(a_lo + 32 * kk, 16, 1024);
    const uint64_t bh = hopper::desc_sw128(b_hi + 32 * kk, 16, 1024);
    const uint64_t bl = hopper::desc_sw128(b_lo + 32 * kk, 16, 1024);
    hopper::wgmma_tf32_ss<TN>(small, al, bh);
    hopper::wgmma_tf32_ss<TN>(small, ah, bl);
    hopper::wgmma_tf32_ss<TN>(big, ah, bh, kk > 0);
  }
  hopper::wgmma_commit();
}

template <int R>
__device__ __forceinline__ void add_into(float (&acc)[R], const float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += x[i];
}

// The warpgroup's 64 x TN slice of the tile into c (row stride N): stored
// (add = false) or added to what c holds, in float2 pairs where N is even.
// Thread t owns the same entries on every call, and loads all of its old
// pairs before it stores any, so their loads are in flight together.
__device__ __forceinline__ void put_tile(float* __restrict__ c,
                                         const float (&acc)[TN / 2], int wg,
                                         int m0, int n0, int M, int N,
                                         bool add) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x % WG) / 32;
  const int row0 = m0 + wg * 64 + 16 * w + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  float2 old[TN / 8][2];
#pragma unroll
  for (int cc = 0; cc < TN / 8; ++cc)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i, col = col0 + 8 * cc;
      old[cc][i] = make_float2(0.f, 0.f);
      if (add && (N & 1) == 0 && row < M && col < N)
        old[cc][i] = *reinterpret_cast<const float2*>(c + static_cast<size_t>(row) * N + col);
    }
#pragma unroll
  for (int cc = 0; cc < TN / 8; ++cc)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i, col = col0 + 8 * cc;
      if (row >= M || col >= N) continue;
      float* p = c + static_cast<size_t>(row) * N + col;
      const float v0 = acc[4 * cc + 2 * i], v1 = acc[4 * cc + 2 * i + 1];
      if ((N & 1) == 0) {                   // col + 1 < N as well
        *reinterpret_cast<float2*>(p) =
            make_float2(old[cc][i].x + v0, old[cc][i].y + v1);
      } else {
        p[0] = add ? p[0] + v0 : v0;
        if (col + 1 < N) p[1] = add ? p[1] + v1 : v1;
      }
    }
}

// The consumer warpgroups' state across the stages of one tile.  The
// tensor cores add into an fp32 accumulator with truncation, so an
// accumulator that carried the whole sum across K would lose up to an ulp
// of the running sum at every product (1.4e-4 at K = 700 on the card);
// each stage's hi_a hi_b sum (32 of K) therefore lands in a fresh
// accumulator and is added into `sum` on the CUDA cores, rounded to
// nearest, once the stage is done.  The small terms, 2^-10 of the sum,
// stay in one tensor-core accumulator per K block.  Two stage
// accumulators alternate, so the products of stage kt run while stage
// kt - 1's are added.
template <int TM>
struct Consumer {
  float sum[TN / 2], small[TN / 2];
  bool held = false;                        // stage kt - 1 not yet released

  __device__ __forceinline__ void init() {
    hopper::zero(sum);
    hopper::zero(small);
  }

  // stage kt into `cur`; `prev` holds stage kt - 1's big sum
  __device__ __forceinline__ void step(int kt, float (&cur)[TN / 2],
                                       float (&prev)[TN / 2],
                                       const uint8_t* ring, uint64_t* full,
                                       uint64_t* empty, float* __restrict__ c,
                                       int wg, int m0, int n0, int M, int N,
                                       int nk, int per_block) {
    using T = Tile<TM>;
    constexpr int S = T::STAGES;
    const bool leader = threadIdx.x % 32 == 0;
    const int s = kt % S;
    hopper::mbar_wait(&full[s], (kt / S) & 1);
    mma_stage<TM>(small, cur, ring + s * T::STAGE_BYTES, wg);
    const bool flush = (kt + 1) % per_block == 0 || kt + 1 == nk;
    if (flush) {
      hopper::wgmma_wait<0>();
    } else {
      hopper::wgmma_wait<1>();              // the previous stage is done
    }
    if (held) {
      hopper::fence_regs(prev);
      add_into(sum, prev);
      if (leader) hopper::mbar_arrive(&empty[(kt + S - 1) % S]);
    }
    held = !flush;
    if (flush) {                            // the K block's (AF: K's) sum
      hopper::fence_regs(cur);
      hopper::fence_regs(small);
      if (leader) hopper::mbar_arrive(&empty[s]);
      add_into(sum, cur);
      add_into(sum, small);
      put_tile(c, sum, wg, m0, n0, M, N, kt >= per_block);
      init();
    }
  }
};

// AF (kblock = 0): one output tile a block, the sum across all of K.  PF
// (kblock = bk / 32 stages): a fresh sum per K block, added into c.
template <int TM>
__global__ void __launch_bounds__(Tile<TM>::THREADS, 1)
mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ c, int M, int N, int K, int lda, int ldb,
          int kblock) {
  using T = Tile<TM>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = hopper::align1024(smem_raw);          // [S][STAGE_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * T::STAGE_BYTES);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nk = (K + BKS - 1) / BKS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], WG);               // every producer thread
      hopper::mbar_init(&empty[s], T::NC * 4);       // one arrival per warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == T::NC) {                                 // producer
    const int t = threadIdx.x - T::NC * WG;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % S;
      hopper::mbar_wait(&empty[s], ((kt / S) & 1) ^ 1);
      produce<TM>(ring + s * T::STAGE_BYTES, a, b, M, N, K, lda, ldb, m0, n0,
                  kt * BKS, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }
  const int per_block = kblock > 0 ? kblock : nk;
  Consumer<TM> con;
  float big0[TN / 2], big1[TN / 2];
  con.init();
  for (int kt = 0; kt < nk; kt += 2) {
    con.step(kt, big0, big1, ring, full, empty, c, wg, m0, n0, M, N, nk,
             per_block);
    if (kt + 1 < nk)
      con.step(kt + 1, big1, big0, ring, full, empty, c, wg, m0, n0, M, N, nk,
               per_block);
  }
}

template <int TM>
int launch(const float* a, const float* b, float* c, int M, int N, int K,
           int lda, int ldb, int kblock, cudaStream_t stream) {
  using T = Tile<TM>;
  auto kern = mm_kernel<TM>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(a, b, c, M, N, K, lda, ldb,
                                              kblock);
  return static_cast<int>(cudaGetLastError());
}

// tm x 64: the block tile (cim_matmul.fp32_tiles); bk sets PF's K blocks
int dispatch(int pf, int tm, int bk, const void* a, const void* b, void* c,
             int M, int N, int K, int lda, int ldb, cudaStream_t stream) {
  if (bk != 64 && bk != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int kblock = pf ? bk / BKS : 0;
  auto pa = static_cast<const float*>(a);
  auto pb = static_cast<const float*>(b);
  auto pc = static_cast<float*>(c);
  if (tm == 128)
    return launch<128>(pa, pb, pc, M, N, K, lda, ldb, kblock, stream);
  if (tm == 64)
    return launch<64>(pa, pb, pc, M, N, K, lda, ldb, kblock, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tf

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
// contiguous, all of one dtype (0: float32, which needs K and lda
// multiples of 4 and a 16-byte-aligned a; 1: bfloat16, which needs lda and
// ldb multiples of 8 and 16-byte-aligned bases, for TMA).  pf = 0 runs AF,
// 1 runs PF (each bf16 PF block sweeps tiles_per_block N tiles; each fp32
// block owns one tile).  bm, bn, bk in {64, 128}; for float32, bm x bn is
// the block tile (bn = 64; a split of the caller's, cim_matmul.fp32_tiles).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int cim_matmul(int dtype, int pf, int bm, int bn, int bk, const void* a,
               const void* b, void* c, int M, int N, int K, int lda, int ldb,
               int tiles_per_block, void* stream) {
  if (M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && K % 4 == 0 && lda % 4 == 0 && lda >= K && ldb >= N &&
      bn == tf::TN)
    return tf::dispatch(pf, bm, bk, a, b, c, M, N, K, lda, ldb, s);
  if (dtype == 1 && lda % 8 == 0 && ldb % 8 == 0 && lda >= K && ldb >= N)
    return tc::dispatch(pf, bm, bn, bk, a, b, c, M, N, K, lda, ldb,
                        tiles_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* cim_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
