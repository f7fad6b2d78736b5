// flash_attention_bwd: the gradient of softmax attention, dq, dk and dv.
//
// The reference has no backward kernel: its models differentiate jnp
// attention (src/repro/models/layers.py:98 dense_attention, :130
// streaming_attention), and its Pallas kernel
// src/repro/kernels/flash_attention.py has no custom_vjp.  The port's
// training forward runs through the flash_attention kernel, so this is its
// backward: q, k, v, do [BH, T|S, d] bfloat16, the forward's row
// log-sum-exp lse [BH, T] fp32 (natural log of the scaled, masked scores),
// scale 1/sqrt(d), causal top-left (also when T != S) or none, 0 < d <=
// 256 with d % 8 == 0 (below); dq, dk, dv bfloat16 with fp32
// accumulation.  With
// P = exp(scale q k^T - lse) (masked entries 0):
//
//   dv = P^T do,  dP = do v^T,  dS = P * (dP - D),  D = rowsum(P * dP),
//   dq = scale dS k,  dk = scale dS^T q.
//
// D equals rowsum(do * o), but not when o is the forward's bf16 output:
// where one key takes most of a row, dP - D cancels, and o's rounding
// (2^-9) then swamps the row's dS.  After ten training steps of yi-6b
// (8 layers) that moved the attention projections' gradients by up to
// 17 %; summed from P and dP in fp32, D leaves them within 0.7 % of fp32
// attention differentiated by autograd.
//
// What bounds it on an H100: operations.  The function needs 5 products
// of 2 d flops per (query, key) pair (QK^T, dO V^T, dV, dK, dQ), 2.5 times
// the forward's; at a yi-6b layer (32 x 4096 x 4096 x 128, causal) that
// is 344 GFLOP, 0.36 ms at the 989 TFLOP/s bf16 tensor-core rate.
//
// Design: every product is a bf16 wgmma with fp32 sums, its tiles brought
// by TMA (3-D tensor maps over [BH, T|S, d]: rows past T or S load as
// zeros and never reach into the next head), as in the forward
// (flash_attention.cu).  A block is one consumer warpgroup (128 threads)
// that owns 64 rows and one producer warp whose first thread keeps a
// 2-stage ring of 64-row tiles in flight behind mbarriers.  Two launches,
// no float atomics, so the result is the same bit for bit on every run:
//
// 1. dq pass, one block per (bh, 64 queries), heaviest (last) q tiles
//    first; Q and dO stay in shared memory while (K, V) tiles stream
//    through the ring twice, each sweep up to the causal diagonal.
//    S = Q K^T and dP = dO V^T are wgmmas with both operands K-major in
//    shared memory; P = exp2(S scale log2e - lse log2e) and the masks are
//    applied on the fp32 fragment.  Sweep 1 sums each thread's P * dP and
//    adds the row's four threads by two xor-shuffles: D, written to
//    D_scratch for pass 2.  Sweep 2 forms dS = P (dP - D), splits it into
//    bf16 hi + lo parts in registers (the accumulator fragment is already
//    the A-operand layout) and adds both times K, K read MN-major (the
//    transpose bit).
// 2. dk/dv pass, one block per (bh, 64 keys); K and V stay in shared
//    memory, dK and dV in registers, while (Q, dO) tiles stream from the
//    diagonal on, each stage with the 64 queries' lse and D, which the
//    producer warp stages in shared memory beside the TMA tiles.
//    S^T = K Q^T and dP^T = V dO^T; P and dS on the fragment, lse and D
//    indexed by column; dV += P^T dO and dK += (dS hi + lo)^T Q with P^T
//    and dS^T from registers and dO, Q read MN-major.  Key tiles that no
//    query sees (S > T under causal masking) write zeros.
//
// That is 11 products a pair (D's sweep 2, dq's 4, dk/dv's 5): 0.76 ms at
// the bf16 peak at a yi-6b layer.  The 5 the function needs would take
// one pass that forms dS once and scatters dS K into dq from every key
// tile: float atomics (a result that changes from run to run) or a dS
// buffer of BH T S bf16 (0.5 GB a yi-6b layer, its causal half) read back
// by a dq pass.
//
// Rounding points: S, dP, P, D and dS are fp32; P (for dV) is a bf16
// wgmma operand, rounded once (2^-9 relative); dS (for dK, dQ) is split
// into bf16 hi + lo parts (about 2^-17), two products each.  dS sums to
// exactly 0 over a row's keys, so dq = dS K cancels whatever the keys
// share; rounded once, dS loses that sum, and keys with a common
// component (trained projections give them) then leave dq up to 1.9x
// chip_smoke.py's bar (2^-6 of each row's largest gradient plus 2^-12 of
// the tensor's): a yi-6b query that sees 4 keys after ten training steps,
// and tests/test_torch_attention_bwd_rounding.py's shared-component
// cases on the CPU.  Nothing cancels through P, so one rounding of it
// holds.
//
// Registers: a d = 128 dk/dv consumer holds dK and dV (64 + 64 fp32) and
// S^T and dP^T (32 + 32), so that pass runs one block of 160 threads a SM
// (up to 255 registers a thread); the dq pass (dQ 64, S 32, dP 32) and
// every d = 64 pass run two blocks a SM (up to 204).
//
// Head widths: the passes are compiled at D = 64, 128 and 256 (the
// forward's), and a width d <= 256 with d % 8 == 0 runs on the smallest D
// that holds it: the tensor maps are d columns wide (rows of 2 d bytes),
// TMA fills columns d .. D - 1 of every tile with zeros, which add exact
// zeros to S and dP, and the stores are masked to d columns.  At D = 256 a
// consumer cannot hold dK and dV (2 x 128 fp32) or dQ beside S and dP, so
// each pass splits d into two 128-column halves over the grid: a block
// forms S and dP (S^T and dP^T) over the full width from its 256-wide
// tiles, as at 128, and adds only its half of dQ (dK and dV); the two
// halves recompute the same S and dP, bit for bit, and the first half
// writes D.  Both passes then take 197 KB of shared memory: one block a
// SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64, BK = 64;               // query and key tile rows
constexpr int WG = 128;                       // the consumer warpgroup
constexpr int THREADS = WG + 32;              // + the producer warp
constexpr int STAGES = 2;
constexpr int BOX = 64 * 128;                 // one [64 rows x 64] bf16 box
constexpr float LOG2E = 1.4426950408889634f;

// bytes of one [64 x D] bf16 tile: D / 64 boxes
template <int D>
__host__ __device__ constexpr int tile_bytes() { return D / 64 * BOX; }

template <int D>
struct DqSmem {
  // Q, dO; STAGES x (K, V); full, empty barriers per stage and q_full
  static constexpr size_t BYTES =
      1024 + (2 + 2 * STAGES) * static_cast<size_t>(tile_bytes<D>()) +
      (2 * STAGES + 1) * 8;
};

template <int D>
struct DkdvSmem {
  // K, V; STAGES x (Q, dO); STAGES x (lse, D) [64] fp32; barriers
  static constexpr size_t BYTES =
      1024 + (2 + 2 * STAGES) * static_cast<size_t>(tile_bytes<D>()) +
      STAGES * 2 * BQ * sizeof(float) + (2 * STAGES + 1) * 8;
};

// the D / 64 boxes of rows r0.. of head bh into dst
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_3d(dst + c * BOX, map, bar, 64 * c, r0, bh);
}

__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc[64 x 64] += A B^T over d: A's and B's 64 rows at a and b, both
// K-major tiles (d contiguous in D / 64 boxes); issued, not committed
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const uint8_t* a,
                                          const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    hopper::wgmma_ss<0>(acc, hopper::desc_sw128(a + off, 16, 1024),
                        hopper::desc_sw128(b + off, 16, 1024));
  }
}

// acc[64 x N] += A B over 64 rows of B: A from registers (four k16
// fragments), B's 64 rows at b read MN-major (the transpose bit; its
// 64-wide d chunks one box apart, N / 64 of them from b on); issued, not
// committed
template <int N>
__device__ __forceinline__ void issue_ab(float (&acc)[N / 2], const uint32_t (&a)[4][4],
                                         const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::wgmma_rs<1>(acc, a[kk], hopper::desc_sw128(b + kk * 2048, BOX, 1024));
}

// the same with A = hi + lo: two products a k16 step
template <int N>
__device__ __forceinline__ void issue_ab(float (&acc)[N / 2], const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4], const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = hopper::desc_sw128(b + kk * 2048, BOX, 1024);
    hopper::wgmma_rs<1>(acc, hi[kk], db);
    hopper::wgmma_rs<1>(acc, lo[kk], db);
  }
}

// the fragment as bf16 A operands: f[kk][r] holds x[8 kk + 2 r], +1
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// the fragment as bf16 hi + lo A operands (x - hi rounded again)
__device__ __forceinline__ void to_split_frags(const float (&x)[32], uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack(x0 - __low2float(h), x1 - __high2float(h));
    }
}

// S and dP of one 64 x 64 tile: s = A B^T, dp = A2 B2^T; waited for
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], float (&dp)[32], const uint8_t* a,
                                       const uint8_t* b, const uint8_t* a2,
                                       const uint8_t* b2) {
  hopper::zero(s);
  hopper::zero(dp);
  hopper::wgmma_fence();
  issue_abt<D>(s, a, b);
  issue_abt<D>(dp, a2, b2);
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  hopper::fence_regs(dp);
}

// ---- pass 1: D and dq -------------------------------------------------------

// The fragment's rows are queries, its columns keys: s[4 c + 2 i + j] is
// query q_row + 8 i, key k0 + 8 c + 2 (lane % 4) + j.  s becomes P.
__device__ __forceinline__ void p_by_row(float (&s)[32], const float (&lse2)[2], int q_row,
                                         int k0, int T_len, int S_len, int causal,
                                         bool masked, float scale2, int lane) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = 4 * c + 2 * i + j;
        const int qpos = q_row + 8 * i, kpos = k0 + 8 * c + 2 * (lane % 4) + j;
        const bool keep =
            !masked || (qpos < T_len && kpos < S_len && (!causal || kpos <= qpos));
        s[idx] = keep ? ex2(fmaf(s[idx], scale2, -lse2[i])) : 0.f;
      }
}

// the output columns a block adds: all of d, or a 128-column half at 256
template <int D>
__host__ __device__ constexpr int out_cols() { return D > 128 ? 128 : D; }

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
dq_kernel(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
          float* __restrict__ Dv, bf16* __restrict__ dq, int T_len, int S_len,
          int d_len, float scale, int causal) {
  constexpr int TB = tile_bytes<D>(), DO = out_cols<D>();
  const int c0 = blockIdx.z * DO;                    // this block's columns of dq
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);
  uint8_t* do_s = q_s + TB;
  uint8_t* k_s = do_s + TB;                          // [STAGES][TB]
  uint8_t* v_s = k_s + STAGES * TB;                  // [STAGES][TB]
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + STAGES * TB);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest q tiles first
  int n_kv = (S_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, q0 / BK + 1);          // keys past the tile's last query
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);               // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {                           // the producer warp
    if (threadIdx.x == WG) {
      hopper::mbar_expect_tx(q_full, 2 * TB);
      load_rows<D>(q_s, &q_map, q_full, q0, bh);
      load_rows<D>(do_s, &do_map, q_full, q0, bh);
      for (int u = 0; u < 2 * n_kv; ++u) {           // two sweeps over the kv tiles
        const int st = u % STAGES, k0 = (u % n_kv) * BK;
        hopper::mbar_wait(&empty[st], ((u / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[st], 2 * TB);
        load_rows<D>(k_s + st * TB, &k_map, &full[st], k0, bh);
        load_rows<D>(v_s + st * TB, &v_map, &full[st], k0, bh);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int q_row = q0 + 16 * w + lane / 4;          // and q_row + 8
  const float scale2 = scale * LOG2E;
  const size_t qo = static_cast<size_t>(bh) * T_len;
  float lse2[2], dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse2[i] = q_row + 8 * i < T_len ? lse[qo + q_row + 8 * i] * LOG2E : 0.f;
  const bool rows_ragged = q0 + BQ > T_len;
  float s[32], dp[32], acc[DO / 2];
  uint32_t ds_hi[4][4], ds_lo[4][4];
  hopper::zero(acc);
  hopper::mbar_wait(q_full, 0);

  for (int u = 0; u < 2 * n_kv; ++u) {
    const int st = u % STAGES, k0 = (u % n_kv) * BK;
    const uint8_t* ks = k_s + st * TB;
    hopper::mbar_wait(&full[st], (u / STAGES) & 1);
    scores<D>(s, dp, q_s, ks, do_s, v_s + st * TB);
    const bool masked = rows_ragged || k0 + BK > S_len || (causal && k0 + BK - 1 > q0);
    p_by_row(s, lse2, q_row, k0, T_len, S_len, causal, masked, scale2, lane);
    if (u < n_kv) {                                  // sweep 1: D = rowsum(P dP)
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) dsum[(idx >> 1) & 1] += s[idx] * dp[idx];
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
      if (u == n_kv - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
          dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
          if (blockIdx.z == 0 && lane % 4 == 0 && q_row + 8 * i < T_len)
            Dv[qo + q_row + 8 * i] = dsum[i];
        }
      }
      continue;
    }
    // sweep 2: dS = P (dP - D), dQ += (dS hi + dS lo) K
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) dp[idx] = s[idx] * (dp[idx] - dsum[(idx >> 1) & 1]);
    to_split_frags(dp, ds_hi, ds_lo);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    issue_ab<DO>(acc, ds_hi, ds_lo, ks + c0 / 64 * BOX);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dq = scale acc, rows past T and columns past d not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q_row + 8 * i;
    if (q >= T_len) continue;
#pragma unroll
    for (int c = 0; c < DO / 8; ++c) {
      const int col = c0 + 8 * c + 2 * (lane % 4);   // d_len % 8 == 0: col + 1 too
      if (col < d_len)
        *reinterpret_cast<__nv_bfloat162*>(dq + (qo + q) * d_len + col) =
            __floats2bfloat162_rn(acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
    }
  }
}

// ---- pass 2: dk and dv ------------------------------------------------------

// The fragment's rows are keys, its columns queries: s[4 c + 2 i + j] is
// key k_row + 8 i, query q0 + col with col = 8 c + 2 (lane % 4) + j, whose
// lse (log2 units) and D are lse2[col], dsum[col].  s becomes P and dp dS.
__device__ __forceinline__ void p_ds_by_col(float (&s)[32], float (&dp)[32],
                                            const float* lse2, const float* dsum,
                                            int k_row, int q0, int T_len, int S_len,
                                            int causal, bool masked, float scale2,
                                            int lane) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    const float2 dd = *reinterpret_cast<const float2*>(dsum + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = 4 * c + 2 * i + j;
        const int kpos = k_row + 8 * i, qpos = q0 + col + j;
        const bool keep =
            !masked || (qpos < T_len && kpos < S_len && (!causal || kpos <= qpos));
        const float p = keep ? ex2(fmaf(s[idx], scale2, -(j ? l2.y : l2.x))) : 0.f;
        s[idx] = p;
        dp[idx] = p * (dp[idx] - (j ? dd.y : dd.x));
      }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D >= 128 ? 1 : 2)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
            const float* __restrict__ Dv, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int T_len, int S_len, int d_len, float scale, int causal) {
  constexpr int TB = tile_bytes<D>(), DO = out_cols<D>();
  const int c0 = blockIdx.z * DO;                    // this block's columns of dk, dv
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = hopper::align1024(smem_raw);
  uint8_t* v_s = k_s + TB;
  uint8_t* q_st = v_s + TB;                          // [STAGES][TB]
  uint8_t* do_st = q_st + STAGES * TB;               // [STAGES][TB]
  float* rows_s = reinterpret_cast<float*>(do_st + STAGES * TB);  // [STAGES][lse, D][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(rows_s + STAGES * 2 * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int bh = blockIdx.x, k0 = blockIdx.y * BK;   // heaviest (first) key tiles first
  const int q_start = causal ? k0 : 0;               // earlier queries do not see these keys
  const int n_q = T_len > q_start ? (T_len - q_start + BQ - 1) / BQ : 0;
  const size_t qo = static_cast<size_t>(bh) * T_len;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);               // the producer warp's lanes
      hopper::mbar_init(&empty[s], 4);               // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {                           // the producer warp
    const int lane = threadIdx.x - WG;
    if (n_q > 0 && lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * TB);
      load_rows<D>(k_s, &k_map, kv_full, k0, bh);
      load_rows<D>(v_s, &v_map, kv_full, k0, bh);
    }
    for (int t = 0; t < n_q; ++t) {
      const int st = t % STAGES, q0 = q_start + t * BQ;
      hopper::mbar_wait(&empty[st], ((t / STAGES) & 1) ^ 1);
      float* rows = rows_s + st * 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {          // the queries' lse (log2 units) and D
        const bool in = q0 + r < T_len;
        rows[r] = in ? lse[qo + q0 + r] * LOG2E : 0.f;
        rows[BQ + r] = in ? Dv[qo + q0 + r] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[st], 2 * TB);
        load_rows<D>(q_st + st * TB, &q_map, &full[st], q0, bh);
        load_rows<D>(do_st + st * TB, &do_map, &full[st], q0, bh);
      } else {
        hopper::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int k_row = k0 + 16 * w + lane / 4;          // and k_row + 8
  const float scale2 = scale * LOG2E;
  float s[32], dp[32], acc_k[DO / 2], acc_v[DO / 2];
  uint32_t p_f[4][4], ds_hi[4][4], ds_lo[4][4];
  hopper::zero(acc_k);
  hopper::zero(acc_v);
  if (n_q > 0) hopper::mbar_wait(kv_full, 0);

  for (int t = 0; t < n_q; ++t) {
    const int st = t % STAGES, q0 = q_start + t * BQ;
    const uint8_t* qs = q_st + st * TB;
    const uint8_t* dos = do_st + st * TB;
    const float* rows = rows_s + st * 2 * BQ;
    hopper::mbar_wait(&full[st], (t / STAGES) & 1);
    scores<D>(s, dp, k_s, qs, v_s, dos);             // S^T = K Q^T, dP^T = V dO^T
    const bool masked = q0 + BQ > T_len || k0 + BK > S_len || (causal && k0 + BK - 1 > q0);
    p_ds_by_col(s, dp, rows, rows + BQ, k_row, q0, T_len, S_len, causal, masked, scale2,
                lane);
    to_frags(s, p_f);
    to_split_frags(dp, ds_hi, ds_lo);
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    hopper::wgmma_fence();
    issue_ab<DO>(acc_v, p_f, dos + c0 / 64 * BOX);   // dV += P^T dO
    issue_ab<DO>(acc_k, ds_hi, ds_lo, qs + c0 / 64 * BOX);  // dK += (dS hi + lo)^T Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // dk = scale acc_k, dv = acc_v (zeros for keys no query sees); rows past
  // S and columns past d not written
  const size_t ko = static_cast<size_t>(bh) * S_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = k_row + 8 * i;
    if (kpos >= S_len) continue;
#pragma unroll
    for (int c = 0; c < DO / 8; ++c) {
      const int col = c0 + 8 * c + 2 * (lane % 4);   // d_len % 8 == 0: col + 1 too
      if (col >= d_len) continue;
      const size_t at = (ko + kpos) * d_len + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
          acc_k[4 * c + 2 * i] * scale, acc_k[4 * c + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(acc_v[4 * c + 2 * i], acc_v[4 * c + 2 * i + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           float* Dv, bf16* dq, bf16* dk, bf16* dv, int BH, int T_len, int S_len,
           int d_len, float scale, int causal, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  const uint64_t d_cols = static_cast<uint64_t>(d_len);
  const uint64_t q_dims[3] = {d_cols, static_cast<uint64_t>(T_len), static_cast<uint64_t>(BH)};
  const uint64_t kv_dims[3] = {d_cols, static_cast<uint64_t>(S_len), static_cast<uint64_t>(BH)};
  const uint64_t q_strides[2] = {d_cols * 2, static_cast<uint64_t>(T_len) * d_cols * 2};
  const uint64_t kv_strides[2] = {d_cols * 2, static_cast<uint64_t>(S_len) * d_cols * 2};
  const unsigned halves = D / out_cols<D>();
  const uint32_t box[3] = {64, 64, 1};
  if (!hopper::bf16_map(&q_map, q, 3, q_dims, q_strides, box) ||
      !hopper::bf16_map(&do_map, dO, 3, q_dims, q_strides, box) ||
      !hopper::bf16_map(&k_map, k, 3, kv_dims, kv_strides, box) ||
      !hopper::bf16_map(&v_map, v, 3, kv_dims, kv_strides, box))
    return static_cast<int>(cudaErrorInvalidValue);

  const int dq_smem = static_cast<int>(DqSmem<D>::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3(BH, (T_len + BQ - 1) / BQ, halves), THREADS, dq_smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, Dv, dq, T_len, S_len, d_len, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int kv_smem = static_cast<int>(DkdvSmem<D>::BYTES);
  err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<D><<<dim3(BH, (S_len + BK - 1) / BK, halves), THREADS, kv_smem, stream>>>(
      q_map, k_map, v_map, do_map, lse, Dv, dk, dv, T_len, S_len, d_len, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, do [BH, T, d], k, v [BH, S, d] bfloat16 (16-byte-aligned bases, for
// TMA) and lse [BH, T] fp32, all contiguous; 0 < d <= 256 with d % 8 ==
// 0, run on the smallest compiled width (64, 128, 256) that holds it; D_scratch
// fp32 [BH, T] -> dq [BH, T, d], dk, dv [BH, S, d] bfloat16.  T, S >= 1.
// Two launches on `stream`; allocates nothing, returns a CUDA error code.
int flash_attention_bwd(int d, const void* q, const void* k, const void* v, const void* dO,
                        const void* lse, void* D_scratch, void* dq, void* dk, void* dv,
                        int BH, int T_len, int S_len, float scale, int causal,
                        void* stream) {
  if (BH == 0 || T_len == 0 || S_len == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto w = [](void* p) { return static_cast<bf16*>(p); };
  auto lse_f = static_cast<const float*>(lse);
  auto d_f = static_cast<float*>(D_scratch);
  if (d <= 0 || d > 256 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 64)
    return launch<64>(q, k, v, dO, lse_f, d_f, w(dq), w(dk), w(dv), BH, T_len, S_len, d,
                      scale, causal, s);
  if (d <= 128)
    return launch<128>(q, k, v, dO, lse_f, d_f, w(dq), w(dk), w(dv), BH, T_len, S_len, d,
                       scale, causal, s);
  return launch<256>(q, k, v, dO, lse_f, d_f, w(dq), w(dk), w(dv), BH, T_len, S_len, d,
                     scale, causal, s);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
