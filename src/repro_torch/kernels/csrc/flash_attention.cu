// flash_attention: streaming-softmax attention, one block per (bh, q tile).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel): q [BH, T, d] against k, v [BH, S, d],
// scale 1/sqrt(d), float32 or bfloat16 in and out.  The reference's
// semantics are kept: NEG_INF = -1e30 for masked scores, keys at or beyond
// S masked, causal masking top-left (key kpos is seen by query qpos when
// kpos <= qpos, also when T != S), a running max, denominator and fp32
// accumulator per query row, out = acc / max(l, 1e-30).  With causal
// masking, kv tiles that lie wholly above the diagonal are skipped: every
// query row has seen key 0 by then, so those tiles would add exact zeros
// (alpha = exp(0) = 1, p = exp(-1e30 - m) = 0).
//
// What bounds it on an H100: operations.  Per (query, key) pair it does
// 4 d flops of products plus the softmax; at bert-large (T = S = 512,
// d = 64) that is 66 flops per byte of q, k, v and out, at a yi-6b
// prefill (4096, d = 128) over 1,000 -- both right of the ridge.  Each
// dtype has its own route:
//
// bfloat16: the tensor cores (wgmma) fed by TMA.  A block is one producer
//   warpgroup, whose first thread issues TMA loads through 3-D tensor maps
//   over [BH, S, d] (rows past S load as zeros and never reach into the next
//   head), and BQ / 64 consumer warpgroups of 64 query rows each.  The q
//   tile is loaded once; K and V tiles go through a 2-stage ring guarded by
//   mbarriers, so the next tile loads while this one is used.  S = Q K^T is
//   a wgmma with both operands in shared memory (K is already K-major) and
//   the fp32 scores in registers; scale (in log2 units, for exp2) and masks
//   are applied on that register fragment, and the running softmax stays
//   in registers: a row is spread over the 4 threads of a quad, so its max
//   is two xor-shuffles and its sum is reduced only once, at the end.  P V
//   is a wgmma with P from registers (the score fragment is already the
//   A-operand layout) and V read with the transpose bit (V is MN-major);
//   O is an fp32 register accumulator, rescaled by alpha per step.  The
//   consumers pipeline the steps: the scores of step u are issued before
//   P V of step u - 1, and the softmax of step u runs while that P V is on
//   the tensor cores.  A step is the whole kv tile with one consumer
//   warpgroup and 64 keys with two, whose threads have only 168 registers
//   (setmaxnreg did not lift ptxas's allocation above that, PERF.md).
//   Blocks start with the heaviest q tiles (under causal masking the last
//   tiles see the most keys), so the light ones fill the tail of the grid.
//   The reference keeps P in fp32 for P V; one bf16 rounding of P breaks
//   the stated tolerance (atol 1e-3 + 2^-7 |x| against the plain version)
//   on rows with few keys or cancelling values, as the CPU rehearsal in
//   tests/test_torch_attention_rounding.py shows, so P is split into bf16
//   hi + lo parts and P V is two wgmmas over the same V tile: P's error
//   drops from 2^-9 to about 2^-17 relative, for 1.5x the product
//   operations.  Ceiling: the 989 TFLOP/s bf16 tensor-core rate.
//
// float32: the tensor cores in 3xTF32 (wgmma .tf32), the softmax as the
//   bf16 route runs it.  Each fp32 operand is split into tf32 hi + lo parts
//   and each product is lo_a hi_b + hi_a lo_b + hi_a hi_b, small terms
//   first, into fp32 accumulators: about 2^-21 relative per product
//   (hopper.cuh, split_tf32); one tf32 product would be off by 2^-11.
//   tf32 wgmma reads its operands K-major only, so V (MN-major in P V)
//   cannot land as it is: a block is one consumer warpgroup of 64 query
//   rows and one producer warpgroup whose 128 threads load the q tile once
//   and each KS-key step of K and V from global memory, split them in
//   registers and store the hi and lo parts K-major and 128-byte swizzled:
//   Q and K as they are (d is their K), V transposed (keys are its K), a
//   thread storing four keys of one column.  K and V each go through a
//   ring of stages guarded by mbarriers (full: every producer thread has
//   stored and fenced; empty: the consumer's products of the stage are
//   done), so the loads and splits of later steps overlap the products.
//   S = Q K^T is 3 x d / 8 wgmmas with both operands in shared memory; the
//   scores' scale (log2 units), masks and running softmax stay in
//   registers (softmax_tile); P V takes P from registers, split into hi +
//   lo A fragments, against V^T's parts.  The score fragment holds keys
//   2c, 2c + 1 of each 8-key group c where the tf32 A fragment wants keys
//   c, c + 4, so the producer stores V^T's keys in that order (logical key
//   L of a group is key 2 (L % 4) + L / 4): the sum over keys is the same.
//   Per width: KS = 64 keys a step at D = 64 and 128 (at 128 K and V have
//   one stage each: 192 KB with Q's parts; 64-key steps read Q's parts
//   half as often as 32-key steps with two stages, and ran a yi-6b
//   prefill 12 % faster), 32 at 256, where a step's V is two 128-column
//   halves, one P V product each, and K and V have one stage each (Q's
//   parts alone take 128 KB).  A step's products and softmax run in turn:
//   issuing step u's scores before step u - 1's P V, as the bf16 route
//   does, ran a yi-6b prefill 5 % slower and spilled at D = 256.  The q
//   tile is 64 rows at every (bq, bk): the route splits a 128-row tile over
//   two blocks (rows are independent) and steps through keys KS at a time
//   whatever bk is (a step's size changes only where the running max is
//   rescaled).
//   Ceiling: 495 TFLOP/s TF32 over three products, 165 TFLOP/s of fp32
//   products.
//
// Head widths: both routes are compiled at D = 64, 128 and 256, and a
// width d <= 256 with d % 8 == 0 (h2o-danube-3-4b's 120, the gemma archs'
// 256, the reduced configs' 16) runs on the smallest D that holds it.
// Loads read rows d wide and fill columns d .. D - 1 with zeros (on the
// bf16 route TMA's out-of-range fill, rows of 2 d bytes), which add exact
// zeros to Q K^T and give zero columns of P V that are never stored; the
// scale stays 1/sqrt(d).  At D = 256 the bf16 route fits only 64 x 64
// tiles in shared memory (161 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG = 128;                      // threads of a warpgroup

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One KS-key step of the running softmax on the score fragment, in place:
// sc[4 c + 2 i + j] is query q_row + 8 i, key kv0 + 8 c + 2 (lane % 4) + j.
// Scale (log2 units) and masks, the quad-wide row max, alpha = the old
// max's weight, sc = exp2(sc - max), and the thread's part of l.
template <int KS>
__device__ __forceinline__ void softmax_tile(float (&sc)[KS / 2],
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int kv0,
                                             int q_row, int S_len, int causal,
                                             bool masked, float scale,
                                             int lane) {
#pragma unroll
  for (int c = 0; c < KS / 8; ++c)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int idx = 4 * c + 2 * i + j;
        const int kpos = kv0 + 8 * c + 2 * (lane % 4) + j;
        const bool keep = !masked || (kpos < S_len &&
                                      (!causal || kpos <= q_row + 8 * i));
        sc[idx] = keep ? sc[idx] * scale : NEG_INF;
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < KS / 8; ++c)
      mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * i], sc[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[i], mx);
    alpha[i] = ex2(m_r[i] - m_new);
    m_r[i] = m_new;
    l_r[i] *= alpha[i];
  }
#pragma unroll
  for (int idx = 0; idx < KS / 2; ++idx) {
    const int i = (idx >> 1) & 1;
    sc[idx] = ex2(sc[idx] - m_r[i]);
    l_r[i] += sc[idx];
  }
}

// ---- float32: 3xTF32 wgmma -------------------------------------------------

namespace tf {

template <int D>
struct Tile {
  static constexpr int KS = D > 128 ? 32 : 64;   // keys a step
  static constexpr int DV = D > 128 ? 128 : D;   // V columns a P V product
  static constexpr int NV = D / DV;              // V halves a step
  static constexpr int SK = D > 64 ? 1 : 2;      // K stages
  static constexpr int SV = D > 64 ? 1 : 2;      // V stages
  static constexpr int Q_PART = 64 * D * 4;      // Q hi (or lo): D / 32 boxes [64 x 32]
  static constexpr int K_PART = KS * D * 4;      // K hi (or lo): D / 32 boxes [KS x 32]
  static constexpr int V_PART = DV * KS * 4;     // V^T hi (or lo): KS / 32 boxes [DV x 32]
  static constexpr int THREADS = 2 * WG;         // consumer + producer
  static constexpr size_t SMEM = 1024 + 2 * Q_PART + 2 * SK * K_PART +
                                 2 * SV * V_PART + (1 + 2 * SK + 2 * SV) * 8;
};

// ROWS rows (r0.. of a [len, d_len] matrix x; zeros past len and d_len) of
// D columns into hi and lo tiles of D / 32 boxes [ROWS x 32], a 16-byte
// chunk a task, eight tasks' loads in flight
template <int D, int ROWS>
__device__ __forceinline__ void produce_rows(uint8_t* hi, uint8_t* lo,
                                             const float* __restrict__ x,
                                             int r0, int len, int d_len,
                                             int t) {
  constexpr int TASKS = ROWS * D / 4 / WG, BATCH = TASKS < 8 ? TASKS : 8;
#pragma unroll
  for (int u0 = 0; u0 < TASKS; u0 += BATCH) {
    float4 xv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = t + (u0 + u) * WG, r = idx / (D / 4), c = idx % (D / 4);
      xv[u] = r0 + r < len && 4 * c < d_len   // d_len % 8 == 0: a whole chunk
                  ? *reinterpret_cast<const float4*>(
                        x + static_cast<size_t>(r0 + r) * d_len + 4 * c)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int idx = t + (u0 + u) * WG, r = idx / (D / 4), c = idx % (D / 4);
      const uint32_t off = (c / 8) * ROWS * 128 + hopper::sw128_offset(r, c % 8);
      hopper::store_split4(hi, lo, off, xv[u].x, xv[u].y, xv[u].z, xv[u].w);
    }
  }
}

// V rows kv0.. kv0 + KS - 1, columns c0.. c0 + DV - 1 (zeros past S_len
// and d_len) transposed into V^T hi and lo tiles of KS / 32 boxes [DV x
// 32 keys]: a task is four keys of one column, neighbouring threads on
// neighbouring columns; 16-byte chunk q of a box row holds logical keys
// 4 q.. 4 q + 3, logical key L of an 8-key group being key 2 (L % 4) +
// L / 4 of it (the order of P's A fragments)
template <int D>
__device__ __forceinline__ void produce_vt(uint8_t* hi, uint8_t* lo,
                                           const float* __restrict__ v,
                                           int kv0, int c0, int S_len,
                                           int d_len, int t) {
  using T = Tile<D>;
  constexpr int DV = T::DV, KS = T::KS;
  constexpr int TASKS = DV * KS / 4 / WG;       // 8
  float xv[TASKS][4];
#pragma unroll
  for (int u = 0; u < TASKS; ++u) {
    const int idx = t + u * WG, n = idx % DV, ch = idx / DV;
    const int key0 = 32 * (ch / 8) + 8 * (ch % 8 / 2) + ch % 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kv0 + key0 + 2 * i;
      xv[u][i] = key < S_len && c0 + n < d_len
                     ? v[static_cast<size_t>(key) * d_len + c0 + n] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < TASKS; ++u) {
    const int idx = t + u * WG, n = idx % DV, ch = idx / DV;
    const uint32_t off = (ch / 8) * DV * 128 + hopper::sw128_offset(n, ch % 8);
    hopper::store_split4(hi, lo, off, xv[u][0], xv[u][1], xv[u][2], xv[u][3]);
  }
}

// sc = Q K^T (64 rows x KS keys) from the parts in shared memory; issued
// and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::KS / 2],
                                         const uint8_t* q_hi,
                                         const uint8_t* q_lo,
                                         const uint8_t* k_hi,
                                         const uint8_t* k_lo) {
  constexpr int KS = Tile<D>::KS;
  hopper::zero(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int qo = (kk / 4) * 64 * 128 + (kk % 4) * 32;
    const int ko = (kk / 4) * KS * 128 + (kk % 4) * 32;
    const uint64_t qh = hopper::desc_sw128(q_hi + qo, 16, 1024);
    const uint64_t ql = hopper::desc_sw128(q_lo + qo, 16, 1024);
    const uint64_t kh = hopper::desc_sw128(k_hi + ko, 16, 1024);
    const uint64_t kl = hopper::desc_sw128(k_lo + ko, 16, 1024);
    hopper::wgmma_tf32_ss<KS>(sc, ql, kh);
    hopper::wgmma_tf32_ss<KS>(sc, qh, kl);
    hopper::wgmma_tf32_ss<KS>(sc, qh, kh);
  }
  hopper::wgmma_commit();
}

// o += (P hi + P lo) V for one DV-column half: P's parts from registers
// (p[c] the A fragment of key group c), V^T's from shared memory; issued
// and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<D>::DV / 2],
                                         const uint32_t (&p_hi)[Tile<D>::KS / 8][4],
                                         const uint32_t (&p_lo)[Tile<D>::KS / 8][4],
                                         const uint8_t* v_hi,
                                         const uint8_t* v_lo) {
  constexpr int DV = Tile<D>::DV, KS = Tile<D>::KS;
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 8; ++kk) {
    const int vo = (kk / 4) * DV * 128 + (kk % 4) * 32;
    const uint64_t vh = hopper::desc_sw128(v_hi + vo, 16, 1024);
    const uint64_t vl = hopper::desc_sw128(v_lo + vo, 16, 1024);
    hopper::wgmma_tf32_rs<DV>(o, p_lo[kk], vh);
    hopper::wgmma_tf32_rs<DV>(o, p_hi[kk], vl);
    hopper::wgmma_tf32_rs<DV>(o, p_hi[kk], vh);
  }
  hopper::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int T_len, int S_len, int d_len,
             float scale, int causal) {
  using T = Tile<D>;
  constexpr int KS = T::KS, DV = T::DV, NV = T::NV, SK = T::SK, SV = T::SV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);        // [hi | lo]
  uint8_t* k_s = q_s + 2 * T::Q_PART;                // [SK][hi | lo]
  uint8_t* v_s = k_s + 2 * SK * T::K_PART;           // [SV][hi | lo]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + 2 * SV * T::V_PART);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + SK;
  uint64_t* v_full = k_empty + SK;
  uint64_t* v_empty = v_full + SV;

  // heaviest q tiles first (under causal masking the last tiles see the
  // most keys), every head's before the next lighter tile
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;
  // steps past S or wholly above the diagonal add exact zeros: skipped
  int n_steps = (S_len + KS - 1) / KS;
  if (causal) n_steps = min(n_steps, (q0 + 63) / KS + 1);
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, WG);
    for (int s = 0; s < SK; ++s) {
      hopper::mbar_init(&k_full[s], WG);             // every producer thread
      hopper::mbar_init(&k_empty[s], 4);             // one arrival per warp
    }
    for (int s = 0; s < SV; ++s) {
      hopper::mbar_init(&v_full[s], WG);
      hopper::mbar_init(&v_empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const size_t kv_base = static_cast<size_t>(bh) * S_len * d_len;
  if (threadIdx.x >= WG) {                           // producer
    const int t = threadIdx.x - WG;
    produce_rows<D, 64>(q_s, q_s + T::Q_PART,
                        q + static_cast<size_t>(bh) * T_len * d_len, q0,
                        T_len, d_len, t);
    hopper::fence_proxy_async();
    hopper::mbar_arrive(q_full);
    for (int u = 0; u < n_steps; ++u) {
      const int sk = u % SK;
      hopper::mbar_wait(&k_empty[sk], ((u / SK) & 1) ^ 1);
      uint8_t* kt = k_s + 2 * sk * T::K_PART;
      produce_rows<D, KS>(kt, kt + T::K_PART, k + kv_base, u * KS, S_len,
                          d_len, t);
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&k_full[sk]);
      for (int h = 0; h < NV; ++h) {
        const int j = u * NV + h, sv = j % SV;
        hopper::mbar_wait(&v_empty[sv], ((j / SV) & 1) ^ 1);
        uint8_t* vt = v_s + 2 * sv * T::V_PART;
        produce_vt<D>(vt, vt + T::V_PART, v + kv_base, u * KS, h * DV, S_len,
                      d_len, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&v_full[sv]);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int row = 16 * w + lane / 4;                 // and row + 8, in the q tile
  const bool leader = lane == 0;
  float o_acc[D / 2], sc[KS / 2], m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f}, alpha[2];
  uint32_t p_hi[KS / 8][4], p_lo[KS / 8][4];
  hopper::zero(o_acc);
  hopper::mbar_wait(q_full, 0);
  for (int u = 0; u < n_steps; ++u) {
    const int sk = u % SK;
    hopper::mbar_wait(&k_full[sk], (u / SK) & 1);
    const uint8_t* kt = k_s + 2 * sk * T::K_PART;
    issue_qk<D>(sc, q_s, q_s + T::Q_PART, kt, kt + T::K_PART);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (leader) hopper::mbar_arrive(&k_empty[sk]);
    const bool masked = (u + 1) * KS > S_len || (causal && (u + 1) * KS - 1 > q0);
    softmax_tile<KS>(sc, m_r, l_r, alpha, u * KS, q0 + row, S_len, causal,
                     masked, scale, lane);
#pragma unroll
    for (int idx = 0; idx < D / 2; ++idx) o_acc[idx] *= alpha[(idx >> 1) & 1];
    // P's A fragments: group c's keys 2 t, 2 t + 1 (t = lane % 4) of rows
    // row, row + 8 are logical keys t, t + 4 (see produce_vt)
#pragma unroll
    for (int c = 0; c < KS / 8; ++c) {
      hopper::split_tf32(sc[4 * c + 0], p_hi[c][0], p_lo[c][0]);
      hopper::split_tf32(sc[4 * c + 2], p_hi[c][1], p_lo[c][1]);
      hopper::split_tf32(sc[4 * c + 1], p_hi[c][2], p_lo[c][2]);
      hopper::split_tf32(sc[4 * c + 3], p_hi[c][3], p_lo[c][3]);
    }
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      const int j = u * NV + h, sv = j % SV;
      hopper::mbar_wait(&v_full[sv], (j / SV) & 1);
      const uint8_t* vt = v_s + 2 * sv * T::V_PART;
      hopper::fence_regs(o_acc);
      issue_pv<D>(hopper::slice<DV / 2>(o_acc, h * DV / 2), p_hi, p_lo, vt,
                  vt + T::V_PART);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o_acc);
      if (leader) hopper::mbar_arrive(&v_empty[sv]);
    }
  }

  // out = acc / max(l, 1e-30), l summed over the row's quad; rows are
  // d_len wide (columns d_len.. D - 1 of acc came from zero-filled loads)
  float* ob = o + static_cast<size_t>(bh) * T_len * d_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int qr = q0 + row + 8 * i;
    if (qr >= T_len) continue;
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(bh) * T_len + qr] = (m_r[i] + log2f(denom)) * LN2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      if (8 * c + 2 * (lane % 4) < d_len)   // d_len % 8 == 0: both or neither
        *reinterpret_cast<float2*>(ob + static_cast<size_t>(qr) * d_len + 8 * c +
                                   2 * (lane % 4)) =
            make_float2(o_acc[4 * c + 2 * i] / denom,
                        o_acc[4 * c + 2 * i + 1] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int T_len, int S_len, int d_len, float scale, int causal,
           cudaStream_t stream) {
  using T = Tile<D>;
  auto kern = flash_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_len + 63) / 64);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, T_len, S_len,
      d_len, scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

// D is the compiled width that holds d (compiled_width); every (bq, bk)
// the wrapper accepts runs the same 64-row blocks and KS-key steps
int dispatch(int D, int d, const void* q, const void* k, const void* v,
             void* o, float* lse, int BH, int T_len, int S_len, float scale,
             int causal, cudaStream_t stream) {
  if (D == 64)
    return launch<64>(q, k, v, o, lse, BH, T_len, S_len, d, scale, causal, stream);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, BH, T_len, S_len, d, scale, causal, stream);
  if (D == 256)
    return launch<256>(q, k, v, o, lse, BH, T_len, S_len, d, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tf

// ---- bfloat16: wgmma + TMA ------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
template <int D, int BQ, int BK>
struct Tile {
  static constexpr int NC = BQ / 64;         // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * WG;  // + the producer warpgroup
  static constexpr int Q_BYTES = BQ * D * 2;     // D / 64 boxes [BQ x 64]
  static constexpr int KV_BYTES = BK * D * 2;    // D / 64 boxes [BK x 64]
  static constexpr int STAGES = 2;
  // Keys per step of the softmax pipeline.  A consumer thread holds the
  // scores of one step (KS / 2 fp32) while the previous step's P (KS / 2
  // packed hi + lo registers) and the output (D / 2 fp32) are in flight in
  // P V.  With two consumer warpgroups a thread has 168 registers (384
  // threads), so a 128-key tile is consumed in two 64-key steps there;
  // one consumer warpgroup (255 registers) takes the whole tile per step.
  static constexpr int KS = NC == 2 ? 64 : BK;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 3 * STAGES) * 8;
};

// the D / 64 boxes of rows r0.. of head bh into dst, one box per 64 columns
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    hopper::tma_load_3d(dst + c * ROWS * 128, map, bar, 64 * c, r0, bh);
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// sc = Q K^T for the 64 rows of warpgroup wg against KS keys whose rows
// start at ks in a staged K tile of BK rows; issued and committed, not
// waited for
template <int D, int BQ, int BK, int KS>
__device__ __forceinline__ void issue_qk(float (&sc)[KS / 2],
                                         const uint8_t* q_s, const uint8_t* ks,
                                         int wg) {
  hopper::zero(sc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint8_t* qk = q_s + (kk / 4) * BQ * 128 + wg * 64 * 128 + (kk % 4) * 32;
    const uint8_t* kt = ks + (kk / 4) * BK * 128 + (kk % 4) * 32;
    hopper::wgmma_ss<0>(sc, hopper::desc_sw128(qk, 16, 1024),
                        hopper::desc_sw128(kt, 16, 1024));
  }
  hopper::wgmma_commit();
}

// o += (P hi + P lo) V for KS keys whose rows start at vs in a staged V
// tile of BK rows (MN-major: transpose bit, 64-wide d chunks BK rows
// apart); a 256-wide o is two 128-wide products.  Issued and committed,
// not waited for
template <int D, int BK, int KS>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p_hi)[KS / 16][4],
                                         const uint32_t (&p_lo)[KS / 16][4],
                                         const uint8_t* vs) {
  constexpr int NB = D > 128 ? 128 : D;      // one product's N
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
    for (int h = 0; h < D / NB; ++h) {
      const uint64_t dv = hopper::desc_sw128(
          vs + h * (NB / 64) * BK * 128 + kk * 2048, BK * 128, 1024);
      hopper::wgmma_rs<1>(hopper::slice<NB / 2>(o, h * NB / 2), p_hi[kk], dv);
      hopper::wgmma_rs<1>(hopper::slice<NB / 2>(o, h * NB / 2), p_lo[kk], dv);
    }
  hopper::wgmma_commit();
}

// P as bf16 hi + lo A fragments: p[kk][r] holds sc[8 kk + 2 r], +1
template <int KS>
__device__ __forceinline__ void split_p(const float (&sc)[KS / 2],
                                        uint32_t (&p_hi)[KS / 16][4],
                                        uint32_t (&p_lo)[KS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      p_hi[kk][r] = pack(hi);
      p_lo[kk][r] = pack(__floats2bfloat162_rn(x0 - __low2float(hi),
                                               x1 - __high2float(hi)));
    }
}

// The consumer warpgroups of one (bh, q tile) block: the softmax pipeline
// over KS-key steps of the staged kv tiles, then the epilogue.
template <int D, int BQ, int BK>
__device__ __forceinline__ void consume(
    const uint8_t* q_s, const uint8_t* k_s, const uint8_t* v_s,
    uint64_t* q_full, uint64_t* k_full, uint64_t* v_full, uint64_t* kv_empty,
    bf16* __restrict__ o, float* __restrict__ lse, int bh, int q0, int n_kv,
    int T_len, int S_len, int d_len, float scale, int causal, int wg) {
  using T = Tile<D, BQ, BK>;
  constexpr int S = T::STAGES, KS = T::KS, R = BK / KS;
  const int lane = threadIdx.x % 32, w = (threadIdx.x % WG) / 32;
  const int row = wg * 64 + 16 * w + lane / 4;   // and row + 8, in the q tile
  // steps past S or wholly above the diagonal add exact zeros: skipped
  // (they lie in the last loaded tile, so every earlier stage is released)
  int n_steps = min(n_kv * R, (S_len + KS - 1) / KS);
  if (causal) n_steps = min(n_steps, (q0 + BQ - 1) / KS + 1);
  // step u: rows (u % R) KS.. of the tile in stage (u / R) % S
  auto stage = [](int u) { return (u / R) % S; };
  auto phase = [](int u) { return (u / R / S) & 1; };
  auto rows = [](int u) { return (u / R) % S * T::KV_BYTES + u % R * KS * 128; };
  // whether step u needs masks for this warpgroup's rows
  auto masked = [&](int u) {
    return (u + 1) * KS > S_len || (causal && (u + 1) * KS - 1 > q0 + wg * 64);
  };
  float o_acc[D / 2], sc[KS / 2], m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f}, alpha[2];
  uint32_t p_hi[KS / 16][4], p_lo[KS / 16][4];
  hopper::zero(o_acc);
  hopper::mbar_wait(q_full, 0);

  // Software pipeline: while P V of step u - 1 runs on the tensor cores,
  // the scores of step u go through the softmax.
  hopper::mbar_wait(&k_full[0], 0);
  issue_qk<D, BQ, BK, KS>(sc, q_s, k_s, wg);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  softmax_tile<KS>(sc, m_r, l_r, alpha, 0, q0 + row, S_len, causal,
                   masked(0), scale, lane);
  split_p<KS>(sc, p_hi, p_lo);
  for (int u = 1; u < n_steps; ++u) {
    hopper::mbar_wait(&k_full[stage(u)], phase(u));
    issue_qk<D, BQ, BK, KS>(sc, q_s, k_s + rows(u), wg);
    hopper::mbar_wait(&v_full[stage(u - 1)], phase(u - 1));
    hopper::fence_regs(o_acc);
    issue_pv<D, BK, KS>(o_acc, p_hi, p_lo, v_s + rows(u - 1));
    hopper::wgmma_wait<1>();                    // the scores are in
    hopper::fence_regs(sc);
    softmax_tile<KS>(sc, m_r, l_r, alpha, u * KS, q0 + row, S_len, causal,
                     masked(u), scale, lane);
    hopper::wgmma_wait<0>();                    // P V of step u - 1 is done
    hopper::fence_regs(o_acc);
    if (u % R == 0 && lane == 0) hopper::mbar_arrive(&kv_empty[stage(u - 1)]);
#pragma unroll
    for (int idx = 0; idx < D / 2; ++idx) o_acc[idx] *= alpha[(idx >> 1) & 1];
    split_p<KS>(sc, p_hi, p_lo);
  }
  hopper::mbar_wait(&v_full[stage(n_steps - 1)], phase(n_steps - 1));
  hopper::fence_regs(o_acc);
  issue_pv<D, BK, KS>(o_acc, p_hi, p_lo, v_s + rows(n_steps - 1));
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o_acc);

  // out = acc / max(l, 1e-30), l summed over the row's quad; rows are
  // d_len wide (columns d_len.. D - 1 of acc came from zero-filled loads)
  bf16* ob = o + static_cast<size_t>(bh) * T_len * d_len;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int q = q0 + row + 8 * i;
    if (q >= T_len) continue;
    // the row's natural-log log-sum-exp of the scaled scores (m_r is in
    // log2 units), for the backward pass
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<size_t>(bh) * T_len + q] = (m_r[i] + log2f(denom)) * LN2;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      if (8 * c + 2 * (lane % 4) < d_len)   // d_len % 8 == 0: both or neither
        *reinterpret_cast<__nv_bfloat162*>(
            ob + static_cast<size_t>(q) * d_len + 8 * c + 2 * (lane % 4)) =
            __floats2bfloat162_rn(o_acc[4 * c + 2 * i] / denom,
                                  o_acc[4 * c + 2 * i + 1] / denom);
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(Tile<D, BQ, BK>::THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
             float* __restrict__ lse, int T_len, int S_len, int d_len,
             float scale, int causal) {
  using T = Tile<D, BQ, BK>;
  constexpr int S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = hopper::align1024(smem_raw);            // [Q_BYTES]
  uint8_t* k_s = q_s + T::Q_BYTES;                       // [S][KV_BYTES]
  uint8_t* v_s = k_s + S * T::KV_BYTES;                  // [S][KV_BYTES]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + S * T::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* kv_empty = v_full + S;

  // heaviest q tiles first (under causal masking the last tiles see the
  // most keys), every head's before the next lighter tile
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int n_kv = (S_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);   // skip tiles above the diagonal
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], T::NC * 4);   // one arrival per warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / WG;
  if (wg == T::NC) {                                 // producer
    if (threadIdx.x == T::NC * WG) {
      hopper::mbar_expect_tx(q_full, T::Q_BYTES);
      load_rows<D, BQ>(q_s, &q_map, q_full, q0, bh);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % S;
        hopper::mbar_wait(&kv_empty[s], ((t / S) & 1) ^ 1);
        hopper::mbar_expect_tx(&k_full[s], T::KV_BYTES);
        load_rows<D, BK>(k_s + s * T::KV_BYTES, &k_map, &k_full[s], t * BK, bh);
        hopper::mbar_expect_tx(&v_full[s], T::KV_BYTES);
        load_rows<D, BK>(v_s + s * T::KV_BYTES, &v_map, &v_full[s], t * BK, bh);
      }
    }
  } else {
    consume<D, BQ, BK>(q_s, k_s, v_s, q_full, k_full, v_full, kv_empty, o,
                       lse, bh, q0, n_kv, T_len, S_len, d_len, scale, causal,
                       wg);
  }
}

// The tensor maps are d_len columns wide (rows of 2 d_len bytes, a multiple
// of 16 as TMA requires when d_len % 8 == 0); the D / 64 boxes of a tile
// reach past them, and TMA fills columns d_len.. D - 1 with zeros.
template <int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int T_len, int S_len, int d_len, float scale, int causal,
           cudaStream_t stream) {
  using T = Tile<D, BQ, BK>;
  CUtensorMap q_map, k_map, v_map;
  const uint64_t strides[2] = {static_cast<uint64_t>(d_len) * 2,
                               static_cast<uint64_t>(T_len) * d_len * 2};
  const uint64_t kv_strides[2] = {static_cast<uint64_t>(d_len) * 2,
                                  static_cast<uint64_t>(S_len) * d_len * 2};
  const uint64_t q_dims[3] = {static_cast<uint64_t>(d_len),
                              static_cast<uint64_t>(T_len),
                              static_cast<uint64_t>(BH)};
  const uint64_t kv_dims[3] = {static_cast<uint64_t>(d_len),
                               static_cast<uint64_t>(S_len),
                               static_cast<uint64_t>(BH)};
  const uint32_t q_box[3] = {64, BQ, 1}, kv_box[3] = {64, BK, 1};
  if (!hopper::bf16_map(&q_map, q, 3, q_dims, strides, q_box) ||
      !hopper::bf16_map(&k_map, k, 3, kv_dims, kv_strides, kv_box) ||
      !hopper::bf16_map(&v_map, v, 3, kv_dims, kv_strides, kv_box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_kernel<D, BQ, BK>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (T_len + BQ - 1) / BQ);
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(q_map, k_map, v_map,
                                              static_cast<bf16*>(o), lse,
                                              T_len, S_len, d_len,
                                              scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

// At D = 256 only 64 x 64 tiles fit (Q 32 KB and a 2-stage K / V ring of
// 4 x 32 KB, 161 KB; 128 x 128 would need 320 KB), with one consumer
// warpgroup: O is 128 fp32 registers a thread beside 32 of scores and 32
// of P hi + lo.
int dispatch(int D, int d, int bq, int bk, const void* q, const void* k,
             const void* v, void* o, float* lse, int BH, int T_len, int S_len,
             float scale, int causal, cudaStream_t stream) {
#define FA_TC_TILE(D_, BQ_, BK_)                                              \
  if (D == D_ && bq == BQ_ && bk == BK_)                                      \
    return launch<D_, BQ_, BK_>(q, k, v, o, lse, BH, T_len, S_len, d, scale,  \
                                causal, stream);
  FA_TC_TILE(64, 128, 128)
  FA_TC_TILE(64, 128, 64)
  FA_TC_TILE(64, 64, 128)
  FA_TC_TILE(64, 64, 64)
  FA_TC_TILE(128, 128, 128)
  FA_TC_TILE(128, 128, 64)
  FA_TC_TILE(128, 64, 128)
  FA_TC_TILE(128, 64, 64)
  FA_TC_TILE(256, 64, 64)
#undef FA_TC_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

extern "C" {

// q [BH, T, d], k, v [BH, S, d] -> o [BH, T, d], all of one dtype (0:
// float32, 1: bfloat16), contiguous, with 16-byte-aligned bases;
// 0 < d <= 256 with d % 8 == 0, run on the smallest compiled width (64,
// 128, 256) that holds it; bq and bk in {64, 128}, 64 at width 256.
// With a non-null `lse` it also writes each row's log-sum-exp of the
// scaled, masked scores, fp32 [BH, T] (o is the same with or without
// it).  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
int flash_attention(int dtype, int d, int bq, int bk, const void* q,
                    const void* k, const void* v, void* o, int BH, int T_len,
                    int S_len, float scale, int causal, void* lse,
                    void* stream) {
  if (d <= 0 || d > 256 || d % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  if (BH == 0 || T_len == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto lse_f = static_cast<float*>(lse);
  if (S_len == 0 && lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (S_len == 0)                 // no keys: acc / max(l, 1e-30) = 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(BH) * T_len * d * (dtype == 0 ? 4 : 2), s));
  if (dtype == 0 && (bq == 64 || bq == 128) && (bk == 64 || bk == 128))
    return tf::dispatch(D, d, q, k, v, o, lse_f, BH, T_len, S_len, scale,
                        causal, s);
  if (dtype == 1)
    return tc::dispatch(D, d, bq, bk, q, k, v, o, lse_f, BH, T_len, S_len,
                        scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
