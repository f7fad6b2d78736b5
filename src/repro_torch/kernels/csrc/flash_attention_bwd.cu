// flash_attention_bwd: the gradient of softmax attention, dq, dk and dv.
//
// The reference has no backward kernel: its models differentiate jnp
// attention (src/repro/models/layers.py:130-192), and its Pallas kernel
// src/repro/kernels/flash_attention.py has no custom_vjp.  The port's
// training forward runs through the flash_attention kernel, so this is its
// backward: q, k, v, do [BH, T|S, d] bfloat16, the forward's row
// log-sum-exp lse [BH, T] fp32 (natural log of the scaled, masked scores),
// scale 1/sqrt(d), causal top-left or none; dq, dk, dv bfloat16 with fp32
// accumulation.  With P = exp(scale q k^T - lse) (masked entries 0):
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
// is 344 GFLOP, 0.35 ms at the 989 TFLOP/s bf16 tensor-core rate.  This
// first version computes on the CUDA cores (67 TFLOP/s fp32 is its
// ceiling) and recomputes QK^T and dO V^T in each of the three passes
// below (9 products a pair): right first, the tensor cores (wgmma, TMA)
// are later work.
//
// Design: three launches, no float atomics, so the result is the same bit
// for bit on every run.
// 1. dsum: one block per (bh, q tile of 64 queries) walks the kv tiles up
//    to the diagonal, recomputing P and dP, and writes D[bh, t] =
//    sum_j P dP (each thread's 4 x 4 tile, then a fixed shuffle tree over
//    the 16 lanes of a row).
// 2. dkdv: one block per (bh, kv tile of 64 keys); k and v stay in shared
//    memory (fp32) and dk, dv in registers while the block walks the q
//    tiles that see its keys (from the diagonal on under causal masking);
//    per q tile it recomputes P from lse and dS, then adds P^T do and
//    dS^T q.  Every dk, dv row is written by one block, once.
// 3. dq: one block per (bh, q tile of 64 queries); q, do, lse and D stay,
//    dq in registers, while the block walks the kv tiles up to the
//    diagonal, recomputing P and dS and adding dS k.
// 256 threads a block as 16 x 16; each owns a 4 x 4 register tile of the
// [64 x 64] score tile and a 4 x (d / 16) tile of its [64 x d]
// accumulators.  Shared rows are padded by one float so that a warp's
// column reads fall in distinct banks.  At d = 128 a block holds 166 KB of
// shared memory (above the 48 KB default: the launch raises the limit).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int BQ = 64, BK = 64;        // query and key tile

template <int D>
constexpr size_t smem_floats() {
  // Qs, dOs [BQ][D+1]; Ks, Vs [BK][D+1]; Ps, dSs [BQ][BK+1]; lse, D [BQ]
  return 2 * static_cast<size_t>(BQ) * (D + 1) + 2 * static_cast<size_t>(BK) * (D + 1) +
         2 * static_cast<size_t>(BQ) * (BK + 1) + 2 * BQ;
}

// rows r0.. of a [len, D] bf16 matrix into fp32 smem rows D + 1 apart;
// rows at or past len are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const bf16* src, int r0, int len) {
  for (int idx = threadIdx.x; idx < ROWS * D / 2; idx += THREADS) {
    const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
    float2 v = make_float2(0.f, 0.f);
    if (r0 + r < len)
      v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(src + static_cast<size_t>(r0 + r) * D + c));
    dst[r * (D + 1) + c] = v.x;
    dst[r * (D + 1) + c + 1] = v.y;
  }
}

// P and dS of the [BQ x BK] tile (query rows q0.., keys k0..) for this
// thread's 4 x 4 register tile: rows ty + 16 i, keys tx + 16 j.  P is
// exp(scale s - lse), 0 where masked or past T / S; dS = P (dP - D).
template <int D>
__device__ __forceinline__ void p_ds_tile(const float* Qs, const float* dOs, const float* Ks,
                                          const float* Vs, const float* lse_s,
                                          const float* d_s, int q0, int k0, int T_len,
                                          int S_len, float scale, int causal,
                                          float (&p)[4][4], float (&ds)[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = Qs[(ty + 16 * i) * (D + 1) + dd];
      ov[i] = dOs[(ty + 16 * i) * (D + 1) + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = Ks[(tx + 16 * j) * (D + 1) + dd];
      vv[j] = Vs[(tx + 16 * j) * (D + 1) + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool keep = qpos < T_len && kpos < S_len && (!causal || kpos <= qpos);
      p[i][j] = keep ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - d_s[r]);
    }
  }
}

// D[bh, t] = sum_j P dP over the row's keys in fp32, one block per (bh, q
// tile): p_ds_tile with D = 0 gives P dP; each thread sums its 4 x 4 tile's
// columns, then the 16 lanes of a row add by a fixed shuffle tree.
template <int D>
__global__ void __launch_bounds__(THREADS)
dsum_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ lse, float* __restrict__ Dv, int T_len,
            int S_len, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (D + 1);
  float* Ks = dOs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* lse_s = Vs + BK * (D + 1);
  float* zero_s = lse_s + BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y, q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t qo = static_cast<size_t>(bh) * T_len, ko = static_cast<size_t>(bh) * S_len;
  load_tile<D, BQ>(Qs, q + qo * D, q0, T_len);
  load_tile<D, BQ>(dOs, dO + qo * D, q0, T_len);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    lse_s[r] = q0 + r < T_len ? lse[qo + q0 + r] : 0.f;
    zero_s[r] = 0.f;
  }
  float rows[4] = {0.f, 0.f, 0.f, 0.f};
  int k_end = S_len;
  if (causal) k_end = min(k_end, q0 + BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D, BK>(Ks, k + ko * D, k0, S_len);
    load_tile<D, BK>(Vs, v + ko * D, k0, S_len);
    __syncthreads();
    float p[4][4], pdp[4][4];
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, zero_s, q0, k0, T_len, S_len, scale, causal, p, pdp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) rows[i] += pdp[i][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off /= 2) rows[i] += __shfl_xor_sync(0xffffffffu, rows[i], off);
    const int qpos = q0 + ty + 16 * i;
    if (tx == 0 && qpos < T_len) Dv[qo + qpos] = rows[i];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ Dv,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int T_len, int S_len,
            float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][D+1]
  float* dOs = Qs + BQ * (D + 1);         // [BQ][D+1]
  float* Ks = dOs + BQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D+1]
  float* Ps = Vs + BK * (D + 1);          // [BQ][BK+1]
  float* dSs = Ps + BQ * (BK + 1);        // [BQ][BK+1]
  float* lse_s = dSs + BQ * (BK + 1);     // [BQ]
  float* d_s = lse_s + BQ;                // [BQ]

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t qo = static_cast<size_t>(bh) * T_len, ko = static_cast<size_t>(bh) * S_len;
  load_tile<D, BK>(Ks, k + ko * D, k0, S_len);
  load_tile<D, BK>(Vs, v + ko * D, k0, S_len);

  constexpr int CD = D / 16;
  float acc_k[4][CD], acc_v[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // under causal masking only queries at or past k0 see these keys
  const int q_start = causal ? k0 / BQ * BQ : 0;
  for (int q0 = q_start; q0 < T_len; q0 += BQ) {
    __syncthreads();                      // the last tile's readers are done
    load_tile<D, BQ>(Qs, q + qo * D, q0, T_len);
    load_tile<D, BQ>(dOs, dO + qo * D, q0, T_len);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      lse_s[r] = q0 + r < T_len ? lse[qo + q0 + r] : 0.f;
      d_s[r] = q0 + r < T_len ? Dv[qo + q0 + r] : 0.f;
    }
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, d_s, q0, k0, T_len, S_len, scale, causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dv[key] += P[:, key]^T do; dk[key] += dS[:, key]^T q, keys ty + 16 i,
    // columns tx + 16 j
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], sv[4], ov[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[r * (BK + 1) + ty + 16 * i];
        sv[i] = dSs[r * (BK + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < CD; ++j) {
        ov[j] = dOs[r * (D + 1) + tx + 16 * j];
        qv[j] = Qs[r * (D + 1) + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          acc_v[i][j] = fmaf(pv[i], ov[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sv[i], qv[j], acc_k[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= S_len) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      const size_t at = (ko + kpos) * D + tx + 16 * j;
      dk[at] = __float2bfloat16_rn(acc_k[i][j] * scale);
      dv[at] = __float2bfloat16_rn(acc_v[i][j]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ Dv,
          bf16* __restrict__ dq, int T_len, int S_len, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * (D + 1);
  float* Ks = dOs + BQ * (D + 1);
  float* Vs = Ks + BK * (D + 1);
  float* dSs = Vs + BK * (D + 1) + BQ * (BK + 1);   // the Ps slot stays unused
  float* lse_s = dSs + BQ * (BK + 1);
  float* d_s = lse_s + BQ;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int bh = blockIdx.y;
  // heaviest q tiles first: under causal masking the last ones see the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t qo = static_cast<size_t>(bh) * T_len, ko = static_cast<size_t>(bh) * S_len;
  load_tile<D, BQ>(Qs, q + qo * D, q0, T_len);
  load_tile<D, BQ>(dOs, dO + qo * D, q0, T_len);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    lse_s[r] = q0 + r < T_len ? lse[qo + q0 + r] : 0.f;
    d_s[r] = q0 + r < T_len ? Dv[qo + q0 + r] : 0.f;
  }

  constexpr int CD = D / 16;
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  int k_end = S_len;
  if (causal) k_end = min(k_end, q0 + BQ);   // keys past the tile's last query add zeros
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<D, BK>(Ks, k + ko * D, k0, S_len);
    load_tile<D, BK>(Vs, v + ko * D, k0, S_len);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_ds_tile<D>(Qs, dOs, Ks, Vs, lse_s, d_s, q0, k0, T_len, S_len, scale, causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq[row] += dS[row, :] k, rows ty + 16 i, columns tx + 16 j
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[CD];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kv[j] = Ks[c * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= T_len) continue;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      dq[(qo + qpos) * D + tx + 16 * j] = __float2bfloat16_rn(acc[i][j] * scale);
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dO, const float* lse,
           float* Dv, bf16* dq, bf16* dk, bf16* dv, int BH, int T_len, int S_len,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dsum_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dsum_kernel<D><<<dim3((T_len + BQ - 1) / BQ, BH), THREADS, smem, stream>>>(
      q, k, v, dO, lse, Dv, T_len, S_len, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<D><<<dim3((S_len + BK - 1) / BK, BH), THREADS, smem, stream>>>(
      q, k, v, dO, lse, Dv, dk, dv, T_len, S_len, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<D><<<dim3((T_len + BQ - 1) / BQ, BH), THREADS, smem, stream>>>(
      q, k, v, dO, lse, Dv, dq, T_len, S_len, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, do [BH, T, d], k, v [BH, S, d] bfloat16 and lse [BH, T] fp32, all
// contiguous; d in {64, 128}; D_scratch fp32 [BH, T] -> dq [BH, T, d], dk,
// dv [BH, S, d] bfloat16.  T, S >= 1.  Three launches on `stream`;
// allocates nothing, returns a CUDA error code.
int flash_attention_bwd(int d, const void* q, const void* k, const void* v, const void* dO,
                        const void* lse, void* D_scratch, void* dq, void* dk, void* dv,
                        int BH, int T_len, int S_len, float scale, int causal,
                        void* stream) {
  if (BH == 0 || T_len == 0 || S_len == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto w = [](void* p) { return static_cast<bf16*>(p); };
  auto lse_f = static_cast<const float*>(lse);
  auto d_f = static_cast<float*>(D_scratch);
  if (d == 64)
    return launch<64>(b(q), b(k), b(v), b(dO), lse_f, d_f, w(dq), w(dk), w(dv), BH, T_len,
                      S_len, scale, causal, s);
  if (d == 128)
    return launch<128>(b(q), b(k), b(v), b(dO), lse_f, d_f, w(dq), w(dk), w(dv), BH, T_len,
                       S_len, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
