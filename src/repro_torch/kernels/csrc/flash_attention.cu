// flash_attention: streaming-softmax attention, one block per (bh, q tile).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel): q [BH, T, d] against k, v [BH, S, d],
// scale 1/sqrt(d), float32 or bfloat16 in and out.  The reference's
// semantics are kept exactly: NEG_INF = -1e30 for masked scores, keys at
// or beyond S masked, causal masking top-left (key kpos is seen by query
// qpos when kpos <= qpos, also when T != S), a running max, denominator
// and fp32 accumulator per query row, out = acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  Per (query, key) pair it does
// 4 d flops of products plus the softmax; at bert-large (T = S = 512,
// d = 64) that is 66 flops per byte of q, k, v and out, at a yi-6b
// prefill (4096, d = 128) over 1,000 -- both right of the ridge.  This
// first version computes in fp32 on the CUDA cores (bf16 is widened on
// load), so the 67 TFLOP/s fp32 rate is its ceiling.  The design: the
// block's q tile stays in shared memory for the whole kv loop; each kv
// tile is staged in shared memory once (K transposed, then V in the same
// buffer), so global memory sees every k and v row once per q tile; the
// 256 threads each own a register tile of the scores (phase 1) and of the
// output accumulator (phase 3), and one warp per row does the softmax
// update (phase 2) with shuffles.  With causal masking, kv tiles that lie
// wholly above the diagonal are skipped: every query row has seen key 0
// by then, so those tiles would add exact zeros (alpha = exp(0) = 1,
// p = exp(-1e30 - m) = 0).  Tiles of 128 x 128 at d = 128 need 195 KB of
// shared memory, above the 48 KB default: the launch raises the limit
// with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // 16 x 16 threads; 8 warps
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D, int BQ, int BK>
constexpr size_t smem_floats() {
  // Qs [BQ][D+1], KV [max(D (BK+1), BK D)], Ss [BQ][BK+1], m, l, alpha [BQ]
  return static_cast<size_t>(BQ) * (D + 1) + static_cast<size_t>(D) * (BK + 1) +
         static_cast<size_t>(BQ) * (BK + 1) + 3 * BQ;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int T_len, int S_len,
             float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                               // [BQ][D+1]
  float* KV = Qs + BQ * (D + 1);                  // Kt [D][BK+1] | Vs [BK][D]
  float* Ss = KV + D * (BK + 1);                  // [BQ][BK+1]
  float* m_s = Ss + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* qb = q + static_cast<size_t>(bh) * T_len * D;
  const T* kb = k + static_cast<size_t>(bh) * S_len * D;
  const T* vb = v + static_cast<size_t>(bh) * S_len * D;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    Qs[r * (D + 1) + c] =
        q0 + r < T_len ? to_f(qb[static_cast<size_t>(q0 + r) * D + c]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  constexpr int RQ = BQ / 16, CK = BK / 16, CD = D / 16;
  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  int n_kv = (S_len + BK - 1) / BK;
  if (causal) n_kv = min(n_kv, (q0 + BQ - 1) / BK + 1);   // skip tiles above the diagonal
  for (int kt = 0; kt < n_kv; ++kt) {
    const int kv0 = kt * BK;
    __syncthreads();                              // previous tile's readers are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      KV[c * (BK + 1) + r] =
          kv0 + r < S_len ? to_f(kb[static_cast<size_t>(kv0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    // phase 1: scores of this thread's RQ x CK register tile
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = KV[dd * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j, kpos = kv0 + c;
        const bool keep = kpos < S_len && (!causal || kpos <= qpos);
        Ss[r * (BK + 1) + c] = keep ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();                              // K no longer read; scores ready

    // stage V over K, and the softmax update, one warp per row
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D;
      KV[idx] = kv0 + r < S_len ? to_f(vb[static_cast<size_t>(kv0) * D + idx]) : 0.f;
    }
    for (int r = warp; r < BQ; r += THREADS / 32) {
      float* row = Ss + r * (BK + 1);
      float mx = NEG_INF;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) mx = fmaxf(mx, row[lane + 32 * u]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(row[lane + 32 * u] - m_new);
        row[lane + 32 * u] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // phase 3: acc = acc * alpha + p @ v on this thread's RQ x CD tile
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float alpha = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < CD; ++j) vv[j] = KV[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = o + static_cast<size_t>(bh) * T_len * D;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= T_len) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CD; ++j)
      ob[static_cast<size_t>(q0 + r) * D + tx + 16 * j] = from_f<T>(acc[i][j] / denom);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T_len, int S_len, float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D, BQ, BK>() * sizeof(float);
  auto kern = flash_kernel<T, D, BQ, BK>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const dim3 grid((T_len + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_len, S_len, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int d, int bq, int bk, const void* q, const void* k,
             const void* v, void* o, int BH, int T_len, int S_len, float scale,
             int causal, cudaStream_t stream) {
#define FA_TILE(D_, BQ_, BK_)                                                 \
  if (d == D_ && bq == BQ_ && bk == BK_)                                      \
    return launch<T, D_, BQ_, BK_>(q, k, v, o, BH, T_len, S_len, scale,       \
                                   causal, stream);
  FA_TILE(64, 128, 128)
  FA_TILE(64, 128, 64)
  FA_TILE(64, 64, 128)
  FA_TILE(64, 64, 64)
  FA_TILE(128, 128, 128)
  FA_TILE(128, 128, 64)
  FA_TILE(128, 64, 128)
  FA_TILE(128, 64, 64)
#undef FA_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q [BH, T, d], k, v [BH, S, d] -> o [BH, T, d], all of one dtype (0:
// float32, 1: bfloat16), contiguous; d in {64, 128}, bq and bk in
// {64, 128}.  Launches on `stream`, allocates nothing, returns
// cudaGetLastError().
int flash_attention(int dtype, int d, int bq, int bk, const void* q,
                    const void* k, const void* v, void* o, int BH, int T_len,
                    int S_len, float scale, int causal, void* stream) {
  if (BH == 0 || T_len == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, bq, bk, q, k, v, o, BH, T_len, S_len, scale,
                           causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, bq, bk, q, k, v, o, BH, T_len, S_len,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
