// selective_scan: the Mamba-1 recurrence, sequential over time.
//
// Replaces the Pallas TPU kernel src/repro/kernels/selective_scan.py
// (selective_scan -> _kernel).  Per batch row b, channel i and state s:
//
//   da = exp(dt[b,t,i] * a[i,s])
//   h[s] = da * h[s] + (dt[b,t,i] * xi[b,t,i]) * B[b,t,s]
//   y[b,t,i] = sum_s h[s] * C[b,t,s]
//
// from h0 [B, I, S]; returns y [B, T, I] in the inputs' dtype (float32 or
// bfloat16) and h_last [B, I, S] in h0's dtype (float32).  All arithmetic
// is fp32.
//
// What bounds it on an H100: bytes.  Each (b, t, i) reads xi and dt and
// writes y once, and does 7 S + 1 flops on them (S <= 16 states); at
// falcon-mamba-7b (T = 2048, I = 8192, S = 16) that is some 10 flops per
// byte, left of the fp32 ridge (20).  The design reads every input once:
// one thread per (b, channel) keeps its S states in registers for the
// whole sequence, so h never touches memory between steps; ct time steps
// of B and C (shared by all channels) are staged per block in shared
// memory; xi, dt and y are read and written straight from registers,
// coalesced across the block's ci consecutive channels.  The recurrence
// is sequential in t, so the parallelism is B x I threads; steps of one
// thread overlap through the S independent state updates and the
// unrolled loads of the next steps.  T needs no padding: the last chunk
// is simply shorter.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int SMAX>
__global__ void scan_kernel(const T* __restrict__ xi, const T* __restrict__ dt,
                            const T* __restrict__ bm, const T* __restrict__ cm,
                            const float* __restrict__ a,
                            const float* __restrict__ h0, T* __restrict__ y,
                            float* __restrict__ hlast, int T_len, int I, int S,
                            int ct) {
  extern __shared__ float smem[];
  float* Bs = smem;                 // [ct][S]
  float* Cs = smem + ct * S;        // [ct][S]
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < I;

  float h[SMAX], av[SMAX];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    const bool on = live && s < S;
    h[s] = on ? h0[(static_cast<size_t>(b) * I + i) * S + s] : 0.f;
    av[s] = on ? a[static_cast<size_t>(i) * S + s] : 0.f;
  }

  for (int t0 = 0; t0 < T_len; t0 += ct) {
    const int n = min(ct, T_len - t0);
    const size_t row0 = static_cast<size_t>(b) * T_len + t0;
    __syncthreads();                          // the previous chunk is consumed
    for (int idx = threadIdx.x; idx < n * S; idx += blockDim.x) {
      Bs[idx] = to_f(bm[row0 * S + idx]);
      Cs[idx] = to_f(cm[row0 * S + idx]);
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const size_t at = (row0 + t) * I + i;
      const float dtv = to_f(dt[at]);
      const float dtx = dtv * to_f(xi[at]);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) {
        if (s < S) {
          const float da = expf(dtv * av[s]);
          h[s] = da * h[s] + dtx * Bs[t * S + s];
          acc += h[s] * Cs[t * S + s];
        }
      }
      y[at] = from_f<T>(acc);
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < SMAX; ++s)
      if (s < S) hlast[(static_cast<size_t>(b) * I + i) * S + s] = h[s];
  }
}

template <typename T, int SMAX>
int launch(const void* xi, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* hlast, int B,
           int T_len, int I, int S, int ct, int ci, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(ct) * S * sizeof(float);
  const dim3 grid((I + ci - 1) / ci, B);
  scan_kernel<T, SMAX><<<grid, ci, smem, stream>>>(
      static_cast<const T*>(xi), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(a), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hlast), T_len, I, S, ct);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* xi, const void* dt, const void* bm, const void* cm,
             const void* a, const void* h0, void* y, void* hlast, int B,
             int T_len, int I, int S, int ct, int ci, cudaStream_t stream) {
  if (S <= 4)
    return launch<T, 4>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct, ci, stream);
  if (S <= 8)
    return launch<T, 8>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct, ci, stream);
  if (S <= 16)
    return launch<T, 16>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct, ci, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// xi, dt [B, T, I], b, c [B, T, S] of one dtype (0: float32, 1: bfloat16),
// a [I, S] and h0 [B, I, S] float32, all contiguous -> y [B, T, I] in the
// inputs' dtype, h_last [B, I, S] float32.  1 <= S <= 16; ct time steps of
// B and C per shared-memory chunk, ci channels (threads) per block.
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
int selective_scan(int dtype, const void* xi, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0, void* y,
                   void* hlast, int B, int T_len, int I, int S, int ct, int ci,
                   void* stream) {
  if (B == 0 || I == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct,
                           ci, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I,
                                   S, ct, ci, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
