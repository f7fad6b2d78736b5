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
// What bounds it on an H100: bytes, if enough is in flight.  Each (b, t, i)
// reads xi and dt and writes y once, and does 7 S + 1 flops on them (S <=
// 16 states); at falcon-mamba-7b (T = 2048, I = 8192, S = 16) that is some
// 10 flops per byte, left of the fp32 ridge (20).  But the recurrence is
// sequential in t, so only B x I x S state updates can run at once, and
// each step waits on its inputs: with one thread per (b, channel), a
// falcon-mamba-7b launch has two warps per SM and is latency-bound.
//
// What the design does about it:
// - A group of G lanes (G = S rounded up to a power of two, at most 16)
//   takes one (b, channel), one state per lane, in registers for the
//   whole sequence; y_t is the group's sum of h[s] * C[t, s] by shuffles
//   (a tree: lane 0 adds its partner 8, 4, 2 and 1 lanes away).  At
//   falcon-mamba-7b that is 16 times the warps of a thread per channel;
//   4 lanes of 4 states (half the shuffles, a quarter of the warps)
//   measured slower there.
// - Time is walked in chunks of ct steps, double-buffered in shared
//   memory: while a block computes one chunk, cp.async brings the next
//   one's [ct, channels] tiles of dt and xi and its [ct, S] rows of B and
//   C, so the time loop reads only shared memory.  A ragged tile (odd I in
//   bfloat16, or an odd S) is copied with plain loads instead.
// - y_t is written into the xi slot it replaces (lane 0 of a group, after
//   the group's shuffle has consumed it), and the chunk's y tile goes out
//   coalesced after the chunk.
// A block takes ci channels (at most 64, and at most 1024 / G threads),
// rounded up to a multiple of 16; T and I need no padding (the last chunk
// is shorter, a channel past I computes and writes nothing).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_CHANNELS = 64;       // channels a block takes at most
constexpr int CHANNEL_ALIGN = 16;      // a block's channels, rounded up
constexpr int MAX_SMEM = 227 * 1024;   // dynamic shared memory a block may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// n rows of ncols elements, src rows `ld` apart, into dst rows `cb` apart;
// 4-byte cp.async copies (one fp32 or two bf16 values) when `vec`, plain
// loads otherwise.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int n, int ncols, int cb,
                                           int ld, bool vec) {
  constexpr int PER = 4 / sizeof(T);
  if (vec) {
    const int words = cb / PER;
    for (int w = threadIdx.x; w < n * words; w += blockDim.x) {
      const int t = w / words, c = (w - t * words) * PER;
      if (c < ncols) cp_async4(dst + t * cb + c, src + static_cast<size_t>(t) * ld + c);
    }
  } else {
    for (int e = threadIdx.x; e < n * cb; e += blockDim.x) {
      const int t = e / cb, c = e - t * cb;
      if (c < ncols) dst[t * cb + c] = src[static_cast<size_t>(t) * ld + c];
    }
  }
}

// `count` contiguous elements
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int count, bool vec) {
  constexpr int PER = 4 / sizeof(T);
  if (vec) {
    for (int w = threadIdx.x; w < count / PER; w += blockDim.x)
      cp_async4(dst + w * PER, src + w * PER);
  } else {
    for (int e = threadIdx.x; e < count; e += blockDim.x) dst[e] = src[e];
  }
}

// G lanes per (b, channel), lane s holding state s; cb channels per
// block, ct steps a chunk.  Shared memory: two stages of [dt: ct x cb]
// [xi: ct x cb][B: ct x S][C: ct x S], in the inputs' dtype.
template <typename T, int G>
__global__ void __launch_bounds__(MAX_THREADS)
scan_kernel(const T* __restrict__ xi, const T* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ h0,
            T* __restrict__ y, float* __restrict__ hlast, int T_len, int I,
            int S, int ct, int cb, bool vec_x, bool vec_bc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int stage_elems = 2 * ct * (cb + S);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * cb;
  const int ncols = min(cb, I - i0);
  const int jc = threadIdx.x / G;           // the block's channel
  const int g = threadIdx.x - jc * G;       // lane in the channel's group
  const int i = i0 + jc;
  const bool live = i < I;

  const int s = g;                          // the lane's state
  const bool on = live && s < S;
  float h = on ? h0[(static_cast<size_t>(b) * I + i) * S + s] : 0.f;
  const float av = on ? a[static_cast<size_t>(i) * S + s] : 0.f;

  const size_t row_b = static_cast<size_t>(b) * T_len;   // first row of batch b
  auto stage = [&](int chunk) {
    T* st = smem + (chunk & 1) * stage_elems;
    const int t0 = chunk * ct;
    const int n = min(ct, T_len - t0);
    const size_t at = (row_b + t0) * I + i0;
    stage_tile(st, dt + at, n, ncols, cb, I, vec_x);
    stage_tile(st + ct * cb, xi + at, n, ncols, cb, I, vec_x);
    stage_rows(st + 2 * ct * cb, bm + (row_b + t0) * S, n * S, vec_bc);
    stage_rows(st + 2 * ct * cb + ct * S, cm + (row_b + t0) * S, n * S, vec_bc);
  };

  const int n_chunks = (T_len + ct - 1) / ct;
  if (n_chunks > 0) stage(0);
  cp_async_commit();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    __syncthreads();                 // the other stage's y has gone out
    if (chunk + 1 < n_chunks) stage(chunk + 1);
    cp_async_commit();
    cp_async_wait_one();             // this chunk's copies have landed
    __syncthreads();

    T* const dts = smem + (chunk & 1) * stage_elems;
    T* const xs = dts + ct * cb;
    const T* const bs = xs + ct * cb;
    const T* const cs = bs + ct * S;
    const int n = min(ct, T_len - chunk * ct);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float dtv = to_f(dts[t * cb + jc]);
      const float dtx = dtv * to_f(xs[t * cb + jc]);
      float acc = 0.f;
      if (s < S) {
        const float da = expf(dtv * av);
        h = da * h + dtx * to_f(bs[t * S + s]);
        acc = h * to_f(cs[t * S + s]);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2) acc += __shfl_xor_sync(FULL_MASK, acc, off);
      if (g == 0) xs[t * cb + jc] = from_f<T>(acc);   // y_t over the xi it used
    }
    __syncthreads();
    T* const yc = y + (row_b + chunk * ct) * I + i0;
    for (int e = threadIdx.x; e < n * cb; e += blockDim.x) {
      const int t = e / cb, c = e - t * cb;
      if (c < ncols) yc[static_cast<size_t>(t) * I + c] = xs[t * cb + c];
    }
  }
  if (on) hlast[(static_cast<size_t>(b) * I + i) * S + s] = h;
}

struct Geometry {
  int group, cb, threads, blocks_x;
  size_t smem;
};

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The launch of one call: S rounded up to a power of two lanes per
// channel, cb channels per block.  False for sizes the kernel does not
// take.
bool plan(int I, int S, int ct, int ci, size_t elem, Geometry* g) {
  if (S < 1 || S > 16 || ct < 1 || ci < 1) return false;
  g->group = pow2_at_least(S);
  int cb = ci < MAX_CHANNELS ? ci : MAX_CHANNELS;
  if (cb > MAX_THREADS / g->group) cb = MAX_THREADS / g->group;
  g->cb = (cb + CHANNEL_ALIGN - 1) / CHANNEL_ALIGN * CHANNEL_ALIGN;
  g->threads = g->cb * g->group;
  g->blocks_x = (I + g->cb - 1) / g->cb;
  g->smem = 2 * 2 * static_cast<size_t>(ct) * (g->cb + S) * elem;
  return g->smem <= static_cast<size_t>(MAX_SMEM);
}

template <typename T, int G>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&scan_kernel<T, G>);
}

template <typename T>
const void* kernel_for(const Geometry& g) {
  switch (g.group) {
    case 1: return kernel_of<T, 1>();
    case 2: return kernel_of<T, 2>();
    case 4: return kernel_of<T, 4>();
    case 8: return kernel_of<T, 8>();
    default: return kernel_of<T, 16>();
  }
}

template <typename T>
int launch(const void* xi, const void* dt, const void* bm, const void* cm,
           const void* a, const void* h0, void* y, void* hlast, int B,
           int T_len, int I, int S, int ct, int ci, cudaStream_t stream) {
  Geometry g;
  if (!plan(I, S, ct, ci, sizeof(T), &g)) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_for<T>(g);
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto aligned4 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; };
  // two bf16 values per 4-byte copy need even rows and aligned bases
  const bool wide = sizeof(T) == 4;
  bool vec_x = wide || (I % 2 == 0 && aligned4(xi) && aligned4(dt));
  bool vec_bc = wide || (S % 2 == 0 && aligned4(bm) && aligned4(cm));
  const T* xi_t = static_cast<const T*>(xi);
  const T* dt_t = static_cast<const T*>(dt);
  const T* bm_t = static_cast<const T*>(bm);
  const T* cm_t = static_cast<const T*>(cm);
  const float* a_t = static_cast<const float*>(a);
  const float* h0_t = static_cast<const float*>(h0);
  T* y_t = static_cast<T*>(y);
  float* hl_t = static_cast<float*>(hlast);
  void* args[] = {&xi_t, &dt_t, &bm_t, &cm_t, &a_t, &h0_t, &y_t, &hl_t,
                  &T_len, &I, &S, &ct, &g.cb, &vec_x, &vec_bc};
  const cudaError_t err = cudaLaunchKernel(fn, dim3(g.blocks_x, B), dim3(g.threads), args,
                                           g.smem, stream);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// xi, dt [B, T, I], b, c [B, T, S] of one dtype (0: float32, 1: bfloat16),
// a [I, S] and h0 [B, I, S] float32, all contiguous -> y [B, T, I] in the
// inputs' dtype, h_last [B, I, S] float32.  1 <= S <= 16; ct time steps a
// chunk; ci channels a block (at most 64 are taken).  Launches on `stream`,
// allocates nothing, returns a CUDA error code.
int selective_scan(int dtype, const void* xi, const void* dt, const void* bm,
                   const void* cm, const void* a, const void* h0, void* y,
                   void* hlast, int B, int T_len, int I, int S, int ct, int ci,
                   void* stream) {
  if (B == 0 || I == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct, ci, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xi, dt, bm, cm, a, h0, y, hlast, B, T_len, I, S, ct, ci,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch selective_scan makes for these sizes: out = {blocks, threads
// a block, shared-memory bytes, lanes per channel, most blocks resident on
// one SM}.  Returns a CUDA error code.
int selective_scan_geometry(int dtype, int B, int I, int S, int ct, int ci,
                            int* out) {
  Geometry g;
  const size_t elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !plan(I, S, ct, ci, elem, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = dtype == 0 ? kernel_for<float>(g) : kernel_for<__nv_bfloat16>(g);
  if (g.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, g.threads, g.smem);
  out[0] = g.blocks_x * B;
  out[1] = g.threads;
  out[2] = static_cast<int>(g.smem);
  out[3] = g.group;
  out[4] = per_sm;
  return static_cast<int>(err);
}

const char* selective_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
