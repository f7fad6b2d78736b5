// adamw: AdamW's global-norm clip and update over every leaf of a training
// step, as multi-tensor kernels on one table of leaves.
//
// Replaces no TPU kernel: the reference's optimizer (src/repro/optim/adamw.py,
// AdamW.update) is jnp that XLA fuses.  Eager PyTorch does not fuse it: the
// port's per-leaf loop (kernels/ref.py adamw_apply_ref, the CPU route) runs about 18
// kernels a leaf and moves about 168 B a parameter.  Here the norm reads each
// gradient once (4 B a parameter) and the update reads g, p, m and v once and
// writes p, m and v once (28 B a parameter).
//
// The table (built by kernels/adamw.py, one 64-byte row a leaf, copied to
// the device from pinned memory on the launching stream) holds each leaf's
// four base pointers, its element count, the index of its first chunk, its
// decay flag and whether all four bases are 16-byte aligned.  A leaf is cut
// into chunks of CHUNK elements (kernels/adamw.py's CHUNK; the last chunk of
// a leaf is shorter); a block takes one chunk and finds its leaf by a binary search
// over the rows' first chunks.  Offsets are 64-bit: a step may hold more
// than 2^31 elements.  An aligned leaf is read and written as float4 with a
// scalar tail of n % 4 elements; a leaf with a misaligned base is scalar.
//
// 1. adamw_sumsq: each chunk's fp32 sum of squares of g (per-thread sums of
//    strided float4 lanes, then a fixed shuffle tree: deterministic), then
//    one block a leaf adds its chunks' partials in a fixed order.
// 2. adamw_norm: one thread adds the leaves' sums in leaf order, as the
//    loop's sum() does, and takes the sqrt.
// 3. adamw_apply: each element, in the loop's order of operations, every
//    operation rounded once in fp32 (__f*_rn, so no contraction into an FMA
//    changes a bit):
//      scale = min(clip * (1 / max(norm, 1e-12)), 1)   (NaN propagates)
//      g' = g * scale
//      m  = m * b1 + g' * (1 - b1)
//      v  = v * b2 + (g' * (1 - b2)) * g'
//      u  = (m / b1c) / (sqrt(v / b2c) + eps)    [+ wd * p where decayed]
//      p  = p - lr * u
//    The scalars arrive as the fp32 values the loop's kernels use: Python's
//    doubles (1 - b1 computed in double) rounded once to fp32.
//
// What bounds it on an H100: bytes (the update does about 30 flops and three
// IEEE divisions on 28 B).  The design keeps every thread's four loads in
// flight together (two float4 of each array an iteration) and launches one
// kernel for all the leaves.
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
// elements a chunk: a block's work (a multiple of the float4 width)
constexpr long long CHUNK = 1LL << 16;
static_assert(CHUNK % 4 == 0, "a chunk is whole float4s");
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;       // elements
  long long chunk0;  // the leaf's first chunk in the step's numbering
  long long decay;   // 1: add wd * p to the update
  long long vec;     // 1: p, g, m and v all 16-byte aligned
};
static_assert(sizeof(Leaf) == 64, "a table row is 8 int64");

struct Hyper {
  float lr, b1, omb1, b2, omb2, b1c, b2c, eps, wd, clip, clip_floor;
};
constexpr int HYPER_FIELDS = 11;
static_assert(sizeof(Hyper) == HYPER_FIELDS * sizeof(float), "packed floats");

// The leaf of chunk c: the last row whose first chunk is at most c (rows of
// empty leaves share the next row's first chunk and are passed over).
__device__ __forceinline__ int find_leaf(const Leaf* __restrict__ table, int leaves,
                                         long long c) {
  int lo = 0, hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].chunk0 <= c)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// The block's sum of one value a thread, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  s = 0.0f;
  if (warp == 0) {
    s = lane < THREADS / 32 ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL_MASK, s, o);
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
    sumsq_kernel(const Leaf* __restrict__ table, int leaves, float* __restrict__ partial) {
  const long long c = blockIdx.x;
  const Leaf lf = table[find_leaf(table, leaves, c)];
  const long long start = (c - lf.chunk0) * CHUNK;
  const long long end = min(start + CHUNK, lf.n);
  const float* __restrict__ g = lf.g;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  long long tail = start;
  if (lf.vec) {
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + start);
    const long long nv = (end - start) >> 2;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nv; i += THREADS) {
      const float4 x = __ldcs(g4 + i);
      a0 = fmaf(x.x, x.x, a0);
      a1 = fmaf(x.y, x.y, a1);
      a2 = fmaf(x.z, x.z, a2);
      a3 = fmaf(x.w, x.w, a3);
    }
    tail = start + 4 * nv;
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
    const float x = g[i];
    a0 = fmaf(x, x, a0);
  }
  const float s = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) partial[c] = s;
}

__global__ void __launch_bounds__(THREADS)
    leaf_sums_kernel(const Leaf* __restrict__ table, const float* __restrict__ partial,
                     float* __restrict__ sums) {
  const Leaf lf = table[blockIdx.x];
  const long long nch = (lf.n + CHUNK - 1) / CHUNK;
  float a = 0.0f;
  for (long long i = threadIdx.x; i < nch; i += THREADS) a += partial[lf.chunk0 + i];
  a = block_sum(a);
  if (threadIdx.x == 0) sums[blockIdx.x] = a;
}

__global__ void norm_kernel(const float* __restrict__ sums, int leaves,
                            float* __restrict__ out) {
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < leaves; ++i) acc = __fadd_rn(acc, sums[i]);
  out[0] = __fsqrt_rn(acc);
}

// torch.clamp(min= / max=) keep a NaN operand.
__device__ __forceinline__ float clip_scale(float norm, const Hyper& h) {
  const float x = isnan(norm) ? norm : fmaxf(norm, h.clip_floor);
  const float s = __fmul_rn(__fdiv_rn(1.0f, x), h.clip);
  return isnan(s) ? s : fminf(s, 1.0f);
}

__device__ __forceinline__ void step(float& p, float g, float& m, float& v, float scale,
                                     bool decay, const Hyper& h) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(gs, h.omb1));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(gs, h.omb2), gs));
  float u = __fdiv_rn(__fdiv_rn(m, h.b1c), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

__device__ __forceinline__ void step4(float4& p, const float4& g, float4& m, float4& v,
                                      float scale, bool decay, const Hyper& h) {
  step(p.x, g.x, m.x, v.x, scale, decay, h);
  step(p.y, g.y, m.y, v.y, scale, decay, h);
  step(p.z, g.z, m.z, v.z, scale, decay, h);
  step(p.w, g.w, m.w, v.w, scale, decay, h);
}

__global__ void __launch_bounds__(THREADS)
    apply_kernel(const Leaf* __restrict__ table, int leaves, const float* __restrict__ norm,
                 const Hyper h) {
  const long long c = blockIdx.x;
  const Leaf lf = table[find_leaf(table, leaves, c)];
  const long long start = (c - lf.chunk0) * CHUNK;
  const long long end = min(start + CHUNK, lf.n);
  const float scale = clip_scale(*norm, h);
  const bool decay = lf.decay != 0;
  float* __restrict__ p = lf.p;
  const float* __restrict__ g = lf.g;
  float* __restrict__ m = lf.m;
  float* __restrict__ v = lf.v;
  long long tail = start;
  if (lf.vec) {
    float4* __restrict__ p4 = reinterpret_cast<float4*>(p + start);
    const float4* __restrict__ g4 = reinterpret_cast<const float4*>(g + start);
    float4* __restrict__ m4 = reinterpret_cast<float4*>(m + start);
    float4* __restrict__ v4 = reinterpret_cast<float4*>(v + start);
    const long long nv = (end - start) >> 2;
    for (long long i = threadIdx.x; i < nv; i += 2 * THREADS) {
      const long long j = i + THREADS;
      const bool two = j < nv;
      const float4 ga = __ldcs(g4 + i);
      float4 pa = __ldcs(p4 + i), ma = __ldcs(m4 + i), va = __ldcs(v4 + i);
      float4 gb, pb, mb, vb;
      if (two) {
        gb = __ldcs(g4 + j);
        pb = __ldcs(p4 + j);
        mb = __ldcs(m4 + j);
        vb = __ldcs(v4 + j);
      }
      step4(pa, ga, ma, va, scale, decay, h);
      __stcs(p4 + i, pa);
      __stcs(m4 + i, ma);
      __stcs(v4 + i, va);
      if (two) {
        step4(pb, gb, mb, vb, scale, decay, h);
        __stcs(p4 + j, pb);
        __stcs(m4 + j, mb);
        __stcs(v4 + j, vb);
      }
    }
    tail = start + 4 * nv;
  }
  for (long long i = tail + threadIdx.x; i < end; i += THREADS) {
    float pi = p[i], mi = m[i], vi = v[i];
    step(pi, g[i], mi, vi, scale, decay, h);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Each leaf's fp32 sum of squares of g: `table` is the device copy of
// `leaves` rows, cut into `chunks` chunks of CHUNK elements; `partial`
// [chunks] and `sums` [leaves] float32.  Two launches on `stream`; returns
// a CUDA error code.
int adamw_sumsq(const void* table, int leaves, long long chunks, float* partial, float* sums,
                void* stream) {
  if (leaves <= 0) return 0;
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto t = static_cast<const Leaf*>(table);
  if (chunks > 0) {
    sumsq_kernel<<<static_cast<unsigned>(chunks), THREADS, 0, s>>>(t, leaves, partial);
    const int err = last_error();
    if (err) return err;
  }
  leaf_sums_kernel<<<leaves, THREADS, 0, s>>>(t, partial, sums);
  return last_error();
}

// sqrt of the leaves' sums added in leaf order, into out[0].  One launch.
int adamw_norm(const float* sums, int leaves, float* out, void* stream) {
  norm_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(sums, leaves, out);
  return last_error();
}

// The clipped AdamW update of every leaf of the table, in place, from the
// global norm at `norm` (device) and the HYPER_FIELDS floats at `hyper`
// (host): lr, b1, 1 - b1, b2, 1 - b2, the two bias corrections, eps, the
// weight decay, the clip and the norm's floor.  One launch.
int adamw_apply(const void* table, int leaves, long long chunks, const float* norm,
                const float* hyper, void* stream) {
  if (leaves <= 0 || chunks == 0) return 0;
  if (chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Hyper h;
  std::memcpy(&h, hyper, sizeof(Hyper));
  apply_kernel<<<static_cast<unsigned>(chunks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(table), leaves, norm, h);
  return last_error();
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
