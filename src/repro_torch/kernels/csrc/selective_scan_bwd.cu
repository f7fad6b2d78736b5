// selective_scan_bwd: the gradient of the Mamba-1 recurrence.
//
// The reference has no backward kernel: its models differentiate the jnp
// scan (src/repro/models/ssm.py:96-132), and its Pallas kernel
// src/repro/kernels/selective_scan.py has no custom_vjp.  The port's
// training forward runs through the selective_scan kernel, so this is its
// backward.  Forward, per batch row b, channel i, state s:
//
//   da_t = exp(dt_t a),  h_t = da_t h_{t-1} + dt_t xi_t B_t[s],
//   y_t = sum_s h_t[s] C_t[s].
//
// Given dy [B, T, I] and dh_last [B, I, S], the reverse recurrence with
// g = dL/dh_t:  g += dy_t C_t;  dC_t += sum_i dy_t h_t;  d(da_t) = g h_{t-1};
// d(dbx_t) = g;  g <- g da_t;  and through da = exp(dt a), dbx = dt xi B:
// ddt_t = sum_s (d(da_t) da_t a + g xi_t B_t),  dxi_t = sum_s g dt_t B_t,
// dB_t = sum_i g dt_t xi_t,  da = sum_{b,t} d(da_t) da_t dt_t,  dh0 = g.
// All fp32.
//
// What bounds it on an H100: bytes.  It reads xi, dt, dy and writes dxi,
// ddt (five [B, T, I] fp32 arrays; B, C, a, h0 are small), some 0.34 GB at
// falcon-mamba-7b (1 x 2048 x 8192 x 16), 0.1 ms at 3.35 TB/s; its ~30
// flops per (b, t, i, s) are 8 GFLOP there, 0.12 ms at the fp32 rate.  But
// the recurrence is sequential in t both ways, so as in the forward the
// design is about keeping enough independent lanes in flight.
//
// Design: the forward's lane layout -- a group of G lanes (S rounded up to
// a power of two) per (b, channel), one state per lane, 256 threads a
// block (256 / G channels) -- and no float atomics:
// 1. Each block first runs the forward recurrence over all T for its
//    channels and stores the state entering every chunk of CT = 32 steps
//    (a checkpoint, [B, chunks, I, S] scratch).
// 2. It then walks the chunks backwards: it recomputes the chunk's h_t from
//    its checkpoint into shared memory (never by dividing h backwards),
//    then runs the reverse recurrence over the chunk.  The sums over s
//    (ddt, dxi) are shuffle trees inside a group, written over the dt and xi
//    they used and stored coalesced after the chunk; the sums over channels
//    (dB, dC) are shuffle trees inside a warp, then the block's warps are
//    added in a fixed order into a per-block partial [B, tiles, T, S].
// 3. A second launch adds the partials over the blocks (dB, dC) and over
//    the batch (da, from per-row partials [B, I, S]) in a fixed order.
// Every sum is taken in one order, so two runs agree bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;       // warps a block
constexpr int CT = 32;                 // steps a chunk (checkpoint spacing)

__host__ __device__ constexpr size_t smem_floats(int G, int S) {
  // dt, xi, dy [CT][cb]; B, C [CT][S]; h [CT][THREADS]; dB, dC [CT][NW][G]
  return 3 * static_cast<size_t>(CT) * (THREADS / G) + 2 * static_cast<size_t>(CT) * S +
         static_cast<size_t>(CT) * THREADS + 2 * static_cast<size_t>(CT) * NW * G;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
scan_bwd_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ h0,
                const float* __restrict__ dy, const float* __restrict__ dh_last,
                float* __restrict__ dxi, float* __restrict__ ddt, float* __restrict__ dh0,
                float* __restrict__ ckpt, float* __restrict__ part_b,
                float* __restrict__ part_c, float* __restrict__ part_a, int T_len, int I,
                int S) {
  constexpr int CB = THREADS / G;                 // channels a block
  extern __shared__ float smem[];
  float* dts = smem;                              // [CT][CB], then ddt
  float* xs = dts + CT * CB;                      // [CT][CB], then dxi
  float* dys = xs + CT * CB;                      // [CT][CB]
  float* bs = dys + CT * CB;                      // [CT][S]
  float* cs = bs + CT * S;                        // [CT][S]
  float* hs = cs + CT * S;                        // [CT][THREADS]
  float* pb = hs + CT * THREADS;                  // [CT][NW][G]
  float* pc = pb + CT * NW * G;                   // [CT][NW][G]

  const int b = blockIdx.y, tile = blockIdx.x, n_tiles = gridDim.x;
  const int i0 = tile * CB;
  const int ncols = min(CB, I - i0);
  const int jc = threadIdx.x / G, s = threadIdx.x % G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = i0 + jc;
  const bool on = i < I && s < S;
  const size_t bis = (static_cast<size_t>(b) * I + i) * S + s;   // [B, I, S] index
  const float av = on ? a[static_cast<size_t>(i) * S + s] : 0.f;
  const size_t row_b = static_cast<size_t>(b) * T_len;
  const int n_chunks = (T_len + CT - 1) / CT;
  // the checkpoint of this lane's state entering chunk c, [B, chunks, I, S]
  auto ck = [&](int c) {
    return ckpt + ((static_cast<size_t>(b) * n_chunks + c) * I + i) * S + s;
  };

  // the chunk's [n, CB] tiles of the given [B, T, I] arrays and [n, S] rows
  auto stage = [&](int t0, int n, bool with_dy, bool with_c) {
    for (int e = threadIdx.x; e < n * CB; e += THREADS) {
      const int t = e / CB, c = e - t * CB;
      const size_t at = (row_b + t0 + t) * I + i0 + c;
      const bool in = c < ncols;
      dts[e] = in ? dt[at] : 0.f;
      xs[e] = in ? xi[at] : 0.f;
      if (with_dy) dys[e] = in ? dy[at] : 0.f;
    }
    for (int e = threadIdx.x; e < n * S; e += THREADS) {
      bs[e] = bm[(row_b + t0) * S + e];
      if (with_c) cs[e] = cm[(row_b + t0) * S + e];
    }
  };

  // ---- 1. forward: the state entering each chunk ------------------------
  float h = on ? h0[bis] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * CT, n = min(CT, T_len - t0);
    if (c > 0 && on) *ck(c) = h;
    __syncthreads();
    stage(t0, n, false, false);
    __syncthreads();
    if (on) {
      for (int t = 0; t < n; ++t) {
        const float dtv = dts[t * CB + jc];
        h = expf(dtv * av) * h + dtv * xs[t * CB + jc] * bs[t * S + s];
      }
    }
  }

  // ---- 2. backward, chunk by chunk ---------------------------------------
  float g = on ? dh_last[bis] : 0.f;
  float da_acc = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * CT, n = min(CT, T_len - t0);
    __syncthreads();                              // the last chunk's tiles went out
    stage(t0, n, true, true);
    __syncthreads();
    // recompute h_t of this chunk from its checkpoint
    const float h_in = !on ? 0.f : c == 0 ? h0[bis] : *ck(c);
    h = h_in;
    for (int t = 0; t < n; ++t) {
      if (on) {
        const float dtv = dts[t * CB + jc];
        h = expf(dtv * av) * h + dtv * xs[t * CB + jc] * bs[t * S + s];
      }
      hs[t * THREADS + threadIdx.x] = h;
    }
    for (int t = n - 1; t >= 0; --t) {
      const float dtv = dts[t * CB + jc], xv = xs[t * CB + jc], dyv = dys[t * CB + jc];
      float c_dc = 0.f, c_db = 0.f, c_dt = 0.f, c_dx = 0.f;
      if (on) {
        const float bv = bs[t * S + s], cv = cs[t * S + s];
        const float hv = hs[t * THREADS + threadIdx.x];
        const float hp = t > 0 ? hs[(t - 1) * THREADS + threadIdx.x] : h_in;
        const float da = expf(dtv * av);
        g += dyv * cv;
        c_dc = dyv * hv;
        c_db = g * dtv * xv;
        const float dda = g * hp;
        c_dt = dda * da * av + g * xv * bv;
        c_dx = g * dtv * bv;
        da_acc += dda * da * dtv;
        g *= da;
      }
      // sums over s: the group's shuffle tree
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2) {
        c_dt += __shfl_xor_sync(FULL_MASK, c_dt, off);
        c_dx += __shfl_xor_sync(FULL_MASK, c_dx, off);
      }
      // sums over the warp's channels: the shuffle tree across groups
#pragma unroll
      for (int off = G; off < 32; off *= 2) {
        c_db += __shfl_xor_sync(FULL_MASK, c_db, off);
        c_dc += __shfl_xor_sync(FULL_MASK, c_dc, off);
      }
      if (s == 0) {                               // over the dt and xi it used
        dts[t * CB + jc] = c_dt;
        xs[t * CB + jc] = c_dx;
      }
      if (lane < G) {
        pb[(t * NW + warp) * G + lane] = c_db;
        pc[(t * NW + warp) * G + lane] = c_dc;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < n * CB; e += THREADS) {
      const int t = e / CB, col = e - t * CB;
      if (col < ncols) {
        const size_t at = (row_b + t0 + t) * I + i0 + col;
        ddt[at] = dts[e];
        dxi[at] = xs[e];
      }
    }
    // the block's warps in order: its partial of dB and dC
    float* pbo = part_b + ((static_cast<size_t>(b) * n_tiles + tile) * T_len + t0) * S;
    float* pco = part_c + ((static_cast<size_t>(b) * n_tiles + tile) * T_len + t0) * S;
    for (int e = threadIdx.x; e < n * S; e += THREADS) {
      const int t = e / S, st = e - t * S;
      float sb = 0.f, sc = 0.f;
      for (int w = 0; w < NW; ++w) {
        sb += pb[(t * NW + w) * G + st];
        sc += pc[(t * NW + w) * G + st];
      }
      pbo[e] = sb;
      pco[e] = sc;
    }
  }
  if (on) {
    dh0[bis] = g;
    part_a[bis] = da_acc;
  }
}

// dB, dC [B, T, S] = partials summed over the tiles in order; da [I, S] =
// the per-row partials summed over b in order
__global__ void reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                              const float* __restrict__ part_a, float* __restrict__ dB,
                              float* __restrict__ dC, float* __restrict__ da, int B, int T_len,
                              int I, int S, int n_tiles) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t n_bc = static_cast<size_t>(B) * T_len * S, n_a = static_cast<size_t>(I) * S;
  if (idx < n_bc) {
    const size_t b = idx / (static_cast<size_t>(T_len) * S);
    const size_t ts = idx - b * T_len * S;
    float sb = 0.f, sc = 0.f;
    for (int tile = 0; tile < n_tiles; ++tile) {
      const size_t at = (b * n_tiles + tile) * T_len * S + ts;
      sb += part_b[at];
      sc += part_c[at];
    }
    dB[idx] = sb;
    dC[idx] = sc;
  } else if (idx < n_bc + n_a) {
    const size_t is = idx - n_bc;
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += part_a[b * n_a + is];
    da[is] = s;
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

template <int G>
int launch(const float* const* in, float* const* out, float* const* scratch, int B,
           int T_len, int I, int S, cudaStream_t stream) {
  constexpr int CB = THREADS / G;
  const int n_tiles = (I + CB - 1) / CB;
  const size_t smem = smem_floats(G, S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_bwd_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_bwd_kernel<G><<<dim3(n_tiles, B), THREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1], out[5],
      scratch[0], scratch[1], scratch[2], scratch[3], T_len, I, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * T_len * S + static_cast<size_t>(I) * S;
  reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      scratch[1], scratch[2], scratch[3], out[2], out[3], out[4], B, T_len, I, S, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The scratch sizes (in floats) selective_scan_bwd needs for these sizes:
// out = {checkpoints, dB/dC partials (each), da partials}.
int selective_scan_bwd_scratch(int B, int T_len, int I, int S, long long* out) {
  if (S < 1 || S > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int cb = THREADS / pow2_at_least(S);
  const long long n_tiles = (I + cb - 1) / cb, n_chunks = (T_len + CT - 1) / CT;
  out[0] = static_cast<long long>(B) * n_chunks * I * S;
  out[1] = static_cast<long long>(B) * n_tiles * T_len * S;
  out[2] = static_cast<long long>(B) * I * S;
  return 0;
}

// Inputs fp32, contiguous: xi, dt, dy [B, T, I]; bm, cm [B, T, S]; a [I, S];
// h0, dh_last [B, I, S].  Outputs fp32: dxi, ddt [B, T, I]; dB, dC
// [B, T, S]; da [I, S]; dh0 [B, I, S].  Scratch fp32 of the sizes
// selective_scan_bwd_scratch gives: ckpt, part_b, part_c, part_a.
// 1 <= S <= 16, T >= 1.  Two launches on `stream`; allocates nothing,
// returns a CUDA error code.
int selective_scan_bwd(const void* xi, const void* dt, const void* bm, const void* cm,
                       const void* a, const void* h0, const void* dy, const void* dh_last,
                       void* dxi, void* ddt, void* dB, void* dC, void* da, void* dh0,
                       void* ckpt, void* part_b, void* part_c, void* part_a, int B,
                       int T_len, int I, int S, void* stream) {
  if (B == 0 || I == 0 || T_len == 0 || S < 1 || S > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  const float* in[] = {f(xi), f(dt), f(bm), f(cm), f(a), f(h0), f(dy), f(dh_last)};
  float* out[] = {w(dxi), w(ddt), w(dB), w(dC), w(da), w(dh0)};
  float* scratch[] = {w(ckpt), w(part_b), w(part_c), w(part_a)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (pow2_at_least(S)) {
    case 1: return launch<1>(in, out, scratch, B, T_len, I, S, s);
    case 2: return launch<2>(in, out, scratch, B, T_len, I, S, s);
    case 4: return launch<4>(in, out, scratch, B, T_len, I, S, s);
    case 8: return launch<8>(in, out, scratch, B, T_len, I, S, s);
    default: return launch<16>(in, out, scratch, B, T_len, I, S, s);
  }
}

const char* selective_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
