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
// both recurrences are sequential in t, and a walk of T steps per lane is a
// chain of dependent latencies: the first version walked T three times in
// each of 1.3 waves of blocks (6,144 dependent steps, 1.95 ms there).
//
// Design: chunk-parallel.  Both recurrences are affine in their state, so
// T is cut into chunks of L = 32 steps and every chunk is walked at once:
// each walk is L steps, and the grid is (channel tiles, chunks, b), T / L
// times the blocks.  Lanes are the forward's: a group of G lanes (S rounded
// up to a power of two) per (b, channel), one state per lane, 256 threads
// a block; a block takes NIT = 4 groups of channels in turn.  Four
// launches, no float atomics, every sum in one order: two runs agree bit
// for bit.
// 1. summary: per (b, chunk, channel, state) the chunk's local forward
//    state u (its last h with a zero entry state), its local reverse state
//    w (the g leaving it with a zero g entering it) and, per channel, the
//    sum of dt over the chunk, whose exp(a sum dt) is the product of its
//    da_t: the chunk maps an entry state h to exp(a sum dt) h + u, and an
//    incoming g to exp(a sum dt) g + w.  The two local recurrences run in
//    one loop, two independent chains.
// 2. combine: per (b, channel, state) a walk over the T / L chunks, from
//    h0 forwards (each chunk's entry state, written over u) and from
//    dh_last backwards (each chunk's incoming g, written over w); dh0.
// 3. walk: each chunk recomputes its h_t from its entry state (never by
//    dividing h backwards) into shared memory, then runs the reverse
//    recurrence from its incoming g.  The sums over s (ddt, dxi) are
//    shuffle trees inside a group, written over the dt and xi they used
//    and stored coalesced after the chunk; the sums over channels (dB,
//    dC) are added in shared memory over the block's 4 groups (dC from h
//    before the walk, dB from the walk's terms written over h), one [L, S]
//    partial a block, so the partials are [B, I / (4 CB), T, S] (16 MB
//    each at falcon-mamba-7b, a quarter of the first version's); each
//    lane's part of da goes over its incoming g.
// 4. reduce: dB, dC over the channel tiles, da over b and the chunks, in
//    a fixed order.
// A lane walks L steps in (1) (both local recurrences in one loop), 2 T / L
// in (2) and 2 L in (3), (1) and (3) for each of its block's 4 groups:
// about 4 (3 L) + 2 T / L = 512 dependent steps at falcon-mamba-7b, against
// 6,144; the scratch (entry states and incoming g, [B, T / L, I, S] fp32,
// 32 MB each there) is written and read twice.
//
// Once latency no longer paces it, the issue rate does: 268 M (b, t, i, s)
// steps at falcon-mamba-7b, each a few dozen instructions over (1) and (3).
// So a step is kept short: every da is ex2.approx(dt a log2 e) (two
// instructions; expf takes about ten, and 2^-22 relative is far inside the
// 1e-4 bar), a chunk is always L steps (the staged inputs are zero past
// T, which makes a step the identity: da = 1, no input), so the loops
// unroll and a lane reads its channel's dt, xi and dy four steps at a time
// from channel-major staging, and the sums over s take one shuffle a level
// (the group's lower half adds ddt and its upper half dxi).  A block's
// next channel group is brought by cp.async while it walks the current
// one (two staging buffers), with the next group's chunk states.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int L = 32;                  // steps a chunk
constexpr int LP = L + 4;              // a staged channel's row (16-byte rows, 2-way banks)
constexpr int NIT = 4;                 // channel groups a block takes in turn
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int group_channels(int G) { return THREADS / G; }

// shared memory, in floats: buffers of dt, xi, dy [CB][LP] -- two (one
// group's, the next group's in flight) unless a group's 256 channels (G =
// 1) would not fit twice -- and B, C [L][S]; the walk adds the block's dB,
// dC sums [L][S] and h [L][THREADS]
__host__ __device__ constexpr size_t stage_floats(int G) {
  return 3 * static_cast<size_t>(LP) * group_channels(G);
}
__host__ __device__ constexpr int stage_buffers(int G) { return G >= 2 ? 2 : 1; }
__host__ __device__ constexpr size_t summary_floats(int G, int S) {
  return stage_buffers(G) * stage_floats(G) + 2 * static_cast<size_t>(L) * S;
}
__host__ __device__ constexpr size_t walk_floats(int G, int S) {
  return summary_floats(G, S) + 2 * static_cast<size_t>(L) * S +
         static_cast<size_t>(L) * THREADS;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// a 4-byte asynchronous copy to shared memory; with `in` false it reads
// nothing and writes a zero
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The chunk's dt, xi (and dy) from row `row0` (b T + t0) of the [B, T, I]
// arrays, channels i0 .. i0 + ncols - 1, staged channel-major ([CB][LP],
// a lane reads four steps at once) by cp.async, committed as one group;
// steps past n and channels past ncols stage as zeros, which make a step
// the identity (da = 1, no input)
template <int G>
__device__ __forceinline__ void stage_cols(float* dts, float* xs, float* dys,
                                           const float* __restrict__ dt,
                                           const float* __restrict__ xi,
                                           const float* __restrict__ dy, size_t row0,
                                           int n, int I, int i0, int ncols) {
  constexpr int CB = group_channels(G);
  for (int e = threadIdx.x; e < L * CB; e += THREADS) {
    const int t = e / CB, c = e - t * CB;
    const bool in = c < ncols && t < n;
    const size_t at = in ? (row0 + t) * I + i0 + c : 0;
    cp_async4(dts + c * LP + t, dt + at, in);
    cp_async4(xs + c * LP + t, xi + at, in);
    if (dys != nullptr) cp_async4(dys + c * LP + t, dy + at, in);
  }
  cp_async_commit();
}

// the channel groups a block takes: NIT, or fewer in the last tile
__device__ __forceinline__ int groups_of(int I, int tile, int CB) {
  return min(NIT, (I - tile * NIT * CB + CB - 1) / CB);
}

// Brings group j's tiles (through `issue`) with two buffers: group 0 is
// issued before the loop, and each group's copies land while the one
// before it is walked; with one buffer, each group's when its turn comes.
// Returns when group j's copies have landed for every thread.
template <int NB, typename Issue>
__device__ __forceinline__ void next_group(Issue&& issue, int j, int ng) {
  __syncthreads();                                // group j - 1's buffer is free
  if (NB == 1) {
    issue(j);
    cp_async_wait<0>();
  } else if (j + 1 < ng) {
    issue(j + 1);
    cp_async_wait<1>();                           // group j's copies have landed
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// the chunk's [L, S] rows of B and C (zeros past n)
__device__ __forceinline__ void stage_rows(float* bs, float* cs, const float* __restrict__ bm,
                                           const float* __restrict__ cm, size_t row0, int n,
                                           int S) {
  for (int e = threadIdx.x; e < L * S; e += THREADS) {
    const bool in = e < n * S;
    bs[e] = in ? bm[row0 * S + e] : 0.f;
    cs[e] = in ? cm[row0 * S + e] : 0.f;
  }
}

// ---- 1. chunk summaries ------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(THREADS, 4)
summary_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
               const float* __restrict__ bm, const float* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ dy,
               float* __restrict__ u, float* __restrict__ w, float* __restrict__ sdt,
               int T_len, int I, int S) {
  constexpr int CB = group_channels(G), SF = stage_floats(G), NB = stage_buffers(G);
  extern __shared__ float smem[];
  float* stage = smem;                            // [NB][dt, xi, dy [CB][LP]]
  float* bs = stage + NB * SF;                    // [L][S]
  float* cs = bs + L * S;                         // [L][S]

  const int b = blockIdx.z, c = blockIdx.y, tile = blockIdx.x, n_ch = gridDim.y;
  const int t0 = c * L, n = min(L, T_len - t0);
  const size_t row0 = static_cast<size_t>(b) * T_len + t0;
  const int jc = threadIdx.x / G, s = threadIdx.x % G;
  const int ng = groups_of(I, tile, CB);
  auto issue = [&](int j) {                       // group j's tiles into buffer j % NB
    float* st = stage + (j % NB) * SF;
    const int i0 = (tile * NIT + j) * CB;
    stage_cols<G>(st, st + CB * LP, st + 2 * CB * LP, dt, xi, dy, row0, n, I, i0,
                  min(CB, I - i0));
  };
  if (NB == 2) issue(0);
  stage_rows(bs, cs, bm, cm, row0, n, S);
  for (int j = 0; j < ng; ++j) {
    next_group<NB>(issue, j, ng);
    const float* dts = stage + (j % NB) * SF;
    const float* xs = dts + CB * LP;
    const float* dys = xs + CB * LP;
    const int i = (tile * NIT + j) * CB + jc;
    if (i >= I || s >= S) continue;
    const float a2 = a[static_cast<size_t>(i) * S + s] * LOG2E;
    const float *dtr = dts + jc * LP, *xr = xs + jc * LP, *dyr = dys + jc * LP;
    // the local forward state over the steps in order and the local
    // reverse state over them backwards, interleaved (two chains)
    float h = 0.f, g = 0.f, sum_dt = 0.f;
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const int rq = L / 4 - 1 - q;
      const float4 d4 = ld4(dtr + 4 * q), x4 = ld4(xr + 4 * q);
      const float4 e4 = ld4(dtr + 4 * rq), y4 = ld4(dyr + 4 * rq);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * q + k, r = 4 * rq + 3 - k;
        const float dtf = comp(d4, k), dtb = comp(e4, 3 - k);
        h = ex2(dtf * a2) * h + dtf * comp(x4, k) * bs[t * S + s];
        sum_dt += dtf;
        g = (g + comp(y4, 3 - k) * cs[r * S + s]) * ex2(dtb * a2);
      }
    }
    const size_t at = ((static_cast<size_t>(b) * n_ch + c) * I + i) * S + s;
    u[at] = h;
    w[at] = g;
    if (s == 0) sdt[(static_cast<size_t>(b) * n_ch + c) * I + i] = sum_dt;
  }
}

// ---- 2. combine over the chunks ---------------------------------------------

constexpr int BATCH = 8;               // chunks whose summaries one load round brings

__global__ void combine_kernel(const float* __restrict__ a, const float* __restrict__ h0,
                               const float* __restrict__ dh_last,
                               const float* __restrict__ sdt, float* __restrict__ u,
                               float* __restrict__ w, float* __restrict__ dh0, int B,
                               int n_ch, int I, int S) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t IS = static_cast<size_t>(I) * S;
  if (idx >= B * IS) return;
  const size_t b = idx / IS, is = idx - b * IS, i = is / S;
  const float a2 = a[is] * LOG2E;
  auto state_at = [&](int c) { return (b * n_ch + c) * IS + is; };
  auto sdt_at = [&](int c) { return (b * n_ch + c) * I + i; };
  // forwards: u[c] <- the state entering chunk c; h <- 2^(a2 sum dt) h + u
  float h = h0[idx];
  for (int c0 = 0; c0 < n_ch; c0 += BATCH) {
    float uu[BATCH], ss[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (c0 + k < n_ch) {
        uu[k] = u[state_at(c0 + k)];
        ss[k] = sdt[sdt_at(c0 + k)];
      }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (c0 + k < n_ch) {
        u[state_at(c0 + k)] = h;
        h = ex2(a2 * ss[k]) * h + uu[k];
      }
  }
  // backwards: w[c] <- the g entering chunk c (from chunk c + 1);
  // g <- 2^(a2 sum dt) g + w
  float g = dh_last[idx];
  for (int c0 = n_ch - 1; c0 >= 0; c0 -= BATCH) {
    float ww[BATCH], ss[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (c0 - k >= 0) {
        ww[k] = w[state_at(c0 - k)];
        ss[k] = sdt[sdt_at(c0 - k)];
      }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (c0 - k >= 0) {
        w[state_at(c0 - k)] = g;
        g = ex2(a2 * ss[k]) * g + ww[k];
      }
  }
  dh0[idx] = g;
}

// ---- 3. the walk of each chunk -----------------------------------------------

template <int G>
__global__ void __launch_bounds__(THREADS, 4)
walk_kernel(const float* __restrict__ xi, const float* __restrict__ dt,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ dy,
            const float* __restrict__ h_in, float* __restrict__ g_in,
            float* __restrict__ dxi, float* __restrict__ ddt, float* __restrict__ part_b,
            float* __restrict__ part_c, int T_len, int I, int S) {
  constexpr int CB = group_channels(G), SF = stage_floats(G), NB = stage_buffers(G);
  extern __shared__ float smem[];
  float* stage = smem;                            // [NB][dt, xi, dy [CB][LP]]: dt, xi
                                                  // then hold ddt, dxi
  float* bs = stage + NB * SF;                    // [L][S]
  float* cs = bs + L * S;                         // [L][S]
  float* sb = cs + L * S;                         // [L][S] the block's dB
  float* sc = sb + L * S;                         // [L][S] the block's dC
  float* hs = sc + L * S;                         // [L][THREADS] h, then dB terms

  const int b = blockIdx.z, c = blockIdx.y, tile = blockIdx.x;
  const int n_ch = gridDim.y, n_tiles = gridDim.x;
  const int t0 = c * L, n = min(L, T_len - t0);
  const size_t row0 = static_cast<size_t>(b) * T_len + t0;
  const int tid = threadIdx.x, jc = tid / G, s = tid % G;
  const int ng = groups_of(I, tile, CB);
  auto issue = [&](int j) {                       // group j's tiles into buffer j % NB
    float* st = stage + (j % NB) * SF;
    const int i0 = (tile * NIT + j) * CB;
    stage_cols<G>(st, st + CB * LP, st + 2 * CB * LP, dt, xi, dy, row0, n, I, i0,
                  min(CB, I - i0));
  };
  // this lane's index into the chunk states in group j, and whether it is
  // busy (an idle lane -- a state past S, a channel past I -- has a = 0,
  // no B or C and a zero state: every term it adds is 0)
  auto lane_at = [&](int j) {
    const int i = (tile * NIT + j) * CB + jc;
    return ((static_cast<size_t>(b) * n_ch + c) * I + i) * S + s;
  };
  auto busy = [&](int j) { return (tile * NIT + j) * CB + jc < I && s < S; };
  if (NB == 2) issue(0);
  stage_rows(bs, cs, bm, cm, row0, n, S);
  for (int e = tid; e < L * S; e += THREADS) sb[e] = sc[e] = 0.f;
  // the first group's entry state and incoming g (each next group's are
  // loaded while this one is walked)
  float h_next = busy(0) ? h_in[lane_at(0)] : 0.f;
  float g_next = busy(0) ? g_in[lane_at(0)] : 0.f;

  for (int j = 0; j < ng; ++j) {
    const int i0 = (tile * NIT + j) * CB;
    const int ncols = min(CB, I - i0);
    next_group<NB>(issue, j, ng);                 // group j - 1's buffer went out first
    float* dts = stage + (j % NB) * SF;
    float* xs = dts + CB * LP;
    const float* dys = xs + CB * LP;
    const int i = i0 + jc;
    const bool on = busy(j);
    const int so = on ? s : 0;
    const size_t at = lane_at(j);
    const float av = on ? a[static_cast<size_t>(i) * S + s] : 0.f, a2 = av * LOG2E;
    const float h_enter = h_next;
    float g = g_next;
    if (j + 1 < ng) {
      h_next = busy(j + 1) ? h_in[lane_at(j + 1)] : 0.f;
      g_next = busy(j + 1) ? g_in[lane_at(j + 1)] : 0.f;
    }
    float* dtr = dts + jc * LP;
    float* xr = xs + jc * LP;
    const float* dyr = dys + jc * LP;

    // h_t of the chunk from its entry state (steps past n keep it)
    float h = h_enter;
#pragma unroll
    for (int q = 0; q < L / 4; ++q) {
      const float4 d4 = ld4(dtr + 4 * q), x4 = ld4(xr + 4 * q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = 4 * q + k;
        const float dtv = comp(d4, k), bv = on ? bs[t * S + so] : 0.f;
        h = ex2(dtv * a2) * h + dtv * comp(x4, k) * bv;
        hs[t * THREADS + tid] = h;
      }
    }
    __syncthreads();
    // dC: the group's channels in order, added to the block's sum
    for (int e = tid; e < n * S; e += THREADS) {
      const int t = e / S, st = e - t * S;
      float acc = 0.f;
      for (int ch = 0; ch < CB; ++ch)
        acc += dys[ch * LP + t] * hs[t * THREADS + ch * G + st];
      sc[e] += acc;
    }
    __syncthreads();                              // h is read; the walk overwrites it

    // the reverse recurrence from the chunk's incoming g (steps past n
    // leave g as it is; what they write is not stored)
    float da_acc = 0.f;
#pragma unroll
    for (int q = L / 4 - 1; q >= 0; --q) {
      const float4 d4 = ld4(dtr + 4 * q), x4 = ld4(xr + 4 * q), y4 = ld4(dyr + 4 * q);
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const int t = 4 * q + k;
        const float dtv = comp(d4, k), xv = comp(x4, k), dyv = comp(y4, k);
        const float bv = on ? bs[t * S + so] : 0.f, cv = on ? cs[t * S + so] : 0.f;
        const float hp = t > 0 ? hs[(t - 1) * THREADS + tid] : h_enter;
        const float da = ex2(dtv * a2);
        g += dyv * cv;
        const float c_db = g * dtv * xv;
        const float dda = g * hp;
        const float c_dt = dda * da * av + g * xv * bv;
        const float c_dx = g * dtv * bv;
        da_acc += dda * da * dtv;
        g *= da;
        hs[t * THREADS + tid] = c_db;             // over h_t, which no step reads again
        // sums over s, written over the dt and xi they used: a
        // reduce-scatter in the group (the upper half takes dxi, the lower
        // ddt), then a shuffle tree in each half
        if constexpr (G == 1) {
          dtr[t] = c_dt;
          xr[t] = c_dx;
        } else {
          const bool upper = s & (G / 2);
          float part = upper ? c_dx : c_dt;
          part += __shfl_xor_sync(FULL_MASK, upper ? c_dt : c_dx, G / 2);
#pragma unroll
          for (int off = G / 4; off > 0; off /= 2)
            part += __shfl_xor_sync(FULL_MASK, part, off);
          if (s == 0) dtr[t] = part;
          if (s == G / 2) xr[t] = part;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < n * CB; e += THREADS) {
      const int t = e / CB, col = e - t * CB;
      if (col < ncols) {
        const size_t out = (row0 + t) * I + i0 + col;
        ddt[out] = dts[col * LP + t];
        dxi[out] = xs[col * LP + t];
      }
    }
    // dB: the group's channels in order, added to the block's sum
    for (int e = tid; e < n * S; e += THREADS) {
      const int t = e / S, st = e - t * S;
      float acc = 0.f;
      for (int ch = 0; ch < CB; ++ch) acc += hs[t * THREADS + ch * G + st];
      sb[e] += acc;
    }
    if (on) g_in[at] = da_acc;                    // this lane's part of da
  }
  __syncthreads();
  const size_t po = ((static_cast<size_t>(b) * n_tiles + tile) * T_len + t0) * S;
  for (int e = tid; e < n * S; e += THREADS) {
    part_b[po + e] = sb[e];
    part_c[po + e] = sc[e];
  }
}

// ---- 4. reduce ----------------------------------------------------------------

// dB, dC [B, T, S] = the partials summed over the tiles in order; da [I, S]
// = the lanes' parts summed over b, then the chunks, in order
__global__ void reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                              const float* __restrict__ part_a, float* __restrict__ dB,
                              float* __restrict__ dC, float* __restrict__ da, int B, int T_len,
                              int I, int S, int n_tiles, int n_ch) {
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
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < n_ch; ++c) s += part_a[(static_cast<size_t>(b) * n_ch + c) * n_a + is];
    da[is] = s;
  }
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

int n_tiles_of(int I, int G) {
  const int cpb = NIT * group_channels(G);
  return (I + cpb - 1) / cpb;
}

template <int G>
int launch(const float* const* in, float* const* out, float* const* scratch, int B,
           int T_len, int I, int S, cudaStream_t stream) {
  const int n_tiles = n_tiles_of(I, G), n_ch = (T_len + L - 1) / L;
  const dim3 grid(n_tiles, n_ch, B);
  const float *xi = in[0], *dt = in[1], *bm = in[2], *cm = in[3], *a = in[4], *h0 = in[5],
              *dy = in[6], *dh_last = in[7];
  float *u = scratch[0], *w = scratch[1], *sdt = scratch[2], *part_b = scratch[3],
        *part_c = scratch[4];
  const size_t smem1 = summary_floats(G, S) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      summary_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  summary_kernel<G><<<grid, THREADS, smem1, stream>>>(xi, dt, bm, cm, a, dy, u, w, sdt, T_len,
                                                      I, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t lanes = static_cast<size_t>(B) * I * S;
  combine_kernel<<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, stream>>>(
      a, h0, dh_last, sdt, u, w, out[5], B, n_ch, I, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem3 = walk_floats(G, S) * sizeof(float);
  err = cudaFuncSetAttribute(walk_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem3));
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_kernel<G><<<grid, THREADS, smem3, stream>>>(xi, dt, bm, cm, a, dy, u, w, out[0], out[1],
                                                   part_b, part_c, T_len, I, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(B) * T_len * S + static_cast<size_t>(I) * S;
  reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      part_b, part_c, w, out[2], out[3], out[4], B, T_len, I, S, n_tiles, n_ch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The scratch sizes (in floats) selective_scan_bwd needs for these sizes:
// out = {chunk states (each of two), dB / dC partials (each of two), the
// chunks' sums of dt}.
int selective_scan_bwd_scratch(int B, int T_len, int I, int S, long long* out) {
  if (S < 1 || S > 16) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ch = (T_len + L - 1) / L;
  out[0] = static_cast<long long>(B) * n_ch * I * S;
  out[1] = static_cast<long long>(B) * n_tiles_of(I, pow2_at_least(S)) * T_len * S;
  out[2] = static_cast<long long>(B) * n_ch * I;
  return 0;
}

// Inputs fp32, contiguous: xi, dt, dy [B, T, I]; bm, cm [B, T, S]; a [I, S];
// h0, dh_last [B, I, S].  Outputs fp32: dxi, ddt [B, T, I]; dB, dC
// [B, T, S]; da [I, S]; dh0 [B, I, S].  Scratch fp32 of the sizes
// selective_scan_bwd_scratch gives: u, w (chunk states), sdt, part_b,
// part_c.  1 <= S <= 16, T >= 1.  Four launches on `stream`; allocates
// nothing, returns a CUDA error code.
int selective_scan_bwd(const void* xi, const void* dt, const void* bm, const void* cm,
                       const void* a, const void* h0, const void* dy, const void* dh_last,
                       void* dxi, void* ddt, void* dB, void* dC, void* da, void* dh0,
                       void* u, void* w, void* sdt, void* part_b, void* part_c, int B,
                       int T_len, int I, int S, void* stream) {
  if (B == 0 || I == 0 || T_len == 0 || S < 1 || S > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto wr = [](void* p) { return static_cast<float*>(p); };
  const float* in[] = {f(xi), f(dt), f(bm), f(cm), f(a), f(h0), f(dy), f(dh_last)};
  float* out[] = {wr(dxi), wr(ddt), wr(dB), wr(dC), wr(da), wr(dh0)};
  float* scratch[] = {wr(u), wr(w), wr(sdt), wr(part_b), wr(part_c)};
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
