// strategy_eval: the CIM-Tuner cost model over a [jobs, candidates] grid.
//
// Replaces the Pallas TPU kernel src/repro/kernels/strategy_eval.py
// (strategy_eval -> _kernel -> _objective_block ->
// core/cost_model.workload_cost_core), widened to the engine's batched
// job_objective: per-job macro/tech constants, strategy mask, objective
// code and area budget, with the area penalty and the bandwidth rule.
//
// What bounds it on an H100: operations, and among them the IEEE
// divisions.  Per (candidate, operator, strategy) matmul_cost is some 120
// scalar floating-point operations on 6 + 5 input values; the arithmetic
// outweighs the bytes by three orders of magnitude.  Twelve or thirteen of
// those operations are divisions (ceil and floor of quotients), and each
// IEEE division is a reciprocal seed, Newton steps and a slow-path branch:
// evaluated strategy by strategy, the divisions are most of the work.
//
// What the design does about it:
// - Work is shared, not repeated.  Of a strategy's quotients only
//   ema_cycles and lat_s depend on its (WP, PF) bits.  The rest depend on
//   the job and REV alone (cyc_c, cyc_u, computed once per block into
//   shared memory beside the 33 constants, with freq_mhz * 1e6), on the
//   candidate (os_rows_af), or on (candidate, operator, REV): tK, tN, G, H,
//   rows_res_raw, B and the PF rows os_full and os_rem.  These are computed
//   once per (candidate, operator, REV) and the four (WP, PF) strategies
//   of that REV are evaluated from them: about a third of the divisions.
// - A strategy the job's mask disallows is not computed (the mask is per
//   job, so a whole block takes the same branch), nor is a REV half with
//   no allowed strategy, nor the PF rows when no PF strategy is allowed.
// - Two lanes take a candidate, one REV half each, and one
//   __shfl_xor_sync per operator combines the halves' best strategies.
//   REV is a value, not a template argument, so the two lanes run one
//   instruction stream.  An SA step's [1 job, 64 chains] launch gets 128
//   threads and half the serial chain; a thread per candidate (both
//   halves in turn, 140 registers in fp64 against 128) measured slower at
//   every launch shape of the main path, the sweep's [24, 4096] included.
//
// Numerics kept from the reference, so the kernel equals the plain version
// bit for bit: every quantity is computed from the same operands by the
// same operations in the same order (a shared term is only computed fewer
// times), IEEE division (never fast math; the model takes ceil/floor of
// quotients), no FMA contraction (built with -fmad=false, so each product
// rounds as in the reference), and an argmin that keeps the first index on
// ties (strict <), as jnp.argmin does -- every infeasible strategy ties at
// INFEASIBLE = 1e30, and REV = 0 (strategies 0-3) wins a tie between the
// halves.
#include <cuda_runtime.h>

namespace {

// per-job constants, one row of NPARAM values per job
enum Param {
  // MacroParams
  P_AL, P_PC, P_ICW, P_WUW, P_DW_IN, P_DW_W, P_DW_PSUM, P_DW_OUT, P_FREQ_MHZ,
  P_UPDATE_DURING_COMPUTE, P_MAC_E_PJ,
  // TechParams
  P_E_CIM_UPDATE, P_E_SRAM_RD, P_E_SRAM_WR, P_E_EMA, P_SYS_OVERHEAD,
  P_LEAK_MW_MM2, P_A_CELL, P_A_CU, P_A_MACRO_FIXED, P_A_SRAM_PER_MB,
  P_A_SRAM_FIXED, P_A_FIXED,
  // strategy mask [8], objective code, area budget
  P_ALLOWED, P_OBJ_CODE = P_ALLOWED + 8, P_AREA_BUDGET, NPARAM
};
static_assert(NPARAM == 33, "parameter layout changed");

// per-job terms computed once per block, stored after the constants
enum Derived { D_CYC_C, D_CYC_U = D_CYC_C + 2, D_FREQ_HZ = D_CYC_U + 2, NDERIVED };

constexpr int OPS_COLS = 5;
constexpr int CAND_COLS = 6;
constexpr int BLOCK = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

template <typename T> __device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T ceil_div(T a, T b) { return ceil(a / b); }
template <typename T> __device__ __forceinline__ T floor_div(T a, T b) { return floor(a / b); }
template <typename T> __device__ __forceinline__ T spill(T work, T os) { return mx(work - os, T(0)); }

template <typename T>
__device__ __forceinline__ T score(T lat, T en, int code) {
  return code == 1 ? lat : (code == 2 ? lat * en : en);
}

// terms of one candidate, shared by all its operators and strategies
template <typename T>
struct Config {
  T mr, mc, scr, is_bits, os_bits, bw, area;
  T Kp, Np;          // macro tile: mr * al rows, mc * pc columns
  T os_rows_af;      // output-SRAM rows of one AF column group
  bool os_feasible;  // the output SRAM holds one psum row
  bool overlap;      // CIM updates overlap compute
};

// terms of one (candidate, operator, REV), shared by its 4 strategies
template <typename T>
struct RevTerms {
  T M, dwt, cyc_u;
  T tK, tN, Npad, H, G, remN, scr_n;
  T rows_res, B, remB;
  T MKd;             // M * Kpad * dws: the streamed matrix's bits
  T planes, compute_cycles, macs, y_bits;
  T os_full, os_rem; // PF: output-SRAM rows of a full and the last group
  bool wp_feasible, is_feasible, fits_all_v, fits_all_s;
};

// cost_model.matmul_cost up to the strategy bits: everything the four
// (WP, PF) strategies of one REV share.
template <typename T>
__device__ __forceinline__ RevTerms<T> rev_terms(int rev, T m, T k, T n, const Config<T>& c,
                                                 const T* prm, bool need_pf) {
  RevTerms<T> r;
  const T dw_psum = prm[P_DW_PSUM];
  r.M = rev ? n : m;
  const T N = rev ? m : n;
  const T K = k;
  const T dws = rev ? prm[P_DW_W] : prm[P_DW_IN];
  r.dwt = rev ? prm[P_DW_IN] : prm[P_DW_W];
  const T cyc_c = prm[NPARAM + D_CYC_C + rev];
  r.cyc_u = prm[NPARAM + D_CYC_U + rev];

  r.tK = ceil_div(K, c.Kp);
  r.tN = ceil_div(N, c.Np);
  const T Kpad = r.tK * c.Kp;
  r.Npad = r.tN * c.Np;
  r.planes = r.tK * r.tN;

  r.G = ceil_div(r.tK, c.scr);
  r.H = ceil_div(r.tN, c.scr);
  r.remN = r.tN - (r.H - T(1)) * c.scr;
  r.scr_n = mn(c.scr, r.tN);

  const T rows_res_raw = floor_div(c.is_bits, Kpad * dws);
  r.wp_feasible = rows_res_raw >= T(1);
  r.rows_res = mn(mx(rows_res_raw, T(1)), r.M);
  r.B = ceil_div(r.M, r.rows_res);
  r.remB = r.M - (r.B - T(1)) * r.rows_res;
  r.is_feasible = c.is_bits >= c.Kp * dws;
  r.MKd = r.M * Kpad * dws;
  r.fits_all_v = r.MKd <= c.is_bits;
  r.fits_all_s = r.planes <= c.scr;

  r.compute_cycles = r.M * r.planes * cyc_c;
  r.macs = r.M * Kpad * r.Npad;
  r.y_bits = r.M * r.Npad * prm[P_DW_OUT];

  if (need_pf) {
    r.os_full = floor_div(c.os_bits, r.scr_n * c.Np * dw_psum);
    r.os_rem = floor_div(c.os_bits, r.remN * c.Np * dw_psum);
  } else {
    r.os_full = r.os_rem = T(0);
  }
  return r;
}

// The rest of cost_model.matmul_cost for one (WP, PF) strategy; returns
// latency and energy (INFEASIBLE where the strategy does not fit).
template <typename T, bool WP, bool PF>
__device__ __forceinline__ void strategy_cost(const RevTerms<T>& r, const Config<T>& c,
                                              const T* prm, T& lat_out, T& en_out) {
  const T INF = T(1e30);
  const T Np = c.Np;
  const T dw_psum = prm[P_DW_PSUM];
  const T M = r.M, tK = r.tK, tN = r.tN, G = r.G, H = r.H, B = r.B;

  const T v_refetch_ip = r.fits_all_v ? T(1) : (PF ? H : tN);
  const T v_bits = r.MKd * (WP ? T(1) : v_refetch_ip);

  const T s_loads = r.planes * ((WP && !r.fits_all_s) ? B : T(1));
  const T s_bits = s_loads * c.Kp * Np * r.dwt;
  const T update_cycles = s_loads * r.cyc_u;

  const T is_wr = v_bits;
  const T is_rd = r.MKd * (PF ? H : tN);

  T spill_bits;
  if (!PF) {
    if (WP) {
      spill_bits = T(2) * (G - T(1)) * Np * dw_psum * tN
          * ((B - T(1)) * spill(r.rows_res, c.os_rows_af) + spill(r.remB, c.os_rows_af));
    } else {
      spill_bits = T(2) * (G - T(1)) * spill(M, c.os_rows_af) * Np * dw_psum * tN;
    }
  } else {
    const T nfull = H - T(1);
    auto pf_rows = [&](T work) {
      return nfull * spill(work, r.os_full) * r.scr_n + spill(work, r.os_rem) * r.remN;
    };
    if (WP) {
      spill_bits = T(2) * (tK - T(1)) * Np * dw_psum
          * ((B - T(1)) * pf_rows(r.rows_res) + pf_rows(r.remB));
    } else {
      spill_bits = T(2) * (tK - T(1)) * Np * dw_psum * pf_rows(M);
    }
  }

  const T groups_per_col = PF ? tK : G;
  const T os_wr = M * tN * groups_per_col * Np * dw_psum;
  const T os_rd = M * tN * (groups_per_col - T(1)) * Np * dw_psum + M * r.Npad * dw_psum;

  const T ema_bits = v_bits + s_bits + spill_bits + r.y_bits;
  const T ema_cycles = ceil_div(ema_bits, c.bw);

  const T busy = mx(r.compute_cycles, ema_cycles);
  const T latency = c.overlap ? mx(busy, update_cycles) : busy + update_cycles;

  const bool feasible = r.is_feasible && c.os_feasible && (!WP || r.wp_feasible);

  const T e_dyn = (r.macs * prm[P_MAC_E_PJ]
                   + s_bits * prm[P_E_CIM_UPDATE]
                   + (is_rd + os_rd) * prm[P_E_SRAM_RD]
                   + (is_wr + os_wr) * prm[P_E_SRAM_WR]
                   + ema_bits * prm[P_E_EMA]) * prm[P_SYS_OVERHEAD];
  const T lat_s = latency / prm[NPARAM + D_FREQ_HZ];
  const T e_leak = prm[P_LEAK_MW_MM2] * c.area * lat_s * T(1e9);
  const T energy = e_dyn + e_leak;

  lat_out = feasible ? latency : INF;
  en_out = feasible ? energy : INF;
}

// The best of one REV half's four strategies, first index kept on ties
template <typename T>
struct Best {
  T score, lat, en;
  int idx;
};

// Strategy s0 + (WP, PF) of the half's argmin: skipped (INFEASIBLE) when
// the mask disallows it.
template <typename T, bool WP, bool PF>
__device__ __forceinline__ void try_strategy(int s0, const RevTerms<T>& r, const Config<T>& c,
                                             const T* prm, int code, Best<T>& best) {
  constexpr int OFF = (WP ? 2 : 0) + (PF ? 1 : 0);
  const T INF = T(1e30);
  T lat = INF, en = INF;
  if (prm[P_ALLOWED + s0 + OFF] > T(0)) strategy_cost<T, WP, PF>(r, c, prm, lat, en);
  const T s = score(lat, en, code);
  if (OFF == 0 || s < best.score) best = {s, lat, en, s0 + OFF};
}

template <typename T>
__device__ __forceinline__ Best<T> best_of_half(int rev, T m, T k, T n, const Config<T>& c,
                                                const T* prm, int code) {
  const int s0 = 4 * rev;
  const T* allowed = prm + P_ALLOWED + s0;
  Best<T> best;
  if (allowed[0] > T(0) || allowed[1] > T(0) || allowed[2] > T(0) || allowed[3] > T(0)) {
    const RevTerms<T> r = rev_terms<T>(rev, m, k, n, c, prm,
                                       allowed[1] > T(0) || allowed[3] > T(0));
    try_strategy<T, false, false>(s0, r, c, prm, code, best);
    try_strategy<T, false, true>(s0, r, c, prm, code, best);
    try_strategy<T, true, false>(s0, r, c, prm, code, best);
    try_strategy<T, true, true>(s0, r, c, prm, code, best);
  } else {  // the whole half disallowed: its first strategy at INFEASIBLE
    const T INF = T(1e30);
    best = {score(INF, INF, code), INF, INF, s0};
  }
  return best;
}

// The argmin over both halves: REV = 1's best only where strictly lower,
// so strategies 0-3 win ties, as a first-index argmin over 0..7 does.
template <typename T>
__device__ __forceinline__ Best<T> combine(const Best<T>& rev0, const Best<T>& rev1) {
  return rev1.score < rev0.score ? rev1 : rev0;
}

template <typename T>
__device__ __forceinline__ Best<T> shfl_xor(const Best<T>& b, int mask) {
  return {__shfl_xor_sync(FULL_MASK, b.score, mask), __shfl_xor_sync(FULL_MASK, b.lat, mask),
          __shfl_xor_sync(FULL_MASK, b.en, mask), __shfl_xor_sync(FULL_MASK, b.idx, mask)};
}

// Two lanes per candidate: lane 0 of a pair takes REV = 0, lane 1 REV = 1.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
strategy_eval_kernel(const T* __restrict__ cand, const T* __restrict__ ops,
                     const T* __restrict__ params, T* __restrict__ obj,
                     T* __restrict__ lat_out, T* __restrict__ en_out,
                     int* __restrict__ idx_out, int C, int P, T penalty_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prm = reinterpret_cast<T*>(smem_raw);   // NPARAM constants, NDERIVED terms
  T* sops = prm + NPARAM + NDERIVED;
  const int j = blockIdx.y;
  for (int i = threadIdx.x; i < NPARAM; i += blockDim.x)
    prm[i] = params[static_cast<size_t>(j) * NPARAM + i];
  for (int i = threadIdx.x; i < P * OPS_COLS; i += blockDim.x)
    sops[i] = ops[static_cast<size_t>(j) * P * OPS_COLS + i];
  __syncthreads();
  if (threadIdx.x < 2) {          // cyc_c, cyc_u of REV = threadIdx.x
    const int rev = threadIdx.x;
    const T al = prm[P_AL];
    const T dws = rev ? prm[P_DW_W] : prm[P_DW_IN];
    const T dwt = rev ? prm[P_DW_IN] : prm[P_DW_W];
    prm[NPARAM + D_CYC_C + rev] = mx(ceil_div(dws * al, prm[P_ICW]), T(1));
    prm[NPARAM + D_CYC_U + rev] = mx(ceil_div(al * dwt, prm[P_WUW]), T(1));
  } else if (threadIdx.x == 2) {
    prm[NPARAM + D_FREQ_HZ] = prm[P_FREQ_MHZ] * T(1e6);
  }
  __syncthreads();

  // ragged candidate edge: a lane past it evaluates the last row (so both
  // lanes of a pair reach every shuffle) and writes nothing
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int ci_raw = t / 2;
  const bool live = ci_raw < C;
  const int ci = live ? ci_raw : C - 1;
  const int half = t & 1;
  const size_t row = static_cast<size_t>(j) * C + ci;
  const T* cr = cand + row * CAND_COLS;

  const T al = prm[P_AL], pc = prm[P_PC], dw_psum = prm[P_DW_PSUM];
  Config<T> c;
  c.mr = cr[0];
  c.mc = cr[1];
  c.scr = cr[2];
  const T is_kb = cr[3], os_kb = cr[4];
  c.bw = cr[5];
  c.is_bits = is_kb * T(1024) * T(8);
  c.os_bits = os_kb * T(1024) * T(8);
  c.Kp = c.mr * al;
  c.Np = c.mc * pc;
  c.os_rows_af = floor_div(c.os_bits, c.Np * dw_psum);
  c.os_feasible = c.os_bits >= c.Np * dw_psum;
  c.overlap = (prm[P_UPDATE_DURING_COMPUTE] * (c.scr >= T(2) ? T(1) : T(0))) != T(0);

  // cost_model.area_mm2_t
  const T cells = al * pc * c.scr * prm[P_DW_W] * prm[P_A_CELL];
  const T cus = al * pc * prm[P_A_CU];
  const T macro_area = (cells + cus) * T(1e-6) + prm[P_A_MACRO_FIXED];
  const T sram_is = is_kb * T(8) / T(1024) * prm[P_A_SRAM_PER_MB] + prm[P_A_SRAM_FIXED];
  const T sram_os = os_kb * T(8) / T(1024) * prm[P_A_SRAM_PER_MB] + prm[P_A_SRAM_FIXED];
  c.area = c.mr * c.mc * macro_area + sram_is + sram_os + prm[P_A_FIXED];

  const int code = static_cast<int>(prm[P_OBJ_CODE]);
  T tot_lat = T(0), tot_en = T(0);
  for (int p = 0; p < P; ++p) {
    const T m = sops[p * OPS_COLS + 0];
    const T k = sops[p * OPS_COLS + 1];
    const T n = sops[p * OPS_COLS + 2];
    const T count = sops[p * OPS_COLS + 3];
    const Best<T> mine = best_of_half(half, m, k, n, c, prm, code);
    const Best<T> other = shfl_xor(mine, 1);
    const Best<T> best = half ? combine(other, mine) : combine(mine, other);
    // both lanes hold the same best; lane 0 of a pair writes
    tot_lat = tot_lat + best.lat * count;
    tot_en = tot_en + best.en * count;
    if (idx_out && live && half == 0) idx_out[row * P + p] = best.idx;
  }
  if (!live || half != 0) return;

  // cost_model.job_terms: score, area penalty, bandwidth rule
  T val = score(tot_lat, tot_en, code);
  const T budget = prm[P_AREA_BUDGET];
  const T excess = mx(c.area - budget, T(0)) / budget;
  val = val * (T(1) + penalty_scale * excess);
  const bool bw_ok = (prm[P_ICW] * c.mr >= c.bw) && (prm[P_WUW] * c.mr * c.mc >= c.bw);
  obj[row] = bw_ok ? val : T(1e30);
  if (lat_out) lat_out[row] = tot_lat;
  if (en_out) en_out[row] = tot_en;
}

template <typename T>
int launch(const void* cand, const void* ops, const void* params, void* obj,
           void* lat, void* en, void* idx, int J, int C, int P,
           double penalty_scale, void* stream) {
  if (J == 0 || C == 0) return 0;
  const long long threads = 2LL * C;
  const dim3 grid(static_cast<unsigned>((threads + BLOCK - 1) / BLOCK), J);
  const size_t smem = (NPARAM + NDERIVED + static_cast<size_t>(OPS_COLS) * P) * sizeof(T);
  strategy_eval_kernel<T><<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cand), static_cast<const T*>(ops),
      static_cast<const T*>(params), static_cast<T*>(obj), static_cast<T*>(lat),
      static_cast<T*>(en), static_cast<int*>(idx), C, P,
      static_cast<T>(penalty_scale));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cand [J, C, 6], ops [J, P, 5], params [J, 33] -> obj [J, C]; lat/en
// [J, C] and idx [J, C, P] (int32) are written when not null.  Launches on
// `stream`, allocates nothing, returns cudaGetLastError().
int strategy_eval_f32(const void* cand, const void* ops, const void* params,
                      void* obj, void* lat, void* en, void* idx, int J, int C,
                      int P, double penalty_scale, void* stream) {
  return launch<float>(cand, ops, params, obj, lat, en, idx, J, C, P,
                       penalty_scale, stream);
}

int strategy_eval_f64(const void* cand, const void* ops, const void* params,
                      void* obj, void* lat, void* en, void* idx, int J, int C,
                      int P, double penalty_scale, void* stream) {
  return launch<double>(cand, ops, params, obj, lat, en, idx, J, C, P,
                        penalty_scale, stream);
}

const char* strategy_eval_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int strategy_eval_nparam() { return NPARAM; }

int strategy_eval_nderived() { return NDERIVED; }

}  // extern "C"
