// strategy_eval: the CIM-Tuner cost model over a [jobs, candidates] grid.
//
// Replaces the Pallas TPU kernel src/repro/kernels/strategy_eval.py
// (strategy_eval -> _kernel -> _objective_block ->
// core/cost_model.workload_cost_core), widened to the engine's batched
// job_objective: per-job macro/tech constants, strategy mask, objective
// code and area budget, with the area penalty and the bandwidth rule.
//
// What bounds it on an H100: operations.  Per (candidate, operator,
// strategy) matmul_cost is some 120 scalar floating-point operations
// (divisions, floors and ceilings included; the count is in chip_smoke.py)
// on 6 + 5 input values, and a candidate's 6 values are read once for all
// of its operators and strategies.  At 67 TFLOP/s (fp32) or 34 TFLOP/s
// (fp64) outside the tensor cores, the arithmetic outweighs the bytes by
// three orders of magnitude.  The design therefore keeps everything in
// registers: one thread per (job, candidate), the job's operator rows and
// its 33 constants staged once per block in shared memory, the 8
// strategies unrolled with their bits as template constants so each
// strategy compiles to its own branch-free arithmetic, and a strategy the
// job's mask disallows is not computed at all (the mask is per job, so a
// whole block takes the same path).
//
// Numerics kept from the reference: IEEE division (never fast math; the
// model takes ceil/floor of quotients), no FMA contraction (built with
// -fmad=false, so each product rounds as in the reference), the
// reference's operation order term for term, and an argmin that keeps the
// first index on ties (strict <), as jnp.argmin does -- every infeasible
// strategy ties at INFEASIBLE = 1e30.
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

constexpr int OPS_COLS = 5;
constexpr int CAND_COLS = 6;
constexpr int BLOCK = 128;

template <typename T> __device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T ceil_div(T a, T b) { return ceil(a / b); }
template <typename T> __device__ __forceinline__ T floor_div(T a, T b) { return floor(a / b); }
template <typename T> __device__ __forceinline__ T spill(T work, T os) { return mx(work - os, T(0)); }

template <typename T>
__device__ __forceinline__ T score(T lat, T en, int code) {
  return code == 1 ? lat : (code == 2 ? lat * en : en);
}

template <typename T>
struct Config {
  T mr, mc, scr, is_bits, os_bits, bw, area;
};

// cost_model.matmul_cost for one strategy; returns latency and energy
// (INFEASIBLE where the strategy does not fit).  REV/WP/PF are the
// strategy's (reversed, weight_priority, parallel_first) bits.
template <typename T, bool REV, bool WP, bool PF>
__device__ __forceinline__ void matmul_cost(T m, T k, T n, const Config<T>& c,
                                            const T* prm, T& lat_out, T& en_out) {
  const T INF = T(1e30);
  const T al = prm[P_AL], pc = prm[P_PC];
  const T dw_psum = prm[P_DW_PSUM], dw_out = prm[P_DW_OUT];

  const T M = REV ? n : m;
  const T N = REV ? m : n;
  const T K = k;
  const T dws = REV ? prm[P_DW_W] : prm[P_DW_IN];
  const T dwt = REV ? prm[P_DW_IN] : prm[P_DW_W];

  const T cyc_c = mx(ceil_div(dws * al, prm[P_ICW]), T(1));
  const T cyc_u = mx(ceil_div(al * dwt, prm[P_WUW]), T(1));

  const T Kp = c.mr * al;
  const T Np = c.mc * pc;
  const T tK = ceil_div(K, Kp);
  const T tN = ceil_div(N, Np);
  const T Kpad = tK * Kp;
  const T Npad = tN * Np;
  const T planes = tK * tN;

  const T G = ceil_div(tK, c.scr);
  const T H = ceil_div(tN, c.scr);
  const T remN = tN - (H - T(1)) * c.scr;
  const T scr_n = mn(c.scr, tN);

  const T rows_res_raw = floor_div(c.is_bits, Kpad * dws);
  const bool wp_feasible = rows_res_raw >= T(1);
  const T rows_res = mn(mx(rows_res_raw, T(1)), M);
  const T B = ceil_div(M, rows_res);
  const T remB = M - (B - T(1)) * rows_res;
  const bool is_feasible = c.is_bits >= Kp * dws;
  const bool fits_all_v = M * Kpad * dws <= c.is_bits;

  const T v_refetch_ip = fits_all_v ? T(1) : (PF ? H : tN);
  const T v_bits = M * Kpad * dws * (WP ? T(1) : v_refetch_ip);

  const bool fits_all_s = planes <= c.scr;
  const T s_loads = planes * ((WP && !fits_all_s) ? B : T(1));
  const T s_bits = s_loads * Kp * Np * dwt;
  const T update_cycles = s_loads * cyc_u;

  const T compute_cycles = M * planes * cyc_c;
  const T macs = M * Kpad * Npad;

  const T is_wr = v_bits;
  const T is_rd = M * Kpad * dws * (PF ? H : tN);

  T spill_bits;
  if (!PF) {
    const T os_rows_af = floor_div(c.os_bits, Np * dw_psum);
    if (WP) {
      spill_bits = T(2) * (G - T(1)) * Np * dw_psum * tN
          * ((B - T(1)) * spill(rows_res, os_rows_af) + spill(remB, os_rows_af));
    } else {
      spill_bits = T(2) * (G - T(1)) * spill(M, os_rows_af) * Np * dw_psum * tN;
    }
  } else {
    const T nfull = H - T(1);
    const T os_full = floor_div(c.os_bits, scr_n * Np * dw_psum);
    const T os_rem = floor_div(c.os_bits, remN * Np * dw_psum);
    auto pf_rows = [&](T work) {
      return nfull * spill(work, os_full) * scr_n + spill(work, os_rem) * remN;
    };
    if (WP) {
      spill_bits = T(2) * (tK - T(1)) * Np * dw_psum
          * ((B - T(1)) * pf_rows(rows_res) + pf_rows(remB));
    } else {
      spill_bits = T(2) * (tK - T(1)) * Np * dw_psum * pf_rows(M);
    }
  }

  const T groups_per_col = PF ? tK : G;
  const T os_wr = M * tN * groups_per_col * Np * dw_psum;
  const T os_rd = M * tN * (groups_per_col - T(1)) * Np * dw_psum + M * Npad * dw_psum;
  const bool os_feasible = c.os_bits >= Np * dw_psum;

  const T y_bits = M * Npad * dw_out;

  const T ema_bits = v_bits + s_bits + spill_bits + y_bits;
  const T ema_cycles = ceil_div(ema_bits, c.bw);

  const bool overlap = (prm[P_UPDATE_DURING_COMPUTE] * (c.scr >= T(2) ? T(1) : T(0))) != T(0);
  const T busy = mx(compute_cycles, ema_cycles);
  const T latency = overlap ? mx(busy, update_cycles) : busy + update_cycles;

  const bool feasible = is_feasible && os_feasible && (!WP || wp_feasible);

  const T e_dyn = (macs * prm[P_MAC_E_PJ]
                   + s_bits * prm[P_E_CIM_UPDATE]
                   + (is_rd + os_rd) * prm[P_E_SRAM_RD]
                   + (is_wr + os_wr) * prm[P_E_SRAM_WR]
                   + ema_bits * prm[P_E_EMA]) * prm[P_SYS_OVERHEAD];
  const T lat_s = latency / (prm[P_FREQ_MHZ] * T(1e6));
  const T e_leak = prm[P_LEAK_MW_MM2] * c.area * lat_s * T(1e9);
  const T energy = e_dyn + e_leak;

  lat_out = feasible ? latency : INF;
  en_out = feasible ? energy : INF;
}

// One strategy of the unrolled argmin: skipped (INFEASIBLE) when the mask
// disallows it, first index kept on ties.
template <typename T, int S>
__device__ __forceinline__ void try_strategy(T m, T k, T n, const Config<T>& c,
                                             const T* prm, int code, T& best_score,
                                             T& best_lat, T& best_en, int& best) {
  const T INF = T(1e30);
  T lat = INF, en = INF;
  if (prm[P_ALLOWED + S] > T(0)) {
    matmul_cost<T, (S & 4) != 0, (S & 2) != 0, (S & 1) != 0>(m, k, n, c, prm, lat, en);
  }
  const T s = score(lat, en, code);
  if (S == 0 || s < best_score) {
    best_score = s;
    best_lat = lat;
    best_en = en;
    best = S;
  }
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
strategy_eval_kernel(const T* __restrict__ cand, const T* __restrict__ ops,
                     const T* __restrict__ params, T* __restrict__ obj,
                     T* __restrict__ lat_out, T* __restrict__ en_out,
                     int* __restrict__ idx_out, int C, int P, T penalty_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* prm = reinterpret_cast<T*>(smem_raw);
  T* sops = prm + NPARAM;
  const int j = blockIdx.y;
  for (int i = threadIdx.x; i < NPARAM; i += blockDim.x)
    prm[i] = params[static_cast<size_t>(j) * NPARAM + i];
  for (int i = threadIdx.x; i < P * OPS_COLS; i += blockDim.x)
    sops[i] = ops[static_cast<size_t>(j) * P * OPS_COLS + i];
  __syncthreads();

  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= C) return;                           // ragged candidate edge
  const size_t row = static_cast<size_t>(j) * C + ci;
  const T* cr = cand + row * CAND_COLS;

  Config<T> c;
  c.mr = cr[0];
  c.mc = cr[1];
  c.scr = cr[2];
  const T is_kb = cr[3], os_kb = cr[4];
  c.bw = cr[5];
  c.is_bits = is_kb * T(1024) * T(8);
  c.os_bits = os_kb * T(1024) * T(8);

  // cost_model.area_mm2_t
  const T al = prm[P_AL], pc = prm[P_PC];
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
    T best_score = T(0), best_lat = T(0), best_en = T(0);
    int best = 0;
    try_strategy<T, 0>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 1>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 2>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 3>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 4>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 5>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 6>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    try_strategy<T, 7>(m, k, n, c, prm, code, best_score, best_lat, best_en, best);
    tot_lat = tot_lat + best_lat * count;
    tot_en = tot_en + best_en * count;
    if (idx_out) idx_out[row * P + p] = best;
  }

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
  const dim3 grid((C + BLOCK - 1) / BLOCK, J);
  const size_t smem = (NPARAM + static_cast<size_t>(OPS_COLS) * P) * sizeof(T);
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

}  // extern "C"
