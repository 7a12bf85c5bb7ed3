// Level-pool reservoir step for every lake lane: kernel L1, with or without
// the typed reservoir DA.
//
// It replaces no TPU kernel: the JAX package writes the step
// (troute_tpu/ops/levelpool.py:levelpool_step) and the typed reservoir DA
// (troute_tpu/ops/reservoir_da.py:typed_reservoir_dispatch) as masked vector
// operations, which XLA fuses into a few loops.  Run eagerly, the port's
// plain versions (troute_torch/ops/levelpool.py, ops/reservoir_da.py) are
// ~144 and ~190 element-wise launches a step, and the engine adds the lakes'
// inflow gather and two scatters: on a step of a few thousand lakes the
// host's dispatch of those launches, not the card, sets the time.  So the
// whole step is one launch, one thread per lake.
//
// What bounds it on an H100: per lake it reads 12-14 values and writes 2-3
// (at most ~130 bytes in f64) and evaluates the discharge four times (two
// pow and one sqrt each), so at 5,441 lakes it is a few microseconds of
// latency, one wave of 22 blocks; nothing here is worth more than being a
// single launch.  With DA a lake runs only its own kind's DA: a persistence
// lake walks its row of observation times once (193 at NWM's 48 h of 15-min
// values) and back to the newest observation present, an RFC lake walks its
// forecast series back only when the outflow is negative; the plain version
// runs every kind over every lake, the dense [n, 193] and [n, 76] masks too.
//
// Bits: the kernel is held to the plain version run on the same card, so
// every operation rounds on its own in the plain version's order (the
// build passes --fmad=false and no fast-math flag): (oc * oa) * sqrt(..),
// (tmp1 + tmp2) + over, powf/pow for `** 1.5`, fminf/fmaxf with the NaN
// tests of torch.minimum and torch.clamp_min, the scalars as the T values
// of the Python literals.  PyTorch divides a CUDA tensor by a Python scalar
// as a multiply by the scalar's reciprocal (rounded in T on the host), so
// `dh1 / 3.0` is dh1 * (T(1) / T(3)) here; a tensor divided by a tensor is
// a true division.  The DA's searches give the indices of the plain
// version's reductions: argmin's first index of the least value (0 when
// every value is inf), amax's largest eligible index (-1 when none, then 0).
//
// Two forms, chosen by the arguments:
//   lane form (rows null): lake i reads H[i], qi0[i], qi1[i] and ql[i]
//     (ql null reads 0), as levelpool_step(H, qi0, qi1, ql, dt, p);
//   row form (rows given): lake i reads its inflow quc[rows[i]] as both
//     qi0 and qi1 with ql 0, as the engine's short step calls the level
//     pool; `inflow` (if given) receives that inflow, and `q_into` and
//     `d_into` (if given) receive the outflow at q_into[rows[i]] and the
//     new elevation at d_into[rows[i]], the engine's two scatters.  A row
//     outside [0, n_nodes) traps, as PyTorch's index kernels assert.
// Outputs `outflow` and `inflow` may be null; `h_new` may not.
//
// The nine parameters come packed, lake i's in LevelpoolParams' order at
// params[9 i .. 9 i + 8]: the wrapper packs a parameter set once and keeps
// it, so nothing is copied per step.
//
// The DA form (levelpool_da_kernel) takes a lake's inflow from `inflow`
// (lane form) or quc[rows[i]] (row form), runs the level pool, then the DA
// of the lake's wbody_type (1 level pool, 2-3 hybrid persistence, 4-5 RFC,
// 6 Great Lakes) on its result, as ops/reservoir_da.py:
// typed_reservoir_dispatch: the elevation to h_new, the outflow and the
// depth column's value to `outflow` and `d_scat` (lane form) or to
// q_into[row] and d_into[row] (row form), the nine DA state fields to
// st_out ([8, n]: persisted outflow, update time, persistence index,
// persistence update time, RFC update time, the Great Lakes' assimilated
// outflow, assimilated time and update time) and ts_out (the RFC series
// index).  A lake of another kind copies each state through.  The inputs
// fixed over a routing call come in DAInputs, packed once per DA data.
//
// C interface (loaded with ctypes): levelpool_f32 / levelpool_f64 take
// H, qi0, qi1, ql, the int64 rows, quc, the packed parameters, dt, the
// outputs outflow, h_new, inflow, q_into, d_into, the lake count, the node
// count and the CUDA stream; levelpool_da_f32 / levelpool_da_f64 take H,
// inflow, rows, quc, the packed parameters, dt, the time `now` (s, as a
// double), the month index, a pointer to the DAInputs, the nine state
// fields in, st_out, ts_out, h_new, outflow, d_scat, q_into, d_into, the
// lake count, the node count and the stream.  They launch on that stream
// and return cudaGetLastError().

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T> struct Math;

template <> struct Math<float> {
  static __device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
  static __device__ __forceinline__ float sq(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float mx(float a, float b) { return fmaxf(a, b); }
};

template <> struct Math<double> {
  static __device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }
  static __device__ __forceinline__ double sq(double x) { return sqrt(x); }
  static __device__ __forceinline__ double mn(double a, double b) { return fmin(a, b); }
  static __device__ __forceinline__ double mx(double a, double b) { return fmax(a, b); }
};

// torch.minimum: a NaN operand is the result
template <typename T> __device__ __forceinline__ T minimum(T a, T b) {
  return a != a ? a : (b != b ? b : Math<T>::mn(a, b));
}

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }

// torch.clamp_min(v, 0.0): NaN passes through
template <typename T> __device__ __forceinline__ T clamp0(T v) {
  return v != v ? v : Math<T>::mx(v, T(0));
}

// one lake's parameters
template <typename T> struct Lake {
  T max_depth, orifice_area, orifice_coeff, orifice_elev, weir_coeff, weir_elev,
      weir_length, dam_length;
};

// ops/levelpool.py:_discharge
template <typename T>
__device__ __forceinline__ T discharge(T h_weir, T h_orifice, T h_overtop_test,
                                       const Lake<T>& k) {
  const T max_weir_depth = k.max_depth - k.weir_elev;
  const T dh = minimum(h_weir - k.weir_elev, max_weir_depth);
  const T head = h_orifice - k.orifice_elev;
  const T tmp1 = (k.orifice_coeff * k.orifice_area) * Math<T>::sq(T(2.0 * 9.81) * clamp0(head));
  const T tmp2 = (k.weir_coeff * k.weir_length) * Math<T>::pw(clamp0(dh), T(1.5));
  const T over = (k.weir_coeff * (k.weir_length * k.dam_length)) *
                 Math<T>::pw(clamp0(h_overtop_test - k.max_depth), T(1.5));
  if (h_overtop_test > k.max_depth) return (tmp1 + tmp2) + over;
  if (dh > T(0)) return tmp1 + tmp2;
  if (h_orifice > k.orifice_elev) return tmp1;
  return T(0);
}

// ops/levelpool.py:levelpool_step for one lake with parameters pi,
// operation for operation: the new elevation hn and the outflow out
template <typename T>
__device__ __forceinline__ void step_lake(T h, T q0, T q1, T lat, const T* pi, T dt, T& hn,
                                          T& out) {
  const Lake<T> k{pi[1], pi[2], pi[3], pi[4], pi[5], pi[6], pi[7], pi[8]};
  const T rise = (q1 + lat) - q0;
  const T itdt_3 = q0 + rise * T(0.33);
  const T itdt_2_3 = q0 + rise * T(0.67);
  const T sap = pi[0] * T(1.0e6);
  const bool has_area = sap > T(0);
  const T safe_sap = has_area ? sap : T(1);
  constexpr T kThird = T(1) / T(3);
  constexpr T kQuarter = T(1) / T(4);

  const T d1 = discharge(h, h, h, k);
  const T dh1 = has_area ? ((q0 - d1) / safe_sap) * dt : T(0);
  const T h2 = h + dh1 * kThird;
  const T d2 = discharge(h2, h2, h, k);
  const T dh2 = has_area ? ((itdt_3 - d2) / safe_sap) * dt : T(0);
  const T h3 = h + T(0.667) * dh2;
  const T d3 = discharge(h3, h3, h, k);
  const T dh3 = has_area ? ((itdt_2_3 - d3) / safe_sap) * dt : T(0);
  hn = (h + dh1 * kQuarter) + T(0.75) * dh3;
  out = discharge(hn, hn, hn, k);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
levelpool_kernel(const T* H, const T* qi0, const T* qi1, const T* ql, const int64_t* rows,
                 const T* quc, const T* params, T dt, T* outflow, T* h_new, T* inflow, T* q_into,
                 T* d_into, int64_t n, int64_t n_nodes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t row = 0;
  T q0, q1;
  T lat = T(0);
  if (rows != nullptr) {
    row = rows[i];
    if (row < 0 || row >= n_nodes) __trap();
    q0 = q1 = quc[row];
    if (inflow != nullptr) inflow[i] = q0;
  } else {
    q0 = qi0[i];
    q1 = qi1[i];
    if (ql != nullptr) lat = ql[i];
  }
  T hn, out;
  step_lake(H[i], q0, q1, lat, params + 9 * i, dt, hn, out);

  h_new[i] = hn;
  if (outflow != nullptr) outflow[i] = out;
  if (q_into != nullptr) q_into[row] = out;
  if (d_into != nullptr) d_into[row] = hn;
}

// ---------------------------------------------------------------- typed DA

// ops/reservoir_da.py's constants
constexpr double kPersistenceLimit = 11;        // cycles
constexpr double kUpdateInterval = 3600.0;      // s
constexpr double kPersistenceInterval = 86400.0;  // s
constexpr double kGreatLakesLimit = 11.0 * 86400.0;  // s

// The DA inputs that stay fixed over a routing call, packed once per DA data
// by the wrapper.  Every field is 8 bytes, in the order of the wrapper's
// ctypes Structure.  The lane vectors are contiguous; the matrices come with
// their element strides.
template <typename T> struct DAInputs {
  const int32_t* wbody_type;
  const int32_t* rfc_counts;
  const bool* rfc_use;
  const T* rfc_timestep;
  const T* rfc_persist;
  const T* hyb_obs;  // [n, n_hobs]
  int64_t hyb_obs_s0, hyb_obs_s1;
  const T* hyb_time;  // [n_hobs]
  int64_t hyb_time_s, n_hobs;
  const T* rfc_series;  // [n, n_counts]
  int64_t rfc_s0, rfc_s1, n_counts;
  const T* gl_obs;  // [n, n_gobs]
  int64_t gl_obs_s0, gl_obs_s1;
  const T* gl_time;  // [n, n_gobs]
  int64_t gl_time_s0, gl_time_s1, n_gobs;
  const T* gl_clim;  // [n, months]
  int64_t clim_s0, clim_s1;
  double lookback_s;  // obs_lookback_hours * 3600.0, as Python computes it
};

// the DA state of one lake, in st_out's row order, and the RFC series index
template <typename T> struct LaneState {
  T persisted, update_time, p_index, p_update_time;  // hybrid persistence
  T rfc_update_time;
  T gl_outflow, gl_time, gl_update_time;  // Great Lakes
  int32_t rfc_idx;
};

// the nine state fields in, each [n] contiguous
template <typename T> struct StatesIn {
  const T *persisted, *update_time, *p_index, *p_update_time;
  const int32_t* rfc_idx;
  const T *rfc_update_time, *gl_outflow, *gl_time, *gl_update_time;
};

// ops/reservoir_da.py:hybrid_persistence_da on lake i
template <typename T>
__device__ __forceinline__ void hybrid_da(const DAInputs<T>& da, int64_t i, T now, T h, T inflow,
                                          T lp_out, T area6, T max_depth, T orifice_elev, T dt,
                                          LaneState<T>& s, T& out, T& elev) {
  const T inf = T(INFINITY);
  const T ut = s.update_time;
  // the nearest observation time not after update_time (argmin of the
  // non-negative differences, inf elsewhere)
  int64_t t_idx = 0;
  T best = inf;
  for (int64_t j = 0; j < da.n_hobs; ++j) {
    const T diff = ut - __ldg(da.hyb_time + j * da.hyb_time_s);
    const T v = diff >= T(0) ? diff : inf;
    if (v < best) {
      best = v;
      t_idx = j;
    }
  }
  // then back to the newest observation present
  const T* obs = da.hyb_obs + i * da.hyb_obs_s0;
  int64_t pick = -1;
  for (int64_t j = t_idx; j >= 0; --j)
    if (!is_nan(obs[j * da.hyb_obs_s1])) {
      pick = j;
      break;
    }
  const bool found = pick >= 0;
  const int64_t safe_pick = found ? pick : 0;
  const T obs_val = obs[safe_pick * da.hyb_obs_s1];
  const T lookback = ut - __ldg(da.hyb_time + safe_pick * da.hyb_time_s);
  const bool stale = lookback > static_cast<T>(da.lookback_s);

  const bool searching = now >= ut;
  const bool fresh = searching && found && !stale;
  const bool bump_cycle = now >= s.p_update_time;

  T persisted = fresh ? obs_val : s.persisted;
  const bool limit_hit = !searching && bump_cycle && s.p_index > T(kPersistenceLimit);
  if (limit_hit) persisted = lp_out;

  T p_idx = s.p_index;
  if (searching && !fresh && bump_cycle) p_idx = s.p_index + T(1);
  if (fresh) p_idx = T(1);
  if (!searching && bump_cycle) p_idx = s.p_index + T(1);
  if (limit_hit) p_idx = T(0);
  const bool adv_cycle = (searching && !fresh && bump_cycle) || fresh || (!searching && bump_cycle);
  if (adv_cycle) s.p_update_time = s.p_update_time + T(kPersistenceInterval);
  if (searching && found) s.update_time = ut + T(kUpdateInterval);

  // NaN persisted value: the level pool's outflow, the index reset
  const bool nan_persist = is_nan(persisted);
  const T assess = nan_persist ? lp_out : persisted;
  if (nan_persist) p_idx = T(0);
  s.persisted = persisted;
  s.p_index = p_idx;

  // storage bounds, projected with the unmodified assessment outflow
  const T initial_storage = (h - orifice_elev) * area6;
  const T maximum_storage = (max_depth - orifice_elev) * area6;
  T out2 = assess < T(0) ? T(0) : assess;
  const T projected = initial_storage + (inflow - assess) * dt;
  if (projected <= T(0)) out2 = inflow;
  out2 = clamp0(out2);
  if (projected > maximum_storage && out2 < lp_out) out2 = lp_out;
  out = out2;
  elev = h + ((inflow - out2) * dt) / area6;
}

// ops/reservoir_da.py:rfc_forecast_da on lake i (type 4 CONUS, 5 Alaska)
template <typename T>
__device__ __forceinline__ void rfc_da(const DAInputs<T>& da, int64_t i, int32_t wt, T now, T h,
                                       T inflow, T lp_out, T lp_elev, T area6, T max_depth, T dt,
                                       LaneState<T>& s, T& out, T& elev) {
  const bool in_window = da.rfc_use[i] && now <= da.rfc_persist[i];
  if (in_window && now >= s.rfc_update_time && s.rfc_idx < da.rfc_counts[i]) {
    s.rfc_idx = s.rfc_idx + 1;
    s.rfc_update_time = s.rfc_update_time + da.rfc_timestep[i];
  }
  const bool is_conus = wt == 4;
  const T fallback = is_conus ? lp_out : inflow;
  if (!in_window) {
    out = fallback;
    elev = lp_elev;
    return;
  }
  const int64_t last = da.n_counts - 1;
  const int64_t idx = s.rfc_idx < 0 ? 0 : (s.rfc_idx > last ? last : s.rfc_idx);
  const T* series = da.rfc_series + i * da.rfc_s0;
  const T ts_val = series[idx * da.rfc_s1];
  T o = is_conus ? ts_val : inflow + ts_val;
  // the elevation from the outflow before the backstop below
  T e = h + ((inflow - o) / area6) * dt;
  e = minimum(clamp0(e), max_depth);
  // negative outflow: back (to index 1) to a non-negative series value
  if (o < T(0)) {
    int64_t back = -1;
    for (int64_t j = idx; j >= 1; --j)
      if (series[j * da.rfc_s1] >= T(0)) {
        back = j;
        break;
      }
    if (back >= 0) {
      o = series[back * da.rfc_s1];
    } else {
      o = fallback;
      e = lp_elev;
    }
  }
  out = o;
  elev = e;
}

// ops/reservoir_da.py:great_lakes_da on lake i
template <typename T>
__device__ __forceinline__ void great_lakes_da(const DAInputs<T>& da, int64_t i, int64_t month,
                                               T now, LaneState<T>& s, T& out) {
  const T clim = da.gl_clim[i * da.clim_s0 + month * da.clim_s1];
  const T prev = is_nan(s.gl_outflow) ? clim : s.gl_outflow;
  // the newest observation at or before now
  const T* obs = da.gl_obs + i * da.gl_obs_s0;
  const T* times = da.gl_time + i * da.gl_time_s0;
  int64_t pick = -1;
  for (int64_t j = da.n_gobs - 1; j >= 0; --j)
    if (now - times[j * da.gl_time_s1] >= T(0)) {
      pick = j;
      break;
    }
  const int64_t safe = pick >= 0 ? pick : 0;
  const T obs_val = obs[safe * da.gl_obs_s1];
  const T t_obs = times[safe * da.gl_time_s1];
  const bool good = pick >= 0 && !is_nan(obs_val);
  const T lookback = now - t_obs;
  const T limit = T(kGreatLakesLimit);
  const bool searching = now >= s.gl_update_time;
  const bool take = searching && good && lookback <= limit;
  const bool stale = searching && good && lookback > limit;
  out = searching ? (take ? obs_val : (stale ? clim : prev))
                  : ((now - s.gl_time) > limit ? clim : prev);
  if (take) {
    s.gl_outflow = obs_val;
    s.gl_time = t_obs;
    s.gl_update_time = s.gl_update_time + T(kUpdateInterval);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
levelpool_da_kernel(const T* H, const T* lake_inflow, const int64_t* rows, const T* quc,
                    const T* params, T dt, T now, int64_t month, const DAInputs<T> da,
                    const StatesIn<T> in, T* st_out, int32_t* ts_out, T* h_new, T* outflow,
                    T* d_scat, T* q_into, T* d_into, int64_t n, int64_t n_nodes) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  int64_t row = 0;
  T inflow;
  if (rows != nullptr) {
    row = rows[i];
    if (row < 0 || row >= n_nodes) __trap();
    inflow = quc[row];
  } else {
    inflow = lake_inflow[i];
  }
  const T h = H[i];
  const T* pi = params + 9 * i;
  T lp_elev, lp_out;
  step_lake(h, inflow, inflow, T(0), pi, dt, lp_elev, lp_out);

  LaneState<T> s{in.persisted[i],       in.update_time[i], in.p_index[i],
                 in.p_update_time[i],   in.rfc_update_time[i], in.gl_outflow[i],
                 in.gl_time[i],         in.gl_update_time[i], in.rfc_idx[i]};
  const int32_t wt = da.wbody_type[i];
  const T area6 = pi[0] * T(1.0e6);
  T out = lp_out, elev = lp_elev;
  if (wt == 2 || wt == 3) {
    hybrid_da(da, i, now, h, inflow, lp_out, area6, pi[1], pi[4], dt, s, out, elev);
  } else if (wt == 4 || wt == 5) {
    rfc_da(da, i, wt, now, h, inflow, lp_out, lp_elev, area6, pi[1], dt, s, out, elev);
  } else if (wt == 6) {
    great_lakes_da(da, i, month, now, s, out);
    elev = h;
  }
  const T d = wt == 6 ? T(0) : elev;

  const T fields[8] = {s.persisted,       s.update_time, s.p_index,  s.p_update_time,
                       s.rfc_update_time, s.gl_outflow,  s.gl_time,  s.gl_update_time};
#pragma unroll
  for (int k = 0; k < 8; ++k) st_out[k * n + i] = fields[k];
  ts_out[i] = s.rfc_idx;
  h_new[i] = elev;
  if (outflow != nullptr) outflow[i] = out;
  if (d_scat != nullptr) d_scat[i] = d;
  if (q_into != nullptr) q_into[row] = out;
  if (d_into != nullptr) d_into[row] = d;
}

int grid(int64_t n, unsigned* blocks) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  if (b > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned>(b);
  return 0;
}

template <typename T>
int launch(const T* H, const T* qi0, const T* qi1, const T* ql, const int64_t* rows,
           const T* quc, const T* params, T dt, T* outflow, T* h_new, T* inflow,
           T* q_into, T* d_into, int64_t n, int64_t n_nodes, void* stream) {
  if (n < 0 || h_new == nullptr || params == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == nullptr ? (qi0 == nullptr || qi1 == nullptr || q_into != nullptr ||
                         d_into != nullptr || inflow != nullptr)
                      : quc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  unsigned blocks;
  if (const int rc = grid(n, &blocks)) return rc;
  levelpool_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      H, qi0, qi1, ql, rows, quc, params, dt, outflow, h_new, inflow, q_into, d_into, n, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_da(const T* H, const T* inflow, const int64_t* rows, const T* quc, const T* params,
              T dt, double now, int64_t month, const DAInputs<T>* da, const StatesIn<T>& in,
              T* st_out, int32_t* ts_out, T* h_new, T* outflow, T* d_scat, T* q_into, T* d_into,
              int64_t n, int64_t n_nodes, void* stream) {
  if (n < 0 || da == nullptr || params == nullptr || st_out == nullptr || ts_out == nullptr ||
      h_new == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // the lane form writes outflow and d_scat, the row form q_into and d_into
  if (rows == nullptr ? (inflow == nullptr || outflow == nullptr || d_scat == nullptr ||
                         q_into != nullptr || d_into != nullptr)
                      : (quc == nullptr || q_into == nullptr || d_into == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  unsigned blocks;
  if (const int rc = grid(n, &blocks)) return rc;
  levelpool_da_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      H, inflow, rows, quc, params, dt, static_cast<T>(now), month, *da, in, st_out, ts_out,
      h_new, outflow, d_scat, q_into, d_into, n, n_nodes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define LP_ENTRY(FN, T)                                                                      \
  int FN(const T* H, const T* qi0, const T* qi1, const T* ql, const int64_t* rows,           \
         const T* quc, const T* params, T dt, T* outflow, T* h_new, T* inflow, T* q_into,    \
         T* d_into, int64_t n, int64_t n_nodes, void* stream) {                              \
    return launch<T>(H, qi0, qi1, ql, rows, quc, params, dt, outflow, h_new, inflow, q_into, \
                     d_into, n, n_nodes, stream);                                            \
  }

LP_ENTRY(levelpool_f32, float)
LP_ENTRY(levelpool_f64, double)

#define LP_DA_ENTRY(FN, T)                                                                    \
  int FN(const T* H, const T* inflow, const int64_t* rows, const T* quc, const T* params,     \
         T dt, double now, int64_t month, const void* da, const T* persisted,                 \
         const T* update_time, const T* p_index, const T* p_update_time,                      \
         const int32_t* rfc_idx, const T* rfc_update_time, const T* gl_outflow,               \
         const T* gl_time, const T* gl_update_time, T* st_out, int32_t* ts_out, T* h_new,     \
         T* outflow, T* d_scat, T* q_into, T* d_into, int64_t n, int64_t n_nodes,             \
         void* stream) {                                                                      \
    const StatesIn<T> in{persisted, update_time,     p_index,    p_update_time, rfc_idx,      \
                         rfc_update_time, gl_outflow, gl_time, gl_update_time};               \
    return launch_da<T>(H, inflow, rows, quc, params, dt, now, month,                         \
                        static_cast<const DAInputs<T>*>(da), in, st_out, ts_out,              \
                        h_new, outflow, d_scat, q_into, d_into, n, n_nodes, stream);          \
  }

LP_DA_ENTRY(levelpool_da_f32, float)
LP_DA_ENTRY(levelpool_da_f64, double)

}  // extern "C"
