// Muskingum-Cunge secant solve for every river segment: kernels B1 and B2.
//
// Kernel B1, `mc_secant_kernel`, replaces the TPU kernel `_mc_block_kernel`
// of troute_tpu/ops/muskingum_pallas.py (launched by `_mc_pallas_padded`),
// which runs the masked `solve_block` loop of troute_tpu/ops/muskingum.py
// on (16, 128)-lane VMEM blocks and exits a block when all of its lanes
// have converged.  Here each segment runs the reference's scalar control
// flow (MCsingleSegStime_f2py_NOLOOP.f90:8-186, readable as
// tests/reference_impl.py:muskingum_cunge_ref) as a small state machine:
// `init_lane` loads it, `trip` makes one pass of the secant loop (the
// label-111 retry included), `finish_lane` computes and stores its
// outputs.  Each operation is written in the order of the plain version
// (troute_torch/ops/muskingum.py) so that the two agree lane for lane,
// whichever thread runs the lane: the build passes --fmad=false and no
// fast-math flag, pow/powf give x^(2/3) and x^(5/3), and FLT_MIN/DBL_MIN
// stand for `tiny`.  Lane invariants (sqrt(s0), sqrt(1+z*z), sqrt(s0)/n,
// sqrt(s0)/ncc) are computed once in `init_lane`: the same correctly
// rounded operations on the same inputs, so the same bits.
//
// What bounds it on an H100: per lane it reads 13 values and writes 3
// (6 with the diagnostics), 64 (f32) to 152 (f64) bytes, against 1..~760
// secant trips; a trip that passes the loop's top check evaluates the
// residual at two depths, with pow, sqrt and IEEE divides (679 SASS
// instructions on the straight in-bank path in f32, PERF.md): at network
// scale it is bound by instruction issue, and at the end of a call by the
// slowest lane's own dependent chain.  One thread per lane (the first
// design) lost issue slots twice: a warp ran until its slowest lane
// converged, and a block held its SM slot until its slowest warp ended.
// So B1 is a persistent grid, as many blocks as are resident (occupancy x
// SMs, queried once), whose lanes refill: a lane whose segment has
// converged keeps its result until at least kRefillMin (28) of its warp's
// 32 lanes are idle; then the warp stores the finished lanes and hands the
// idle ones the next segment indices from its range of 32; when the range
// is spent, lane 0 claims the next 32 from a global counter with one
// atomicAdd for the warp (ballot, popc, shfl share the range out).  A warp
// leaves when the counter is past nseg and all its lanes are idle.
// No-flow lanes finish in zero trips.  A refill pass (stores, 13 loads,
// the lane invariants) costs about a trip's issue, so refilling after
// every trip was slower than refilling in batches (PERF.md, Findings).
// Where a call's trips are tight, as on the steps of a cold start, one
// thread per lane wasted little, and the refill machinery's own cost
// makes this design ~10% slower there (PERF.md).
// The two points of a trip are computed side by side so that their chains
// interleave.  Which thread solves a lane, and in which order, changes
// nothing in its result.
//
// Kernel B2, `mc_secant_skip_kernel`, replaces `_mc_block_kernel_skip` of
// the same Pallas file (launched by `_mc_pallas_padded_skip`), the
// active-set form used by strict fixed-point sweeps: a block whose int32
// activity flag is 0 copies the previous call's outputs through instead of
// solving.  A flag covers kSkipBlock (256) consecutive lanes.  What bounds
// it: a skipped lane moves 3 (6) values in and as many out, 24 to 96
// bytes and no arithmetic; a solved lane costs what it costs in B1.  One
// thread per lane and one CUDA block per flag (the first design) lost the
// skip's gain twice: a solved block held its SM slot until its slowest
// lane ended, and skipped and solved blocks were scheduled in index order
// with no balance between SMs.  So B2 is B1's persistent grid
// (`persistent_solve`, one loop for both kernels) with the flag read at
// claim time: a claim is 32 aligned lanes, which lie inside one flag
// block, so the test is uniform across the warp.  A claim in an inactive
// block is copied through at once by the whole warp (thread l copies lane
// base + l of each `prev` array, one 128-byte line per array in f32,
// whatever segments its threads still hold) and the warp claims again; a
// claim in an active block refills idle lanes exactly as in B1.  `prev`
// and the outputs must not overlap (the wrapper allocates the outputs).
// `prev` comes in the order of the outputs (qdc, velc, depthc, ck, cn, x);
// the TPU wrapper hands it over with ck and cn swapped
// (muskingum_pallas.py:172-173), which the port does not copy.
//
// C interface (loaded with ctypes): mc_secant_f32 / mc_secant_f64 take the
// 13 input pointers, dt, the 6 output pointers (ck, cn, x may be null to
// skip the diagnostics), two int32 per-lane counts (null skips either):
// the trips, passes of the secant loop, and the evaluations, the passes
// that evaluated the residual, then the int32 work counter (one value,
// zero before the call), the lane count and the CUDA stream, launch on
// that stream and return cudaGetLastError().
// mc_secant_skip_f32 / _f64 take, after the outputs, the 6 `prev` pointers
// (the last 3 null with the outputs') and the [ceil(nseg / 256)] int32
// flags, then the same two counts (0 expected on skipped lanes: the kernel
// does not write them), the work counter, the lane count and the stream.
// Built with -DMC_SECANT_PROBES, the file also holds two probe
// kernels whose SASS differ by one residual evaluation (for counting its
// instructions).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxiterInit = 100;
constexpr int kMaxTries = 4;

template <typename T> struct Math;

template <> struct Math<float> {
  static __device__ __forceinline__ float pw(float x, float y) { return powf(x, y); }
  static __device__ __forceinline__ float sq(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float ab(float x) { return fabsf(x); }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};

template <> struct Math<double> {
  static __device__ __forceinline__ double pw(double x, double y) { return pow(x, y); }
  static __device__ __forceinline__ double sq(double x) { return sqrt(x); }
  static __device__ __forceinline__ double ab(double x) { return fabs(x); }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// max/min written as the plain version's clamp_min/minimum/maximum
template <typename T> __device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }
template <typename T> __device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// idle lanes of a warp that start a refill
constexpr int kRefillMin = 28;
// lanes per activity flag of B2: a multiple of kWarp, so that a claim of
// kWarp aligned lanes lies inside one flag block
constexpr int kSkipBlock = 256;
static_assert(kSkipBlock % kWarp == 0, "a claim must not straddle two flags");

// blocks of kThreads an SM must hold at once: f32 at <= 64 registers
// (50% occupancy), f64 at <= 128
template <typename T> struct Occupancy;
template <> struct Occupancy<float> { static constexpr int kMinBlocks = 4; };
template <> struct Occupancy<double> { static constexpr int kMinBlocks = 2; };

// one segment's inputs, with the lane invariants computed once
template <typename T> struct Lane {
  T qup, quc, qdp, ql, dx, bw, twcc, n, ncc, s0, z, bfd, dt;
  T sqrt_s0, sqz, ks_n, ks_ncc;  // sqrt(s0), sqrt(1+z*z), sqrt(s0)/n, sqrt(s0)/ncc
};

template <typename T> struct Geometry {
  T twl, h_lt, h_gt, area, areac, wp, wpc, r;
};

template <typename T>
__device__ __forceinline__ Geometry<T> hydraulic_geometry(T h, const Lane<T>& L) {
  using M = Math<T>;
  Geometry<T> g;
  g.twl = L.bw + T(2.0) * L.z * h;
  g.h_gt = mx(h - L.bfd, T(0.0));
  g.h_lt = mn(L.bfd, h);
  if (g.h_gt > T(0.0) && L.twcc <= T(0.0)) {  // NWM 3.0: trapezoid extends up
    g.h_gt = T(0.0);
    g.h_lt = h;
  }
  g.area = (L.bw + g.h_lt * L.z) * g.h_lt;
  g.wp = L.bw + T(2.0) * g.h_lt * L.sqz;
  g.areac = L.twcc * g.h_gt;
  g.wpc = g.h_gt > T(0.0) ? L.twcc + T(2.0) * g.h_gt : T(0.0);
  g.r = (g.area + g.areac) / mx(g.wp + g.wpc, M::tiny());
  return g;
}

// The parts of a residual evaluation at depth h that do not depend on the
// other evaluation of the same trip: geometry, r^(2/3), the kinematic
// celerity (reference .f90:248-268) and the Muskingum K.
template <typename T> struct Point {
  Geometry<T> g;
  T r23, ck, km;
};

template <typename T>
__device__ __forceinline__ bool overbank(T h, const Lane<T>& L) {
  return h > L.bfd && L.twcc > T(0.0) && L.ncc > T(0.0);
}

// A trip's two points (h_0 and h), computed side by side so that their
// dependent chains of pow, sqrt and divides interleave.  The channel
// celerity takes the bankfull depth above bankfull, as the reference's two
// branches do; only the floodplain term stays a branch.
template <typename T>
__device__ __forceinline__ void points(T ha, T hb, const Lane<T>& L, Point<T>& a,
                                       Point<T>& b) {
  using M = Math<T>;
  const T p23 = T(2.0 / 3.0), p53 = T(5.0 / 3.0), tiny = M::tiny();
  a.g = hydraulic_geometry(ha, L);
  b.g = hydraulic_geometry(hb, L);
  a.r23 = M::pw(a.g.r, p23);
  b.r23 = M::pw(b.g.r, p23);
  const T r53a = M::pw(a.g.r, p53);
  const T r53b = M::pw(b.g.r, p53);
  const bool ova = overbank(ha, L), ovb = overbank(hb, L);
  const T da = L.bw + T(2.0) * (ova ? L.bfd : ha) * L.z;
  const T db = L.bw + T(2.0) * (ovb ? L.bfd : hb) * L.z;
  T cka = L.ks_n * (p53 * a.r23 - p23 * r53a * (T(2.0) * L.sqz / mx(da, tiny)));
  T ckb = L.ks_n * (p53 * b.r23 - p23 * r53b * (T(2.0) * L.sqz / mx(db, tiny)));
  if (ova) {
    const T fp = L.ks_ncc * p53 * M::pw(mx(ha - L.bfd, T(0.0)), p23);
    cka = (cka * a.g.area + fp * a.g.areac) / mx(a.g.area + a.g.areac, tiny);
  } else if (!(ha > T(0.0))) {
    cka = T(0.0);
  }
  if (ovb) {
    const T fp = L.ks_ncc * p53 * M::pw(mx(hb - L.bfd, T(0.0)), p23);
    ckb = (ckb * b.g.area + fp * b.g.areac) / mx(b.g.area + b.g.areac, tiny);
  } else if (!(hb > T(0.0))) {
    ckb = T(0.0);
  }
  a.ck = mx(cka, T(0.0));
  b.ck = mx(ckb, T(0.0));
  a.km = a.ck > T(0.0) ? mx(L.dt, L.dx / mx(a.ck, tiny)) : L.dt;
  b.km = b.ck > T(0.0) ? mx(L.dt, L.dx / mx(b.ck, tiny)) : L.dt;
}

template <typename T> struct Secant {
  T qj, c1, c2, c3, c4, x;
};

// one residual evaluation (reference secant2_h, .f90:198-334) at the point
// p of depth h.  Interval 1 reads the aliased Qj slot `qj_in` in its X
// formula; interval 2 reads the C1..C4 of the interval-1 call and applies
// the channel-loss clamp.
template <typename T, int kInterval>
__device__ __forceinline__ Secant<T> secant2_h(T h, const Point<T>& p, T qj_in,
                                               const Secant<T>& cin, const Lane<T>& L) {
  using M = Math<T>;
  const T tiny = M::tiny();
  const Geometry<T>& g = p.g;
  const T r23 = p.r23, ck = p.ck, km = p.km;

  T numer, lo;
  if (kInterval == 1) {
    numer = qj_in;
    lo = T(0.0);
  } else {
    numer = cin.c1 * L.qup + cin.c2 * L.quc + cin.c3 * L.qdp + cin.c4;
    lo = T(0.25);
  }
  Secant<T> s;
  if (ck > T(0.0)) {
    const T width = overbank(h, L) ? L.twcc : g.twl;
    const T denom = T(2.0) * width * L.s0 * ck * L.dx;
    const T x_formula = T(0.5) * (T(1.0) - numer / (denom != T(0.0) ? denom : T(1.0)));
    s.x = mn(mx(x_formula, lo), T(0.5));
  } else {
    s.x = T(0.5);
  }
  const T half_dt = L.dt / T(2.0);
  const T d = km * (T(1.0) - s.x) + half_dt;
  const T safe_d = d != T(0.0) ? d : T(1.0);
  s.c1 = (km * s.x + half_dt) / safe_d;
  s.c2 = (half_dt - km * s.x) / safe_d;
  s.c3 = (km * (T(1.0) - s.x) - half_dt) / safe_d;
  s.c4 = (L.ql * L.dt) / safe_d;
  if (kInterval == 2) {
    const T base = s.c1 * L.qup + s.c2 * L.quc + s.c3 * L.qdp;
    if (s.c4 < T(0.0) && M::ab(s.c4) > base) s.c4 = -base;
  }
  const T wp_tot = g.wp + g.wpc;
  if (wp_tot > T(0.0)) {
    const T n_eff = (g.wp * L.n + g.wpc * L.ncc) / mx(wp_tot, tiny);
    const T q_manning = (T(1.0) / mx(n_eff, tiny)) * (g.area + g.areac) * r23 * L.sqrt_s0;
    s.qj = (s.c1 * L.qup + s.c2 * L.quc + s.c3 * L.qdp + s.c4) - q_manning;
  } else {
    s.qj = T(0.0);
  }
  return s;
}

template <typename T> struct Inputs {
  const T* __restrict__ qup; const T* __restrict__ quc; const T* __restrict__ qdp;
  const T* __restrict__ ql; const T* __restrict__ dx; const T* __restrict__ bw;
  const T* __restrict__ tw; const T* __restrict__ twcc; const T* __restrict__ n;
  const T* __restrict__ ncc; const T* __restrict__ cs; const T* __restrict__ s0;
  const T* __restrict__ depthp;
};

template <typename T> struct Outputs {
  T* __restrict__ qdc; T* __restrict__ velc; T* __restrict__ depthc;
  T* __restrict__ ck; T* __restrict__ cn; T* __restrict__ x;  // null: skip
  int32_t* __restrict__ trips;                                 // null: skip
  int32_t* __restrict__ evals;                                 // null: skip
};

template <typename T> struct Prev {  // a previous call's outputs, in their order
  const T* __restrict__ qdc; const T* __restrict__ velc; const T* __restrict__ depthc;
  const T* __restrict__ ck; const T* __restrict__ cn; const T* __restrict__ x;
};

// one segment in flight: its inputs and the secant loop's variables
template <typename T> struct State {
  Lane<T> L;
  T h, h_0, qj0_slot, rerror, aerror;
  Secant<T> c;
  int it, maxiter, tries, trips, evals;
  bool active, has_flow;
};

template <typename T>
__device__ __forceinline__ State<T> init_lane(const Inputs<T>& in, T dt, int64_t i) {
  using M = Math<T>;
  const T mindepth = T(0.01);
  State<T> s;
  Lane<T>& L = s.L;
  L.qup = in.qup[i]; L.quc = in.quc[i]; L.qdp = in.qdp[i]; L.ql = in.ql[i];
  L.dx = in.dx[i]; L.bw = in.bw[i]; L.twcc = in.twcc[i]; L.n = in.n[i];
  L.ncc = in.ncc[i]; L.s0 = in.s0[i]; L.dt = dt;
  const T tw = in.tw[i], cs = in.cs[i], depthp = in.depthp[i];
  L.z = cs == T(0.0) ? T(1.0) : T(1.0) / cs;
  L.bfd = L.bw > tw ? L.bw / T(0.00001)
        : (L.bw == tw ? L.bw / (T(2.0) * L.z) : (tw - L.bw) / (T(2.0) * L.z));
  L.sqrt_s0 = M::sq(L.s0);
  L.sqz = M::sq(T(1.0) + L.z * L.z);
  L.ks_n = L.sqrt_s0 / L.n;
  L.ks_ncc = L.sqrt_s0 / L.ncc;

  const T depthc0 = mx(depthp, T(0.0));
  s.h = depthc0 * T(1.33) + mindepth;
  s.h_0 = depthc0 * T(0.67);
  s.has_flow = L.ql > T(0.0) || L.qup > T(0.0) || L.quc > T(0.0) || L.qdp > T(0.0);
  s.c = {T(0.0), T(0.0), T(0.0), T(0.0), T(0.0), T(0.0)};
  s.qj0_slot = T(0.0);
  s.rerror = T(1.0);
  s.aerror = mindepth;
  s.it = 0;
  s.maxiter = kMaxiterInit;
  s.tries = 0;
  s.trips = 0;
  s.evals = 0;
  s.active = s.has_flow;
  return s;
}

// the residual evaluation of a pass whose top check passed: the two
// points, the secant update and the errors
template <typename T>
__device__ __forceinline__ void evaluate(State<T>& s) {
  using M = Math<T>;
  Point<T> pa, pb;
  points(s.h_0, s.h, s.L, pa, pb);
  const Secant<T> s1 = secant2_h<T, 1>(s.h_0, pa, s.qj0_slot, s.c, s.L);
  const Secant<T> s2 = secant2_h<T, 2>(s.h, pb, T(0.0), s1, s.L);
  const T diff = s1.qj - s2.qj;
  T h_1 = diff != T(0.0) ? s.h - (s2.qj * (s.h_0 - s.h)) / diff : s.h;
  if (h_1 < T(0.0)) h_1 = s.h;
  if (s.h > T(0.0)) {
    s.rerror = M::ab((h_1 - s.h) / s.h);
    s.aerror = M::ab(h_1 - s.h);
  } else {
    s.rerror = T(0.0);
    s.aerror = T(0.9);
  }
  s.h_0 = mx(s.h, T(0.0));
  s.h = mx(h_1, T(0.0));
  s.qj0_slot = s1.qj;
  s.c = s2;
  s.it += 1;
}

// one pass of the secant loop of an active lane
template <typename T>
__device__ __forceinline__ void trip(State<T>& s) {
  const T mindepth = T(0.01);
  s.trips += 1;
  // top-of-loop check (reference do-while condition, .f90:83)
  const bool run = s.rerror > T(0.01) && s.aerror >= mindepth && s.it <= s.maxiter;
  if (run) {
    s.evals += 1;
    evaluate(s);
  }
  // label 111: the loop ended at the top check or the small-depth break
  // (.f90:120-122); retry with a wider search space
  const bool at_111 = !run || s.h < mindepth;
  if (!at_111) return;
  if (s.it >= s.maxiter) {
    s.tries += 1;
    if (s.tries <= kMaxTries) {
      s.h = s.h * T(1.33);
      s.h_0 = s.h_0 * T(0.67);
      s.maxiter += 25;
      s.it = 0;
      return;
    }
  }
  s.active = false;
}

// outputs of a lane whose loop has ended, stored at lane i
template <typename T>
__device__ __forceinline__ void finish_lane(const State<T>& s, const Outputs<T>& out, int64_t i) {
  using M = Math<T>;
  const T p23 = T(2.0 / 3.0), p53 = T(5.0 / 3.0);
  const Lane<T>& L = s.L;
  const Secant<T>& c = s.c;
  const T h = s.h;
  if (out.trips != nullptr) out.trips[i] = s.trips;
  if (out.evals != nullptr) out.evals[i] = s.evals;

  // final discharge (reference .f90:149-161)
  const T base = c.c1 * L.qup + c.c2 * L.quc + c.c3 * L.qdp;
  const T qmc = base + c.c4;
  T qdc = qmc;
  if (qmc < T(0.0)) {
    if (c.c4 < T(0.0) && M::ab(c.c4) > base) {
      qdc = T(0.0);
    } else {
      qdc = mx(c.c1 * L.qup + c.c2 * L.quc + c.c4, c.c1 * L.qup + c.c3 * L.qdp + c.c4);
    }
  }
  // velocity from the legacy hydraulic-radius formula (.f90:163-169)
  const T twl = L.bw + T(2.0) * L.z * h;
  const T half_top = (twl - L.bw) / T(2.0);
  const T r_leg = (h * (L.bw + twl) / T(2.0)) /
                  (L.bw + T(2.0) * M::sq(half_top * half_top + h * h));
  const T velc = (T(1.0) / L.n) * M::pw(r_leg, p23) * L.sqrt_s0;

  out.qdc[i] = s.has_flow ? qdc : T(0.0);
  out.velc[i] = s.has_flow ? velc : T(0.0);
  out.depthc[i] = s.has_flow ? h : T(0.0);
  if (out.ck == nullptr) return;

  // Courant diagnostics, always from the final h (.f90:183,342-367)
  const Geometry<T> g = hydraulic_geometry(h, L);
  const T denom_lt = L.bw + T(2.0) * g.h_lt * L.z;
  const T ck_ch = L.ks_n *
      (p53 * M::pw(g.r, p23) -
       p23 * M::pw(g.r, p53) * (T(2.0) * L.sqz / mx(denom_lt, M::tiny())));
  // sqrt(s0) / 1 is sqrt(s0) exactly
  const T ck_fp = (L.ncc > T(0.0) ? L.ks_ncc : L.sqrt_s0) * p53 * M::pw(g.h_gt, p23);
  const T area_tot = g.area + g.areac;
  T ck = area_tot > T(0.0) ? (ck_ch * g.area + ck_fp * g.areac) / mx(area_tot, M::tiny())
                           : T(0.0);
  ck = mx(ck, T(0.0));
  out.ck[i] = ck;
  out.cn[i] = ck * (L.dt / L.dx);
  out.x[i] = s.has_flow ? c.x : T(0.0);
}

// lane i of a skipped block: the previous call's outputs, unchanged
template <typename T>
__device__ __forceinline__ void copy_through(const Prev<T>& prev, const Outputs<T>& out,
                                             int64_t i) {
  out.qdc[i] = prev.qdc[i];
  out.velc[i] = prev.velc[i];
  out.depthc[i] = prev.depthc[i];
  if (out.ck == nullptr) return;
  out.ck[i] = prev.ck[i];
  out.cn[i] = prev.cn[i];
  out.x[i] = prev.x[i];
}

// The loop of B1 and B2: a persistent grid whose lanes refill from a work
// counter (see the note at the top).  `next` holds 0 at launch; nseg <
// 2^31 - 2^24.  A lane whose loop has ended keeps its state until the warp
// refills, which it does once at least kRefillMin of its lanes are idle
// (or all are): the stores of the finished lanes and the loads of the new
// ones then run together, once per refill and not once per lane.  With
// kSkip, a claim whose flag `active[base / kSkipBlock]` is 0 is copied
// through from `prev` by the whole warp and never enters the state
// machine; the warp then claims again, so a warp that meets only such
// claims still reaches the exit test once the counter is past nseg.
template <typename T, bool kSkip>
__device__ __forceinline__ void persistent_solve(const Inputs<T>& in, T dt,
                                                 const Outputs<T>& out,
                                                 const Prev<T>& prev,
                                                 const int32_t* __restrict__ active,
                                                 int32_t* __restrict__ next,
                                                 int32_t nseg) {
  const int lane = threadIdx.x % kWarp;
  const unsigned below = (1u << lane) - 1u;
  State<T> s;
  s.active = false;
  bool held = false;                // this lane holds segment i
  int32_t i = 0;
  int32_t w_next = 0, w_end = 0;    // the warp's unclaimed range [w_next, w_end)
  bool open = true;                 // the counter is not yet past nseg
  while (true) {
    // control outside `if (s.active)` is uniform across the warp
    const int n_idle = __popc(__ballot_sync(kFullMask, !s.active));
    if (n_idle >= kRefillMin || n_idle == kWarp) {
      if (held && !s.active) {
        finish_lane(s, out, static_cast<int64_t>(i));
        held = false;
      }
      while (open) {
        const unsigned idle = __ballot_sync(kFullMask, !held);
        if (idle == 0u) break;
        if (w_next == w_end) {
          int32_t base = 0;
          if (lane == 0) base = atomicAdd(next, kWarp);
          base = __shfl_sync(kFullMask, base, 0);
          if (base >= nseg) {
            open = false;
            break;
          }
          if (kSkip && active[base / kSkipBlock] == 0) {
            // the claim's tail past nseg, when nseg is no multiple of
            // kWarp, is left alone
            const int32_t j = base + lane;
            if (j < nseg) copy_through(prev, out, static_cast<int64_t>(j));
            continue;
          }
          w_next = base;
          w_end = min(base + kWarp, nseg);
        }
        const int take = min(__popc(idle), w_end - w_next);
        const int rank = __popc(idle & below);
        if (!held && rank < take) {
          i = w_next + rank;
          s = init_lane(in, dt, static_cast<int64_t>(i));
          if (s.active) {
            held = true;
          } else {
            finish_lane(s, out, static_cast<int64_t>(i));  // no flow: 0 trips
          }
        }
        w_next += take;
      }
      if (__ballot_sync(kFullMask, held) == 0u) return;
    }
    if (s.active) trip(s);
  }
}

// B1: every lane is solved
template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
mc_secant_kernel(Inputs<T> in, T dt, Outputs<T> out, int32_t* __restrict__ next,
                 int32_t nseg) {
  persistent_solve<T, false>(in, dt, out, Prev<T>{}, nullptr, next, nseg);
}

// B2: flag block b (kSkipBlock lanes) is solved when active[b] != 0, else
// its lanes of `prev` are copied through
template <typename T>
__global__ void __launch_bounds__(kThreads, Occupancy<T>::kMinBlocks)
mc_secant_skip_kernel(Inputs<T> in, T dt, Outputs<T> out, Prev<T> prev,
                      const int32_t* __restrict__ active,
                      int32_t* __restrict__ next, int32_t nseg) {
  persistent_solve<T, true>(in, dt, out, prev, active, next, nseg);
}

#ifdef MC_SECANT_PROBES
// Two kernels whose SASS differ by one in-bank residual evaluation: each
// copies a lane's loop state from `in` to `out` (loaded from memory, so
// nothing folds), and probe_eval1 runs `evaluate` on it in between with
// ncc = 0, which makes `overbank` false at compile time, so that only the
// in-bank code of an evaluation is left.
template <typename T>
__global__ void probe_eval0(const State<T>* in, State<T>* out) {
  out[threadIdx.x] = in[threadIdx.x];
}

template <typename T>
__global__ void probe_eval1(const State<T>* in, State<T>* out) {
  State<T> s = in[threadIdx.x];
  s.L.ncc = T(0.0);
  evaluate(s);
  out[threadIdx.x] = s;
}

#endif

// resident blocks of B1 (kSkip false) or B2 on the current device:
// occupancy x SMs, queried once per device, dtype and kernel
template <typename T, bool kSkip>
int resident_blocks(int* err) {
  constexpr int kMaxDevices = 64;
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  *err = static_cast<int>(cudaGetDevice(&dev));
  if (*err != 0) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int per_sm = 0, sms = 0;
  if (kSkip) {
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_secant_skip_kernel<T>, kThreads, 0));
  } else {
    *err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mc_secant_kernel<T>, kThreads, 0));
  }
  if (*err == 0)
    *err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (*err != 0) return 0;
  const int blocks = per_sm * sms;
  if (dev < kMaxDevices) cache[dev] = blocks;
  return blocks;
}

// B1 when `active` is null, else B2 with `prev` and the flags
template <typename T>
int launch(const Inputs<T>& in, T dt, const Outputs<T>& out, const Prev<T>& prev,
           const int32_t* active, int32_t* next, int64_t nseg, void* stream) {
  // the counter runs past nseg by at most 32 per warp of the grid
  if (nseg < 0 || nseg > (int64_t{1} << 31) - (int64_t{1} << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  const int resident = active == nullptr ? resident_blocks<T, false>(&err)
                                         : resident_blocks<T, true>(&err);
  if (err != 0) return err;
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t needed = (nseg + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(needed < resident ? needed : resident);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t n = static_cast<int32_t>(nseg);
  if (active == nullptr) {
    mc_secant_kernel<T><<<blocks, kThreads, 0, st>>>(in, dt, out, next, n);
  } else {
    mc_secant_skip_kernel<T><<<blocks, kThreads, 0, st>>>(in, dt, out, prev, active, next, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define MC_INPUT_PARAMS(T)                                                        \
  const T *qup, const T *quc, const T *qdp, const T *ql, const T *dx, const T *bw, \
      const T *tw, const T *twcc, const T *n, const T *ncc, const T *cs,           \
      const T *s0, const T *depthp, T dt, T *qdc, T *velc, T *depthc, T *ck,       \
      T *cn, T *x
#define MC_INPUTS(T) \
  Inputs<T> { qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp }
#define MC_OUTPUTS(T) \
  Outputs<T> { qdc, velc, depthc, ck, cn, x, trips, evals }

#define MC_SECANT_ENTRY(NAME, T)                                                  \
  int NAME(MC_INPUT_PARAMS(T), int32_t* trips, int32_t* evals, int32_t* next,     \
           int64_t nseg, void* stream) {                                          \
    return launch<T>(MC_INPUTS(T), dt, MC_OUTPUTS(T), Prev<T>{}, nullptr, next,   \
                     nseg, stream);                                               \
  }

// a null `active` would select B1, so it is refused here
#define MC_SECANT_SKIP_ENTRY(NAME, T)                                             \
  int NAME(MC_INPUT_PARAMS(T), const T* p_qdc, const T* p_velc, const T* p_depthc, \
           const T* p_ck, const T* p_cn, const T* p_x, const int32_t* active,     \
           int32_t* trips, int32_t* evals, int32_t* next, int64_t nseg,           \
           void* stream) {                                                        \
    if (active == nullptr) return static_cast<int>(cudaErrorInvalidValue);        \
    return launch<T>(MC_INPUTS(T), dt, MC_OUTPUTS(T),                             \
                     Prev<T>{p_qdc, p_velc, p_depthc, p_ck, p_cn, p_x}, active,   \
                     next, nseg, stream);                                         \
  }

MC_SECANT_ENTRY(mc_secant_f32, float)
MC_SECANT_ENTRY(mc_secant_f64, double)
MC_SECANT_SKIP_ENTRY(mc_secant_skip_f32, float)
MC_SECANT_SKIP_ENTRY(mc_secant_skip_f64, double)

#ifdef MC_SECANT_PROBES
// taking their addresses keeps the probe kernels in the library
const void* mc_secant_probes[2] = {reinterpret_cast<const void*>(probe_eval0<float>),
                                   reinterpret_cast<const void*>(probe_eval1<float>)};
#endif

}  // extern "C"
