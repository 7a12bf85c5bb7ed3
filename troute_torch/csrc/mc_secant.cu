// Muskingum-Cunge secant solve, one CUDA thread per river segment.
//
// Replaces the TPU kernel `_mc_block_kernel` of
// troute_tpu/ops/muskingum_pallas.py (launched by `_mc_pallas_padded`),
// which runs the masked `solve_block` loop of troute_tpu/ops/muskingum.py
// on (16, 128)-lane VMEM blocks and exits a block when all of its lanes
// have converged.  Here each thread runs the reference's scalar control
// flow (MCsingleSegStime_f2py_NOLOOP.f90:8-186, readable as
// tests/reference_impl.py:muskingum_cunge_ref) for its own segment, so a
// lane stops as soon as it converges; the warp is the real granularity of
// the early exit.  Each operation is written in the order of the plain
// version (troute_torch/ops/muskingum.py) so that the two agree lane for
// lane: the build passes --fmad=false and no fast-math flag, pow/powf
// give x^(2/3) and x^(5/3), and FLT_MIN/DBL_MIN stand for `tiny`.
//
// What bounds it on an H100: per lane it reads 13 values and writes 3
// (6 with the diagnostics), 64 (f32) to 152 (f64) bytes, against 2..~750
// secant trips of two residual evaluations each, every one with
// pow/sqrt/divides.  A typical lane converges in a few trips, so at
// network scale the kernel is bound by the transcendental throughput of
// the slowest lanes in each warp (divergence: a warp runs until its
// slowest lane is done), not by memory traffic.  This first version is the
// plain one-thread-per-lane design: no compaction of stragglers, no
// shared memory.
//
// Kernel B2, `mc_secant_skip_kernel`, replaces `_mc_block_kernel_skip` of
// the same Pallas file (launched by `_mc_pallas_padded_skip`), the
// active-set form used by strict fixed-point sweeps: a block whose int32
// activity flag is 0 copies the previous call's outputs through instead of
// solving.  Here a flag covers one CUDA block of kThreads (256) lanes, so
// the branch is uniform per block; an active block runs the same
// `solve_lane` as B1, so the two kernels cannot drift apart.  `prev` comes
// in the order of the outputs (qdc, velc, depthc, ck, cn, x); the TPU
// wrapper hands it over with ck and cn swapped (muskingum_pallas.py:172-173),
// which the port does not copy.  An inactive block moves 3 or 6 values per
// lane and no more, so a sweep with few active blocks is bound by those
// copies and by the active blocks' slowest warps.
//
// C interface (loaded with ctypes): mc_secant_f32 / mc_secant_f64 take the
// 13 input pointers, dt, the 6 output pointers (ck, cn, x may be null to
// skip the diagnostics), the lane count and the CUDA stream, launch on that
// stream and return cudaGetLastError().  mc_secant_skip_f32 / _f64 take, after
// the outputs, the 6 `prev` pointers (the last 3 null with the outputs') and
// the [ceil(nseg / 256)] int32 flags.

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

template <typename T> struct Lane {
  T qup, quc, qdp, ql, dx, bw, twcc, n, ncc, s0, z, bfd, dt;
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
  g.wp = L.bw + T(2.0) * g.h_lt * M::sq(T(1.0) + L.z * L.z);
  g.areac = L.twcc * g.h_gt;
  g.wpc = g.h_gt > T(0.0) ? L.twcc + T(2.0) * g.h_gt : T(0.0);
  g.r = (g.area + g.areac) / mx(g.wp + g.wpc, M::tiny());
  return g;
}

// kinematic celerity (reference .f90:248-268)
template <typename T>
__device__ __forceinline__ T celerity(const Geometry<T>& g, T h, const Lane<T>& L) {
  using M = Math<T>;
  const T p23 = T(2.0 / 3.0), p53 = T(5.0 / 3.0);
  const T sqrt_s0 = M::sq(L.s0);
  const T r23 = M::pw(g.r, p23), r53 = M::pw(g.r, p53);
  const T sqz = M::sq(T(1.0) + L.z * L.z);
  T ck;
  if (h > L.bfd && L.twcc > T(0.0) && L.ncc > T(0.0)) {
    const T denom_bf = L.bw + T(2.0) * L.bfd * L.z;
    const T ck_bf = (sqrt_s0 / L.n) *
        (p53 * r23 - p23 * r53 * (T(2.0) * sqz / mx(denom_bf, M::tiny())));
    const T ck_fp = (sqrt_s0 / L.ncc) * p53 * M::pw(mx(h - L.bfd, T(0.0)), p23);
    ck = (ck_bf * g.area + ck_fp * g.areac) / mx(g.area + g.areac, M::tiny());
  } else if (h > T(0.0)) {
    const T denom_ch = L.bw + T(2.0) * h * L.z;
    ck = (sqrt_s0 / L.n) *
        (p53 * r23 - p23 * r53 * (T(2.0) * sqz / mx(denom_ch, M::tiny())));
  } else {
    ck = T(0.0);
  }
  return mx(ck, T(0.0));
}

template <typename T> struct Secant {
  T qj, c1, c2, c3, c4, x;
};

// one residual evaluation (reference secant2_h, .f90:198-334).  Interval 1
// reads the aliased Qj slot `qj_in` in its X formula; interval 2 reads the
// C1..C4 of the interval-1 call and applies the channel-loss clamp.
template <typename T, int kInterval>
__device__ __forceinline__ Secant<T> secant2_h(T h, T qj_in, const Secant<T>& cin,
                                               const Lane<T>& L) {
  using M = Math<T>;
  const T tiny = M::tiny();
  const Geometry<T> g = hydraulic_geometry(h, L);
  const T ck = celerity(g, h, L);
  const T km = ck > T(0.0) ? mx(L.dt, L.dx / mx(ck, tiny)) : L.dt;

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
    const bool overbank = h > L.bfd && L.twcc > T(0.0) && L.ncc > T(0.0);
    const T width = overbank ? L.twcc : g.twl;
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
    const T q_manning = (T(1.0) / mx(n_eff, tiny)) * (g.area + g.areac) *
                        M::pw(g.r, T(2.0 / 3.0)) * M::sq(L.s0);
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
};

template <typename T> struct Prev {  // a previous call's outputs, in their order
  const T* __restrict__ qdc; const T* __restrict__ velc; const T* __restrict__ depthc;
  const T* __restrict__ ck; const T* __restrict__ cn; const T* __restrict__ x;
};

// the whole solve of lane i, shared by both kernels so they cannot drift
template <typename T>
__device__ __forceinline__ void solve_lane(const Inputs<T>& in, T dt, const Outputs<T>& out,
                                           int64_t i) {
  using M = Math<T>;
  const T mindepth = T(0.01);
  const T p23 = T(2.0 / 3.0), p53 = T(5.0 / 3.0);

  Lane<T> L;
  L.qup = in.qup[i]; L.quc = in.quc[i]; L.qdp = in.qdp[i]; L.ql = in.ql[i];
  L.dx = in.dx[i]; L.bw = in.bw[i]; L.twcc = in.twcc[i]; L.n = in.n[i];
  L.ncc = in.ncc[i]; L.s0 = in.s0[i]; L.dt = dt;
  const T tw = in.tw[i], cs = in.cs[i], depthp = in.depthp[i];
  L.z = cs == T(0.0) ? T(1.0) : T(1.0) / cs;
  L.bfd = L.bw > tw ? L.bw / T(0.00001)
        : (L.bw == tw ? L.bw / (T(2.0) * L.z) : (tw - L.bw) / (T(2.0) * L.z));

  const T depthc0 = mx(depthp, T(0.0));
  T h = depthc0 * T(1.33) + mindepth;
  T h_0 = depthc0 * T(0.67);
  const bool has_flow = L.ql > T(0.0) || L.qup > T(0.0) || L.quc > T(0.0) || L.qdp > T(0.0);

  Secant<T> c = {T(0.0), T(0.0), T(0.0), T(0.0), T(0.0), T(0.0)};
  T qj0_slot = T(0.0);
  T rerror = T(1.0), aerror = mindepth;
  int it = 0, maxiter = kMaxiterInit, tries = 0;
  bool active = has_flow;

  while (active) {
    // top-of-loop check (reference do-while condition, .f90:83)
    const bool run = rerror > T(0.01) && aerror >= mindepth && it <= maxiter;
    if (run) {
      const Secant<T> s1 = secant2_h<T, 1>(h_0, qj0_slot, c, L);
      const Secant<T> s2 = secant2_h<T, 2>(h, T(0.0), s1, L);
      const T diff = s1.qj - s2.qj;
      T h_1 = diff != T(0.0) ? h - (s2.qj * (h_0 - h)) / diff : h;
      if (h_1 < T(0.0)) h_1 = h;
      if (h > T(0.0)) {
        rerror = M::ab((h_1 - h) / h);
        aerror = M::ab(h_1 - h);
      } else {
        rerror = T(0.0);
        aerror = T(0.9);
      }
      h_0 = mx(h, T(0.0));
      h = mx(h_1, T(0.0));
      qj0_slot = s1.qj;
      c = s2;
      it += 1;
    }
    // label 111: the loop ended at the top check or the small-depth break
    // (.f90:120-122); retry with a wider search space
    const bool at_111 = !run || h < mindepth;
    if (!at_111) continue;
    if (it >= maxiter) {
      tries += 1;
      if (tries <= kMaxTries) {
        h = h * T(1.33);
        h_0 = h_0 * T(0.67);
        maxiter += 25;
        it = 0;
        continue;
      }
    }
    active = false;
  }

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
  const T velc = (T(1.0) / L.n) * M::pw(r_leg, p23) * M::sq(L.s0);

  out.qdc[i] = has_flow ? qdc : T(0.0);
  out.velc[i] = has_flow ? velc : T(0.0);
  out.depthc[i] = has_flow ? h : T(0.0);
  if (out.ck == nullptr) return;

  // Courant diagnostics, always from the final h (.f90:183,342-367)
  const Geometry<T> g = hydraulic_geometry(h, L);
  const T sqrt_s0 = M::sq(L.s0);
  const T denom_lt = L.bw + T(2.0) * g.h_lt * L.z;
  const T ck_ch = (sqrt_s0 / L.n) *
      (p53 * M::pw(g.r, p23) -
       p23 * M::pw(g.r, p53) * (T(2.0) * M::sq(T(1.0) + L.z * L.z) / mx(denom_lt, M::tiny())));
  const T safe_ncc = L.ncc > T(0.0) ? L.ncc : T(1.0);
  const T ck_fp = (sqrt_s0 / safe_ncc) * p53 * M::pw(g.h_gt, p23);
  const T area_tot = g.area + g.areac;
  T ck = area_tot > T(0.0) ? (ck_ch * g.area + ck_fp * g.areac) / mx(area_tot, M::tiny())
                           : T(0.0);
  ck = mx(ck, T(0.0));
  out.ck[i] = ck;
  out.cn[i] = ck * (dt / L.dx);
  out.x[i] = has_flow ? c.x : T(0.0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mc_secant_kernel(Inputs<T> in, T dt, Outputs<T> out, int64_t nseg) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nseg) return;
  solve_lane(in, dt, out, i);
}

// Block-skip variant: block b solves its lanes when active[b] != 0, else
// copies its lanes of `prev` (same order as the outputs) through.  One flag
// per CUDA block, so the branch is uniform across the block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mc_secant_skip_kernel(Inputs<T> in, T dt, Outputs<T> out, Prev<T> prev,
                      const int32_t* __restrict__ active, int64_t nseg) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nseg) return;
  if (active[blockIdx.x] != 0) {
    solve_lane(in, dt, out, i);
    return;
  }
  out.qdc[i] = prev.qdc[i];
  out.velc[i] = prev.velc[i];
  out.depthc[i] = prev.depthc[i];
  if (out.ck == nullptr) return;
  out.ck[i] = prev.ck[i];
  out.cn[i] = prev.cn[i];
  out.x[i] = prev.x[i];
}

template <typename T>
int launch(const T* qup, const T* quc, const T* qdp, const T* ql, const T* dx,
           const T* bw, const T* tw, const T* twcc, const T* n, const T* ncc,
           const T* cs, const T* s0, const T* depthp, T dt, T* qdc, T* velc,
           T* depthc, T* ck, T* cn, T* x, int64_t nseg, void* stream) {
  Inputs<T> in = {qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp};
  Outputs<T> out = {qdc, velc, depthc, ck, cn, x};
  const int64_t blocks = (nseg + kThreads - 1) / kThreads;
  mc_secant_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(in, dt, out, nseg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_skip(const T* qup, const T* quc, const T* qdp, const T* ql, const T* dx,
                const T* bw, const T* tw, const T* twcc, const T* n, const T* ncc,
                const T* cs, const T* s0, const T* depthp, T dt, T* qdc, T* velc,
                T* depthc, T* ck, T* cn, T* x, const T* p_qdc, const T* p_velc,
                const T* p_depthc, const T* p_ck, const T* p_cn, const T* p_x,
                const int32_t* active, int64_t nseg, void* stream) {
  Inputs<T> in = {qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp};
  Outputs<T> out = {qdc, velc, depthc, ck, cn, x};
  Prev<T> prev = {p_qdc, p_velc, p_depthc, p_ck, p_cn, p_x};
  const int64_t blocks = (nseg + kThreads - 1) / kThreads;
  mc_secant_skip_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(in, dt, out, prev,
                                                                  active, nseg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mc_secant_f32(const float* qup, const float* quc, const float* qdp, const float* ql,
                  const float* dx, const float* bw, const float* tw, const float* twcc,
                  const float* n, const float* ncc, const float* cs, const float* s0,
                  const float* depthp, float dt, float* qdc, float* velc, float* depthc,
                  float* ck, float* cn, float* x, int64_t nseg, void* stream) {
  return launch<float>(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp, dt,
                       qdc, velc, depthc, ck, cn, x, nseg, stream);
}

int mc_secant_f64(const double* qup, const double* quc, const double* qdp, const double* ql,
                  const double* dx, const double* bw, const double* tw, const double* twcc,
                  const double* n, const double* ncc, const double* cs, const double* s0,
                  const double* depthp, double dt, double* qdc, double* velc,
                  double* depthc, double* ck, double* cn, double* x, int64_t nseg,
                  void* stream) {
  return launch<double>(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp, dt,
                        qdc, velc, depthc, ck, cn, x, nseg, stream);
}

int mc_secant_skip_f32(const float* qup, const float* quc, const float* qdp, const float* ql,
                       const float* dx, const float* bw, const float* tw, const float* twcc,
                       const float* n, const float* ncc, const float* cs, const float* s0,
                       const float* depthp, float dt, float* qdc, float* velc, float* depthc,
                       float* ck, float* cn, float* x, const float* p_qdc,
                       const float* p_velc, const float* p_depthc, const float* p_ck,
                       const float* p_cn, const float* p_x, const int32_t* active,
                       int64_t nseg, void* stream) {
  return launch_skip<float>(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp, dt,
                            qdc, velc, depthc, ck, cn, x, p_qdc, p_velc, p_depthc, p_ck,
                            p_cn, p_x, active, nseg, stream);
}

int mc_secant_skip_f64(const double* qup, const double* quc, const double* qdp,
                       const double* ql, const double* dx, const double* bw, const double* tw,
                       const double* twcc, const double* n, const double* ncc,
                       const double* cs, const double* s0, const double* depthp, double dt,
                       double* qdc, double* velc, double* depthc, double* ck, double* cn,
                       double* x, const double* p_qdc, const double* p_velc,
                       const double* p_depthc, const double* p_ck, const double* p_cn,
                       const double* p_x, const int32_t* active, int64_t nseg,
                       void* stream) {
  return launch_skip<double>(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp,
                             dt, qdc, velc, depthc, ck, cn, x, p_qdc, p_velc, p_depthc,
                             p_ck, p_cn, p_x, active, nseg, stream);
}

}  // extern "C"
