// Level-pool reservoir step for every lake lane: kernel L1.
//
// It replaces no TPU kernel: the JAX package writes the step
// (troute_tpu/ops/levelpool.py:levelpool_step) as masked vector operations,
// which XLA fuses into one loop.  Run eagerly, the port's plain version
// (troute_torch/ops/levelpool.py) is ~144 element-wise launches a step, and
// the engine adds the lakes' inflow gather and two scatters: on a step of
// a few thousand lakes the host's dispatch of those launches, not the card,
// sets the time.  So the whole step is one launch, one thread per lake.
//
// What bounds it on an H100: per lake it reads 12-14 values and writes 2-3
// (at most ~130 bytes in f64) and evaluates the discharge four times (two
// pow and one sqrt each), so at 5,441 lakes it is a few microseconds of
// latency, one wave of 22 blocks; nothing here is worth more than being a
// single launch.
//
// Bits: the kernel is held to the plain version run on the same card, so
// every operation rounds on its own in the plain version's order (the
// build passes --fmad=false and no fast-math flag): (oc * oa) * sqrt(..),
// (tmp1 + tmp2) + over, powf/pow for `** 1.5`, fminf/fmaxf with the NaN
// tests of torch.minimum and torch.clamp_min, the scalars as the T values
// of the Python literals.  PyTorch divides a CUDA tensor by a Python scalar
// as a multiply by the scalar's reciprocal (rounded in T on the host), so
// `dh1 / 3.0` is dh1 * (T(1) / T(3)) here.
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
// C interface (loaded with ctypes): levelpool_f32 / levelpool_f64 take
// H, qi0, qi1, ql, the int64 rows, quc, the packed parameters, dt, the
// outputs outflow, h_new, inflow, q_into, d_into, the lake count, the node
// count and the CUDA stream; they launch on that stream and return
// cudaGetLastError().

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
  const T h = H[i];
  const T* pi = params + 9 * i;
  const Lake<T> k{pi[1], pi[2], pi[3], pi[4], pi[5], pi[6], pi[7], pi[8]};

  // ops/levelpool.py:levelpool_step, operation for operation
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
  const T hn = (h + dh1 * kQuarter) + T(0.75) * dh3;
  const T out = discharge(hn, hn, hn, k);

  h_new[i] = hn;
  if (outflow != nullptr) outflow[i] = out;
  if (q_into != nullptr) q_into[row] = out;
  if (d_into != nullptr) d_into[row] = hn;
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
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  levelpool_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      H, qi0, qi1, ql, rows, quc, params, dt, outflow, h_new, inflow, q_into, d_into, n, n_nodes);
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

}  // extern "C"
