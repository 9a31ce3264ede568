// Dense-Q Schur-condensed block-Thomas KKT sweep (kernel K3).
//
// Replaces algames_tpu/ops/thomas_pallas.py::solve_thomas_pallas
// (_make_fwd_kernel, _make_bwd_kernel, _reduced_solve(pivot=True)),
// homogeneous specs.
//
// The same sweep as K1 (thomas_sq.cu; the shared parts are in
// thomas_common.cuh), with the statx Hessian blocks given densely,
// Qblk [B, T, p, n, n]: collision-cost pairs make them full cross-player
// blocks, so B^T Q_owner, sum_i F_i Q_i and Q_i x are dense n x n products.
// The reduced system's columns are eliminated x first, as in K1 (the TPU
// kernel takes u first): see ColumnOrder in the header.
//
// What bounds it on the card: the latency of the dependent chain, as for
// K1.  At the 4-player roundabout's shapes (n=16, m=8, p=4, T=39: d=24,
// R=65) a lane reads Q (160 KB in f32, the largest input) and moves about
// 0.65 MB over both launches, and does about 6 MFLOP; the sweep is T knots
// of d pivot steps with a block barrier each.  The design keeps K1's: one
// 128-thread block per lane, the knot's Q blocks staged in shared memory
// next to the carry and the 24 x 89 augmented system (about 30 KB per block
// in f32 and 61 KB in f64, which opts in above the 48 KB default), so the
// dense products read shared memory and only G and y_hat go back to device
// memory for the backward launch.
#include "thomas_common.cuh"

namespace {

using thomas::Bwd;
using thomas::Fwd;
using thomas::kMaxM;
using thomas::kThreads;

struct DenseMeta {
  int owner[kMaxM];     // player owning control row r
};

template <typename T>
struct DenseForm {
  const T *Bs, *Q, *F;
  int n, m, p, pn;
  // (B^T Q_o)[r, cc] = sum_k B[k, r] Q_o[k, cc]
  __device__ T btq(int r, int o, int cc) const {
    const T* Qo = Q + o * n * n;
    T v = T(0);
    #pragma unroll 1
    for (int k = 0; k < n; ++k) v += Bs[k * m + r] * Qo[k * n + cc];
    return v;
  }
  // (sum_i F_i Q_i)[a, cc]
  __device__ T fq(int a, int cc) const {
    T v = T(0);
    for (int i = 0; i < p; ++i) {
      #pragma unroll 1
      for (int k = 0; k < n; ++k)
        v += F[a * pn + i * n + k] * Q[(i * n + k) * n + cc];
    }
    return v;
  }
};

template <typename T>
struct DenseBwdForm {
  const T *Q, *xu;
  int n;
  // (Q_i x)[a] = sum_b Q_i[a, b] x[b]
  __device__ T qx(int i, int a) const {
    const T* row = Q + (i * n + a) * n;
    T v = T(0);
    for (int b = 0; b < n; ++b) v += row[b] * xu[b];
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_dense_fwd_kernel(
    const T* __restrict__ Qg, const T* __restrict__ Ub,
    const T* __restrict__ Bm, const T* __restrict__ A,
    const T* __restrict__ bk, T* __restrict__ G_out, T* __restrict__ y_out,
    int Tn, int n, int m, int p, const __grid_constant__ DenseMeta meta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pnn = p * n * n;
  const Fwd<T> S(smem_raw, n, m, p, pnn, 0);
  const DenseForm<T> qf{S.Bs, S.q, S.F, n, m, p, S.pn};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_carry(S);
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = (size_t)lane * Tn + t;
    for (int i = tid; i < pnn; i += nth) S.q[i] = Qg[kt * pnn + i];
    thomas::load_knot(S, Ub, Bm, A, bk, kt, t, Tn);
    __syncthreads();
    thomas::fill_in(S);
    __syncthreads();
    thomas::build_system(S, meta.owner, qf);
    __syncthreads();
    thomas::solve_and_store(S, G_out, y_out, kt);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_dense_bwd_kernel(
    const T* __restrict__ G, const T* __restrict__ yhat,
    const T* __restrict__ Qg, const T* __restrict__ A,
    const T* __restrict__ bk, T* __restrict__ y_out, int Tn, int n, int m,
    int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pnn = p * n * n;
  const Bwd<T> S(smem_raw, n, m, p, pnn);
  const DenseBwdForm<T> qf{S.q, S.xu, n};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_lam(S);
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t kt = (size_t)lane * Tn + t;
    for (int i = tid; i < pnn; i += nth) S.q[i] = Qg[kt * pnn + i];
    thomas::load_At1T(S, A, kt, t, Tn);
    __syncthreads();
    thomas::primal_step(S, G, yhat, kt);
    __syncthreads();
    thomas::multipliers_and_store(S, bk, y_out, kt, qf);
  }
}

template <typename T>
int launch_fwd(const void* Q, const void* Ub, const void* Bm, const void* A,
               const void* b, const int* owner, void* G, void* yhat, int B,
               int Tn, int n, int m, int p, void* stream) {
  if (m > kMaxM) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = thomas::fwd_smem_bytes<T>(n, m, p, p * n * n, 0);
  int err = thomas::set_smem((const void*)thomas_dense_fwd_kernel<T>, bytes);
  if (err) return err;
  DenseMeta meta = {};
  for (int r = 0; r < m; ++r) meta.owner[r] = owner[r];
  thomas_dense_fwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)Q, (const T*)Ub, (const T*)Bm, (const T*)A, (const T*)b,
      (T*)G, (T*)yhat, Tn, n, m, p, meta);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* G, const void* yhat, const void* Q, const void* A,
               const void* b, void* y, int B, int Tn, int n, int m, int p,
               void* stream) {
  if (m > kMaxM) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = thomas::bwd_smem_bytes<T>(n, m, p, p * n * n, 0);
  int err = thomas::set_smem((const void*)thomas_dense_bwd_kernel<T>, bytes);
  if (err) return err;
  thomas_dense_bwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)yhat, (const T*)Q, (const T*)A, (const T*)b,
      (T*)y, Tn, n, m, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define THOMAS_DENSE_EXPORT(SUFFIX, T)                                        \
  extern "C" int thomas_dense_fwd_##SUFFIX(                                   \
      const void* Q, const void* Ub, const void* Bm, const void* A,           \
      const void* b, const int* owner, void* G, void* yhat, int B, int Tn,    \
      int n, int m, int p, void* stream) {                                    \
    return launch_fwd<T>(Q, Ub, Bm, A, b, owner, G, yhat, B, Tn, n, m, p,     \
                         stream);                                             \
  }                                                                           \
  extern "C" int thomas_dense_bwd_##SUFFIX(                                   \
      const void* G, const void* yhat, const void* Q, const void* A,          \
      const void* b, void* y, int B, int Tn, int n, int m, int p,             \
      void* stream) {                                                         \
    return launch_bwd<T>(G, yhat, Q, A, b, y, B, Tn, n, m, p, stream);        \
  }

THOMAS_DENSE_EXPORT(f32, float)
THOMAS_DENSE_EXPORT(f64, double)

extern "C" const char* thomas_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
