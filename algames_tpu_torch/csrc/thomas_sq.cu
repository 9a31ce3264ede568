// Structured-Q Schur-condensed block-Thomas KKT sweep (kernel K1).
//
// Replaces algames_tpu/ops/thomas_pallas.py::solve_thomas_pallas_structured
// (_make_fwd_kernel_sq, _make_bwd_kernel_sq, _reduced_solve(pivot=True)).
//
// Q_i is given as diag(q_i) + sum_k w_k w_k^T (k owned by player i); the
// sweep itself, shared with the dense-Q kernel K3, is in thomas_common.cuh.
// Its reduced systems are eliminated x first, as K3's (the TPU kernel takes
// u first): the quadrotor's KKT systems lose up to 2.95e3 relative in f32
// at mu = 1e7 with u first, against 4.16 x first (PERF.md).
//
// What bounds it on the card: neither bytes nor flops.  A lane moves ~160 KB
// (f32, both launches, G and y_hat included) and does ~1.2 MFLOP; the sweep
// is a chain of T knots, each a chain of d pivot steps, so it is bound by
// the latency of that dependent chain (one block barrier per pivot step).  The design answers with one thread
// block per lane so that a whole batch of independent chains is in flight
// across the SMs (about eight 128-thread blocks per SM at a batch of 1,024
// lanes), with every per-knot operand, the recursion carry and the
// augmented system [d x (d+R)] held in shared memory: no intermediate of the
// sweep touches device memory except G and y_hat, which the backward launch
// reads back.
#include "thomas_common.cuh"

namespace {

using thomas::Bwd;
using thomas::Fwd;
using thomas::kMaxM;
using thomas::kThreads;

constexpr int kMaxNW = 64;

struct SqMeta {
  int owner[kMaxM];     // player owning control row r
  int w_owner[kMaxNW];  // player owning rank-1 vector k
};

// Q_i = diag(q_i) + sum_{owner(k) = i} w_k w_k^T.  Fw[a, k] =
// F_{owner(k)}[a, :] . w_k is computed once per knot before the system.
template <typename T>
struct SqForm {
  const T *Bs, *q, *w, *F, *Fw;
  int n, m, p, pn, NW;
  const int* w_owner;
  __device__ T btq(int r, int o, int cc) const {
    T v = Bs[cc * m + r] * q[o * n + cc];
    #pragma unroll 1
    for (int k = 0; k < NW; ++k) {
      if (w_owner[k] != o) continue;
      T bw = T(0);
      #pragma unroll 1
      for (int j = 0; j < n; ++j) bw += Bs[j * m + r] * w[k * n + j];
      v += bw * w[k * n + cc];
    }
    return v;
  }
  __device__ T fq(int a, int cc) const {
    T v = T(0);
    for (int i = 0; i < p; ++i) v += F[a * pn + i * n + cc] * q[i * n + cc];
    #pragma unroll 1
    for (int k = 0; k < NW; ++k) v += Fw[a * NW + k] * w[k * n + cc];
    return v;
  }
};

// Backward: Q_i x = diag(q_i) x + sum_{owner(k) = i} (w_k . x) w_k, with
// wx[k] = w_k . x computed once per knot.
template <typename T>
struct SqBwdForm {
  const T *q, *w, *xu, *wx;
  int n, NW;
  const int* w_owner;
  __device__ T qx(int i, int a) const {
    T v = q[i * n + a] * xu[a];
    for (int k = 0; k < NW; ++k)
      if (w_owner[k] == i) v += wx[k] * w[k * n + a];
    return v;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_sq_fwd_kernel(
    const T* __restrict__ qd, const T* __restrict__ wv,
    const T* __restrict__ Ub, const T* __restrict__ Bm,
    const T* __restrict__ A, const T* __restrict__ bk,
    T* __restrict__ G_out, T* __restrict__ y_out,
    int Tn, int n, int m, int p, int NW, const __grid_constant__ SqMeta meta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Fwd<T> S(smem_raw, n, m, p, p * n + NW * n, n * NW);
  T* w = S.q + p * n;
  const SqForm<T> qf{S.Bs, S.q, w, S.F, S.Fw, n, m, p, S.pn, NW,
                     meta.w_owner};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_carry(S);
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = (size_t)lane * Tn + t;
    for (int i = tid; i < p * n; i += nth) S.q[i] = qd[kt * p * n + i];
    for (int i = tid; i < NW * n; i += nth) w[i] = wv[kt * NW * n + i];
    thomas::load_knot(S, Ub, Bm, A, bk, kt, t, Tn);
    __syncthreads();
    thomas::fill_in(S);
    __syncthreads();
    for (int idx = tid; idx < n * NW; idx += nth) {
      const int a = idx / NW, k = idx % NW;
      const int o = meta.w_owner[k];
      T s = T(0);
      #pragma unroll 1
      for (int j = 0; j < n; ++j) s += S.F[a * S.pn + o * n + j] * w[k * n + j];
      S.Fw[idx] = s;
    }
    __syncthreads();
    thomas::build_system(S, meta.owner, qf);
    __syncthreads();
    thomas::solve_and_store(S, G_out, y_out, kt);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_sq_bwd_kernel(
    const T* __restrict__ G, const T* __restrict__ yhat,
    const T* __restrict__ qd, const T* __restrict__ wv,
    const T* __restrict__ A, const T* __restrict__ bk,
    T* __restrict__ y_out, int Tn, int n, int m, int p, int NW,
    const __grid_constant__ SqMeta meta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Bwd<T> S(smem_raw, n, m, p, p * n + NW * n);
  T* w = S.q + p * n;
  T* wx = S.ext;
  const SqBwdForm<T> qf{S.q, w, S.xu, wx, n, NW, meta.w_owner};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_lam(S);
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t kt = (size_t)lane * Tn + t;
    for (int i = tid; i < p * n; i += nth) S.q[i] = qd[kt * p * n + i];
    for (int i = tid; i < NW * n; i += nth) w[i] = wv[kt * NW * n + i];
    thomas::load_At1T(S, A, kt, t, Tn);
    __syncthreads();
    thomas::primal_step(S, G, yhat, kt);
    __syncthreads();
    for (int k = tid; k < NW; k += nth) {
      T s = T(0);
      for (int j = 0; j < n; ++j) s += w[k * n + j] * S.xu[j];
      wx[k] = s;
    }
    __syncthreads();
    thomas::multipliers_and_store(S, bk, y_out, kt, qf);
  }
}

SqMeta make_meta(const int* owner, const int* w_owner, int m, int NW) {
  SqMeta meta = {};
  for (int r = 0; r < m; ++r) meta.owner[r] = owner[r];
  for (int k = 0; k < NW; ++k) meta.w_owner[k] = w_owner[k];
  return meta;
}

bool dims_ok(int m, int NW) { return m <= kMaxM && NW <= kMaxNW; }

template <typename T>
int launch_fwd(const void* qd, const void* wv, const void* Ub, const void* Bm,
               const void* A, const void* b, const int* owner,
               const int* w_owner, void* G, void* yhat, int B, int Tn, int n,
               int m, int p, int NW, void* stream) {
  if (!dims_ok(m, NW)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes =
      thomas::fwd_smem_bytes<T>(n, m, p, p * n + NW * n, n * NW);
  int err = thomas::set_smem((const void*)thomas_sq_fwd_kernel<T>, bytes);
  if (err) return err;
  thomas_sq_fwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)qd, (const T*)wv, (const T*)Ub, (const T*)Bm, (const T*)A,
      (const T*)b, (T*)G, (T*)yhat, Tn, n, m, p, NW,
      make_meta(owner, w_owner, m, NW));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* G, const void* yhat, const void* qd, const void* wv,
               const void* A, const void* b, const int* owner,
               const int* w_owner, void* y, int B, int Tn, int n, int m,
               int p, int NW, void* stream) {
  if (!dims_ok(m, NW)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = thomas::bwd_smem_bytes<T>(n, m, p, p * n + NW * n, NW);
  int err = thomas::set_smem((const void*)thomas_sq_bwd_kernel<T>, bytes);
  if (err) return err;
  thomas_sq_bwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)yhat, (const T*)qd, (const T*)wv, (const T*)A,
      (const T*)b, (T*)y, Tn, n, m, p, NW, make_meta(owner, w_owner, m, NW));
  return (int)cudaGetLastError();
}

}  // namespace

#define THOMAS_SQ_EXPORT(SUFFIX, T)                                           \
  extern "C" int thomas_sq_fwd_##SUFFIX(                                      \
      const void* qd, const void* wv, const void* Ub, const void* Bm,         \
      const void* A, const void* b, const int* owner, const int* w_owner,     \
      void* G, void* yhat, int B, int Tn, int n, int m, int p, int NW,        \
      void* stream) {                                                         \
    return launch_fwd<T>(qd, wv, Ub, Bm, A, b, owner, w_owner, G, yhat, B,    \
                         Tn, n, m, p, NW, stream);                            \
  }                                                                           \
  extern "C" int thomas_sq_bwd_##SUFFIX(                                      \
      const void* G, const void* yhat, const void* qd, const void* wv,        \
      const void* A, const void* b, const int* owner, const int* w_owner,     \
      void* y, int B, int Tn, int n, int m, int p, int NW, void* stream) {    \
    return launch_bwd<T>(G, yhat, qd, wv, A, b, owner, w_owner, y, B, Tn, n,  \
                         m, p, NW, stream);                                   \
  }

THOMAS_SQ_EXPORT(f32, float)
THOMAS_SQ_EXPORT(f64, double)

extern "C" const char* thomas_sq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
