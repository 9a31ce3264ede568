// Dense-Q Schur-condensed block-Thomas KKT sweep (kernel K3).
//
// Replaces algames_tpu/ops/thomas_pallas.py::solve_thomas_pallas
// (_make_fwd_kernel, _make_bwd_kernel, _reduced_solve(pivot=True)),
// homogeneous specs.
//
// The same sweep as K1 (thomas_sq.cu; the shared parts are in
// thomas_common.cuh, the register-tiled forward sweep in
// thomas_dense_core.cuh), with the statx Hessian blocks given densely,
// Qblk [B, T, p, n, n]: collision-cost pairs make them full cross-player
// blocks, so B^T Q_owner, sum_i F_i Q_i and Q_i x are dense n x n products.
// The reduced system's columns are eliminated x first, as in K1 (the TPU
// kernel takes u first): see ColumnOrder in the header.
//
// What bounds it on the card (H100 80GB HBM3 at 700 W, f32, the
// roundabout's shapes n=16, m=8, p=4, T=39: d=24, R=65; tests/
// thomas_compare.py and tests/k3_phase_clocks.py): the instruction stream
// of one lane's dependent chain, not bytes (0.65 MB a lane over both
// launches) or FMAs (0.12 ms for 1,024 lanes).  The shared-memory forward
// kernel of thomas_common.cuh spends most of its instructions, by a count
// from its code, on runtime division and modulo in its flat index loops,
// with three barriers per pivot step and a serial back substitution per
// right-hand side: 4.07 ms
// for B=132 (one lane per SM), 6.34 ms for B=924 (seven lanes per SM, one
// wave) and 9.39 ms for B=1024 (a second wave of 100 lanes costs three
// quarters of a lane's chain).  Its replacement, thomas_dense_core.cuh,
// holds each thread's tile of the augmented system in registers with
// compile-time strides, eliminates Gauss-Jordan with one barrier per pivot
// step, and copies the next knot's operands in while a knot is eliminated;
// 23 KB of shared memory and 64 registers a thread put 8 lanes on an SM,
// so B=1024 runs in one wave: 1.19 / 1.91 / 2.12 ms at the same batches.
// Of a knot's ~89,700 SM cycles at B=1024, the elimination takes ~44,000
// (24 steps of barrier, shuffles and a pivot search) and the build of the
// augmented system ~30,000.  The backward kernel (0.46 ms of the
// roundabout's 2.57 ms) is the shared-memory one for every width.
// The core's Q form here is DenseQ: Q [p, n, n] staged per knot, the x
// columns as dense products.  Its classes for d <= 24 eliminate
// Gauss-Jordan; those for d <= 32 (the quadrotor's systems turned dense,
// d=32, and IBR's quadrotor player systems, d=28) eliminate LU with K1's
// back substitution, since Gauss-Jordan misses the backward-error gate on
// the quadrotor's f32 systems (tests/test_torch_k3_order.py), and stage Q
// (2 x 24 x 24 scalars a knot at the quadrotor's widths) in one buffer,
// the next knot's copy issued once the build has read it: double-buffered,
// the 30,496 bytes a lane in f32 fit 7 lanes on an SM and B=1024 took a
// second wave; staged once, 25,888 fit 8.  Systems beyond (d > 32 or
// d + R > 96) up to d = 64 take the per-player blocked route of
// thomas_blocked.cuh, K1's design (below); wider ones the shared-memory
// forward kernel (the "big" route) where its bytes fit a block's 227 KB,
// and beyond that the device-memory route of thomas_global.cuh with the Q
// form DenseGlobalQ below, Q read from device memory.  Both stay reachable
// by name, timed beside the blocked route.
//
// The blocked route (thomas_dense_blocked_kernel) replaces the forward half
// of thomas_pallas.py:424 (solve_thomas_pallas; the kernel _make_fwd_kernel,
// :114-228) beyond the register-tiled classes: the 4-player quadrotor with
// collision-cost pairs (n=48, m=16, p=4: d=64, R=193), the 3-player
// quadrotor's systems turned dense (d=48), the 6-player unicycle's (d=36).
// The TPU kernel differs from K1's only in K's x columns (B^T Q_owner on
// the statu rows, sum_i F_i Q_i on the dyn rows), so the route is K1's
// blocked sweep with the Q form thomas_blocked::DenseForm.  What bounds it
// on the card is what bounds K1's: the latency of a knot's chains (64 LU
// pivot steps, the substitutions), not bytes or operations.  What the
// dense form adds is Q itself: p n^2 = 9,216 scalars a knot at quad4 do
// not fit beside the rest (f32 would lose its second lane an SM, f64
// would not fit at all), so Q comes in a player at a time by cp.async into
// two slots (109,696 bytes a lane in f32: 2 lanes an SM; 218,816 in f64),
// player i + 1's copy in flight while player i's pass adds F_i Q_i to K's
// dyn rows in registers and sets B^T Q_i on player i's statu rows.  The
// products are FMA / DFMA on the CUDA cores, as K1's.
#include "thomas_common.cuh"
#include "thomas_dense_core.cuh"
#include "thomas_global.cuh"
#include "thomas_blocked.cuh"

namespace {

using thomas::Bwd;
using thomas::Fwd;
using thomas::kThreads;

// The owner of each control row is a device array of m ints (``owner``)
// that the wrapper uploads once per shape: no table of a fixed size bounds
// m.

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

// The register-tiled core's dense Q form: Q_i [n, n] per player staged per
// knot; the x columns are B^T Q_owner (statu rows) and -I + sum_i F_i Q_i
// (dyn rows).  ``LU``: the classes for d <= 32, LU elimination and Q
// staged once; else Gauss-Jordan and Q double-buffered.
template <typename T, bool LU>
struct DenseQ {
  static constexpr bool kLU = LU;
  static constexpr bool kProducts = false;
  static constexpr bool kStageOnce = LU;
  const T* Qg;                         // [B, T, p, n, n]

  __host__ __device__ int staged(int n, int p) const {
    return thomas_core::round16<T>(p * n * n);
  }
  __host__ __device__ int extra(int, int) const { return 0; }
  template <int NT>
  __device__ __forceinline__ void issue(T* dst, size_t kt, int n,
                                        int p) const {
    const int pn = p * n;
    thomas_core::copy_flat<T, NT>(dst, Qg + kt * pn * n, pn * n);
  }
  // acc[i] += column c (< n) of owned row rg + RG i; acc is zero on entry.
  template <int RG, int TR>
  __device__ __forceinline__ void x_column(T (&acc)[TR], const T* Q,
                                           const T* Bs, const T* Fs,
                                           const T*, int ldF,
                                           const int (&own)[TR], int rg,
                                           int c, int n, int m,
                                           int p) const {
    #pragma unroll 1
    for (int i2 = 0; i2 < p; ++i2) {
      #pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const T qv = Q[(i2 * n + k) * n + c];
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int a = rg + RG * i - m;
          if (a >= 0 && a < n) acc[i] += Fs[a * ldF + i2 * n + k] * qv;
        }
      }
    }
    #pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rg + RG * i;
      if (r < m) {                     // B^T Q_owner
        const T* Qo = Q + own[i] * n * n;
        T v = T(0);
        #pragma unroll 4
        for (int k = 0; k < n; ++k) v += Bs[k * m + r] * Qo[k * n + c];
        acc[i] = v;
      } else if (r < n + m) {          // -I + sum_i F_i Q_i
        acc[i] += (r - m == c) ? T(-1) : T(0);
      }
    }
  }
};

// The device-memory route's dense Q form (thomas_global.cuh): each x
// entry of K from Q read from device memory, summed in DenseForm's order.
template <typename T>
struct DenseGlobalQ {
  const T* Qg;                         // [B, T, p, n, n]

  // K[:, :n] of knot kt into K (row stride d): B^T Q_owner, or -I + sum_i
  // F_i Q_i (the panel unused: no products).
  __device__ void x_columns(T* K, T*, const T* F, const T* Bs, size_t kt,
                            const int* owner, int n, int m, int p) const {
    const int pn = p * n, d = n + m;
    const T* Q = Qg + kt * pn * n;
    for (int idx = threadIdx.x; idx < d * n;
         idx += thomas_global::kThreads) {
      const int r = idx / n, c = idx - r * n;
      T v = T(0);
      if (r < m) {
        const T* Qo = Q + owner[r] * n * n;
        for (int k = 0; k < n; ++k) v += Bs[k * m + r] * Qo[k * n + c];
      } else {
        const T* f = F + (r - m) * pn;
        for (int j = 0; j < pn; ++j) v += f[j] * Q[j * n + c];
        if (r - m == c) v += T(-1);
      }
      K[r * d + c] = v;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_dense_fwd_kernel(
    const T* __restrict__ Qg, const T* __restrict__ Ub,
    const T* __restrict__ Bm, const T* __restrict__ A,
    const T* __restrict__ bk, T* __restrict__ G_out, T* __restrict__ y_out,
    int Tn, int n, int m, int p, const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pnn = p * n * n;
  const Fwd<T> S(smem_raw, n, m, p, pnn, 0);
  const DenseForm<T> qf{S.Bs, S.q, S.F, n, m, p, S.pn};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_carry(S, owner);
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = (size_t)lane * Tn + t;
    for (int i = tid; i < pnn; i += nth) S.q[i] = Qg[kt * pnn + i];
    thomas::load_knot(S, Ub, Bm, A, bk, kt, t, Tn);
    __syncthreads();
    thomas::fill_in(S);
    __syncthreads();
    thomas::build_system(S, qf);
    __syncthreads();
    thomas::solve_and_store(S, G_out, y_out, kt);
  }
}

// The forward sweep with the augmented system in registers
// (thomas_dense_core.cuh), one instance per size class: TR x 8 rows and
// TC x 16 columns of the augmented system.  8 lanes per SM in f32 (at most
// 64 registers a thread), 4 in f64.
template <typename T, int TR, int TC>
__global__ void
__launch_bounds__(thomas_core::kThreads, sizeof(T) == 4 ? 8 : 4)
thomas_dense_tiled_kernel(const T* __restrict__ Qg, const T* __restrict__ Ub,
                          const T* __restrict__ Bm, const T* __restrict__ A,
                          const T* __restrict__ bk, T* __restrict__ G_out,
                          T* __restrict__ y_out, int Tn, int n, int m, int p,
                          const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_core::forward_sweep<T, TR, TC>(DenseQ<T, false>{Qg}, Ub, Bm, A,
                                        bk, G_out, y_out, Tn, n, m, p,
                                        owner, smem_raw);
}

// The same for the classes of d <= 32: LU, Q staged once.
template <typename T, int TR, int TC>
__global__ void
__launch_bounds__(thomas_core::kThreads, sizeof(T) == 4 ? 8 : 4)
thomas_dense_tiled_lu_kernel(const T* __restrict__ Qg,
                             const T* __restrict__ Ub,
                             const T* __restrict__ Bm,
                             const T* __restrict__ A,
                             const T* __restrict__ bk, T* __restrict__ G_out,
                             T* __restrict__ y_out, int Tn, int n, int m,
                             int p, const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_core::forward_sweep<T, TR, TC>(DenseQ<T, true>{Qg}, Ub, Bm, A,
                                        bk, G_out, y_out, Tn, n, m, p,
                                        owner, smem_raw);
}

// The device-memory route (thomas_global.cuh).
template <typename T>
__global__ void __launch_bounds__(thomas_global::kThreads)
thomas_dense_global_kernel(const T* __restrict__ Qg,
                           const T* __restrict__ Ub,
                           const T* __restrict__ Bm,
                           const T* __restrict__ A,
                           const T* __restrict__ bk, T* G_out, T* y_out,
                           T* work, int Tn, int n, int m, int p,
                           const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_global::forward_sweep<T>(DenseGlobalQ<T>{Qg}, Ub, Bm, A, bk, G_out,
                                  y_out, work, Tn, n, m, p, owner,
                                  smem_raw);
}

// The per-player blocked route (thomas_blocked.cuh, Q form DenseForm); NI
// tiles of 16 cover n.  2 lanes an SM in f32, 1 in f64.
template <typename T, int NI>
__global__ void
__launch_bounds__(thomas_blocked::kThreads, sizeof(T) == 4 ? 2 : 1)
thomas_dense_blocked_kernel(const T* __restrict__ Qg,
                            const T* __restrict__ Ub,
                            const T* __restrict__ Bm,
                            const T* __restrict__ A,
                            const T* __restrict__ bk, T* __restrict__ G_out,
                            T* __restrict__ y_out, int Tn, int n, int m,
                            int p, const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_blocked::forward_sweep<T, NI, thomas_blocked::DenseForm<T>>(
      Qg, nullptr, Ub, Bm, A, bk, G_out, y_out, Tn, n, m, p, 0, owner,
      nullptr, smem_raw);
}

// kStageQ: Q [p, n, n] staged a knot; else read from device memory, for
// the systems whose Q does not fit a block beside the rest (p n^2 scalars:
// from 15 unicycles on in f32, 12 in f64).
template <typename T, bool kStageQ>
__global__ void __launch_bounds__(kThreads) thomas_dense_bwd_kernel(
    const T* __restrict__ G, const T* __restrict__ yhat,
    const T* __restrict__ Qg, const T* __restrict__ A,
    const T* __restrict__ bk, T* __restrict__ y_out, int Tn, int n, int m,
    int p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pnn = p * n * n;
  const Bwd<T> S(smem_raw, n, m, p, kStageQ ? pnn : 0);
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_lam(S);
  for (int t = Tn - 1; t >= 0; --t) {
    const size_t kt = (size_t)lane * Tn + t;
    if (kStageQ)
      for (int i = tid; i < pnn; i += nth) S.q[i] = Qg[kt * pnn + i];
    thomas::load_At1T(S, A, kt, t, Tn);
    __syncthreads();
    thomas::primal_step(S, G, yhat, kt);
    __syncthreads();
    const DenseBwdForm<T> qf{kStageQ ? S.q : Qg + kt * pnn, S.xu, n};
    thomas::multipliers_and_store(S, bk, y_out, kt, qf);
  }
}

// The shared-memory kernel of thomas_common.cuh, for systems beyond the
// largest size class.
template <typename T>
int launch_fwd_big(const void* Q, const void* Ub, const void* Bm,
                   const void* A, const void* b, const int* owner, void* G,
                   void* yhat, int B, int Tn, int n, int m, int p,
                   void* stream) {
  if (B == 0) return 0;
  const size_t bytes = thomas::fwd_smem_bytes<T>(n, m, p, p * n * n, 0);
  int err = thomas::set_smem((const void*)thomas_dense_fwd_kernel<T>, bytes);
  if (err) return err;
  thomas_dense_fwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)Q, (const T*)Ub, (const T*)Bm, (const T*)A, (const T*)b,
      (T*)G, (T*)yhat, Tn, n, m, p, owner);
  return (int)cudaGetLastError();
}

// The device-memory route of thomas_global.cuh, for systems the
// shared-memory kernel cannot hold; ``work``: n p n scalars a lane.
template <typename T>
int launch_fwd_global(const void* Q, const void* Ub, const void* Bm,
                      const void* A, const void* b, const int* owner,
                      void* G, void* yhat, void* work, int B, int Tn, int n,
                      int m, int p, void* stream) {
  if (!thomas_global::fits<T>(n, m, p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = thomas_global::smem_bytes<T>(n, m, p);
  int err = thomas::set_smem((const void*)thomas_dense_global_kernel<T>,
                             bytes);
  if (err) return err;
  thomas_dense_global_kernel<T>
      <<<B, thomas_global::kThreads, bytes, (cudaStream_t)stream>>>(
          (const T*)Q, (const T*)Ub, (const T*)Bm, (const T*)A, (const T*)b,
          (T*)G, (T*)yhat, (T*)work, Tn, n, m, p, owner);
  return (int)cudaGetLastError();
}

// Whether the blocked route takes these widths, and its kernel.
template <typename T>
bool blocked_fits(int n, int m, int p) {
  return thomas_blocked::fits<T, thomas_blocked::DenseForm<T>>(n, m, p, 0);
}

template <typename T>
size_t blocked_smem_bytes(int n, int m, int p) {
  return thomas_blocked::smem_bytes<T, thomas_blocked::DenseForm<T>>(n, m, p,
                                                                     0);
}

template <typename T>
const void* blocked_kernel(int n) {
  if (n <= 48) return (const void*)thomas_dense_blocked_kernel<T, 3>;
  return (const void*)thomas_dense_blocked_kernel<T, 4>;
}

// The per-player blocked route of thomas_blocked.cuh, for systems beyond
// the size classes up to d = 64.
template <typename T>
int launch_fwd_blocked(const void* Q, const void* Ub, const void* Bm,
                       const void* A, const void* b, const int* owner,
                       void* G, void* yhat, int B, int Tn, int n, int m,
                       int p, void* stream) {
  if (!blocked_fits<T>(n, m, p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const void* fn = blocked_kernel<T>(n);
  const size_t bytes = blocked_smem_bytes<T>(n, m, p);
  int err = thomas::set_smem(fn, bytes);
  if (err) return err;
  const T *Qp = (const T*)Q, *Ubp = (const T*)Ub, *Bp = (const T*)Bm,
          *Ap = (const T*)A, *bp = (const T*)b;
  T *Gp = (T*)G, *yp = (T*)yhat;
  void* args[] = {&Qp, &Ubp, &Bp, &Ap, &bp, &Gp,
                  &yp, &Tn,  &n,  &m,  &p,  &owner};
  return (int)cudaLaunchKernel(fn, dim3(B), dim3(thomas_blocked::kThreads),
                               args, bytes, (cudaStream_t)stream);
}

template <typename T>
size_t big_smem_bytes(int n, int m, int p) {
  return thomas::fwd_smem_bytes<T>(n, m, p, p * n * n, 0);
}

// A size class's kernel and its Q form (lu: LU, Q staged once).
struct Tiled {
  const void* fn;
  bool lu;
};

// The size classes, smallest first: (TR, TC) holds d <= 8 TR and
// C = d + p n + 1 <= 16 TC.  route() sends the systems that fit none to
// launch_fwd_big or launch_fwd_global.
template <typename T>
Tiled tiled_kernel(int n, int m, int p) {
  const int d = n + m, C = d + p * n + 1;
  if (d <= 16 && C <= 32)
    return {(const void*)thomas_dense_tiled_kernel<T, 2, 2>, false};
  if (d <= 24 && C <= 64)
    return {(const void*)thomas_dense_tiled_kernel<T, 3, 4>, false};
  if (d <= 24 && C <= 96)
    return {(const void*)thomas_dense_tiled_kernel<T, 3, 6>, false};
  if (d <= 32 && C <= 64)
    return {(const void*)thomas_dense_tiled_lu_kernel<T, 4, 4>, true};
  if (d <= 32 && C <= 96)
    return {(const void*)thomas_dense_tiled_lu_kernel<T, 4, 6>, true};
  return {nullptr, false};
}

template <typename T, bool LU>
size_t smem_bytes_of(int n, int m, int p) {
  const DenseQ<T, LU> qf{nullptr};
  return thomas_core::CoreLayout<T>::bytes(
      n, m, p, qf.staged(n, p), qf.extra(n, m), DenseQ<T, LU>::kLU,
      DenseQ<T, LU>::kStageOnce);
}

template <typename T>
size_t tiled_smem_bytes(int n, int m, int p) {
  return tiled_kernel<T>(n, m, p).lu ? smem_bytes_of<T, true>(n, m, p)
                                       : smem_bytes_of<T, false>(n, m, p);
}

template <typename T>
int launch_fwd(const void* Q, const void* Ub, const void* Bm, const void* A,
               const void* b, const int* owner, void* G, void* yhat, int B,
               int Tn, int n, int m, int p, void* stream) {
  const void* kernel = tiled_kernel<T>(n, m, p).fn;
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = tiled_smem_bytes<T>(n, m, p);
  int err = thomas::set_smem(kernel, bytes);
  if (err) return err;
  const T *Qp = (const T*)Q, *Ubp = (const T*)Ub, *Bp = (const T*)Bm,
          *Ap = (const T*)A, *bp = (const T*)b;
  T *Gp = (T*)G, *yp = (T*)yhat;
  void* args[] = {&Qp, &Ubp, &Bp, &Ap, &bp, &Gp,
                  &yp, &Tn,  &n,  &m,  &p,  &owner};
  return (int)cudaLaunchKernel(kernel, dim3(B), dim3(thomas_core::kThreads),
                               args, bytes, (cudaStream_t)stream);
}

// K3's forward route at these widths, by shape: 0 a register-tiled class
// (launch_fwd), else 3 the blocked route (launch_fwd_blocked) where it
// fits, else 1 the shared-memory kernel (launch_fwd_big) where its bytes
// fit a block, else 2 the device-memory route (launch_fwd_global), -1
// none.
template <typename T>
int route(int n, int m, int p) {
  if (tiled_kernel<T>(n, m, p).fn != nullptr) return 0;
  if (blocked_fits<T>(n, m, p)) return 3;
  if (big_smem_bytes<T>(n, m, p) <= (size_t)thomas_global::kMaxSmem)
    return 1;
  return thomas_global::fits<T>(n, m, p) ? 2 : -1;
}

// The forward kernel of ``which`` route (as route() numbers them) at these
// widths: out = {lanes per SM, registers a thread, local memory bytes a
// thread}; non-zero if there is none.
template <typename T>
int occupancy(int n, int m, int p, int which, int* out) {
  const void* kernel = nullptr;
  size_t bytes = 0;
  int threads = kThreads;
  if (which == 0) {
    kernel = tiled_kernel<T>(n, m, p).fn;
    bytes = tiled_smem_bytes<T>(n, m, p);
  } else if (which == 1) {
    kernel = (const void*)thomas_dense_fwd_kernel<T>;
    bytes = big_smem_bytes<T>(n, m, p);
  } else if (which == 2 && thomas_global::fits<T>(n, m, p)) {
    kernel = (const void*)thomas_dense_global_kernel<T>;
    bytes = thomas_global::smem_bytes<T>(n, m, p);
  } else if (which == 3 && blocked_fits<T>(n, m, p)) {
    kernel = blocked_kernel<T>(n);
    bytes = blocked_smem_bytes<T>(n, m, p);
    threads = thomas_blocked::kThreads;
  }
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int err = thomas::set_smem(kernel, bytes);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kernel);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                           threads, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return err;
}

// The backward kernel: Q staged a knot where it fits a block beside the
// rest, else read from device memory.
template <typename T>
int launch_bwd(const void* G, const void* yhat, const void* Q, const void* A,
               const void* b, void* y, int B, int Tn, int n, int m, int p,
               void* stream) {
  if (B == 0) return 0;
  size_t bytes = thomas::bwd_smem_bytes<T>(n, m, p, p * n * n, 0);
  const bool stage = bytes <= (size_t)thomas_global::kMaxSmem;
  const void* fn = stage ? (const void*)thomas_dense_bwd_kernel<T, true>
                         : (const void*)thomas_dense_bwd_kernel<T, false>;
  if (!stage) bytes = thomas::bwd_smem_bytes<T>(n, m, p, 0, 0);
  int err = thomas::set_smem(fn, bytes);
  if (err) return err;
  const T *Gp = (const T*)G, *yhp = (const T*)yhat, *Qp = (const T*)Q,
          *Ap = (const T*)A, *bp = (const T*)b;
  T* yp = (T*)y;
  void* args[] = {&Gp, &yhp, &Qp, &Ap, &bp, &yp, &Tn, &n, &m, &p};
  return (int)cudaLaunchKernel(fn, dim3(B), dim3(kThreads), args, bytes,
                               (cudaStream_t)stream);
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
  extern "C" int thomas_dense_fwd_big_##SUFFIX(                               \
      const void* Q, const void* Ub, const void* Bm, const void* A,           \
      const void* b, const int* owner, void* G, void* yhat, int B, int Tn,    \
      int n, int m, int p, void* stream) {                                    \
    return launch_fwd_big<T>(Q, Ub, Bm, A, b, owner, G, yhat, B, Tn, n, m, p, \
                             stream);                                         \
  }                                                                           \
  extern "C" int thomas_dense_bwd_##SUFFIX(                                   \
      const void* G, const void* yhat, const void* Q, const void* A,          \
      const void* b, void* y, int B, int Tn, int n, int m, int p,             \
      void* stream) {                                                         \
    return launch_bwd<T>(G, yhat, Q, A, b, y, B, Tn, n, m, p, stream);        \
  }                                                                           \
  extern "C" int thomas_dense_fwd_global_##SUFFIX(                            \
      const void* Q, const void* Ub, const void* Bm, const void* A,           \
      const void* b, const int* owner, void* G, void* yhat, void* work,       \
      int B, int Tn, int n, int m, int p, void* stream) {                     \
    return launch_fwd_global<T>(Q, Ub, Bm, A, b, owner, G, yhat, work, B,     \
                                Tn, n, m, p, stream);                         \
  }                                                                           \
  extern "C" int thomas_dense_fwd_blocked_##SUFFIX(                           \
      const void* Q, const void* Ub, const void* Bm, const void* A,           \
      const void* b, const int* owner, void* G, void* yhat, int B, int Tn,    \
      int n, int m, int p, void* stream) {                                    \
    return launch_fwd_blocked<T>(Q, Ub, Bm, A, b, owner, G, yhat, B, Tn, n,   \
                                 m, p, stream);                               \
  }                                                                           \
  extern "C" int thomas_dense_route_##SUFFIX(int n, int m, int p) {           \
    return route<T>(n, m, p);                                                 \
  }                                                                           \
  extern "C" int thomas_dense_occupancy_##SUFFIX(int n, int m, int p,         \
                                                 int which, int* out) {       \
    return occupancy<T>(n, m, p, which, out);                                 \
  }

THOMAS_DENSE_EXPORT(f32, float)
THOMAS_DENSE_EXPORT(f64, double)

extern "C" const char* thomas_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
