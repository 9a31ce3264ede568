// Structured-Q Schur-condensed block-Thomas KKT sweep (kernel K1).
//
// Replaces algames_tpu/ops/thomas_pallas.py::solve_thomas_pallas_structured
// (_make_fwd_kernel_sq, _make_bwd_kernel_sq, _reduced_solve(pivot=True)).
//
// Q_i is given as diag(q_i) + sum_k w_k w_k^T (k owned by player i).  Its
// reduced systems are eliminated x first, as K3's (the TPU kernel takes u
// first): the quadrotor's KKT systems lose up to 2.95e3 relative in f32 at
// mu = 1e7 with u first, against 4.16 x first (PERF.md).
//
// What bounds it on the card: neither bytes nor flops.  A lane moves ~160 KB
// (f32, both launches, G and y_hat included) and does ~1.2 MFLOP; the sweep
// is a chain of T knots, each a chain of d pivot steps, so it is bound by
// the latency of that dependent chain and by how many chains an SM holds.
// The forward kernel is K3's register-tiled core (thomas_dense_core.cuh:
// one 128-thread block per lane, each thread's tile of the augmented
// system in registers with compile-time strides, one block barrier per
// pivot step, the next knot's operands copied in by cp.async while a knot
// is eliminated) with the Q form StructuredQ below: per knot it stages q
// [p, n] and w [NW, n] instead of Q [p, n, n], forms Bw = B^T w_k and
// Fw = F_owner(k) w_k once after the fill-in, and builds each x column
// from them.  Its elimination is LU with a back substitution inside each
// warp, not the core's Gauss-Jordan: on the quadrotor's f32 systems
// Gauss-Jordan's backward error reached 66 x the plain version's at mu =
// 1e7 (tests/test_torch_k1_order.py).  Size classes (TR, TC) = (2, 2),
// (3, 4), (4, 6) of 128 threads cover d <= 32 and d + R <= 96: the double
// integrator, the flagship, the quadrotor (d=32).  On an H100 80GB HBM3
// (f32, B=1024, forward + backward; tests/thomas_compare.py) it takes 1.68
// ms on the quadrotor's systems, 0.98 ms on the flagship's and 0.20 ms on
// the double integrator's, where the shared-memory forward kernel took
// 4.84, 1.67 and 0.30 ms: one wave of 8 lanes per SM against 6
// (quadrotor), one barrier per pivot step against three.  Of a quadrotor
// knot's ~173,000 SM cycles the elimination takes ~68,000, the build of the
// augmented system ~48,000 and the back substitution ~24,000
// (tests/k1_phase_clocks.py); its f32 instance holds 64 registers a thread
// and spills (a 224-byte frame).
// The tall class (3, 10) covers d <= 48 and d + R <= 160, the 3-player
// quadrotor's systems (d=48, d + R = 157): 256 threads a lane, 16 row
// groups by 16 column groups (thomas_core::kTallRG), so that a thread
// holds 30 entries of the 48 x 157 system where 128 threads would hold 60
// (the (4, 6) tile already spills at 64 registers); the pivot search and
// the row broadcast are 16-lane shuffles and the pivot mask 64 bits.  Its
// 60,096 bytes of shared memory a lane in f32 (the double-buffered q and
// w, the A ring, the carry G and LU's d x d slots) fit 3 lanes on an SM
// (80 registers a thread at most), so B=1024 takes 3 waves where the
// shared-memory kernel, at 2 lanes, took 4.
// Wider systems up to d = 64 take the per-player blocked route of
// thomas_blocked.cuh (the "blocked" route: F formed over the carry in
// place, K's LU in registers, the right-hand sides built in pivot order and
// substituted in registers, 256 threads a lane; the 4-player quadrotor's
// systems, d = 64, in f32 and f64; the 9-player unicycle merge's, d = 54
// with 72 w vectors, both too, f64 with the products Pw over K's slots).  No
// table of a fixed size bounds the control rows or the w vectors: their
// owners are device arrays.  The routes it replaced stay
// reachable by name: the shared-memory forward kernel of thomas_common.cuh
// (the "wide" route: every per-knot operand, the carry and the augmented
// system in shared memory, three barriers per pivot step, a serial back
// substitution per right-hand side) where its bytes fit a block's 227 KB,
// and beyond (from d = 64 in f64, 443 KB) the device-memory route of
// thomas_global.cuh, with the Q form SqGlobalQ below: K [d, d] and a panel
// of 128 right-hand sides in shared memory, the fill-in F in a workspace
// in device memory, the carry read back from G; it is the route of the
// unicycle merges of 11 to 17 players, d = 66 to 102, whose products Pw
// it forms 128 w vectors at a time.  The route rule: a
// register-tiled class, else the blocked route where it fits, else the
// shared-memory kernel, else the device-memory route.  The backward
// kernel is the shared-memory one of thomas_common.cuh for every width:
// a knot's multipliers are one matrix-vector product, about 7% of K1's
// device time in the quadrotor sweep's profile on an H100 (PERF.md).
#include "thomas_common.cuh"
#include "thomas_dense_core.cuh"
#include "thomas_global.cuh"
#include "thomas_blocked.cuh"

namespace {

using thomas::Bwd;
using thomas::Fwd;
using thomas::kThreads;

// The owner of each control row (owner [m]) and of each rank-1 vector
// (w_owner [NW]) are device arrays that the wrapper uploads once per shape,
// so that no table sized by a constant bounds m or NW: only shared memory
// does (the 17-player unicycle merge has m = 34 and NW = 272).

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

// The register-tiled core's structured Q form (thomas_dense_core.cuh).
// Staged per knot: q [p, n], then w [NW, n] at wofs().  Products, after the
// fill-in F, one row per row of the augmented system:
//   Pw[r, k] = B[:, r] . w_k if player owner(r) owns w_k, else 0  (r < m)
//   Pw[r, k] = F[r - m, owner(k) block] . w_k                     (r >= m)
// and the x columns (c < n):
//   statu row r: B[c, r] q_owner(r)[c] + sum_k Pw[r, k] w_k[c]
//   dyn row r:   sum_i F[r - m, i n + c] q_i[c] + sum_k Pw[r, k] w_k[c]
//                - delta(r - m, c).
// LU elimination (see the core).
template <typename T>
struct StructuredQ {
  static constexpr bool kLU = true;
  static constexpr bool kProducts = true;
  static constexpr bool kStageOnce = false;
  const T* qd;                         // [B, T, p, n]
  const T* wv;                         // [B, T, NW, n]
  const int* w_owner;                  // [NW]
  int NW;

  __host__ __device__ static int wofs(int n, int p) {
    return thomas_core::round16<T>(p * n);
  }
  __host__ __device__ int ldW() const { return thomas_core::row_pad<T>(NW); }
  __host__ __device__ int staged(int n, int p) const {
    return wofs(n, p) + thomas_core::round16<T>(NW * n);
  }
  __host__ __device__ int extra(int n, int m) const {
    return (n + m) * ldW();
  }
  template <int NT>
  __device__ __forceinline__ void issue(T* dst, size_t kt, int n,
                                        int p) const {
    thomas_core::copy_flat<T, NT>(dst, qd + kt * p * n, p * n);
    thomas_core::copy_flat<T, NT>(dst + wofs(n, p), wv + kt * NW * n,
                                  NW * n);
  }
  template <int NT>
  __device__ __forceinline__ void products(const T* Q, const T* Bs,
                                           const T* Fs, T* Pw, int ldF,
                                           const int* owner, int n, int m,
                                           int p) const {
    const T* w = Q + wofs(n, p);
    const int d = n + m, ld = ldW();
    for (int idx = threadIdx.x; idx < d * NW; idx += NT) {
      const int r = idx / NW, k = idx - r * NW;
      const int o = w_owner[k];
      const T* wk = w + k * n;
      T s = T(0);
      if (r >= m) {                    // F_owner(k) w_k
        const T* f = Fs + (r - m) * ldF + o * n;
        #pragma unroll 4
        for (int j = 0; j < n; ++j) s += f[j] * wk[j];
      } else if (owner[r] == o) {      // B^T w_k, owner's rows only
        #pragma unroll 4
        for (int j = 0; j < n; ++j) s += Bs[j * m + r] * wk[j];
      }
      Pw[r * ld + k] = s;
    }
  }
  // acc[i] += column c (< n) of owned row rg + RG i; acc is zero on
  // entry.
  template <int RG, int TR>
  __device__ __forceinline__ void x_column(T (&acc)[TR], const T* Q,
                                           const T* Bs, const T* Fs,
                                           const T* Pw, int ldF,
                                           const int (&own)[TR], int rg,
                                           int c, int n, int m,
                                           int p) const {
    const T* w = Q + wofs(n, p);
    const int d = n + m, ld = ldW();
    #pragma unroll 1
    for (int i2 = 0; i2 < p; ++i2) {   // sum_i F_i diag(q_i)
      const T qv = Q[i2 * n + c];
      #pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int a = rg + RG * i - m;
        if (a >= 0 && a < n) acc[i] += Fs[a * ldF + i2 * n + c] * qv;
      }
    }
    #pragma unroll
    for (int i = 0; i < TR; ++i) {     // B^T diag(q_owner)
      const int r = rg + RG * i;
      if (r < m) acc[i] = Bs[c * m + r] * Q[own[i] * n + c];
    }
    #pragma unroll 2
    for (int k = 0; k < NW; ++k) {     // the rank-1 terms
      const T wv_c = w[k * n + c];
      #pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = rg + RG * i;
        if (r < d) acc[i] += Pw[r * ld + k] * wv_c;
      }
    }
    #pragma unroll
    for (int i = 0; i < TR; ++i) {     // -I
      const int r = rg + RG * i;
      if (r >= m && r < d) acc[i] += (r - m == c) ? T(-1) : T(0);
    }
  }
};

// The device-memory route's structured Q form (thomas_global.cuh): K's x
// columns from q and w read from device memory, the rank-1 terms a panel
// of at most thomas_global::kThreads w vectors at a time: the products Pw
// [d, kc] of StructuredQ (B^T w_k on the owner's statu rows, F_owner(k) w_k
// on the dyn rows) formed into the panel, then added into K, so that shared
// memory does not grow with NW.  Each entry sums StructuredQ's terms in its
// order (the diagonal part, the rank-1 terms in increasing k, -I last), so
// K does not depend on the panel width.
template <typename T>
struct SqGlobalQ {
  const T* qd;                         // [B, T, p, n]
  const T* wv;                         // [B, T, NW, n]
  const int* w_owner;                  // [NW]
  int NW;

  // K[:, :n] of knot kt into K (row stride d); P: the panel, [d, kc]
  // products at a time; owner: the control rows' owners.  Each thread
  // keeps its entries of K (idx = tid mod kThreads) from pass to pass.
  // Out of line: inlined into the sweep, its loops and the sweep's shared
  // one register budget, and the route ran 7-22% longer in both precisions
  // on an H100 80GB HBM3 at 700 W (tests/source_variants.py, k1-inline).
  __device__ __noinline__ void x_columns(T* K, T* P, const T* F, const T* Bs, size_t kt,
                            const int* owner, int n, int m, int p) const {
    constexpr int nth = thomas_global::kThreads;
    const T* q = qd + kt * p * n;
    const T* w = wv + kt * NW * n;
    const int d = n + m, pn = p * n, tid = threadIdx.x;
    for (int idx = tid; idx < d * n; idx += nth) {
      const int r = idx / n, c = idx - r * n;
      T v;
      if (r < m) {                     // B^T diag(q_owner)
        v = Bs[c * m + r] * q[owner[r] * n + c];
      } else {                         // sum_i F_i diag(q_i)
        v = T(0);
        const T* f = F + (r - m) * pn;
        for (int i = 0; i < p; ++i) v += f[i * n + c] * q[i * n + c];
      }
      if (NW == 0 && r >= m && r - m == c) v += T(-1);
      K[r * d + c] = v;
    }
    for (int k0 = 0; k0 < NW; k0 += nth) {
      const int kc = NW - k0 < nth ? NW - k0 : nth;
      const bool last = k0 + kc == NW;
      for (int idx = tid; idx < d * kc; idx += nth) {
        const int r = idx / kc, k = k0 + (idx - r * kc);
        const int o = w_owner[k];
        const T* wk = w + k * n;
        T s = T(0);
        if (r >= m) {                  // F_owner(k) w_k
          const T* f = F + (r - m) * pn + o * n;
          for (int j = 0; j < n; ++j) s += f[j] * wk[j];
        } else if (owner[r] == o) {    // B^T w_k, owner's rows only
          for (int j = 0; j < n; ++j) s += Bs[j * m + r] * wk[j];
        }
        P[idx] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < d * n; idx += nth) {
        const int r = idx / n, c = idx - r * n;
        T v = K[r * d + c];
        for (int j = 0; j < kc; ++j) v += P[r * kc + j] * w[(k0 + j) * n + c];
        if (last && r >= m && r - m == c) v += T(-1);
        K[r * d + c] = v;
      }
      if (!last) __syncthreads();      // the panel is free again
    }
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
    int Tn, int n, int m, int p, int NW, const int* __restrict__ w_owner,
    const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Fwd<T> S(smem_raw, n, m, p, p * n + NW * n, n * NW);
  T* w = S.q + p * n;
  const SqForm<T> qf{S.Bs, S.q, w, S.F, S.Fw, n, m, p, S.pn, NW, w_owner};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  thomas::init_carry(S, owner);
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
      const int o = w_owner[k];
      T s = T(0);
      #pragma unroll 1
      for (int j = 0; j < n; ++j) s += S.F[a * S.pn + o * n + j] * w[k * n + j];
      S.Fw[idx] = s;
    }
    __syncthreads();
    thomas::build_system(S, qf);
    __syncthreads();
    thomas::solve_and_store(S, G_out, y_out, kt);
  }
}

// The forward sweep on the register-tiled core, one instance per size
// class: TR x 8 rows and TC x 16 columns of the augmented system.
template <typename T, int TR, int TC>
__global__ void
__launch_bounds__(thomas_core::kThreads, sizeof(T) == 4 ? 8 : 4)
thomas_sq_tiled_kernel(const T* __restrict__ qd, const T* __restrict__ wv,
                       const T* __restrict__ Ub, const T* __restrict__ Bm,
                       const T* __restrict__ A, const T* __restrict__ bk,
                       T* __restrict__ G_out, T* __restrict__ y_out, int Tn,
                       int n, int m, int p, int NW,
                       const int* __restrict__ w_owner,
                       const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_core::forward_sweep<T, TR, TC>(
      StructuredQ<T>{qd, wv, w_owner, NW}, Ub, Bm, A, bk,
      G_out, y_out, Tn, n, m, p, owner, smem_raw);
}

// The tall size class: TR x 16 rows and TC x 16 columns, 256 threads; 3
// lanes per SM in f32 (at most 80 registers a thread), 1 in f64 (its
// 123,216 bytes of shared memory).
template <typename T, int TR, int TC>
__global__ void
__launch_bounds__(thomas_core::kTallRG * thomas_core::kCG,
                  sizeof(T) == 4 ? 3 : 1)
thomas_sq_tiled_tall_kernel(const T* __restrict__ qd,
                            const T* __restrict__ wv,
                            const T* __restrict__ Ub,
                            const T* __restrict__ Bm,
                            const T* __restrict__ A,
                            const T* __restrict__ bk,
                            T* __restrict__ G_out, T* __restrict__ y_out,
                            int Tn, int n, int m, int p, int NW,
                            const int* __restrict__ w_owner,
                            const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_core::forward_sweep<T, TR, TC, StructuredQ<T>,
                             thomas_core::kTallRG>(
      StructuredQ<T>{qd, wv, w_owner, NW}, Ub, Bm, A, bk,
      G_out, y_out, Tn, n, m, p, owner, smem_raw);
}

// The device-memory route (thomas_global.cuh).
template <typename T>
__global__ void __launch_bounds__(thomas_global::kThreads)
thomas_sq_global_kernel(const T* __restrict__ qd, const T* __restrict__ wv,
                        const T* __restrict__ Ub, const T* __restrict__ Bm,
                        const T* __restrict__ A, const T* __restrict__ bk,
                        T* G_out, T* y_out, T* work, int Tn, int n, int m,
                        int p, int NW, const int* __restrict__ w_owner,
                        const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_global::forward_sweep<T>(
      SqGlobalQ<T>{qd, wv, w_owner, NW}, Ub, Bm, A, bk, G_out, y_out,
      work, Tn, n, m, p, owner, smem_raw);
}

// The per-player blocked route (thomas_blocked.cuh); NI tiles of 16 cover
// n.  2 lanes an SM in f32, 1 in f64.  kPwInK (f64 only): the products Pw
// live in K's LU slots (thomas_blocked::Layout), for the systems whose
// whole layout does not fit a block otherwise (the 9-player unicycle merge;
// in f32 its layout fits whole, 131,736 bytes).
template <typename T, int NI, bool kPwInK>
__global__ void
__launch_bounds__(thomas_blocked::kThreads, sizeof(T) == 4 ? 2 : 1)
thomas_sq_blocked_kernel(const T* __restrict__ qd, const T* __restrict__ wv,
                         const T* __restrict__ Ub, const T* __restrict__ Bm,
                         const T* __restrict__ A, const T* __restrict__ bk,
                         T* __restrict__ G_out, T* __restrict__ y_out,
                         int Tn, int n, int m, int p, int NW,
                         const int* __restrict__ w_owner,
                         const int* __restrict__ owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  thomas_blocked::forward_sweep<T, NI, thomas_blocked::StructuredForm<T>,
                                kPwInK>(
      qd, wv, Ub, Bm, A, bk, G_out, y_out, Tn, n, m, p, NW, owner,
      w_owner, smem_raw);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) thomas_sq_bwd_kernel(
    const T* __restrict__ G, const T* __restrict__ yhat,
    const T* __restrict__ qd, const T* __restrict__ wv,
    const T* __restrict__ A, const T* __restrict__ bk,
    T* __restrict__ y_out, int Tn, int n, int m, int p, int NW,
    const int* __restrict__ w_owner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Bwd<T> S(smem_raw, n, m, p, p * n + NW * n);
  T* w = S.q + p * n;
  T* wx = S.ext;
  int* wown = reinterpret_cast<int*>(wx + NW);   // w_owner, staged once
  const SqBwdForm<T> qf{S.q, w, S.xu, wx, n, NW, wown};
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = kThreads;

  for (int k = tid; k < NW; k += nth) wown[k] = w_owner[k];
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

// A size class's kernel and its threads a lane.
struct Tiled {
  const void* fn;
  int threads;
};

// The size classes, smallest first: (TR, TC) holds d <= 8 TR and
// C = d + p n + 1 <= 16 TC, the tall one d <= 16 TR.  route() sends the
// systems that fit none to launch_fwd_wide or launch_fwd_global.
template <typename T>
Tiled tiled_kernel(int n, int m, int p) {
  constexpr int k128 = thomas_core::kThreads;
  constexpr int k256 = thomas_core::kTallRG * thomas_core::kCG;
  const int d = n + m, C = d + p * n + 1;
  if (d <= 16 && C <= 32)
    return {(const void*)thomas_sq_tiled_kernel<T, 2, 2>, k128};
  if (d <= 24 && C <= 64)
    return {(const void*)thomas_sq_tiled_kernel<T, 3, 4>, k128};
  if (d <= 32 && C <= 96)
    return {(const void*)thomas_sq_tiled_kernel<T, 4, 6>, k128};
  if (d <= 48 && C <= 160)
    return {(const void*)thomas_sq_tiled_tall_kernel<T, 3, 10>, k256};
  return {nullptr, 0};
}

template <typename T>
size_t tiled_smem_bytes(int n, int m, int p, int NW) {
  const StructuredQ<T> qf{nullptr, nullptr, nullptr, NW};
  return thomas_core::CoreLayout<T>::bytes(n, m, p, qf.staged(n, p),
                                           qf.extra(n, m),
                                           StructuredQ<T>::kLU);
}

template <typename T>
size_t wide_smem_bytes(int n, int m, int p, int NW) {
  return thomas::fwd_smem_bytes<T>(n, m, p, p * n + NW * n, n * NW);
}

// Whether the blocked route takes these widths with its whole layout
// resident, or with Pw in K's slots (blocked_fits_in_k), and its kernel.
template <typename T>
bool blocked_fits(int n, int m, int p, int NW) {
  return thomas_blocked::fits<T, thomas_blocked::StructuredForm<T>, false>(
      n, m, p, NW);
}

template <typename T>
bool blocked_fits_in_k(int n, int m, int p, int NW) {
  return sizeof(T) == 8 &&
         thomas_blocked::fits<T, thomas_blocked::StructuredForm<T>, true>(
             n, m, p, NW);
}

template <typename T>
bool blocked_any(int n, int m, int p, int NW) {
  return blocked_fits<T>(n, m, p, NW) || blocked_fits_in_k<T>(n, m, p, NW);
}

template <typename T>
const void* blocked_kernel(int n, int m, int p, int NW) {
  if constexpr (sizeof(T) == 8) {
    if (!blocked_fits<T>(n, m, p, NW)) {
      if (n <= 48) return (const void*)thomas_sq_blocked_kernel<T, 3, true>;
      return (const void*)thomas_sq_blocked_kernel<T, 4, true>;
    }
  }
  if (n <= 48) return (const void*)thomas_sq_blocked_kernel<T, 3, false>;
  return (const void*)thomas_sq_blocked_kernel<T, 4, false>;
}

template <typename T>
size_t blocked_smem_bytes(int n, int m, int p, int NW) {
  using SF = thomas_blocked::StructuredForm<T>;
  return blocked_fits<T>(n, m, p, NW)
             ? thomas_blocked::smem_bytes<T, SF, false>(n, m, p, NW)
             : thomas_blocked::smem_bytes<T, SF, true>(n, m, p, NW);
}

template <typename T>
int launch_fwd(const void* qd, const void* wv, const void* Ub, const void* Bm,
               const void* A, const void* b, const int* owner,
               const int* w_owner, void* G, void* yhat, int B, int Tn, int n,
               int m, int p, int NW, void* stream) {
  const Tiled k = tiled_kernel<T>(n, m, p);
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = tiled_smem_bytes<T>(n, m, p, NW);
  int err = thomas::set_smem(k.fn, bytes);
  if (err) return err;
  const T *qp = (const T*)qd, *wp = (const T*)wv, *Ubp = (const T*)Ub,
          *Bp = (const T*)Bm, *Ap = (const T*)A, *bp = (const T*)b;
  T *Gp = (T*)G, *yp = (T*)yhat;
  void* args[] = {&qp, &wp, &Ubp, &Bp, &Ap, &bp,      &Gp,  &yp,
                  &Tn, &n,  &m,   &p,  &NW, &w_owner, &owner};
  return (int)cudaLaunchKernel(k.fn, dim3(B), dim3(k.threads), args, bytes,
                               (cudaStream_t)stream);
}

// The shared-memory kernel of thomas_common.cuh, for systems beyond the
// largest size class.
template <typename T>
int launch_fwd_wide(const void* qd, const void* wv, const void* Ub,
                    const void* Bm, const void* A, const void* b,
                    const int* owner, const int* w_owner, void* G,
                    void* yhat, int B, int Tn, int n, int m, int p, int NW,
                    void* stream) {
  if (B == 0) return 0;
  const size_t bytes = wide_smem_bytes<T>(n, m, p, NW);
  int err = thomas::set_smem((const void*)thomas_sq_fwd_kernel<T>, bytes);
  if (err) return err;
  thomas_sq_fwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)qd, (const T*)wv, (const T*)Ub, (const T*)Bm, (const T*)A,
      (const T*)b, (T*)G, (T*)yhat, Tn, n, m, p, NW, w_owner, owner);
  return (int)cudaGetLastError();
}

// The device-memory route of thomas_global.cuh, for systems the
// shared-memory kernel cannot hold; ``work``: n p n scalars a lane.
template <typename T>
int launch_fwd_global(const void* qd, const void* wv, const void* Ub,
                      const void* Bm, const void* A, const void* b,
                      const int* owner, const int* w_owner, void* G,
                      void* yhat, void* work, int B, int Tn, int n, int m,
                      int p, int NW, void* stream) {
  if (!thomas_global::fits<T>(n, m, p)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t bytes = thomas_global::smem_bytes<T>(n, m, p);
  int err = thomas::set_smem((const void*)thomas_sq_global_kernel<T>, bytes);
  if (err) return err;
  thomas_sq_global_kernel<T>
      <<<B, thomas_global::kThreads, bytes, (cudaStream_t)stream>>>(
          (const T*)qd, (const T*)wv, (const T*)Ub, (const T*)Bm,
          (const T*)A, (const T*)b, (T*)G, (T*)yhat, (T*)work, Tn, n, m, p,
          NW, w_owner, owner);
  return (int)cudaGetLastError();
}

// The per-player blocked route of thomas_blocked.cuh, for systems beyond
// the size classes up to d = 64.
template <typename T>
int launch_fwd_blocked(const void* qd, const void* wv, const void* Ub,
                       const void* Bm, const void* A, const void* b,
                       const int* owner, const int* w_owner, void* G,
                       void* yhat, int B, int Tn, int n, int m, int p, int NW,
                       void* stream) {
  if (!blocked_any<T>(n, m, p, NW)) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const void* fn = blocked_kernel<T>(n, m, p, NW);
  const size_t bytes = blocked_smem_bytes<T>(n, m, p, NW);
  int err = thomas::set_smem(fn, bytes);
  if (err) return err;
  const T *qp = (const T*)qd, *wp = (const T*)wv, *Ubp = (const T*)Ub,
          *Bp = (const T*)Bm, *Ap = (const T*)A, *bp = (const T*)b;
  T *Gp = (T*)G, *yp = (T*)yhat;
  void* args[] = {&qp, &wp, &Ubp, &Bp, &Ap, &bp,      &Gp,  &yp,
                  &Tn, &n,  &m,   &p,  &NW, &w_owner, &owner};
  return (int)cudaLaunchKernel(fn, dim3(B), dim3(thomas_blocked::kThreads),
                               args, bytes, (cudaStream_t)stream);
}

// The backward kernel's bytes a lane: lam_{t+1}, lam_t, (x, u), q and w
// staged a knot, A_{t+1}^T, w . x [NW], then w_owner [NW] as ints; in f64
// 216,784 at the 17-player unicycle merge, past a block's 232,448 from 18
// players on.
template <typename T>
size_t bwd_smem_bytes(int n, int m, int p, int NW) {
  return thomas::bwd_smem_bytes<T>(n, m, p, p * n + NW * n, NW) +
         NW * sizeof(int);
}

// K1's forward route at these widths, by shape: 0 a register-tiled class
// (launch_fwd), else 3 the blocked route (launch_fwd_blocked) where it
// fits, else 1 the shared-memory kernel (launch_fwd_wide) where its bytes
// fit a block, else 2 the device-memory route (launch_fwd_global); -1 none,
// or where the backward kernel does not fit a block.
template <typename T>
int route(int n, int m, int p, int NW) {
  if (bwd_smem_bytes<T>(n, m, p, NW) > (size_t)thomas_global::kMaxSmem)
    return -1;
  if (tiled_kernel<T>(n, m, p).fn != nullptr) return 0;
  if (blocked_any<T>(n, m, p, NW)) return 3;
  if (wide_smem_bytes<T>(n, m, p, NW) <= (size_t)thomas_global::kMaxSmem)
    return 1;
  return thomas_global::fits<T>(n, m, p) ? 2 : -1;
}

// The forward kernel of ``which`` route (as route() numbers them) at these
// widths: out = {lanes per SM, registers a thread, local memory bytes a
// thread}; non-zero if there is none.
template <typename T>
int occupancy(int n, int m, int p, int NW, int which, int* out) {
  Tiled k = {nullptr, 0};
  size_t bytes = 0;
  if (which == 0) {
    k = tiled_kernel<T>(n, m, p);
    bytes = tiled_smem_bytes<T>(n, m, p, NW);
  } else if (which == 1) {
    k = {(const void*)thomas_sq_fwd_kernel<T>, kThreads};
    bytes = wide_smem_bytes<T>(n, m, p, NW);
  } else if (which == 2 && thomas_global::fits<T>(n, m, p)) {
    k = {(const void*)thomas_sq_global_kernel<T>, thomas_global::kThreads};
    bytes = thomas_global::smem_bytes<T>(n, m, p);
  } else if (which == 3 && blocked_any<T>(n, m, p, NW)) {
    k = {blocked_kernel<T>(n, m, p, NW), thomas_blocked::kThreads};
    bytes = blocked_smem_bytes<T>(n, m, p, NW);
  }
  if (k.fn == nullptr) return (int)cudaErrorInvalidValue;
  int err = thomas::set_smem(k.fn, bytes);
  if (err) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, k.fn);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], k.fn, k.threads, bytes);
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return err;
}

// The backward kernel (owner unused: the export keeps the forward
// launchers' argument order).
template <typename T>
int launch_bwd(const void* G, const void* yhat, const void* qd, const void* wv,
               const void* A, const void* b, const int* owner,
               const int* w_owner, void* y, int B, int Tn, int n, int m,
               int p, int NW, void* stream) {
  const size_t bytes = bwd_smem_bytes<T>(n, m, p, NW);
  if (bytes > (size_t)thomas_global::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int err = thomas::set_smem((const void*)thomas_sq_bwd_kernel<T>, bytes);
  if (err) return err;
  thomas_sq_bwd_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)G, (const T*)yhat, (const T*)qd, (const T*)wv, (const T*)A,
      (const T*)b, (T*)y, Tn, n, m, p, NW, w_owner);
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
  extern "C" int thomas_sq_fwd_wide_##SUFFIX(                                 \
      const void* qd, const void* wv, const void* Ub, const void* Bm,         \
      const void* A, const void* b, const int* owner, const int* w_owner,     \
      void* G, void* yhat, int B, int Tn, int n, int m, int p, int NW,        \
      void* stream) {                                                         \
    return launch_fwd_wide<T>(qd, wv, Ub, Bm, A, b, owner, w_owner, G, yhat,  \
                              B, Tn, n, m, p, NW, stream);                    \
  }                                                                           \
  extern "C" int thomas_sq_fwd_global_##SUFFIX(                               \
      const void* qd, const void* wv, const void* Ub, const void* Bm,         \
      const void* A, const void* b, const int* owner, const int* w_owner,     \
      void* G, void* yhat, void* work, int B, int Tn, int n, int m, int p,    \
      int NW, void* stream) {                                                 \
    return launch_fwd_global<T>(qd, wv, Ub, Bm, A, b, owner, w_owner, G,      \
                                yhat, work, B, Tn, n, m, p, NW, stream);      \
  }                                                                           \
  extern "C" int thomas_sq_fwd_blocked_##SUFFIX(                              \
      const void* qd, const void* wv, const void* Ub, const void* Bm,         \
      const void* A, const void* b, const int* owner, const int* w_owner,     \
      void* G, void* yhat, int B, int Tn, int n, int m, int p, int NW,        \
      void* stream) {                                                         \
    return launch_fwd_blocked<T>(qd, wv, Ub, Bm, A, b, owner, w_owner, G,     \
                                 yhat, B, Tn, n, m, p, NW, stream);           \
  }                                                                           \
  extern "C" int thomas_sq_route_##SUFFIX(int n, int m, int p, int NW) {      \
    return route<T>(n, m, p, NW);                                             \
  }                                                                           \
  extern "C" int thomas_sq_occupancy_##SUFFIX(int n, int m, int p, int NW,    \
                                              int which, int* out) {          \
    return occupancy<T>(n, m, p, NW, which, out);                             \
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
