// The forward sweep of the block-Thomas KKT solve for systems that neither
// the register-tiled classes (thomas_dense_core.cuh) nor the shared-memory
// kernel (thomas_common.cuh) can hold: the "device-memory" route of K1
// (thomas_sq.cu) and K3 (thomas_dense.cu).
//
// It computes what the other forward kernels compute -- per lane and knot
// the Schur-condensed system M = [K | RHS] (rows [statu (m) | dyn (n)],
// columns [x (n) | u (m) | G rhs (p n) | y rhs (1)]), the x columns
// eliminated first, virtual row partial pivoting on the unused row of
// largest magnitude with the lowest index on ties, LU with a back
// substitution -- with the Q form a compile-time policy (products, x_entry)
// as in the core.  What does not fit an SM at the 4-player quadrotor's
// widths (n=48, m=16, p=4: d=64, R=193) is what grows with p n: the carry
// G_{t-1} and the fill-in F (n x p n each, 73.7 KB apiece in f64), the
// right-hand sides and the solution (d x R, 98.8 KB) and, for K3, Q itself
// (p n^2, 73.7 KB).  The shared-memory kernel holds all of them (443 KB
// for K1 and 499 KB for K3 in f64, 250 KB for K3 in f32; an SM offers
// 227 KB).  Here shared memory holds only what is d x d or smaller and a
// panel that grows with nothing:
//   - K [d, d]: factored in place, then copied to pivot order with the
//     multipliers of L below the diagonal and U on and above it;
//   - the panel [d, kThreads]: one right-hand-side column a thread, R / 128
//     passes (2 at R=193, 10 at the 17-player unicycle merge's R=1157); it
//     also holds the K1 form's products B^T w_k and F w_k for a panel of
//     at most kThreads w vectors while K is built (each panel's rank-1
//     terms are added into K's x columns before the next panel is formed,
//     in increasing k, so K is the same as with all NW products at once),
//     and K's copy while it is permuted;
//   - B [n, m], b [W], the pivot rows and marks, and the owner of each
//     control row (a device array of m ints, staged once a launch).
// F lives in a per-lane workspace in device memory that the wrapper
// allocates (n x p n scalars a lane); the carry G_{t-1}, y_{t-1} is read
// back from the outputs G and y_hat, which the previous knot wrote; Q, q,
// w, U and A are read from the inputs.  A lane's F, G_{t-1} and knot
// operands are what its next knot reads again: ~150 KB in f64 at d=64,
// which stays in the 50 MB L2 for the lanes in flight.
//
// A knot takes, with a block barrier between each: the fill-in F = -A_t
// G_{t-1} into the workspace; K (the Q form's x columns, a panel of
// products at a time, and the u columns); d pivot steps of two barriers
// each (warp 0 finds the pivot, every thread updates the rows not pivoted
// yet with the multiplier K[r, s] (1 / piv)); K in pivot order; then, with
// no barrier, each thread builds its right-hand-side column in pivot
// order, runs the forward substitution with L and the back substitution
// with U (dot products in increasing column order, divided by the pivot),
// and writes the solution, which is G_t's column or y_t, straight into the
// outputs in (x, u) row order.
//
// Shared memory a lane at the 4-player quadrotor's widths: 107,072 bytes
// in f64 and 53,824 in f32 (2 and 4 lanes an SM); at the 17-player
// unicycle merge's (d = 102) 217,192 in f64.  The route takes d <= 128
// within 232,448 bytes (in f64 d up to about 104), at any number of
// control rows and w vectors (fits); the wrappers refuse wider systems.
// Bound on the card: neither bytes nor operations, but the latency of each
// knot's chains (d pivot steps; a right-hand side's 2 d^2 dependent
// multiply-adds from shared memory) at 1 to 4 lanes an SM.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "thomas_common.cuh"

namespace thomas_global {

constexpr int kThreads = 128;      // threads a lane, columns a panel
constexpr int kMaxSmem = 232448;   // shared memory a block may have

// Shared-memory layout of a lane, in scalars of T, then 2 d + m ints.
struct Layout {
  int K, panel, Bs, bs, total;
  __host__ __device__ Layout(int n, int m, int p) {
    const int d = n + m, W = n + m + p * n;
    int o = 0;
    K = o;     o += d * d;
    panel = o; o += d * kThreads;
    Bs = o;    o += n * m;
    bs = o;    o += W;
    total = o;
  }
};

// Bytes a lane: the layout, then pivrow [d], used [d], owner [m] as ints.
template <typename T>
size_t smem_bytes(int n, int m, int p) {
  return Layout(n, m, p).total * sizeof(T) + (2 * (n + m) + m) * sizeof(int);
}

// Whether the route takes these widths.
template <typename T>
bool fits(int n, int m, int p) {
  return n >= 1 && m >= 1 && n + m <= kThreads &&
         smem_bytes<T>(n, m, p) <= (size_t)kMaxSmem;
}

// Scalars of the per-lane workspace: the fill-in F [n, p n].
__host__ __device__ inline size_t work_scalars(int n, int p) {
  return (size_t)n * p * n;
}

// Right-hand side ``col`` (< p n: column col of G_t; p n: y_t) of
// equation row r, as thomas_common.cuh's build_system sums it.  A1 is
// A_{t+1} (nullptr at the last knot), yp the previous knot's y_hat (nullptr
// at the first).
template <typename T>
__device__ __forceinline__ T rhs_entry(int r, int col, const T* Bs,
                                       const T* bs, const T* F,
                                       const T* At, const T* A1,
                                       const T* yp, const int* owner, int n,
                                       int m, int pn) {
  if (r < m) {
    const int o = owner[r];
    if (col < pn) {                          // owner-embedded B^T A_{t+1}^T
      const int i = col / n, cc = col - i * n;
      T v = T(0);
      if (i == o && A1 != nullptr) {
        for (int k = 0; k < n; ++k) v += Bs[k * m + r] * A1[cc * n + k];
      }
      return v;
    }
    T v = bs[pn + r];                        // c + B^T a_owner
    for (int k = 0; k < n; ++k) v += Bs[k * m + r] * bs[o * n + k];
    return v;
  }
  const int a = r - m;
  if (col < pn) {                            // F_i A_{t+1}^T
    const int i = col / n, cc = col - i * n;
    T v = T(0);
    if (A1 != nullptr) {
      for (int k = 0; k < n; ++k) v += F[a * pn + i * n + k] * A1[cc * n + k];
    }
    return v;
  }
  T s1 = T(0), s2 = T(0);                    // d0 - A_t y_{t-1} + F a
  if (yp != nullptr) {
    for (int k = 0; k < n; ++k) s1 += At[a * n + k] * yp[k];
  }
  for (int j = 0; j < pn; ++j) s2 += F[a * pn + j] * bs[j];
  return bs[pn + m + a] - s1 + s2;
}

// The forward sweep of lane blockIdx.x: G [B, T, d, p n] and y_hat
// [B, T, d] in (x, u) row order, as the other forward kernels write them.
// ``work``: the lanes' workspaces, work_scalars a lane; ``owner``: the
// control rows' owners, a device array of m ints.  The Q form writes K's
// x columns (x_columns: from its products where it has some, formed into
// the panel a part at a time behind barriers of its own).
template <typename T, class QForm>
__device__ void forward_sweep(const QForm& qf, const T* __restrict__ Ub,
                              const T* __restrict__ Bm,
                              const T* __restrict__ A,
                              const T* __restrict__ bk, T* G, T* yhat,
                              T* work, int Tn, int n, int m, int p,
                              const int* __restrict__ owner,
                              unsigned char* raw) {
  const int pn = p * n, d = n + m, R = pn + 1, W = n + m + pn;
  const int tid = threadIdx.x, lane = blockIdx.x;
  const Layout L(n, m, p);
  T* sm = reinterpret_cast<T*>(raw);
  T* K = sm + L.K;
  T* P = sm + L.panel;
  T* Bs = sm + L.Bs;
  T* bs = sm + L.bs;
  int* pivrow = reinterpret_cast<int*>(sm + L.total);
  int* used = pivrow + d;
  int* own = used + d;
  T* F = work + (size_t)lane * work_scalars(n, p);

  for (int r = tid; r < m; r += kThreads) own[r] = owner[r];
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = (size_t)lane * Tn + t;
    const T* At = A + kt * n * n;
    const T* A1 = (t + 1 < Tn) ? A + (kt + 1) * n * n : nullptr;
    const T* Gp = (t > 0) ? G + (kt - 1) * d * pn : nullptr;
    const T* yp = (t > 0) ? yhat + (kt - 1) * d : nullptr;

    // The knot's B and b, the pivot marks, the fill-in F = -A_t G_{t-1}
    // (its x rows: the carry).
    for (int i = tid; i < n * m; i += kThreads) Bs[i] = Bm[kt * n * m + i];
    for (int i = tid; i < W; i += kThreads) bs[i] = bk[kt * W + i];
    for (int r = tid; r < d; r += kThreads) used[r] = 0;
    for (int idx = tid; idx < n * pn; idx += kThreads) {
      const int a = idx / pn, c = idx - a * pn;
      T s = T(0);
      if (Gp != nullptr) {
        for (int k = 0; k < n; ++k) s += At[a * n + k] * Gp[k * pn + c];
      }
      F[idx] = -s;
    }
    __syncthreads();

    // K: the x columns from the Q form, the u columns [U; B].
    qf.x_columns(K, P, F, Bs, kt, own, n, m, p);
    for (int idx = tid; idx < d * m; idx += kThreads) {
      const int r = idx / m, c = idx - r * m;
      K[r * d + n + c] = (r < m) ? Ub[kt * m * m + r * m + c]
                                 : Bs[(r - m) * m + c];
    }
    __syncthreads();

    // LU with virtual row partial pivoting: the rows not pivoted yet take
    // K[r, c] -= (K[r, s] (1 / piv)) K[pr, c] for c > s.
    for (int s = 0; s < d; ++s) {
      if (tid < 32) {
        T best = T(-1);
        int bi = d;
        for (int r = tid; r < d; r += 32) {
          if (used[r]) continue;
          const T v = thomas::absval(K[r * d + s]);
          if (bi == d || v > best) { best = v; bi = r; }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const T ob = __shfl_down_sync(0xffffffffu, best, off);
          const int oi = __shfl_down_sync(0xffffffffu, bi, off);
          if (oi != d && (bi == d || ob > best || (ob == best && oi < bi))) {
            best = ob;
            bi = oi;
          }
        }
        if (tid == 0) {
          pivrow[s] = bi;
          used[bi] = 1;
        }
      }
      __syncthreads();
      const int pr = pivrow[s];
      const T rp = T(1) / K[pr * d + s];
      const int span = d - s - 1;
      for (int idx = tid; idx < d * span; idx += kThreads) {
        const int r = idx / span, c = s + 1 + (idx - r * span);
        if (used[r]) continue;
        K[r * d + c] -= (K[r * d + s] * rp) * K[pr * d + c];
      }
      __syncthreads();
    }

    // K in pivot order: row j is row pivrow[j]; below the diagonal the
    // multipliers K[pr_j, c] (1 / piv_c), on and above it U.
    for (int idx = tid; idx < d * d; idx += kThreads) P[idx] = K[idx];
    __syncthreads();
    for (int idx = tid; idx < d * d; idx += kThreads) {
      const int j = idx / d, c = idx - j * d;
      T v = P[pivrow[j] * d + c];
      if (c < j) v *= T(1) / P[pivrow[c] * d + c];
      K[idx] = v;
    }
    __syncthreads();

    // The right-hand sides, a column a thread: built in pivot order,
    // forward substitution with L, back substitution with U.  Variable i
    // is row i of the outputs (x columns first).
    for (int c0 = 0; c0 < R; c0 += kThreads) {
      const int col = c0 + tid;
      if (col >= R) break;
      T* x = P + tid;
      for (int j = 0; j < d; ++j)
        x[j * kThreads] = rhs_entry(pivrow[j], col, Bs, bs, F, At, A1, yp,
                                    own, n, m, pn);
      for (int i = 0; i < d; ++i) {
        const T xi = x[i * kThreads];
        for (int j = i + 1; j < d; ++j) x[j * kThreads] -= K[j * d + i] * xi;
      }
      for (int i = d - 1; i >= 0; --i) {
        T s = x[i * kThreads];
        for (int j = i + 1; j < d; ++j) s -= K[i * d + j] * x[j * kThreads];
        x[i * kThreads] = s / K[i * d + i];
      }
      if (col < pn) {
        for (int i = 0; i < d; ++i)
          G[kt * d * pn + (size_t)i * pn + col] = x[i * kThreads];
      } else {
        for (int i = 0; i < d; ++i) yhat[kt * d + i] = x[i * kThreads];
      }
    }
    __syncthreads();
  }
}

}  // namespace thomas_global
