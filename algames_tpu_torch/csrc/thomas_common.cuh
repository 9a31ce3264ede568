// Schur-condensed block-Thomas KKT sweep: the parts shared by the
// structured-Q kernel (K1, thomas_sq.cu) and the dense-Q kernel (K3,
// thomas_dense.cu).  The two differ only in how the statx Hessian blocks
// Q_i enter: each kernel passes a "Q form" functor with
//   btq(r, o, c) = (B^T Q_o)[r, c]            forward, statu rows
//   fq(a, c)     = (sum_i F_i Q_i)[a, c]      forward, dyn rows
//   qx(i, a)     = (Q_i x_t)[a]               backward
// and everything else -- the knot operands, the Thomas fill-in, the
// augmented reduced system, the pivoted solve, the carry, the boundary gate
// A_{t+1}^T = 0 at the last knot, the multiplier rebuild -- lives here.
//
// Per scenario lane the KKT system of one Newton step is block tridiagonal
// over T knots.  The statx rows [Q_i | 0 | -I] eliminate the p*n multiplier
// unknowns in closed form, so each knot of the forward sweep reduces to one
// d x d system (d = n+m) with R = p*n+1 right-hand sides, solved by Gaussian
// elimination with row partial pivoting; the backward sweep rebuilds the
// multipliers  lam_{i,t} = Q_i x_t + A_{t+1}^T lam_{i,t+1} - a_{i,t}.
//
// One thread block per lane walks the knots in order (the TPU kernel's
// sequential grid axis becomes a loop); every per-knot operand, the (G, y)
// carry, the owner of each control row (a device array of m ints, staged
// once a launch: no table of a fixed size bounds m) and the augmented
// system [d x (d+R)] live in shared memory.  Only G
// and y_hat go to device memory, for the backward launch.  Pivoting is
// virtual, as on the TPU: a row is marked used instead of being moved, the
// pivot is the unused row of largest magnitude with the lowest index on
// ties (the reference's tie-break), found by one warp with shuffles.
//
// Layout: every operand is batch-leading and contiguous, [B, T, ...].
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace thomas {

// Every kernel runs kThreads threads per block, and the block-strided loops
// step by that constant; the forward sweep's short dot products (length n
// or p*n) stay rolled (#pragma unroll 1).  With a runtime stride and
// unrolled dot products nvcc gave K1's forward kernel 123 registers per
// thread, which halves the blocks per SM and cost 38% of its time on an
// H100.  The backward kernels keep theirs unrolled: only d or p*n threads
// work per knot there, and they need the instruction-level parallelism.
constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

// Shared-memory layout of the forward kernel, in scalars.  ``qs`` scalars
// hold the knot's Q operands, ``fws`` a Q form's own products with F.
struct FwdLayout {
  int Gx, yx, q, Ub, Bm, At, At1T, b, F, Fw, M, sol, total;
  __host__ __device__ FwdLayout(int n, int m, int p, int qs, int fws) {
    const int pn = p * n, d = n + m, R = pn + 1, W = n + m + pn;
    int o = 0;
    Gx = o;   o += n * pn;
    yx = o;   o += n;
    q = o;    o += qs;
    Ub = o;   o += m * m;
    Bm = o;   o += n * m;
    At = o;   o += n * n;
    At1T = o; o += n * n;
    b = o;    o += W;
    F = o;    o += n * pn;
    Fw = o;   o += fws;
    M = o;    o += d * (d + R);
    sol = o;  o += d * R;
    total = o;
  }
};

// Ints after the scalars: the pivot marks and rows [d] each, the control
// rows' owners [m], rounded up to keep the pivot value 8-byte aligned.
__host__ __device__ inline int fwd_ints(int n, int m) {
  return (2 * (n + m) + m + 1) & ~1;
}

template <typename T>
size_t fwd_smem_bytes(int n, int m, int p, int qs, int fws) {
  const FwdLayout L(n, m, p, qs, fws);
  return L.total * sizeof(T) + fwd_ints(n, m) * sizeof(int) + sizeof(T);
}

// Shared-memory layout of the backward kernel: lam_{t+1}, lam_t, (x, u),
// ``qs`` scalars of Q operands, A_{t+1}^T and ``es`` scalars of a Q form's
// own.
template <typename T>
size_t bwd_smem_bytes(int n, int m, int p, int qs, int es) {
  return (2 * p * n + n + m + qs + n * n + es) * sizeof(T);
}

// The forward kernel's shared-memory views and sizes.
template <typename T>
struct Fwd {
  int n, m, p, pn, d, R, W, C;
  T *Gx, *yx, *q, *Ub, *Bs, *At, *At1T, *bs, *F, *Fw, *M, *sol;
  int *used, *pivrow, *own;
  T* pivval;

  __device__ Fwd(unsigned char* raw, int n_, int m_, int p_, int qs, int fws)
      : n(n_), m(m_), p(p_) {
    pn = p * n;
    d = n + m;
    R = pn + 1;
    W = n + m + pn;
    C = d + R;
    const FwdLayout L(n, m, p, qs, fws);
    T* sm = reinterpret_cast<T*>(raw);
    Gx = sm + L.Gx;
    yx = sm + L.yx;
    q = sm + L.q;
    Ub = sm + L.Ub;
    Bs = sm + L.Bm;
    At = sm + L.At;
    At1T = sm + L.At1T;
    bs = sm + L.b;
    F = sm + L.F;
    Fw = sm + L.Fw;
    M = sm + L.M;
    sol = sm + L.sol;
    used = reinterpret_cast<int*>(sm + L.total);
    pivrow = used + d;
    own = pivrow + d;
    pivval = reinterpret_cast<T*>(used + fwd_ints(n_, m_));
  }
};

// Zero the (G, y) carry and stage the control rows' owners (``owner``: a
// device array of m ints).
template <typename T>
__device__ __forceinline__ void init_carry(const Fwd<T>& S,
                                           const int* owner) {
  for (int i = threadIdx.x; i < S.n * S.pn; i += kThreads) S.Gx[i] = T(0);
  for (int i = threadIdx.x; i < S.n; i += kThreads) S.yx[i] = T(0);
  for (int r = threadIdx.x; r < S.m; r += kThreads) S.own[r] = owner[r];
}

// Knot t's operands other than Q: Ublk, B, A_t, A_{t+1}^T (zero at the last
// knot) and the right-hand side b; clears the pivot marks.
template <typename T>
__device__ __forceinline__ void load_knot(const Fwd<T>& S, const T* Ub,
                                          const T* Bm, const T* A,
                                          const T* bk, size_t kt, int t,
                                          int Tn) {
  const int n = S.n, m = S.m, tid = threadIdx.x, nth = kThreads;
  for (int i = tid; i < m * m; i += nth) S.Ub[i] = Ub[kt * m * m + i];
  for (int i = tid; i < n * m; i += nth) S.Bs[i] = Bm[kt * n * m + i];
  for (int i = tid; i < n * n; i += nth) {
    S.At[i] = A[kt * n * n + i];
    const int a = i / n, c = i % n;
    S.At1T[i] = (t < Tn - 1) ? A[(kt + 1) * n * n + c * n + a] : T(0);
  }
  for (int i = tid; i < S.W; i += nth) S.bs[i] = bk[kt * S.W + i];
  for (int r = tid; r < S.d; r += nth) S.used[r] = 0;
}

// Thomas fill-in F = -A_t G_{t-1} (x rows of the carry), [n, pn].
template <typename T>
__device__ __forceinline__ void fill_in(const Fwd<T>& S) {
  const int n = S.n, pn = S.pn;
  for (int idx = threadIdx.x; idx < n * pn; idx += kThreads) {
    const int a = idx / pn, c = idx % pn;
    T s = T(0);
    #pragma unroll 1
    for (int k = 0; k < n; ++k) s += S.At[a * n + k] * S.Gx[k * pn + c];
    S.F[idx] = -s;
  }
}

// Column of the first u and of the first x unknown in the reduced system.
// The elimination visits the columns in order, so the order decides the
// pivot sequence.  Both K1 and K3 take the x columns first, the plain
// version's order; the TPU kernel takes u first.  With a large AL penalty
// the x columns carry the largest entries, and eliminating the small u
// pivots first loses up to ~1e-2 relative in f32 at mu = 1e7 on dense-Q
// systems, where x first stays near 1e-5.
struct ColumnOrder {
  int u0, x0;
  __device__ ColumnOrder(int n, int) : u0(n), x0(0) {}
};

// Augmented reduced system M = [K | RHS], rows [statu (m) | dyn (n)],
// columns [x (n) | u (m)], then [G rhs (pn) | y rhs (1)].
// ``S.own[r]`` is the player owning control row r.
template <typename T, typename QForm>
__device__ __forceinline__ void build_system(const Fwd<T>& S,
                                             const QForm& qf) {
  const int* owner = S.own;
  const int n = S.n, m = S.m, pn = S.pn, d = S.d, C = S.C;
  const ColumnOrder col(n, m);
  for (int idx = threadIdx.x; idx < d * C; idx += kThreads) {
    const int r = idx / C, c = idx % C;
    const bool ucol = c >= col.u0 && c < col.u0 + m;
    T v;
    if (r < m) {
      const int o = owner[r];
      if (ucol) {
        v = S.Ub[r * m + c - col.u0];
      } else if (c < d) {                      // B^T Q_owner
        v = qf.btq(r, o, c - col.x0);
      } else if (c < d + pn) {                 // owner-embedded B^T A_{t+1}^T
        const int jj = c - d, i = jj / n, cc = jj % n;
        v = T(0);
        if (i == o) {
          #pragma unroll 1
          for (int k = 0; k < n; ++k)
            v += S.Bs[k * m + r] * S.At1T[k * n + cc];
        }
      } else {                                 // c + B^T a_owner
        v = S.bs[pn + r];
        #pragma unroll 1
        for (int k = 0; k < n; ++k) v += S.Bs[k * m + r] * S.bs[o * n + k];
      }
    } else {
      const int a = r - m;
      if (ucol) {
        v = S.Bs[a * m + c - col.u0];
      } else if (c < d) {                      // -I + sum_i F_i Q_i
        const int cc = c - col.x0;
        v = qf.fq(a, cc);
        v += (a == cc) ? T(-1) : T(0);
      } else if (c < d + pn) {                 // F_i A_{t+1}^T
        const int jj = c - d, i = jj / n, cc = jj % n;
        v = T(0);
        #pragma unroll 1
        for (int k = 0; k < n; ++k)
          v += S.F[a * pn + i * n + k] * S.At1T[k * n + cc];
      } else {                                 // d0 - A_t y_{t-1} + F a
        T s1 = T(0), s2 = T(0);
        #pragma unroll 1
        for (int k = 0; k < n; ++k) s1 += S.At[a * n + k] * S.yx[k];
        #pragma unroll 1
        for (int j = 0; j < pn; ++j) s2 += S.F[a * pn + j] * S.bs[j];
        v = S.bs[pn + m + a] - s1 + s2;
      }
    }
    S.M[idx] = v;
  }
}

// Gaussian elimination of M with virtual row partial pivoting, back
// substitution, the knot's outputs G_t [d, pn] and y_t [d] in (x, u) row
// order, and the new carry (the x rows).  Ends with a block barrier.
template <typename T>
__device__ __forceinline__ void solve_and_store(const Fwd<T>& S, T* G_out,
                                                T* y_out, size_t kt) {
  const int m = S.m, n = S.n, pn = S.pn, d = S.d, R = S.R, C = S.C;
  const ColumnOrder col(n, m);
  const int tid = threadIdx.x, nth = kThreads;
  T* M = S.M;
  for (int i = 0; i < d; ++i) {
    if (tid < 32) {
      T best = T(-1);
      int bi = d;
      for (int r = tid; r < d; r += 32) {
        if (S.used[r]) continue;
        const T v = absval(M[r * C + i]);
        if (bi == d || v > best) { best = v; bi = r; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        // An empty lane (oi == d) never wins, so a row of NaNs still
        // yields a valid pivot index.
        if (oi != d && (bi == d || ob > best || (ob == best && oi < bi))) {
          best = ob;
          bi = oi;
        }
      }
      if (tid == 0) {
        S.pivrow[i] = bi;
        S.used[bi] = 1;
        *S.pivval = M[bi * C + i];
      }
    }
    __syncthreads();
    const int pr = S.pivrow[i];
    const T piv = *S.pivval;
    for (int c = i + 1 + tid; c < C; c += nth) M[pr * C + c] /= piv;
    __syncthreads();
    const int span = C - i - 1;
    for (int idx = tid; idx < d * span; idx += nth) {
      const int r = idx / span, c = i + 1 + idx % span;
      if (S.used[r]) continue;
      M[r * C + c] -= M[r * C + i] * M[pr * C + c];
    }
    __syncthreads();
  }
  // Back substitution in variable order, one thread per right-hand side.
  for (int col = tid; col < R; col += nth) {
    for (int i = d - 1; i >= 0; --i) {
      const int pr = S.pivrow[i];
      T acc = M[pr * C + d + col];
      for (int j = i + 1; j < d; ++j) acc -= M[pr * C + j] * S.sol[j * R + col];
      S.sol[i * R + col] = acc;
    }
  }
  __syncthreads();

  // Outputs in (x, u) row order; the carry keeps the x rows.
  for (int idx = tid; idx < d * pn; idx += nth) {
    const int r = idx / pn, c = idx % pn;
    const int src = (r < n) ? (col.x0 + r) : (col.u0 + r - n);
    G_out[kt * d * pn + idx] = S.sol[src * R + c];
  }
  for (int r = tid; r < d; r += nth) {
    const int src = (r < n) ? (col.x0 + r) : (col.u0 + r - n);
    y_out[kt * d + r] = S.sol[src * R + pn];
  }
  for (int idx = tid; idx < n * pn; idx += nth)
    S.Gx[idx] = S.sol[(col.x0 + idx / pn) * R + idx % pn];
  for (int a = tid; a < n; a += nth) S.yx[a] = S.sol[(col.x0 + a) * R + pn];
  __syncthreads();
}

// The backward kernel's shared-memory views and sizes.
template <typename T>
struct Bwd {
  int n, m, p, pn, d, W;
  T *lam_next, *lam, *xu, *q, *At1T, *ext;

  __device__ Bwd(unsigned char* raw, int n_, int m_, int p_, int qs)
      : n(n_), m(m_), p(p_) {
    pn = p * n;
    d = n + m;
    W = n + m + pn;
    lam_next = reinterpret_cast<T*>(raw);
    lam = lam_next + pn;
    xu = lam + pn;
    q = xu + d;
    At1T = q + qs;
    ext = At1T + n * n;
  }
};

template <typename T>
__device__ __forceinline__ void init_lam(const Bwd<T>& S) {
  for (int i = threadIdx.x; i < S.pn; i += kThreads) S.lam_next[i] = T(0);
}

// A_{t+1}^T, zero at the last knot.
template <typename T>
__device__ __forceinline__ void load_At1T(const Bwd<T>& S, const T* A,
                                          size_t kt, int t, int Tn) {
  const int n = S.n;
  for (int i = threadIdx.x; i < n * n; i += kThreads) {
    const int a = i / n, c = i % n;
    S.At1T[i] = (t < Tn - 1) ? A[(kt + 1) * n * n + c * n + a] : T(0);
  }
}

// (x, u)_t = y_hat_t - G_t lam_{t+1}.
template <typename T>
__device__ __forceinline__ void primal_step(const Bwd<T>& S, const T* G,
                                            const T* yhat, size_t kt) {
  const int d = S.d, pn = S.pn;
  for (int r = threadIdx.x; r < d; r += kThreads) {
    T s = T(0);
    for (int c = 0; c < pn; ++c) s += G[kt * d * pn + r * pn + c] * S.lam_next[c];
    S.xu[r] = yhat[kt * d + r] - s;
  }
}

// lam_{i,t} = Q_i x_t + A_{t+1}^T lam_{i,t+1} - a_{i,t}, then the knot's
// output row [x, u, lam] and the carry.  Ends with a block barrier.
template <typename T, typename QForm>
__device__ __forceinline__ void multipliers_and_store(const Bwd<T>& S,
                                                      const T* bk, T* y_out,
                                                      size_t kt,
                                                      const QForm& qf) {
  const int n = S.n, pn = S.pn, W = S.W, tid = threadIdx.x, nth = kThreads;
  for (int idx = tid; idx < pn; idx += nth) {
    const int i = idx / n, a = idx % n;
    const T v = qf.qx(i, a);
    T s = T(0);
    for (int b = 0; b < n; ++b) s += S.At1T[a * n + b] * S.lam_next[i * n + b];
    S.lam[idx] = v + s - bk[kt * W + idx];
  }
  __syncthreads();
  for (int r = tid; r < S.d; r += nth) y_out[kt * W + r] = S.xu[r];
  for (int j = tid; j < pn; j += nth) {
    y_out[kt * W + S.d + j] = S.lam[j];
    S.lam_next[j] = S.lam[j];
  }
  __syncthreads();
}

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace thomas
