// The forward sweep of the block-Thomas KKT solve with the knot's
// augmented system in registers: the core of the register-tiled forward
// kernels of K3 (thomas_dense.cu, dense Q) and K1 (thomas_sq.cu, Q as
// diag + rank-1 terms).
//
// Per scenario lane and knot t the forward sweep eliminates the p*n
// multipliers in closed form and solves one pivoted d x d system (d = n+m)
// with R = p*n+1 right-hand sides,
//   M = [K | RHS], rows [statu (m) | dyn (n)], columns [x (n) | u (m) |
//        G rhs (p n) | y rhs (1)],
// the x columns eliminated first, with virtual row partial pivoting (the
// unused row of largest magnitude, the lowest index on ties), as the
// shared-memory kernel of thomas_common.cuh does.
//
// The Q form is a compile-time policy (QForm), given the widths n, m, p
// by the core: it stages a knot's Q operands (issue), may form per-knot
// products once the fill-in F is known (products, behind one more
// barrier), builds the x columns of the owned rows (x_column), picks the
// elimination (kLU) and where its operands are staged (kStageOnce: one
// buffer, the next knot's copy issued once the build has read it, instead
// of two).  Everything else -- the fill-in, the u columns, the right-hand
// sides, the pivoting, the stores -- is the core's.
//
// One block of RG x 16 threads per lane: RG = 8 row groups (128 threads)
// or, for the tallest systems, 16 (256 threads).  Thread (rg, cg) =
// (tid % RG, tid / RG) owns the fixed tile of M with rows rg + RG i
// (i < TR) and columns cg + 16 j (j < TC) in registers; RG, TR and TC are
// the instance's size class, so every stride and trip count is a
// compile-time constant and the actual d and C = d + R only mask.  The RG
// owners of a column (one per row group) are RG neighbouring lanes of one
// warp, and the RG owners of a row's entries within one column group are
// the same lanes, so:
//   - column s's pivot is found by an RG-lane shuffle reduction among
//     its owners, who publish the pivot row, 1 / piv and the multipliers
//     M[r, s] / piv of every row in a slot of shared memory: one block
//     barrier per pivot step;
//   - every thread takes the pivot row's entries of its own columns by a
//     shuffle from the lane of its column group that owns that row, and
//     updates its tile with one FMA per owned entry;
//   - Gauss-Jordan (K3's classes for d <= 24): every row but the pivot row
//     is updated, rows pivoted before as well, so that no back substitution
//     follows: each pivot row's right-hand sides times 1 / piv are the
//     unknowns, where they sit.  (A column-by-column back substitution took
//     as long as the elimination, one dependent chain of d steps; tests/
//     test_torch_k3_order.py emulates this order and holds it to the plain
//     version at mu up to 1e7.)  Slots are used in turn, two of them;
//   - LU (K1, and K3's classes for d <= 32): only the rows not yet pivoted
//     are updated, and step s's slot keeps column s of the rows pivoted
//     before unscaled (U[r, s]), so each step has a slot of its own.  A
//     right-looking back substitution follows on the right-hand sides: step
//     s's unknowns x_s = (pivot row) / piv leave every row pivoted before
//     with RHS -= U[r, s] x_s.  A right-hand-side column's entries all
//     belong to the RG lanes of its column group, so the back substitution
//     is shuffles within a warp and no block barrier.  Gauss-Jordan is not
//     backward stable in general: on the quadrotor's f32 systems its
//     normwise backward error reached 66 x the plain version's at mu = 1e7
//     where this form stays within 2 x (tests/test_torch_k1_order.py; the
//     same systems turned dense, tests/test_torch_k3_order.py).
// The per-knot products (the fill-in F = -A_t G_{t-1}, the Q form's x
// columns, F_i A_{t+1}^T, B^T A_{t+1}^T) are FMA chains from shared
// memory straight into the owned registers, in the order of the
// shared-memory kernel (the same order at either RG: no sum spans
// threads); rows of F and A are padded in shared memory so that eight
// consecutive row groups read eight different banks.  Knot t+1's operands
// (the Q form's, Ublk, B, b, and A_{t+2}: A is a ring of three knots,
// since knot t reads A_t and A_{t+1}) are copied by cp.async into a second
// buffer while knot t is eliminated.
//
// Shared memory per lane in f32: 23,488 bytes at the roundabout's shapes
// (K3: n=16, m=8, p=4) and 24,352 at the quadrotor's (K1: n=24, m=8, p=2,
// 6 w vectors), so 8 lanes fit on an SM and B=1024 runs in one wave;
// 25,888 at the quadrotor's turned dense (K3, Q staged once: 4,608 bytes
// fewer than double-buffered, which left room for 7 lanes), 8 lanes;
// 60,096 at the 3-player quadrotor's (K1, RG = 16: n=36, m=12, p=3, 12 w
// vectors), 3 lanes.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace thomas_core {

constexpr int kThreads = 128;   // threads of a block of kRG row groups
constexpr int kRG = 8;          // row groups
constexpr int kCG = 16;         // column groups
constexpr int kTallRG = 16;     // row groups of the tall size classes

template <typename T>
__host__ __device__ __forceinline__ int vec() { return 16 / (int)sizeof(T); }

// Smallest x' >= x that is a multiple of 16 bytes of T.
template <typename T>
__host__ __device__ __forceinline__ int round16(int x) {
  const int v = vec<T>();
  return (x + v - 1) / v * v;
}

// A row stride >= x whose rows start on 16 bytes and put eight consecutive
// rows in eight different pairs of banks (stride * sizeof(T) = 16 mod 32).
template <typename T>
__host__ __device__ __forceinline__ int row_pad(int x) {
  int ld = round16<T>(x);
  if ((ld * (int)sizeof(T)) % 32 == 0) ld += vec<T>();
  return ld;
}

// Shared-memory layout, in elements of T (then ints).  ``qs``: the scalars
// of one knot's Q operands (QForm::staged, a multiple of 16 bytes);
// ``exts``: the Q form's per-knot products (QForm::extra); ``lu``: the
// elimination keeps one slot per step (U's columns, d x d) instead of two;
// ``once``: the Q operands have one buffer of their own (``q`` is then an
// offset from the start, not from a knot's buffer).
template <typename T>
struct CoreLayout {
  int ldA, ldF, q, ub, bm, bk, buf, a, gx, yx, fs, rinv, ext, words;
  __host__ __device__ CoreLayout(int n, int m, int p, int qs, int exts,
                                 bool lu, bool once = false) {
    const int pn = p * n, d = n + m, W = n + m + pn;
    ldA = row_pad<T>(n);
    ldF = row_pad<T>(pn);
    int o = 0;
    q = o;  o += once ? 0 : qs;
    ub = o; o += round16<T>(m * m);
    bm = o; o += round16<T>(n * m);
    bk = o; o += round16<T>(W);
    buf = o;                          // one knot's operands; two buffers
    o = 2 * buf;
    if (once) {
      q = o;  o += qs;
    }
    a = o;  o += 3 * n * ldA;         // A ring: A_t, A_{t+1}, A_{t+2}
    gx = o; o += n * ldF;             // carry G_{t-1}, x rows
    yx = o; o += round16<T>(n);       // carry y_{t-1}, x rows
    fs = o;                           // F [n, ldF], then the step slots
    const int slots = lu ? d * d : 2 * d;
    o += round16<T>(n * ldF > slots ? n * ldF : slots);
    rinv = o; o += round16<T>(d);     // 1 / piv per step
    ext = o; o += round16<T>(exts);   // the Q form's products
    words = o;
  }
  // ints after the T arrays: the G-column table [pn], the pivot rows [d]
  __host__ __device__ static size_t bytes(int n, int m, int p, int qs,
                                          int exts, bool lu,
                                          bool once = false) {
    const CoreLayout L(n, m, p, qs, exts, lu, once);
    return L.words * sizeof(T) + (size_t)(p * n + n + m) * sizeof(int);
  }
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy ``rows`` rows of ``len`` contiguous elements (global row stride
// ``len``) into shared memory at row stride ``ld``, by cp.async: 16-byte
// pieces where both sides allow, else one element per copy.  Eight threads
// share a row, NT / 8 rows per pass (NT: the block's threads): no division.
template <typename T, int NT = kThreads>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows,
                                          int len, int ld) {
  const bool v16 = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) &&
                   ((len * (int)sizeof(T)) % 16 == 0) &&
                   ((ld * (int)sizeof(T)) % 16 == 0);
  const int per = v16 ? vec<T>() : 1;
  const int pieces = len / per;        // exact: len is a multiple when v16
  const int bytes = per * (int)sizeof(T);
  for (int r = threadIdx.x >> 3; r < rows; r += NT / 8)
    for (int c = threadIdx.x & 7; c < pieces; c += 8)
      cp_async(dst + r * ld + c * per, src + (size_t)r * len + c * per, bytes);
}

// One contiguous run of ``len`` elements.
template <typename T, int NT = kThreads>
__device__ __forceinline__ void copy_flat(T* dst, const T* src, int len) {
  const bool v16 = ((reinterpret_cast<uintptr_t>(src) & 15) == 0) &&
                   ((len * (int)sizeof(T)) % 16 == 0);
  const int per = v16 ? vec<T>() : 1;
  const int bytes = per * (int)sizeof(T);
  for (int c = threadIdx.x; c < len / per; c += NT)
    cp_async(dst + c * per, src + c * per, bytes);
}

template <typename T>
__device__ __forceinline__ T absval(T v) { return v < T(0) ? -v : v; }

// The sweep of lane blockIdx.x by a block of RG x kCG threads.
template <typename T, int TR, int TC, typename QForm, int RG = kRG>
__device__ __forceinline__ void forward_sweep(
    const QForm& qf, const T* __restrict__ Ubg, const T* __restrict__ Bg,
    const T* __restrict__ Ag, const T* __restrict__ bg,
    T* __restrict__ G_out, T* __restrict__ y_out, int Tn, int n, int m,
    int p, const int* owner, unsigned char* raw) {
  static_assert(RG == kRG || RG == kTallRG, "8 or 16 row groups");
  constexpr int kThr = RG * kCG;             // the block's threads
  constexpr int kRS = RG == kRG ? 3 : 4;     // log2(RG)
  // The pivot mask, a bit per row of the tile's TR x RG.
  using Mask =
      std::conditional_t<(TR * RG > 32), unsigned long long, unsigned>;
  const int pn = p * n, d = n + m, C = d + pn + 1, W = n + m + pn;
  const CoreLayout<T> L(n, m, p, qf.staged(n, p), qf.extra(n, m),
                        QForm::kLU, QForm::kStageOnce);
  T* sm = reinterpret_cast<T*>(raw);
  int* gcol = reinterpret_cast<int*>(sm + L.words);  // (i << 16) | cc
  int* pivrow = gcol + pn;
  T* Gx = sm + L.gx;
  T* yx = sm + L.yx;
  T* Fs = sm + L.fs;
  T* rinvs = sm + L.rinv;
  T* ext = sm + L.ext;
  const int tid = threadIdx.x, rg = tid & (RG - 1), cg = tid >> kRS;
  const int gbase = (tid & 31) & ~(RG - 1);
  const unsigned gmask = ((1u << RG) - 1u) << gbase;
  const size_t lane0 = (size_t)blockIdx.x * Tn;
  const int ldA = L.ldA, ldF = L.ldF;

  for (int i = 0; i < p; ++i)
    for (int cc = tid; cc < n; cc += kThr)
      gcol[i * n + cc] = (i << 16) | cc;
  for (int k = tid; k < n * ldF; k += kThr) Gx[k] = T(0);
  for (int k = tid; k < n; k += kThr) yx[k] = T(0);

  // Knot k's operands other than A into buffer k & 1 (the Q form's too,
  // unless staged once); A_k into ring slot ``slot`` (zeros where A_k does
  // not exist: k == Tn).
  auto issue = [&](int k) {
    T* buf = sm + (k & 1) * L.buf;
    const size_t kt = lane0 + k;
    if constexpr (!QForm::kStageOnce)
      qf.template issue<kThr>(buf + L.q, kt, n, p);
    copy_flat<T, kThr>(buf + L.ub, Ubg + kt * m * m, m * m);
    copy_flat<T, kThr>(buf + L.bm, Bg + kt * n * m, n * m);
    copy_flat<T, kThr>(buf + L.bk, bg + kt * W, W);
  };
  auto issue_A = [&](int k, int slot) {
    T* dst = sm + L.a + slot * n * ldA;
    if (k < Tn)
      copy_rows<T, kThr>(dst, Ag + (lane0 + k) * n * n, n, n, ldA);
    else
      for (int e = tid; e < n * ldA; e += kThr) dst[e] = T(0);
  };
  issue(0);
  if constexpr (QForm::kStageOnce)
    qf.template issue<kThr>(sm + L.q, lane0, n, p);
  issue_A(0, 0);
  issue_A(1, 1);
  cp_async_commit();

  // The owner of each owned control row, read once.
  int own[TR];
  #pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = rg + RG * i;
    own[i] = r < m ? owner[r] : -1;
  }

  T tile[TR][TC];
  int slot = 0;                        // ring slot of A_t
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = lane0 + t;
    cp_async_wait_all();
    __syncthreads();                   // knot t's operands and the carry
    const T* buf = sm + (t & 1) * L.buf;
    const T* Q = (QForm::kStageOnce ? sm : buf) + L.q;
    const T* Ub = buf + L.ub;
    const T* Bs = buf + L.bm;
    const T* bs = buf + L.bk;
    const T* At = sm + L.a + slot * n * ldA;
    const int slot1 = slot == 2 ? 0 : slot + 1;
    const int slot2 = slot1 == 2 ? 0 : slot1 + 1;
    const T* A1 = sm + L.a + slot1 * n * ldA;     // A_{t+1}, rows [cc][k]
    if (t + 1 < Tn) {
      issue(t + 1);
      issue_A(t + 2, slot2);
      cp_async_commit();
    }

    // Fill-in F = -A_t G_{t-1} [n, pn], register-tiled.
    {
      T acc[TR][TC];
      #pragma unroll
      for (int i = 0; i < TR; ++i)
        #pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = T(0);
      #pragma unroll 2
      for (int k = 0; k < n; ++k) {
        T av[TR], gv[TC];
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int a = rg + RG * i;
          av[i] = a < n ? At[a * ldA + k] : T(0);
        }
        #pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int c = cg + kCG * j;
          gv[j] = c < pn ? Gx[k * ldF + c] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < TR; ++i)
          #pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] += av[i] * gv[j];
      }
      #pragma unroll
      for (int i = 0; i < TR; ++i)
        #pragma unroll
        for (int j = 0; j < TC; ++j) {
          const int a = rg + RG * i, c = cg + kCG * j;
          if (a < n && c < pn) Fs[a * ldF + c] = -acc[i][j];
        }
    }
    __syncthreads();                   // F
    if constexpr (QForm::kProducts) {
      qf.template products<kThr>(Q, Bs, Fs, ext, ldF, owner, n, m, p);
      __syncthreads();                 // the Q form's products
    }

    // The augmented system, each owned entry an FMA chain from shared
    // memory.
    #pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int c = cg + kCG * j;
      T acc[TR];
      #pragma unroll
      for (int i = 0; i < TR; ++i) acc[i] = T(0);
      if (c < n) {                     // x columns
        qf.template x_column<RG>(acc, Q, Bs, Fs, ext, ldF, own, rg, c, n, m,
                                 p);
      } else if (c < d) {              // u columns
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = rg + RG * i;
          if (r < m)
            acc[i] = Ub[r * m + c - n];
          else if (r < d)
            acc[i] = Bs[(r - m) * m + c - n];
        }
      } else if (c < d + pn) {         // G right-hand sides
        const int code = gcol[c - d], blk = code >> 16, cc = code & 0xffff;
        const T* a1 = A1 + cc * ldA;
        #pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const T av = a1[k];
          #pragma unroll
          for (int i = 0; i < TR; ++i) {
            const int r = rg + RG * i;
            if (r < m) {               // owner-embedded B^T A_{t+1}^T
              if (own[i] == blk) acc[i] += Bs[k * m + r] * av;
            } else if (r < d) {        // F_i A_{t+1}^T
              acc[i] += Fs[(r - m) * ldF + blk * n + k] * av;
            }
          }
        }
      } else if (c < C) {              // y right-hand side
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = rg + RG * i;
          if (r < m) {                 // c + B^T a_owner
            const int o = own[i];
            T v = bs[pn + r];
            #pragma unroll 4
            for (int k = 0; k < n; ++k) v += Bs[k * m + r] * bs[o * n + k];
            acc[i] = v;
          } else if (r < d) {          // d0 - A_t y_{t-1} + F a
            const int a = r - m;
            T s1 = T(0), s2 = T(0);
            #pragma unroll 4
            for (int k = 0; k < n; ++k) s1 += At[a * ldA + k] * yx[k];
            #pragma unroll 4
            for (int k = 0; k < pn; ++k) s2 += Fs[a * ldF + k] * bs[k];
            acc[i] = bs[pn + m + a] - s1 + s2;
          }
        }
      }
      #pragma unroll
      for (int i = 0; i < TR; ++i) tile[i][j] = acc[i];
    }
    __syncthreads();                   // F is dead: the step slots reuse it
    if constexpr (QForm::kStageOnce) {  // and Q_t: Q_{t+1} streams in
      if (t + 1 < Tn) {
        qf.template issue<kThr>(sm + L.q, kt + 1, n, p);
        cp_async_commit();
      }
    }

    // The elimination: step s publishes the multipliers M[r, s] / piv of
    // every row (LU: of the rows not pivoted yet, and U[r, s] of the
    // others) in its slot, the pivot row and 1 / piv.  Gauss-Jordan uses
    // slot s & 1 (double-buffered: one barrier per step) and updates every
    // row but the pivot row, so that each pivot row ends with only its
    // pivot among the unknowns' columns; LU uses slot s and updates the
    // rows not pivoted yet.
    Mask used = 0u;
    int step_of[TR];
    #pragma unroll
    for (int i = 0; i < TR; ++i) step_of[i] = -1;
    #pragma unroll 1
    for (int s = 0; s < d; ++s) {
      const int js = s >> 4;           // s / kCG
      T* Ss = Fs + (QForm::kLU ? s : (s & 1)) * d;
      if (cg == (s & (kCG - 1))) {
        T col[TR];
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          T v = tile[i][0];
          #pragma unroll
          for (int j = 1; j < TC; ++j) v = (js == j) ? tile[i][j] : v;
          col[i] = v;
        }
        T best = T(-1);
        int bi = d;
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = rg + RG * i;
          if (r < d && !((used >> r) & 1u)) {
            const T a = absval(col[i]);
            if (bi == d || a > best) { best = a; bi = r; }
          }
        }
        #pragma unroll
        for (int off = RG / 2; off > 0; off >>= 1) {
          const T ob = __shfl_xor_sync(gmask, best, off);
          const int oi = __shfl_xor_sync(gmask, bi, off);
          // An empty lane (oi == d) never wins, so a column of NaNs still
          // yields a valid pivot row.
          if (oi != d && (bi == d || ob > best || (ob == best && oi < bi))) {
            best = ob;
            bi = oi;
          }
        }
        const int pr = __shfl_sync(gmask, bi, gbase);
        T mine = col[0];
        #pragma unroll
        for (int i = 1; i < TR; ++i)
          mine = ((pr >> kRS) == i) ? col[i] : mine;
        const T rinv =
            T(1) / __shfl_sync(gmask, mine, gbase | (pr & (RG - 1)));
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = rg + RG * i;
          if (r < d)
            Ss[r] = (QForm::kLU && ((used >> r) & 1u)) ? col[i]
                                                       : col[i] * rinv;
        }
        if (rg == 0) {
          pivrow[s] = pr;
          rinvs[s] = rinv;
        }
      }
      __syncthreads();                 // slot s
      const int pr = pivrow[s];
      const int src = gbase | (pr & (RG - 1)), ipr = pr >> kRS;
      T prow[TC];
      #pragma unroll
      for (int j = 0; j < TC; ++j) {
        T v = tile[0][j];
        #pragma unroll
        for (int i = 1; i < TR; ++i) v = (ipr == i) ? tile[i][j] : v;
        prow[j] = __shfl_sync(0xffffffffu, v, src);
      }
      #pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int r = rg + RG * i;
        const bool pending = !QForm::kLU || !((used >> r) & 1u);
        if (r < d && r != pr && pending) {
          const T l = Ss[r];
          #pragma unroll
          for (int j = 0; j < TC; ++j) tile[i][j] -= l * prow[j];
        }
        if (r == pr) step_of[i] = s;
      }
      used |= Mask(1) << pr;
    }

    if constexpr (QForm::kLU) {
      // Back substitution on the right-hand sides, last step first: x_s =
      // (pivot row of step s) / piv, taken by shuffle from the lane of each
      // column group that owns that row; every row pivoted before step s
      // takes RHS -= U[r, s] x_s.  Shuffles within the warp only.
      #pragma unroll 1
      for (int s = d - 1; s > 0; --s) {
        const int pr = pivrow[s];
        const T rinv = rinvs[s];
        const int src = gbase | (pr & (RG - 1)), ipr = pr >> kRS;
        const T* Us = Fs + s * d;
        T xs[TC];
        #pragma unroll
        for (int j = 0; j < TC; ++j) {
          T v = tile[0][j];
          #pragma unroll
          for (int i = 1; i < TR; ++i) v = (ipr == i) ? tile[i][j] : v;
          xs[j] = __shfl_sync(0xffffffffu, v, src) * rinv;
        }
        #pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int r = rg + RG * i;
          if (r < d && step_of[i] < s) {
            const T u = Us[r];
            #pragma unroll
            for (int j = 0; j < TC; ++j)
              if (cg + kCG * j >= d) tile[i][j] -= u * xs[j];
          }
        }
      }
    }

    // The unknowns: each pivot row's right-hand sides times 1 / piv.
    #pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rg + RG * i;
      if (r >= d) continue;
      const T rinv = rinvs[step_of[i]];
      #pragma unroll
      for (int j = 0; j < TC; ++j)
        if (cg + kCG * j >= d) tile[i][j] *= rinv;
    }

    // Outputs in (x, u) row order = step order (x columns first); the
    // carry keeps the x rows.
    #pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int r = rg + RG * i;
      if (r >= d) continue;
      const int var = step_of[i];
      #pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = cg + kCG * j - d;
        if (c < 0 || c > pn) continue;
        const T v = tile[i][j];
        if (c < pn) {
          G_out[(kt * d + var) * pn + c] = v;
          if (var < n) Gx[var * ldF + c] = v;
        } else {
          y_out[kt * d + var] = v;
          if (var < n) yx[var] = v;
        }
      }
    }
    slot = slot1;
  }
}

}  // namespace thomas_core
