// The per-player blocked forward sweep for the systems beyond the
// register-tiled classes up to d = 64: the "blocked" route of K1
// (thomas_sq.cu) and K3 (thomas_dense.cu), one 256-thread block per lane.
// The Q form is a compile-time policy (StructuredForm, DenseForm below): it
// decides what a knot stages, the layout words it adds, its products and
// K's x columns; everything else is shared.
//
// Replaces the forward half of algames_tpu/ops/thomas_pallas.py:566
// (solve_thomas_pallas_structured; the kernel _make_fwd_kernel_sq, :269-374)
// and of :424 (solve_thomas_pallas; _make_fwd_kernel, :114-228) at the
// widths the register-tiled classes do not hold: the 4-player quadrotor's
// systems (n=48, m=16, p=4, NW=20: d = n + m = 64, R = p n + 1 = 193), with
// collision-cost pairs K3's; the 3-player quadrotor's turned dense (d=48);
// the 6-player unicycle's (d=36).  Per lane and knot t it computes what
// every forward kernel of both computes -- the fill-in F = -A_t G_{t-1}, K
// = [[Ub, B^T Q_o], [B, -I + sum_i F_i Q_i]] (K1: Q_i = diag(q_i) +
// sum_{owner(k) = i} w_k w_k^T; K3: Q_i dense), the right-hand sides
// [owner-embedded B^T A_{t+1}^T | c + B^T a_o] and [F_i A_{t+1}^T | d0 -
// A_t y_{t-1} + F a], and the solve with the x columns eliminated first,
// row partial pivoting on the unused row of largest magnitude and the
// lowest index on ties -- and writes G_t, y_t in (x, u) row order for the
// unchanged backward kernels.
//
// What bounds it on the card: neither bytes (~0.11 MB a lane and knot in
// f32) nor operations (~1.8 M multiply-adds: the fill-in and F A^T 0.88 M,
// the substitutions 0.79 M, the LU 0.09 M; K3's F_i Q_i 0.44 M more), but
// latency.  On an H100 80GB HBM3 at 700 W (tests/k1_blocked_clocks.py, one
// lane an SM, quad4's systems) K1's knot takes about 222,000 SM cycles in
// f32 and 257,000 in f64: the LU 112,000 / 123,000 (its 64 pivot steps are
// one dependent chain of a butterfly, a barrier, a shuffle and the tile's
// update, about 1,750 cycles a step), the substitutions 49,000 / 55,000,
// the fill-in 19,000 / 24,000, the right-hand sides 19,000 / 25,000, K and
// Pw 16,000 / 20,000.  K3's (--form dense) about as many: its per-player
// F_i Q_i and B^T Q_i 22,000 / 27,000 and the Q_i slots' waits 3,000 in the
// place of K and Pw.  A second lane on the SM (f32) fills the LU's idle
// issue slots: 1,024 lanes take 1.2 x the cycles a knot of one lane, in
// half the waves.
//
// Design (what does not fit an SM at these widths is F whole, the carry, K,
// the right-hand sides and the knot operands all at once: the shared-memory
// kernel needs 443 KB in f64):
//   - One buffer X [d, R] holds the carry, then F, then the right-hand
//     sides, then the solution.  At the knot's start its rows 0..n-1 are
//     G_{t-1}'s x rows and column p n is y_{t-1}, as the previous knot left
//     them (zero at t = 0).  u = y_{t-1} + G_{t-1} a (four lanes a row),
//     which gives the y column's d0 - A_t u = d0 - A_t y_{t-1} + F a.
//   - The fill-in F = -A_t G_{t-1} is a register-tiled product from shared
//     memory (thread (rg, cg) = (tid % 16, tid / 16) owns rows rg + 16 i
//     and columns cg + 16 j, 3 x 6 a pass: two players' blocks), written
//     over the carry in place after a barrier: F is never held apart from
//     the carry.  (Player by player, four passes of 3 x 3 took about as
//     long: 18,300 cycles a knot.)
//   - K is built straight into registers, a 4 x 4 tile a thread (d <= 64):
//     its x columns by the Q form (K1: the products Pw [d, NW] (B^T w_k on
//     the owner's statu rows, F_owner(k) w_k on the dyn rows), then
//     StructuredQ's order: sum_i F_i q_i, the rank-1 terms; K3: a pass a
//     player, F_i Q_i on the dyn rows and B^T Q_i on the player's statu
//     rows, Q_i [n, n] staged by cp.async in one of two slots while the
//     previous player's pass runs: the whole Q, p n^2 scalars, would cost
//     f32 its second lane an SM and not fit at all in f64), then the u
//     columns and -I.
//   - LU of K in registers, one block barrier a pivot step: the 16 holders
//     of column s (one half-warp) find the pivot by a butterfly and publish
//     the multipliers K[r, s] / piv of the unused rows in column s of the
//     slots Ks (d x d, in zeros up to a multiple of 16 rows and columns);
//     every thread takes the pivot row by a shuffle within its warp and
//     updates its tile.  Every warp runs the butterfly
//     (on empty candidates but the holders) so that its shuffles are
//     converged, and every index into the tile is a compile-time constant
//     (selects), which keeps the tile in registers.  Then L (the slots) and
//     U (the tiles) are written back to Ks in pivot order.  (One warp
//     factoring K in shared memory beside the other warps building the
//     right-hand sides took 228,000 cycles a knot: one warp cannot hide its
//     own load latency.)  The LU of K comes before the right-hand sides so
//     that these are built straight in pivot order.
//   - The right-hand sides, block i: [B^T A_{t+1}^T on player i's statu
//     rows; F_i A_{t+1}^T] is one register-tiled product (d x n x n), read
//     from F_i in X and written over it, row e at pos[e], after a barrier.
//   - Forward and back substitution over the R right-hand sides, every sum
//     in the unblocked order.  f32 (128 registers a thread, 2 lanes an SM):
//     X in registers, a 4 x 13 tile a thread (208 columns a pass); each
//     warp owns two column groups, so every step's pivot row comes by a
//     shuffle within the warp, and the step is a rank-1 update of the tile:
//     no barrier.  f64 (1 lane an SM; K1 254 registers, K3 255 and a
//     24-byte frame): by panels of 16 pivot
//     steps, warp w holding panel w / 2 of 128 columns (4 a lane, 16 rows);
//     once panel Q is solved and in X, every later panel takes the rank-16
//     update z -= L[rows, Q] z_Q, a register-tiled product with L's entries
//     read alike by the whole warp; then a panel solves its own triangle;
//     one barrier a panel (55,000 cycles a knot, the shuffles 78,000; in f32
//     at 128 registers the panels took 107,000, their L loads exposed).  The
//     solution lands in X in variable order: the outputs and the next
//     knot's carry.
//   - Knot t+1's B, Ub, b, the Q form's operands (K1: q and w; K3: Q_0)
//     and A_{t+2} (A is a ring of two: A_{t+2} over A_t once F is formed)
//     are copied in by cp.async while knot t is eliminated.
// Products are FMA (f32) and DFMA (f64) on the CUDA cores: they are
// 48-wide and bound by shared-memory loads and latency, not by FMA issue,
// so the FP64 tensor cores (mma.sync m8n8k4) would not shorten them, and
// one code path serves both types.  Nothing calls a library.
//
// Shared memory a lane at the 4-player quadrotor's widths: K1 101,328 bytes
// in f32 (2 lanes an SM) and 202,000 in f64 (1); K3 109,696 and 218,816;
// see smem_bytes().  The route takes d <= 64 and at most 32 control rows
// within 232,448 bytes: K1's w vectors are bounded by those bytes alone
// (the 9-player unicycle merge, NW = 72: 131,736 bytes a lane in f32, and
// in f64 231,064 with Pw over Ks, see Layout).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "thomas_dense_core.cuh"

namespace thomas_blocked {

constexpr int kRG = 16;               // row groups
constexpr int kCG = 16;               // column groups
constexpr int kThreads = kRG * kCG;   // threads a lane
constexpr int kDT = 4;                // row and column tiles of K: d <= 64
constexpr int kFT = 6;                // column tiles of a fill-in pass
constexpr int kZT = 13;               // column tiles of an f32 pass
constexpr int kPR = 16;               // rows of an f64 substitution panel

constexpr int kMaxSmem = 232448;      // shared memory a block may have

__host__ __device__ inline int odd(int x) { return x | 1; }
// d up to a multiple of 16: the rows and columns of Ks.
__host__ __device__ inline int panels(int d) {
  return (d + kPR - 1) / kPR * kPR;
}

// Shared-memory layout of a lane, in elements of T (then ints).  Odd row
// strides put 16 consecutive rows of one column in 16 different banks.  Ks
// is K padded with zeros to panels(d) rows and columns: the f64
// substitution's 16-row panels read all of them.  The Q form QF sizes its
// own words: ``q``, what it stages a knot (QF::staged: K1's q [p, n], K3's
// two slots of one player's Q_i); ``w``, K1's w [NW, n] (NW = 0 for K3);
// ``Pw``, its products [d, NW] (K1's, QF::kStructured; K3 has none), in
// words of its own or, with kPwInK, over K's slots Ks: Pw is dead once K is
// in registers and the slots are first written by the LU after it, so the
// two never live at once (where d ldP <= panels(d) ldK; forward_sweep
// zeroes the words of Ks outside K's d x d again after K is built).  That
// sheds Pw's bytes where the layout would not fit a block otherwise: the
// 9-player unicycle merge in f64 (n=36, m=18, p=9, NW=72) needs 262,600
// bytes with Pw resident and 231,064 with Pw in Ks.
template <typename T, typename QF, bool kPwInK = false>
struct Layout {
  int ldX, ldK, ldA, ldP;
  int X, K, A, Bs, q, w, bk, Ub, Pw, yr, u, rinv, words;
  __host__ __device__ Layout(int n, int m, int p, int NW) {
    const int d = n + m, pn = p * n, R = pn + 1, W = n + m + pn;
    ldX = odd(R);
    ldK = odd(panels(d));
    ldA = odd(n);
    ldP = odd(NW);
    int o = 0;
    X = o;    o += thomas_core::round16<T>(d * ldX);
    K = o;    o += thomas_core::round16<T>(panels(d) * ldK);
    A = o;    o += thomas_core::round16<T>(2 * n * ldA);
    Bs = o;   o += thomas_core::round16<T>(n * m);
    q = o;    o += thomas_core::round16<T>(QF::staged(n, p));
    w = o;    o += thomas_core::round16<T>(NW * n);
    bk = o;   o += thomas_core::round16<T>(W);
    Ub = o;   o += thomas_core::round16<T>(m * m);
    if (kPwInK) {
      Pw = K;
    } else {
      Pw = o; o += thomas_core::round16<T>(QF::kStructured ? d * ldP : 0);
    }
    yr = o;   o += thomas_core::round16<T>(d);
    u = o;    o += thomas_core::round16<T>(n);
    rinv = o; o += thomas_core::round16<T>(d);
    words = o;
  }
};

// Bytes a lane: the layout, then pivrow [d], pos [d], owner [m], w_owner
// [NW] as ints.
template <typename T, typename QF, bool kPwInK = false>
size_t smem_bytes(int n, int m, int p, int NW) {
  return Layout<T, QF, kPwInK>(n, m, p, NW).words * sizeof(T) +
         (size_t)(2 * (n + m) + m + NW) * sizeof(int);
}

// Whether the route takes these widths (kPwInK: with Pw over Ks).  Shared
// memory bounds m and NW; no table of a fixed size does.
template <typename T, typename QF, bool kPwInK = false>
bool fits(int n, int m, int p, int NW) {
  const int d = n + m;
  if (kPwInK && d * odd(NW) > panels(d) * odd(panels(d))) return false;
  return n >= 1 && p >= 1 && m >= 1 && d <= kRG * kDT &&
         smem_bytes<T, QF, kPwInK>(n, m, p, NW) <= (size_t)kMaxSmem;
}

// K1's Q form: Q_i = diag(q_i) + sum_{owner(k) = i} w_k w_k^T, staged a
// knot as q [p, n] (from qd [B, T, p, n]) and w [NW, n] (from wv [B, T, NW,
// n]); its products Pw [d, NW] (B^T w_k on the statu rows of w_k's owner, 0
// on the others; F_owner(k) w_k on the dyn rows), then K's x columns in
// StructuredQ's order: sum_i F_i diag(q_i), then the rank-1 terms.  Its
// statements are written out in forward_sweep under kStructured: moved
// into functions of the form (forced inline), the same statements compiled
// to other SASS for K1's instances (tests/sass_compare.py).
template <typename T>
struct StructuredForm {
  static constexpr bool kStructured = true;
  __host__ __device__ static int staged(int n, int p) { return p * n; }
};

// K3's Q form: every player's dense Q_i [n, n] (collision-cost pairs make
// them full), staged a player at a time into two slots by cp.async: player
// 0's with the knot's other operands, player i + 1's while player i's pass
// runs.  Player i's pass adds F_i Q_i to K's dyn rows and sets B^T Q_i on
// the statu rows that player i owns, each entry summed over k ascending,
// the players in order (thomas_dense.cu's DenseForm order).  No products.
// Its operand: Qg [B, T, p, n, n].
template <typename T>
struct DenseForm {
  static constexpr bool kStructured = false;

  __host__ __device__ static int slot(int n) {
    return thomas_core::round16<T>(n * n);
  }
  __host__ __device__ static int staged(int n, int) { return 2 * slot(n); }

  // Knot kt's Q_0 into slot 0.
  __device__ static __forceinline__ void issue(T* q, const T* Qg, size_t kt,
                                               int n, int p) {
    thomas_core::copy_flat<T, kThreads>(q, Qg + kt * p * n * n, n * n);
  }

  // K's x columns (c < n) into the tile kx: rows e = rg + 16 i, columns
  // c = cg + 16 j; knot kt's Q_0 in slot 0.
  __device__ static __forceinline__ void x_columns(
      T (&kx)[kDT][kDT], T* q, const T* X, const T* Bs, const int* own,
      const T* Qg, size_t kt, int ldX, int n, int m, int p, int rg, int cg) {
    const int d = n + m, nn = n * n, sl = slot(n);
    #pragma unroll
    for (int i = 0; i < kDT; ++i)
      #pragma unroll
      for (int j = 0; j < kDT; ++j) kx[i][j] = T(0);
    #pragma unroll 1
    for (int i2 = 0; i2 < p; ++i2) {
      if (i2 > 0) {
        thomas_core::cp_async_wait_all();
        __syncthreads();               // Q_i2 in; the other slot read
      }
      if (i2 + 1 < p) {                // player i2 + 1 streams in
        thomas_core::copy_flat<T, kThreads>(q + ((i2 + 1) & 1) * sl,
                                            Qg + (kt * p + i2 + 1) * nn, nn);
        thomas_core::cp_async_commit();
      }
      const T* Qi = q + (i2 & 1) * sl;
      // Row e's left factor: B[:, e] on player i2's statu rows, F_i2[e - m,
      // :] on the dyn rows.  (Offsets from X in the place of these
      // pointers took the f32 instance of quad4's n = 48 9% longer a call:
      // its right-hand sides ran 36,900 SM cycles a knot, not 19,200.)
      const T* ap[kDT];
      int as[kDT];
      bool live[kDT];
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int e = rg + kRG * i;
        live[i] = e < d && (e >= m || own[e] == i2);
        ap[i] = e < m ? Bs + e : X + (e < d ? (e - m) * ldX + i2 * n : 0);
        as[i] = e < m ? m : 1;
      }
      #pragma unroll 4
      for (int k = 0; k < n; ++k) {
        T qv[kDT];
        #pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const int c = cg + kCG * j;
          qv[j] = c < n ? Qi[k * n + c] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < kDT; ++i)
          if (live[i]) {
            const T av = ap[i][k * as[i]];
            #pragma unroll
            for (int j = 0; j < kDT; ++j) kx[i][j] += av * qv[j];
          }
      }
    }
  }
};

// The forward sweep of lane blockIdx.x: G [B, T, d, p n] and y_hat [B, T, d]
// in (x, u) row order.  NI: tiles of 16 that cover n; QF: the Q form and
// qd, wv its operands (StructuredForm: q and w, NW w vectors owned per
// w_owner; DenseForm: Q, wv unused, NW = 0); kPwInK: Pw over Ks (Layout).
template <typename T, int NI, typename QF, bool kPwInK = false>
__device__ __forceinline__ void forward_sweep(
    const T* __restrict__ qd, const T* __restrict__ wv,
    const T* __restrict__ Ubg, const T* __restrict__ Bg,
    const T* __restrict__ Ag, const T* __restrict__ bg, T* __restrict__ G_out,
    T* __restrict__ y_out, int Tn, int n, int m, int p, int NW,
    const int* owner, const int* w_owner, unsigned char* raw) {
  static_assert(NI >= 1 && NI <= kDT, "n <= 64");
  const int pn = p * n, d = n + m, R = pn + 1, W = n + m + pn;
  const Layout<T, QF, kPwInK> L(n, m, p, NW);
  T* sm = reinterpret_cast<T*>(raw);
  T* X = sm + L.X;
  T* Ks = sm + L.K;
  T* Abuf = sm + L.A;
  T* Bs = sm + L.Bs;
  T* q = sm + L.q;
  T* w = sm + L.w;
  T* bs = sm + L.bk;
  T* Ub = sm + L.Ub;
  T* Pw = sm + L.Pw;
  T* yr = sm + L.yr;
  T* uv = sm + L.u;
  T* rinvs = sm + L.rinv;
  int* pivrow = reinterpret_cast<int*>(sm + L.words);
  int* pos = pivrow + d;
  int* own = pos + d;
  int* wown = own + m;
  const int ldX = L.ldX, ldK = L.ldK, ldA = L.ldA, ldP = L.ldP;
  const int tid = threadIdx.x, rg = tid & (kRG - 1), cg = tid / kRG;
  const int lane = tid & 31, gbase = lane & 16;
  const unsigned gmask = 0xffffu << gbase;   // this half-warp
  const size_t lane0 = (size_t)blockIdx.x * Tn;

  for (int r = tid; r < m; r += kThreads) own[r] = owner[r];
  for (int k = tid; k < NW; k += kThreads) wown[k] = w_owner[k];
  for (int e = tid; e < d * ldX; e += kThreads) X[e] = T(0);
  // Ks's words outside K's d x d, which no knot writes, stay 0: where d is
  // no multiple of 16 the f64 substitution's last panel reads them as the
  // multipliers of its rows past d and of the zeros those rows hold, so
  // that these rows stay 0 and add 0 to the others.
  for (int e = tid; e < panels(d) * ldK; e += kThreads) Ks[e] = T(0);

  // Knot k's operands but A (the Q form's first); A_k into ring slot k & 1
  // (zeros at k == Tn).
  auto issue = [&](int k) {
    const size_t kt = lane0 + k;
    if constexpr (QF::kStructured) {
      thomas_core::copy_flat<T, kThreads>(q, qd + kt * pn, pn);
      thomas_core::copy_flat<T, kThreads>(w, wv + kt * NW * n, NW * n);
    } else {
      QF::issue(q, qd, kt, n, p);
    }
    thomas_core::copy_flat<T, kThreads>(Ub, Ubg + kt * m * m, m * m);
    thomas_core::copy_flat<T, kThreads>(Bs, Bg + kt * n * m, n * m);
    thomas_core::copy_flat<T, kThreads>(bs, bg + kt * W, W);
  };
  auto issue_A = [&](int k) {
    T* dst = Abuf + (k & 1) * n * ldA;
    if (k < Tn)
      thomas_core::copy_rows<T, kThreads>(dst, Ag + (lane0 + k) * n * n, n,
                                          n, ldA);
    else
      for (int e = tid; e < n * ldA; e += kThreads) dst[e] = T(0);
  };
  issue(0);
  issue_A(0);
  issue_A(1);
  thomas_core::cp_async_commit();

  #pragma unroll 1
  for (int t = 0; t < Tn; ++t) {
    const size_t kt = lane0 + t;
    thomas_core::cp_async_wait_all();
    __syncthreads();                   // knot t's operands and the carry
    const T* At = Abuf + (t & 1) * n * ldA;
    const T* A1 = Abuf + ((t + 1) & 1) * n * ldA;   // A_{t+1}, rows [cc][k]

    // u = y_{t-1} + G_{t-1} a over the x rows: lane `part` of four sums a
    // quarter of the row, then two shuffles add the quarters.
    {
      const int k = tid >> 2, part = tid & 3;
      const int len = (pn + 3) >> 2, j0 = part * len;
      const int j1 = j0 + len < pn ? j0 + len : pn;
      T s = T(0);
      if (k < n) {
        const T* g = X + k * ldX;
        for (int j = j0; j < j1; ++j) s += g[j] * bs[j];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (k < n && part == 0) uv[k] = X[k * ldX + pn] + s;
    }

    // The fill-in F = -A_t G_{t-1}, every player's block at once (rows
    // a = rg + 16 i, columns c0 + cg + 16 j), written over the carry in
    // place after a barrier; with the first chunk, the y column.
    #pragma unroll 1
    for (int c0 = 0; c0 < pn; c0 += kCG * kFT) {
      T acc[NI][kFT];
      #pragma unroll
      for (int i = 0; i < NI; ++i)
        #pragma unroll
        for (int j = 0; j < kFT; ++j) acc[i][j] = T(0);
      #pragma unroll 1
      for (int k = 0; k < n; ++k) {
        T av[NI], gv[kFT];
        #pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int a = rg + kRG * i;
          av[i] = a < n ? At[a * ldA + k] : T(0);
        }
        #pragma unroll
        for (int j = 0; j < kFT; ++j) {
          const int c = c0 + cg + kCG * j;
          gv[j] = c < pn ? X[k * ldX + c] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < NI; ++i)
          #pragma unroll
          for (int j = 0; j < kFT; ++j) acc[i][j] += av[i] * gv[j];
      }
      __syncthreads();                 // these columns (and, c0 = 0, u) read
      #pragma unroll
      for (int i = 0; i < NI; ++i)
        #pragma unroll
        for (int j = 0; j < kFT; ++j) {
          const int a = rg + kRG * i, c = c0 + cg + kCG * j;
          if (a < n && c < pn) X[a * ldX + c] = -acc[i][j];
        }
      if (c0 == 0 && tid < d) {        // y column, equation row e
        const int e = tid;
        T v;
        if (e < m) {                   // c + B^T a_owner
          const int o = own[e];
          v = bs[pn + e];
          for (int k = 0; k < n; ++k) v += Bs[k * m + e] * bs[o * n + k];
        } else {                       // d0 - A_t u
          const int a = e - m;
          T s = T(0);
          for (int k = 0; k < n; ++k) s += At[a * ldA + k] * uv[k];
          v = bs[pn + m + a] - s;
        }
        yr[e] = v;
      }
    }
    __syncthreads();                   // F; A_t is dead
    if (t + 2 <= Tn) {
      issue_A(t + 2);
      thomas_core::cp_async_commit();
    }

    // The Q form's products (K1's Pw), then K in registers: rows e = rg +
    // 16 i, columns c = cg + 16 j; its x columns from the Q form, then the
    // u columns [Ub; B] and -I.
    if constexpr (QF::kStructured) {
      // Pw [d, NW]: B[:, e] . w_k on the statu rows of w_k's owner (0 on the
      // others), F_owner(k)[e - m, :] . w_k on the dyn rows.
      #pragma unroll 1
      for (int kk = 0; kk * kCG < NW; ++kk) {
        const int k = cg + kCG * kk;
        if (k < NW) {
          const int o = wown[k];
          const T* wk = w + k * n;
          const T* ap[kDT];
          int as[kDT];
          bool live[kDT];
          #pragma unroll
          for (int i = 0; i < kDT; ++i) {
            const int e = rg + kRG * i;
            live[i] = e < d && (e >= m || own[e] == o);
            ap[i] = e < m ? Bs + e : X + (e < d ? (e - m) * ldX + o * n : 0);
            as[i] = e < m ? m : 1;
          }
          T acc[kDT];
          #pragma unroll
          for (int i = 0; i < kDT; ++i) acc[i] = T(0);
          #pragma unroll 4
          for (int j = 0; j < n; ++j) {
            const T wj = wk[j];
            #pragma unroll
            for (int i = 0; i < kDT; ++i)
              if (live[i]) acc[i] += ap[i][j * as[i]] * wj;
          }
          #pragma unroll
          for (int i = 0; i < kDT; ++i) {
            const int e = rg + kRG * i;
            if (e < d) Pw[e * ldP + k] = acc[i];
          }
        }
      }
      __syncthreads();                   // Pw

    }
    T kx[kDT][kDT];
    if constexpr (QF::kStructured) {
      #pragma unroll
      for (int i = 0; i < kDT; ++i)
        #pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const int e = rg + kRG * i, c = cg + kCG * j;
          kx[i][j] = (e < m && c < n) ? Bs[c * m + e] * q[own[e] * n + c]
                                      : T(0);
        }
      #pragma unroll 1
      for (int i2 = 0; i2 < p; ++i2) {   // sum_i F_i diag(q_i), dyn rows
        T qv[kDT];
        #pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const int c = cg + kCG * j;
          qv[j] = c < n ? q[i2 * n + c] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < kDT; ++i) {
          const int e = rg + kRG * i;
          if (e >= m && e < d) {
            const T* f = X + (e - m) * ldX + i2 * n;
            #pragma unroll
            for (int j = 0; j < kDT; ++j) {
              const int c = cg + kCG * j;
              if (c < n) kx[i][j] += f[c] * qv[j];
            }
          }
        }
      }
      #pragma unroll 1
      for (int k = 0; k < NW; ++k) {     // the rank-1 terms, every row
        T wkv[kDT];
        #pragma unroll
        for (int j = 0; j < kDT; ++j) {
          const int c = cg + kCG * j;
          wkv[j] = c < n ? w[k * n + c] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < kDT; ++i) {
          const int e = rg + kRG * i;
          const T pw = e < d ? Pw[e * ldP + k] : T(0);
          #pragma unroll
          for (int j = 0; j < kDT; ++j) {
            const int c = cg + kCG * j;
            if (c < n) kx[i][j] += pw * wkv[j];
          }
        }
      }
      if constexpr (kPwInK) {
        // Pw read; the words of Ks it covered outside K's d x d back to 0
        // (the LU writes only inside, so no barrier before it).
        __syncthreads();
        for (int e = tid; e < d * ldP; e += kThreads) {
          const int r = e / ldK, c = e - r * ldK;
          if (r >= d || c >= d) Ks[e] = T(0);
        }
      }
    } else {
      QF::x_columns(kx, q, X, Bs, own, qd, kt, ldX, n, m, p, rg, cg);
    }
    #pragma unroll
    for (int i = 0; i < kDT; ++i)
      #pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const int e = rg + kRG * i, c = cg + kCG * j;
        if (e >= d || c >= d) continue;
        if (c >= n)                    // u columns [Ub; B]
          kx[i][j] = e < m ? Ub[e * m + c - n] : Bs[(e - m) * m + c - n];
        else if (e >= m && e - m == c)
          kx[i][j] += T(-1);
      }

    // LU of K in registers: at step s the half-warp cg == s % 16 holds
    // column s; the unused row of largest magnitude, the lowest index on
    // ties, by a butterfly over each half-warp carrying the pivot's signed
    // value (every warp runs it, on empty candidates but one, so that its
    // shuffles are converged); the holders publish the multipliers K[r, s]
    // (1 / piv) of the unused rows in column s of the slots Ks; one barrier;
    // every thread takes the pivot row by a shuffle within its warp and
    // updates its tile.
    unsigned long long used = 0ull;
    int step_of[kDT];
    #pragma unroll
    for (int i = 0; i < kDT; ++i) step_of[i] = -1;
    #pragma unroll 1
    for (int s = 0; s < d; ++s) {
      const int js = s >> 4;
      const bool holder = cg == (s & (kCG - 1));
      T col[kDT];
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        T v = kx[i][0];
        #pragma unroll
        for (int j = 1; j < kDT; ++j) v = (js == j) ? kx[i][j] : v;
        col[i] = v;
      }
      T best = T(-1), val = T(0);
      int bi = d;
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int r = rg + kRG * i;
        if (holder && r < d && !((used >> r) & 1ull)) {
          const T a = thomas_core::absval(col[i]);
          if (bi == d || a > best) {
            best = a;
            bi = r;
            val = col[i];
          }
        }
      }
      #pragma unroll
      for (int off = kRG / 2; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const T ov = __shfl_xor_sync(0xffffffffu, val, off);
        // An empty lane (oi == d) never wins, so a column of NaNs still
        // yields a valid pivot row.
        if (oi != d && (bi == d || ob > best || (ob == best && oi < bi))) {
          best = ob;
          bi = oi;
          val = ov;
        }
      }
      if (holder) {
        const T rinv = T(1) / val;
        #pragma unroll
        for (int i = 0; i < kDT; ++i) {
          const int r = rg + kRG * i;
          if (r < d && !((used >> r) & 1ull)) Ks[r * ldK + s] = col[i] * rinv;
        }
        if (rg == 0) {
          pivrow[s] = bi;
          pos[bi] = s;
          rinvs[s] = rinv;
        }
      }
      __syncthreads();                 // slot s
      const int pr = pivrow[s];
      const int src = gbase | (pr & (kRG - 1)), ipr = pr >> 4;
      T prow[kDT];
      #pragma unroll
      for (int j = 0; j < kDT; ++j) {
        T v = kx[0][j];
        #pragma unroll
        for (int i = 1; i < kDT; ++i) v = (ipr == i) ? kx[i][j] : v;
        prow[j] = __shfl_sync(0xffffffffu, v, src);
      }
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int r = rg + kRG * i;
        if (r < d && r != pr && !((used >> r) & 1ull)) {
          const T l = Ks[r * ldK + s];
          #pragma unroll
          for (int j = 0; j < kDT; ++j) kx[i][j] -= l * prow[j];
        }
        if (r == pr) step_of[i] = s;
      }
      used |= 1ull << pr;
    }
    // L below the pivots (the slots), U on and above them (the tile), in
    // pivot order: row r of K becomes row step_of(r), through registers.
    #pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int r = rg + kRG * i;
      #pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const int c = cg + kCG * j;
        if (r < d && c < step_of[i]) kx[i][j] = Ks[r * ldK + c];
      }
    }
    __syncthreads();                   // every slot read
    #pragma unroll
    for (int i = 0; i < kDT; ++i) {
      if (rg + kRG * i >= d) continue;
      #pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const int c = cg + kCG * j;
        if (c < d) Ks[step_of[i] * ldK + c] = kx[i][j];
      }
    }

    // The right-hand sides in pivot order, block by block: [B^T A_{t+1}^T
    // on block b's statu rows (0 on the others); F_b A_{t+1}^T], read from
    // F_b in X and written over it, equation row e to row pos[e], after a
    // barrier; the y column with the first block.
    #pragma unroll 1
    for (int b = 0; b < p; ++b) {
      const T* ap[kDT];
      int as[kDT];
      bool live[kDT];
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int e = rg + kRG * i;
        live[i] = e < d && (e >= m || own[e] == b);
        ap[i] = e < m ? Bs + e : X + (e < d ? (e - m) * ldX + b * n : 0);
        as[i] = e < m ? m : 1;
      }
      T acc[kDT][NI];
      #pragma unroll
      for (int i = 0; i < kDT; ++i)
        #pragma unroll
        for (int j = 0; j < NI; ++j) acc[i][j] = T(0);
      #pragma unroll 4
      for (int k = 0; k < n; ++k) {
        T bv[NI];
        #pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int cc = cg + kCG * j;
          bv[j] = cc < n ? A1[cc * ldA + k] : T(0);
        }
        #pragma unroll
        for (int i = 0; i < kDT; ++i)
          if (live[i]) {
            const T av = ap[i][k * as[i]];
            #pragma unroll
            for (int j = 0; j < NI; ++j) acc[i][j] += av * bv[j];
          }
      }
      __syncthreads();                 // block b's F read
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int e = rg + kRG * i;
        if (e >= d) continue;
        T* row = X + pos[e] * ldX + b * n;
        #pragma unroll
        for (int j = 0; j < NI; ++j) {
          const int cc = cg + kCG * j;
          if (cc < n) row[cc] = acc[i][j];
        }
      }
      if (b == 0)
        for (int e = tid; e < d; e += kThreads) X[pos[e] * ldX + pn] = yr[e];
    }
    __syncthreads();                   // the right-hand sides, L\U
    if (t + 1 < Tn) {                  // knot t+1's operands stream in
      issue(t + 1);
      thomas_core::cp_async_commit();
    }

    // Forward and back substitution over the R right-hand sides, L and U
    // from Ks in pivot order, every sum in the unblocked order (s
    // increasing forward, decreasing back, x_s = z_s (1 / piv_s)); the
    // solution lands in X in variable order.
    if constexpr (sizeof(T) == 4) {
      // f32 (128 registers a thread, 2 lanes an SM): X in registers, rows
      // v = rg + 16 i and columns c0 + cg + 16 j of a pass; step s's row
      // comes by a shuffle from its owner in the warp, and the step is a
      // rank-1 update of the tile: no barrier.
      const T* lrow[kDT];
      #pragma unroll
      for (int i = 0; i < kDT; ++i) {
        const int v = rg + kRG * i;
        lrow[i] = Ks + (v < d ? v : 0) * ldK;
      }
      #pragma unroll 1
      for (int c0 = 0; c0 < R; c0 += kCG * kZT) {
        T z[kDT][kZT];
        #pragma unroll
        for (int i = 0; i < kDT; ++i)
          #pragma unroll
          for (int j = 0; j < kZT; ++j) {
            const int v = rg + kRG * i, c = c0 + cg + kCG * j;
            z[i][j] = (v < d && c < R) ? X[v * ldX + c] : T(0);
          }
        #pragma unroll
        for (int is = 0; is < kDT; ++is) {
          #pragma unroll 1
          for (int sl = 0; sl < kRG; ++sl) {
            const int s = kRG * is + sl;
            if (s >= d - 1) break;
            T zs[kZT];
            #pragma unroll
            for (int j = 0; j < kZT; ++j)
              zs[j] = __shfl_sync(0xffffffffu, z[is][j], gbase | sl);
            if (rg > sl) {
              const T l = lrow[is][s];
              #pragma unroll
              for (int j = 0; j < kZT; ++j) z[is][j] -= l * zs[j];
            }
            #pragma unroll
            for (int i = is + 1; i < kDT; ++i) {
              const T l = lrow[i][s];
              #pragma unroll
              for (int j = 0; j < kZT; ++j) z[i][j] -= l * zs[j];
            }
          }
        }
        #pragma unroll
        for (int is = kDT - 1; is >= 0; --is) {
          #pragma unroll 1
          for (int sl = kRG - 1; sl >= 0; --sl) {
            const int s = kRG * is + sl;
            if (s >= d) continue;
            const T ri = rinvs[s];
            T xs[kZT];
            #pragma unroll
            for (int j = 0; j < kZT; ++j)
              xs[j] = __shfl_sync(0xffffffffu, z[is][j], gbase | sl) * ri;
            if (rg == sl) {
              #pragma unroll
              for (int j = 0; j < kZT; ++j) z[is][j] = xs[j];
            } else if (rg < sl) {
              const T u = lrow[is][s];
              #pragma unroll
              for (int j = 0; j < kZT; ++j) z[is][j] -= u * xs[j];
            }
            #pragma unroll
            for (int i = 0; i < is; ++i) {
              const T u = lrow[i][s];
              #pragma unroll
              for (int j = 0; j < kZT; ++j) z[i][j] -= u * xs[j];
            }
          }
        }
        #pragma unroll
        for (int i = 0; i < kDT; ++i)
          #pragma unroll
          for (int j = 0; j < kZT; ++j) {
            const int v = rg + kRG * i, c = c0 + cg + kCG * j;
            if (v < d && c < R) X[v * ldX + c] = z[i][j];
          }
      }
    } else {
      // f64 (255 registers, 1 lane an SM): by panels of 16 rows, warp w
      // holding panel w / 2 of the columns lane + 32 (w % 2) + 64 k in
      // registers.  Once panel Q is solved and in X, every later panel
      // takes the rank-16 update z -= L[rows, Q] z_Q, L's entries read
      // alike by the whole warp; then a panel solves its own triangle and
      // writes its rows; one barrier a panel; the back substitution
      // likewise from the last panel.
      constexpr int kZC = 4;
      const int wp = tid >> 5, P = wp >> 1;
      const int cb = lane + 32 * (wp & 1);
      const int v0 = kPR * P;
      const bool live = v0 < d;
      T z[kPR][kZC];
      #pragma unroll 1
      for (int c0 = 0; c0 < R; c0 += 64 * kZC) {
        #pragma unroll
        for (int r = 0; r < kPR; ++r)
          #pragma unroll
          for (int k = 0; k < kZC; ++k) {
            const int v = v0 + r, c = c0 + cb + 64 * k;
            z[r][k] = (v < d && c < R) ? X[v * ldX + c] : T(0);
          }
        #pragma unroll 1
        for (int Q = 0; Q * kPR < d; ++Q) {
          if (live && P == Q) {        // the triangle, L unit lower
            #pragma unroll
            for (int s2 = 0; s2 < kPR - 1; ++s2)
              #pragma unroll
              for (int r = s2 + 1; r < kPR; ++r) {
                const T l = Ks[(v0 + r) * ldK + v0 + s2];
                #pragma unroll
                for (int k = 0; k < kZC; ++k) z[r][k] -= l * z[s2][k];
              }
            #pragma unroll
            for (int r = 0; r < kPR; ++r)
              #pragma unroll
              for (int k = 0; k < kZC; ++k) {
                const int v = v0 + r, c = c0 + cb + 64 * k;
                if (v < d && c < R) X[v * ldX + c] = z[r][k];
              }
          }
          __syncthreads();             // panel Q's rows
          if (live && P > Q) {
            #pragma unroll 2
            for (int s2 = 0; s2 < kPR; ++s2) {
              const int s = kPR * Q + s2;
              if (s >= d) break;
              T zq[kZC];
              #pragma unroll
              for (int k = 0; k < kZC; ++k) {
                const int c = c0 + cb + 64 * k;
                zq[k] = c < R ? X[s * ldX + c] : T(0);
              }
              #pragma unroll
              for (int r = 0; r < kPR; ++r) {
                const T l = Ks[(v0 + r) * ldK + s];
                #pragma unroll
                for (int k = 0; k < kZC; ++k) z[r][k] -= l * zq[k];
              }
            }
          }
        }
        #pragma unroll 1
        for (int Q = (d - 1) / kPR; Q >= 0; --Q) {
          if (live && P == Q) {        // the triangle, U upper
            #pragma unroll
            for (int s2 = kPR - 1; s2 >= 0; --s2) {
              const T ri = v0 + s2 < d ? rinvs[v0 + s2] : T(0);
              #pragma unroll
              for (int k = 0; k < kZC; ++k) z[s2][k] *= ri;
              #pragma unroll
              for (int r = 0; r < s2; ++r) {
                const T u = Ks[(v0 + r) * ldK + v0 + s2];
                #pragma unroll
                for (int k = 0; k < kZC; ++k) z[r][k] -= u * z[s2][k];
              }
            }
            #pragma unroll
            for (int r = 0; r < kPR; ++r)
              #pragma unroll
              for (int k = 0; k < kZC; ++k) {
                const int v = v0 + r, c = c0 + cb + 64 * k;
                if (v < d && c < R) X[v * ldX + c] = z[r][k];
              }
          }
          __syncthreads();             // panel Q's unknowns
          if (live && P < Q) {
            #pragma unroll 2
            for (int s2 = kPR - 1; s2 >= 0; --s2) {
              const int s = kPR * Q + s2;
              if (s >= d) continue;
              T xq[kZC];
              #pragma unroll
              for (int k = 0; k < kZC; ++k) {
                const int c = c0 + cb + 64 * k;
                xq[k] = c < R ? X[s * ldX + c] : T(0);
              }
              #pragma unroll
              for (int r = 0; r < kPR; ++r) {
                const T u = Ks[(v0 + r) * ldK + s];
                #pragma unroll
                for (int k = 0; k < kZC; ++k) z[r][k] -= u * xq[k];
              }
            }
          }
        }
      }
    }
    __syncthreads();                   // the solution, variable order

    // G_t and y_t, a row a warp; X keeps the carry.
    for (int v = tid >> 5; v < d; v += kThreads / 32) {
      const T* x = X + v * ldX;
      T* g = G_out + (kt * d + v) * pn;
      for (int c = lane; c < pn; c += 32) g[c] = x[c];
      if (lane == 0) y_out[kt * d + v] = x[pn];
    }
  }
}

}  // namespace thomas_blocked
