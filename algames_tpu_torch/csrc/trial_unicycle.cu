// Fused line-search trial for the unicycle games (kernels K2 and K4).
//
// Replaces algames_tpu/ops/trial_kernel.py::_trial_eval_handwritten
// (_make_kernel_h, the whole-horizon variant; the per-knot variant
// _make_kernel computes the same function), and, for the unicycle family,
// algames_tpu/ops/trial_pallas.py::trial_eval_pallas as driven by
// fused_trial_for_spec (the generic fused trial): collision-cost pairs in
// the objective, circle obstacles and state bounds besides the collision
// constraints.
//
// One trial of the backtracking line search, per scenario lane: the trial
// point z + alpha dz, the RK2 defects, the hand-derived unicycle RK2 dual
// pulls A^T lam / B^T lam, the cost gradients (collision-cost pairs
// included) with dt / terminal scaling, the state- and control-constraint
// values with their AL gradients, the Tikhonov pull toward the current
// iterate, and the mean 1-norm of the residual.  It writes the carried point
// (rx0, ru0, rd, constraint values) and tn.
//
// Unicycle midpoint step F = x + dt f(x + dt/2 f(x,u), u) with
// f = [cos(th) v; sin(th) v; omega; a].  With g = J_f(mid)^T (dt lam):
//   A^T lam = lam + g            (J_f(x)^T g = 0: g has no x, y parts)
//   B^T lam = dt lam_{th,v} + dt/2 g_{th,v}
// Player i owns controls i and i+p (the interleaved layout), and the pull of
// player i's multiplier is picked for those two rows.
//
// What bounds it on the card: latency.  The trial reads the iterate and the
// step (x, u, lam: ~4 KB per lane in f32 for the flagship, twice) plus the
// AL state and writes the carried point, at about one flop per byte, so at
// full occupancy it would be bound by device-memory bytes; but a batch of
// 1,024 lanes gives about eight warps per SM, too few to hide the per-knot
// loads and the sin/cos chains.  The design is a single pass: one warp per
// lane, one thread per knot (a loop over knots when T > 32), every
// intermediate in registers or shared memory, and one warp-shuffle sum for
// the norm.  The static structure (block kinds, owners, indices, bound
// masks, collision-cost pairs) travels as a by-value parameter table, so
// one compiled kernel serves any player count and block list; the family
// parameters (radii, circle centres, bounds, pair weights) are small device
// arrays.  State bounds read their AL state only at finite rows and write
// 0 at the others, as the masked bound evaluation does.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxSB = 64;    // state blocks
constexpr int kMaxCB = 4;     // control-bound blocks
constexpr int kMaxM = 32;     // control dimension
constexpr int kMaxN = 32;     // state dimension (2n bound rows in a 64-bit mask)
constexpr int kMaxPair = 64;  // collision-cost pairs

enum : short { kCollision = 0, kCircle = 1, kBound = 2 };

// One state block.  a[]: collision pxi0, pxi1, pxj0, pxj1; circle xi, yi
// and the number of circles.  ``row`` is the block's first row in the
// stacked [Csum] rows of the AL state and the values; ``par`` its first
// entry in the parameter array (collision r^2; circle (xc, yc, r) per
// circle; bound z_max [n] then z_min [n]); ``mask`` the finite rows of a
// bound (bit j: upper bound of state j, bit n+j: lower bound).
struct SBlock {
  unsigned long long mask;
  int row, par;
  short kind, owner;
  short a[4];
};

struct TrialMeta {
  SBlock sb[kMaxSB];
  short pair[kMaxPair][5];               // owner, pxi0, pxi1, pxj0, pxj1
  unsigned char c_mask[kMaxCB][2 * kMaxM];
};

template <typename T> __device__ __forceinline__ T dsin(T v);
template <typename T> __device__ __forceinline__ T dcos(T v);
template <> __device__ __forceinline__ float dsin(float v) { return sinf(v); }
template <> __device__ __forceinline__ float dcos(float v) { return cosf(v); }
template <> __device__ __forceinline__ double dsin(double v) { return sin(v); }
template <> __device__ __forceinline__ double dcos(double v) { return cos(v); }
template <typename T> __device__ __forceinline__ T absval(T v) {
  return v < T(0) ? -v : v;
}

template <typename T>
struct Lane {
  const T *x, *u, *lam, *dx, *du, *dlam;
  T al;
  int N, Tn, n, m, p;
  __device__ T X(int k, int c) const {
    const int o = k * n + c;
    return x[o] + al * dx[o];
  }
  __device__ T U(int k, int c) const {
    const int o = k * m + c;
    return u[o] + al * du[o];
  }
  __device__ T Lm(int i, int k, int c) const {
    const int o = (i * Tn + k) * n + c;
    return lam[o] + al * dlam[o];
  }
  // The current iterate (the Tikhonov pull's anchor).
  __device__ T X0(int k, int c) const { return x[k * n + c]; }
  __device__ T U0(int k, int c) const { return u[k * m + c]; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) trial_unicycle_kernel(
    const T* __restrict__ x, const T* __restrict__ u,
    const T* __restrict__ lam, const T* __restrict__ dx,
    const T* __restrict__ du, const T* __restrict__ dlam,
    const T* __restrict__ alpha, const T* __restrict__ reg,
    const T* __restrict__ Qd, const T* __restrict__ xf,
    const T* __restrict__ Rdp, const T* __restrict__ ufp,
    const T* __restrict__ spar, const T* __restrict__ slam,
    const T* __restrict__ smu, const T* __restrict__ zmax,
    const T* __restrict__ zmin, const T* __restrict__ clam,
    const T* __restrict__ cmu, const T* __restrict__ pmr,
    T* __restrict__ rx0_out, T* __restrict__ ru0_out, T* __restrict__ rd_out,
    T* __restrict__ sc_out, T* __restrict__ cc_out, T* __restrict__ tn_out,
    int N, int p, int nsb, int csum, int ncb, int npair, int S, T dt,
    T eps_n, const __grid_constant__ TrialMeta meta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Tn = N - 1, n = 4 * p, m = 2 * p;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int per = p * n + m + (npair ? p * n : 0);
  T* alx = reinterpret_cast<T*>(smem_raw) + tid * per;  // AL grads
  T* alu = alx + p * n;
  T* cgx = alu + m;                                        // pair grads

  Lane<T> L;
  L.x = x + (size_t)b * N * n;
  L.u = u + (size_t)b * Tn * m;
  L.lam = lam + (size_t)b * p * Tn * n;
  L.dx = dx + (size_t)b * N * n;
  L.du = du + (size_t)b * Tn * m;
  L.dlam = dlam + (size_t)b * p * Tn * n;
  L.al = alpha[b];
  L.N = N; L.Tn = Tn; L.n = n; L.m = m; L.p = p;
  const T rg = reg[b];
  const T half = T(0.5);

  T part = T(0);
  for (int t = tid; t < Tn; t += kThreads) {
    for (int c = 0; c < p * n; ++c) alx[c] = T(0);
    for (int c = 0; c < m; ++c) alu[c] = T(0);
    const T scale = (t + 1 < N - 1) ? dt : T(1);

    // State blocks at knot t+1; rows of the stacked AL state / values.
    for (int k = 0; k < nsb; ++k) {
      const SBlock& sb = meta.sb[k];
      T* g = alx + sb.owner * n;
      const size_t o0 = ((size_t)b * csum + sb.row) * Tn + t;
      if (sb.kind == kCollision) {    // c = r^2 - |x_i - x_j|^2
        const T d0 = L.X(t + 1, sb.a[0]) - L.X(t + 1, sb.a[2]);
        const T d1 = L.X(t + 1, sb.a[1]) - L.X(t + 1, sb.a[3]);
        const T cv = spar[sb.par] - (d0 * d0 + d1 * d1);
        const T lc = slam[o0];
        const T irho = (cv >= T(0) || lc > T(0)) ? smu[o0] : T(0);
        const T w = lc + irho * cv;
        g[sb.a[0]] += (T(-2) * d0) * w;
        g[sb.a[2]] += (T(2) * d0) * w;
        g[sb.a[1]] += (T(-2) * d1) * w;
        g[sb.a[3]] += (T(2) * d1) * w;
        sc_out[o0] = cv;
      } else if (sb.kind == kCircle) {  // c_j = r_j^2 - |(x, y) - c_j|^2
        const T px = L.X(t + 1, sb.a[0]), py = L.X(t + 1, sb.a[1]);
        for (int j = 0; j < sb.a[2]; ++j) {
          const T* pc = spar + sb.par + 3 * j;
          const T ex = px - pc[0], ey = py - pc[1];
          const T cv = pc[2] * pc[2] - ex * ex - ey * ey;
          const size_t o = o0 + (size_t)j * Tn;
          const T lc = slam[o];
          const T irho = (cv >= T(0) || lc > T(0)) ? smu[o] : T(0);
          const T w = lc + irho * cv;
          g[sb.a[0]] += (T(-2) * ex) * w;
          g[sb.a[1]] += (T(-2) * ey) * w;
          sc_out[o] = cv;
        }
      } else {                          // c = [x - z_max; z_min - x], masked
        const T* zx = spar + sb.par;
        for (int j = 0; j < n; ++j) {
          const bool mu_ = (sb.mask >> j) & 1ull;
          const bool ml_ = (sb.mask >> (n + j)) & 1ull;
          const size_t ou = o0 + (size_t)j * Tn, ol = o0 + (size_t)(n + j) * Tn;
          T cu = T(0), cl = T(0), gj = T(0);
          if (mu_) {
            cu = L.X(t + 1, j) - zx[j];
            const T lu = slam[ou];
            const T iu = (cu >= T(0) || lu > T(0)) ? smu[ou] : T(0);
            gj = lu + iu * cu;
          }
          if (ml_) {
            cl = zx[n + j] - L.X(t + 1, j);
            const T ll = slam[ol];
            const T il = (cl >= T(0) || ll > T(0)) ? smu[ol] : T(0);
            gj -= ll + il * cl;
          }
          if (mu_ || ml_) g[j] += gj;
          sc_out[ou] = cu;
          sc_out[ol] = cl;
        }
      }
    }
    // Control-bound blocks: c = [u - z_max; z_min - u] (masked rows 0).
    for (int k = 0; k < ncb; ++k) {
      const size_t o = (((size_t)b * ncb + k) * Tn + t) * 2 * m;
      for (int j = 0; j < m; ++j) {
        const T uj = L.U(t, j);
        const bool mu_ = meta.c_mask[k][j], ml_ = meta.c_mask[k][m + j];
        const T cu = mu_ ? uj - zmax[k * m + j] : T(0);
        const T cl = ml_ ? zmin[k * m + j] - uj : T(0);
        const T lu = clam[o + j], ll = clam[o + m + j];
        const T iu = (cu >= T(0) || lu > T(0)) ? cmu[o + j] : T(0);
        const T il = (cl >= T(0) || ll > T(0)) ? cmu[o + m + j] : T(0);
        const T wu = lu + iu * cu, wl = ll + il * cl;
        alu[j] += wu * (mu_ ? T(1) : T(0)) - wl * (ml_ ? T(1) : T(0));
        cc_out[o + j] = cu;
        cc_out[o + m + j] = cl;
      }
    }
    // Collision-cost pairs at knot t+1 (scaled like the cost): player i is
    // pushed off player j while |delta| < r,
    //   g = mu (r (eps + delta) / (eps_n + |delta|) - delta).
    if (npair) {
      for (int c = 0; c < p * n; ++c) cgx[c] = T(0);
      for (int k = 0; k < npair; ++k) {
        const short* pr = meta.pair[k];
        const T d0 = L.X(t + 1, pr[1]) - L.X(t + 1, pr[3]);
        const T d1 = L.X(t + 1, pr[2]) - L.X(t + 1, pr[4]);
        const T dn = sqrt(d0 * d0 + d1 * d1);
        const T mu = pmr[2 * k], r = pmr[2 * k + 1];
        if (!(r - dn > T(0))) continue;
        const T eps = T(1e-10);
        const T g0 = mu * (r * (eps + d0) / (eps_n + dn) - d0) * scale;
        const T g1 = mu * (r * (eps + d1) / (eps_n + dn) - d1) * scale;
        T* cg = cgx + pr[0] * n;
        cg[pr[1]] -= g0;
        cg[pr[2]] -= g1;
        cg[pr[3]] += g0;
        cg[pr[4]] += g1;
      }
    }

    const bool has_next = t + 1 < Tn;
    for (int j = 0; j < p; ++j) {
      // RK2 step of player j at knot t: defects and control rows.
      const int cx = j, cy = p + j, cth = 2 * p + j, cv = 3 * p + j;
      const T px = L.X(t, cx), py = L.X(t, cy), th = L.X(t, cth),
              v = L.X(t, cv);
      const T om = L.U(t, j), ac = L.U(t, p + j);
      const T mth = th + half * (om * dt), mv = v + half * (ac * dt);
      const T sm_ = dsin(mth), cm_ = dcos(mth);
      const T Fx = px + cm_ * mv * dt, Fy = py + sm_ * mv * dt;
      const T Ft = th + om * dt, Fv = v + ac * dt;
      T* rd = rd_out + ((size_t)b * Tn + t) * n;
      const T r0 = Fx - L.X(t + 1, cx), r1 = Fy - L.X(t + 1, cy);
      const T r2v = Ft - L.X(t + 1, cth), r3 = Fv - L.X(t + 1, cv);
      rd[cx] = r0; rd[cy] = r1; rd[cth] = r2v; rd[cv] = r3;
      part += absval(r0) + absval(r1) + absval(r2v) + absval(r3);

      // B^T lam_j picked at player j's own control rows (omega_j, a_j).
      const T lx = L.Lm(j, t, cx), ly = L.Lm(j, t, cy);
      const T lt = L.Lm(j, t, cth), lv = L.Lm(j, t, cv);
      const T gth = -sm_ * mv * (dt * lx) + cm_ * mv * (dt * ly);
      const T gv = cm_ * (dt * lx) + sm_ * (dt * ly);
      T* ru0 = ru0_out + ((size_t)b * Tn + t) * m;
      const int ow = j, oa = p + j;
      const T ro = ufp[ow], ra = ufp[oa];
      const T ru_o = Rdp[ow] * (om - ro) * dt + (dt * lt + half * dt * gth);
      const T ru_a = Rdp[oa] * (ac - ra) * dt + (dt * lv + half * dt * gv);
      ru0[ow] = ru_o;
      ru0[oa] = ru_a;
      part += absval(ru_o + alu[ow] + rg * (om - L.U0(t, ow)))
            + absval(ru_a + alu[oa] + rg * (ac - L.U0(t, oa)));
    }

    // Statx rows: cost gradient at x_{t+1} + A_{t+1}^T lam_{t+1} - lam_t.
    for (int j = 0; j < p; ++j) {
      const int cs[4] = {j, p + j, 2 * p + j, 3 * p + j};
      T sm1 = T(0), cm1 = T(0), mv1 = T(0);
      if (has_next) {   // midpoint of player j's step at knot t+1
        const T th1 = L.X(t + 1, cs[2]), v1 = L.X(t + 1, cs[3]);
        const T mth1 = th1 + half * (L.U(t + 1, j) * dt);
        mv1 = v1 + half * (L.U(t + 1, p + j) * dt);
        sm1 = dsin(mth1);
        cm1 = dcos(mth1);
      }
      for (int i = 0; i < p; ++i) {
        T gx[4] = {T(0), T(0), T(0), T(0)};
        if (has_next) {
          const T lx = L.Lm(i, t + 1, cs[0]), ly = L.Lm(i, t + 1, cs[1]);
          gx[0] = lx;
          gx[1] = ly;
          gx[2] = L.Lm(i, t + 1, cs[2])
                  + (-sm1 * mv1 * (dt * lx) + cm1 * mv1 * (dt * ly));
          gx[3] = L.Lm(i, t + 1, cs[3]) + (cm1 * (dt * lx) + sm1 * (dt * ly));
        }
        T* rx0 = rx0_out + (((size_t)b * Tn + t) * p + i) * n;
        for (int q = 0; q < 4; ++q) {
          const int c = cs[q];
          const T x1 = L.X(t + 1, c);
          T qx = Qd[i * n + c] * (x1 - xf[i * n + c]) * scale;
          if (npair) qx += cgx[i * n + c];
          const T r = (qx + gx[q]) - L.Lm(i, t, c);
          rx0[c] = r;
          part += absval((r + alx[i * n + c]) + rg * (x1 - L.X0(t + 1, c)));
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (tid == 0) tn_out[b] = part / T(S);
}

template <typename T>
int launch(const void* x, const void* u, const void* lam, const void* dx,
           const void* du, const void* dlam, const void* alpha,
           const void* reg, const void* Qd, const void* xf, const void* Rdp,
           const void* ufp, const void* spar, const void* slam,
           const void* smu, const void* zmax, const void* zmin,
           const void* clam, const void* cmu, const void* pmr,
           const int* s_meta, const unsigned long long* s_mask,
           const int* p_meta, const unsigned char* c_mask, void* rx0,
           void* ru0, void* rd, void* sc, void* cc, void* tn, int B, int N,
           int p, int nsb, int csum, int ncb, int npair, int S, double dt,
           double eps_n, void* stream) {
  const int n = 4 * p, m = 2 * p;
  if (nsb > kMaxSB || ncb > kMaxCB || npair > kMaxPair || m > kMaxM ||
      n > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  TrialMeta meta = {};
  // s_meta per state block: kind, owner, row, par, a0, a1, a2, a3.
  for (int k = 0; k < nsb; ++k) {
    const int* s = s_meta + 8 * k;
    SBlock& sb = meta.sb[k];
    sb.kind = (short)s[0];
    sb.owner = (short)s[1];
    sb.row = s[2];
    sb.par = s[3];
    for (int j = 0; j < 4; ++j) sb.a[j] = (short)s[4 + j];
    sb.mask = s_mask[k];
  }
  for (int k = 0; k < npair; ++k)
    for (int j = 0; j < 5; ++j) meta.pair[k][j] = (short)p_meta[5 * k + j];
  for (int k = 0; k < ncb; ++k)
    for (int j = 0; j < 2 * m; ++j) meta.c_mask[k][j] = c_mask[2 * m * k + j];
  const int per = p * n + m + (npair ? p * n : 0);
  const size_t bytes = (size_t)kThreads * per * sizeof(T);
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        trial_unicycle_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err) return err;
  }
  trial_unicycle_kernel<T><<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)u, (const T*)lam, (const T*)dx, (const T*)du,
      (const T*)dlam, (const T*)alpha, (const T*)reg, (const T*)Qd,
      (const T*)xf, (const T*)Rdp, (const T*)ufp, (const T*)spar,
      (const T*)slam, (const T*)smu, (const T*)zmax, (const T*)zmin,
      (const T*)clam, (const T*)cmu, (const T*)pmr, (T*)rx0, (T*)ru0,
      (T*)rd, (T*)sc, (T*)cc, (T*)tn, N, p, nsb, csum, ncb, npair, S, (T)dt,
      (T)eps_n, meta);
  return (int)cudaGetLastError();
}

}  // namespace

#define TRIAL_EXPORT(SUFFIX, T)                                               \
  extern "C" int trial_unicycle_##SUFFIX(                                     \
      const void* x, const void* u, const void* lam, const void* dx,          \
      const void* du, const void* dlam, const void* alpha, const void* reg,   \
      const void* Qd, const void* xf, const void* Rdp, const void* ufp,       \
      const void* spar, const void* slam, const void* smu, const void* zmax,  \
      const void* zmin, const void* clam, const void* cmu, const void* pmr,   \
      const int* s_meta, const unsigned long long* s_mask, const int* p_meta, \
      const unsigned char* c_mask, void* rx0, void* ru0, void* rd, void* sc,  \
      void* cc, void* tn, int B, int N, int p, int nsb, int csum, int ncb,    \
      int npair, int S, double dt, double eps_n, void* stream) {              \
    return launch<T>(x, u, lam, dx, du, dlam, alpha, reg, Qd, xf, Rdp, ufp,   \
                     spar, slam, smu, zmax, zmin, clam, cmu, pmr, s_meta,     \
                     s_mask, p_meta, c_mask, rx0, ru0, rd, sc, cc, tn, B, N,  \
                     p, nsb, csum, ncb, npair, S, dt, eps_n, stream);         \
  }

TRIAL_EXPORT(f32, float)
TRIAL_EXPORT(f64, double)

extern "C" const char* trial_unicycle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
