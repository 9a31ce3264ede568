// Fused line-search trial (kernels K2 and K4) for every model and constraint
// family of the port.
//
// Replaces algames_tpu/ops/trial_kernel.py::_trial_eval_handwritten
// (_make_kernel_h, the whole-horizon variant; the per-knot variant
// _make_kernel computes the same function) for the unicycle games, and
// algames_tpu/ops/trial_pallas.py::trial_eval_pallas as driven by
// fused_trial_for_spec (the generic fused trial) for the unicycle, double
// integrator (homogeneous, or planar heterogeneous with player-blocked
// ragged controls), bicycle and quadrotor models with collision-cost pairs in the
// objective and collision (planar or spherical), circle, 2D wall, 3D wall,
// cylinder and state-bound blocks.
//
// One trial of the backtracking line search, per scenario lane: the trial
// point z + alpha dz, the RK2 defects, the RK2 dual pulls A^T lam / B^T lam,
// the cost gradients (collision-cost pairs included) with dt / terminal
// scaling, the state- and control-constraint values with their AL
// gradients, the Tikhonov pull toward the current iterate, and the mean
// 1-norm of the residual.  It writes the carried point (rx0, ru0, rd,
// constraint values) and tn.
//
// The model is a template parameter: a device functor per model gives one
// player's vector field f(x_i, u_i) (ni states, mi controls) and its VJP
// (J_x^T g, J_u^T g), one cotangent at a time, and names its layout policy:
// where component c of player i sits in the full vectors (Interleaved:
// c p + i; Blocked: player-major, with ragged controls).  One generic routine builds
// the midpoint step F = x + dt f(x + dt/2 f(x, u), u) and its pulls: with
// g = dt lam and (gx, gu) the VJP of f at (mid, u),
//   A^T lam = lam + gx + dt/2 J_x f(x, u)^T gx
//   B^T lam = gu + dt/2 J_u f(x, u)^T gx.
// The unicycle's VJP has J_x f^T gx = 0 (gx has no x, y parts), so its pulls
// are the closed form A^T lam = lam + g, B^T lam = dt lam_{th,v} +
// dt/2 g_{th,v}.  The unicycle, double-integrator and bicycle VJPs are
// derived by hand; the quadrotor's comes from forward-mode dual numbers over
// the player's attitude, rate and rotor inputs (see Quadrotor).  The pull of
// player i's multiplier is picked for player i's own control rows.  One
// compiled kernel per (model, threads per knot, type); the model's
// constants are kernel arguments.
//
// What bounds it on the card: the latency of each knot's chain of loads,
// transcendentals and VJPs, not bytes (on the roundabout 0.0447 ms of
// device-memory traffic for 1,024 lanes, against 0.31 ms for the earlier
// one-warp kernel and 0.20 ms for this one; H100 80GB HBM3 at 700 W, f32,
// tests/trial_compare.py).  That kernel gave a lane one warp, one thread
// per knot, so the roundabout's 39 knots ran as two passes, the second on 7
// of 32 threads, each thread reading its knot's strided rows of x, u and
// lam from device memory.  This one gives a lane ceil(T TPK / 32) warps and
// makes one pass: TPK threads per knot, a compile-time policy of the
// instance (two for the unicycle games of four or more players, one
// elsewhere), split the knot's state blocks, collision-cost pairs and
// control-bound rows by owner and then its players, meeting at one warp
// barrier; the instances whose knots read many values (unicycle, bicycle,
// quadrotor) first stage the lane's trial point, iterate and trial
// multipliers in shared memory with 16-byte loads, so that neighbouring
// threads read neighbouring addresses (the unicycle past 64 states stages
// the point and the iterate only: its p T n trial multipliers, 22,287
// scalars at 17 players, would not fit a block beside the rest in f64).  The roundabout's lane then holds
// ~40 KB of shared memory: 5 lanes per SM, two waves at B=1024.  The
// double integrators read device memory directly, as before: their knots
// read few values and staging cost more than it saved.  Every intermediate
// stays in registers, thread-local or shared memory; the norm is summed by
// warp shuffles, then over the warps in order.  The family parameters
// (radii, centres, wall corners, bounds, pair weights) are small device
// arrays; the static structure is a device array too, which the wrapper
// uploads once per problem, so that one compiled kernel serves any player
// count and block list, bounded by nothing but memory: the state blocks
// (SBlock: kinds, owners, senses, indices, bound masks, cylinder axes; the
// 17-player unicycle merge has 272 collision blocks) and the collision-cost
// pairs and control-bound blocks (TrialMeta: owners, indices, row flags,
// senses, at any control dimension): a by-value parameter table may take
// 4 KB, which the merges' tables outgrow.
// A state bound's 2n rows are flagged in one 64-bit mask (n up to 32), or,
// for the instances past 32 states (Model::kRowFlags: the quadrotor and the
// wide unicycle), by 2n flags in the parameter array after the bound's
// z_max and z_min, which the wrapper writes for those instances only.
// State bounds read their AL state only at finite rows and write 0 at the
// others, as the masked bound evaluation does; gated rows (walls,
// cylinders) use the reference's strict comparisons and are exactly 0
// outside their gates.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per lane: ceil(T TPK / 32) warps
constexpr int kMaxN = 32;     // state dimension (2n bound rows in a 64-bit mask)
constexpr int kMaxConst = 12; // model constants

enum : unsigned char {
  kCollision = 0, kCircle = 1, kBound = 2, kWall2D = 3, kWall3D = 4,
  kCylinder = 5
};

// One state block.  ``cnt``: collision dimension (2 or 3), or the number of
// circles / walls / cylinders.  a[]: collision pxi then pxj (three slots
// each); circle and 2D wall x, y index; 3D wall and cylinder x, y, z index.
// ``row`` is the block's first row in the stacked [Csum] rows of the AL
// state and the values; ``par`` its first entry in the parameter array
// (collision r^2; per circle (xc, yc, r); per 2D wall (x1, y1, x2, y2, xv,
// yv); per 3D wall (x1, y1, z1, x2, y2, z2, x3, y3, z3, xv, yv, zv); per
// cylinder (p1, p2, p3, l, r); bound z_max [n], z_min [n], then, for the
// Model::kRowFlags instances, its 2n row flags, 1 for a finite bound, in
// the mask's order).  ``mask``: a bound's finite rows (bit j: upper bound
// of state j, bit n+j: lower bound; 0 for the Model::kRowFlags
// instances), or a cylinder block's axes (bits 2j, 2j+1: axis of cylinder
// j; at most 32 cylinders, ops/trial.py::_MAX_CYL).  ``eq``: 1 for an
// equality block (its rows always penalized), 0 for the inequality and
// second-order-cone senses.  32 bytes; the wrapper packs the same layout
// (ops/trial.py::SBLOCK, checked against trial_fused_sblock_bytes).
struct SBlock {
  unsigned long long mask;
  int row, par;
  unsigned char kind, owner, cnt, eq;
  unsigned char a[6];
};

// One collision-cost pair: the owner (the player pushed), the dimension (2
// or 3), pxi then pxj.  8 bytes (ops/trial.py::PAIR, checked against
// trial_fused_pair_bytes).
struct Pair {
  unsigned char owner, dim, a[3], b[3];
};

// The pairs' and the control-bound blocks' table: a device array of bytes
// that the wrapper packs and uploads once per problem
// (ops/trial.py::_meta_table): npair Pair records, then per control block
// its 2m row flags (upper rows, then lower; 1 for a finite bound), then
// each control block's ``eq`` (as SBlock's), padded to 8 bytes.
__host__ __device__ __forceinline__ size_t meta_bytes(int npair, int ncb,
                                                      int m) {
  return ((size_t)npair * sizeof(Pair) + (size_t)ncb * (2 * m + 1) + 7) &
         ~(size_t)7;
}

// A view of that table.
struct TrialMeta {
  const Pair* pair;
  const unsigned char *c_mask, *c_eq;
  __device__ TrialMeta(const unsigned char* base, int npair, int ncb, int m)
      : pair(reinterpret_cast<const Pair*>(base)),
        c_mask(base + npair * sizeof(Pair)),
        c_eq(base + npair * sizeof(Pair) + ncb * 2 * m) {}
};

struct ModelConst {
  double c[kMaxConst];
};

template <typename T> __device__ __forceinline__ T dsin(T v);
template <typename T> __device__ __forceinline__ T dcos(T v);
template <typename T> __device__ __forceinline__ T dtan(T v);
template <typename T> __device__ __forceinline__ T datan2(T y, T x);
template <typename T> __device__ __forceinline__ T dexp(T v);
template <typename T> __device__ __forceinline__ T dlog1p(T v);
template <typename T> __device__ __forceinline__ T dsqrt(T v);
template <> __device__ __forceinline__ float dsin(float v) { return sinf(v); }
template <> __device__ __forceinline__ float dcos(float v) { return cosf(v); }
template <> __device__ __forceinline__ float dtan(float v) { return tanf(v); }
template <> __device__ __forceinline__ float datan2(float y, float x) {
  return atan2f(y, x);
}
template <> __device__ __forceinline__ float dexp(float v) { return expf(v); }
template <> __device__ __forceinline__ float dlog1p(float v) {
  return log1pf(v);
}
template <> __device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
template <> __device__ __forceinline__ double dsin(double v) { return sin(v); }
template <> __device__ __forceinline__ double dcos(double v) { return cos(v); }
template <> __device__ __forceinline__ double dtan(double v) { return tan(v); }
template <> __device__ __forceinline__ double datan2(double y, double x) {
  return atan2(y, x);
}
template <> __device__ __forceinline__ double dexp(double v) { return exp(v); }
template <> __device__ __forceinline__ double dlog1p(double v) {
  return log1p(v);
}
template <> __device__ __forceinline__ double dsqrt(double v) {
  return sqrt(v);
}
template <typename T> __device__ __forceinline__ T absval(T v) {
  return v < T(0) ? -v : v;
}

// ---------------------------------------------------------------------------
// Layout policies: where component c of player j sits in the full state and
// control vectors, the control dimension m, and control c of player j at a
// knot of the lane's trial point (``u_at``).  A model names its policy, so
// the index arithmetic is fixed when the kernel is compiled.  Everything is
// forced inline: after inlining, an interleaved instance is the same code
// as before the policies existed (its outputs stay bitwise equal).
// ---------------------------------------------------------------------------

// Interleaved (every model but the heterogeneous one): c p + j in both
// vectors, MI controls per player, every control present.
template <int MI>
struct Interleaved {
  static constexpr bool kRagged = false;
  __host__ __device__ __forceinline__ static int x(int c, int j, int p) {
    return c * p + j;
  }
  __device__ __forceinline__ static int u(const ModelConst&, int c, int j,
                                          int p) {
    return c * p + j;
  }
  template <typename T, class LaneT>
  __device__ __forceinline__ static T u_at(const LaneT& L, const ModelConst&,
                                           int t, int c, int j, int p) {
    return L.U(t, c * p + j);
  }
  __host__ __device__ __forceinline__ static int m(const ModelConst&, int p) {
    return MI * p;
  }
};

// Player-blocked with ragged controls (the heterogeneous double integrator):
// state j NI + c; control off[j] + c for c < mi[j] = off[j+1] - off[j], and
// absent (zero, never written) for mi[j] <= c < MI.  The offsets are the
// model constants c[0..p] (off[p] = m), read from the kernel's parameter
// space at run time; they index device memory only, never a thread-local
// array.
template <int NI>
struct Blocked {
  static constexpr bool kRagged = true;
  __host__ __device__ __forceinline__ static int x(int c, int j, int) {
    return j * NI + c;
  }
  __device__ __forceinline__ static bool has_u(const ModelConst& k, int c,
                                               int j) {
    return c < (int)k.c[j + 1] - (int)k.c[j];
  }
  __device__ __forceinline__ static int u(const ModelConst& k, int c, int j,
                                          int) {
    return (int)k.c[j] + c;
  }
  template <typename T, class LaneT>
  __device__ __forceinline__ static T u_at(const LaneT& L, const ModelConst& k,
                                           int t, int c, int j, int p) {
    return has_u(k, c, j) ? L.U(t, u(k, c, j, p)) : T(0);
  }
  __host__ __device__ __forceinline__ static int m(const ModelConst& k, int p) {
    return (int)k.c[p];
  }
};

// ---------------------------------------------------------------------------
// Models: one player's vector field f, and its VJP at a point (x, u) for one
// cotangent g [NI]: gx [NI] = J_x^T g and gu [MI] = J_u^T g, each written
// when not null.  ``lin(x, u)`` holds what the VJP needs of the point (the
// trigonometric factors), computed once for the p cotangents pulled through
// it.  Every thread-local array of a model or the trial is indexed by
// compile-time constants once the loops over NI, MI and the three
// coordinates unroll, so that it stays in registers (a run-time index puts
// it in local memory, which doubled K2's device time).
// ---------------------------------------------------------------------------

// Unicycle: x = [px, py, th, v], u = [om, a], f = [cos(th) v, sin(th) v, om,
// a].
template <typename T>
struct Unicycle {
  static constexpr int NI = 4, MI = 2;
  static constexpr bool kStage = true;
  static constexpr bool kStageLam = true;
  static constexpr bool kRowFlags = false;
  using Layout = Interleaved<MI>;
  struct Lin {
    T s, c, v;
  };
  __device__ explicit Unicycle(const ModelConst&) {}
  __device__ void f(const T* x, const T* u, T* out) const {
    out[0] = dcos(x[2]) * x[3];
    out[1] = dsin(x[2]) * x[3];
    out[2] = u[0];
    out[3] = u[1];
  }
  __device__ Lin lin(const T* x, const T*) const {
    return {dsin(x[2]), dcos(x[2]), x[3]};
  }
  __device__ void vjp(const Lin& l, const T* g, T* gx, T* gu) const {
    if (gx) {
      gx[0] = T(0);
      gx[1] = T(0);
      gx[2] = -l.s * l.v * g[0] + l.c * l.v * g[1];
      gx[3] = l.c * g[0] + l.s * g[1];
    }
    if (gu) {
      gu[0] = g[2];
      gu[1] = g[3];
    }
  }
};

// The unicycle past 32 states (nine players or more): the same model with
// a state bound's rows flagged in the parameter array, and in f64 the trial
// multipliers read from device memory rather than staged: staged, the f64
// lane does not fit a block at 17 players (unstaged it takes 224,552 bytes
// of shared memory with the merge's 272 state blocks), and at nine players
// it ran 20% longer on an H100 80GB HBM3 at 700 W; in f32 staging ran 25%
// (nine players) and 8% (17) faster there (tests/source_variants.py,
// k2-wide-staged and k2-wide-unstaged).
template <typename T>
struct UnicycleWide : Unicycle<T> {
  static constexpr bool kStageLam = sizeof(T) == sizeof(float);
  static constexpr bool kRowFlags = true;
  __device__ explicit UnicycleWide(const ModelConst& k) : Unicycle<T>(k) {}
};

// Double integrator in D dimensions: x = [pos (D); vel (D)], u = acc (D),
// f = [vel; u].
template <typename T, int D>
struct DoubleIntegrator {
  static constexpr int NI = 2 * D, MI = D;
  static constexpr bool kStage = false;
  static constexpr bool kStageLam = false;
  static constexpr bool kRowFlags = false;
  using Layout = Interleaved<MI>;
  struct Lin {};
  __device__ explicit DoubleIntegrator(const ModelConst&) {}
  __device__ void f(const T* x, const T* u, T* out) const {
    #pragma unroll
    for (int j = 0; j < D; ++j) {
      out[j] = x[D + j];
      out[D + j] = u[j];
    }
  }
  __device__ Lin lin(const T*, const T*) const { return {}; }
  __device__ void vjp(const Lin&, const T* g, T* gx, T* gu) const {
    #pragma unroll
    for (int j = 0; j < D; ++j) {
      if (gx) {
        gx[j] = T(0);
        gx[D + j] = g[j];
      }
      if (gu) gu[j] = g[D + j];
    }
  }
};

// Heterogeneous double integrator in D dimensions: player j actuates its
// first mi[j] <= D acceleration components and the others coast, so the
// vector field and its VJP are the double integrator's with the absent
// controls held at zero; the layout is player-blocked.  Constants: the
// control offsets off[0..p].
template <typename T, int D>
struct HeteroDoubleIntegrator : DoubleIntegrator<T, D> {
  using Layout = Blocked<2 * D>;
  __device__ explicit HeteroDoubleIntegrator(const ModelConst& c)
      : DoubleIntegrator<T, D>(c) {}
};

// Kinematic bicycle: x = [px, py, v, psi], u = [a, delta], slip angle
// beta = atan2(lr tan(delta), lr + lf), f = [v cos(beta + psi),
// v sin(beta + psi), a, v sin(beta) / lr].  Constants: lf, lr.
template <typename T>
struct Bicycle {
  static constexpr int NI = 4, MI = 2;
  static constexpr bool kStage = true;
  static constexpr bool kStageLam = true;
  static constexpr bool kRowFlags = false;
  using Layout = Interleaved<MI>;
  struct Lin {
    T v, sh, ch, sb, cb, db;
  };
  T lf, lr;
  __device__ explicit Bicycle(const ModelConst& c)
      : lf(T(c.c[0])), lr(T(c.c[1])) {}
  __device__ T beta(T delta) const {
    return datan2(lr * dtan(delta), lr + lf);
  }
  __device__ void f(const T* x, const T* u, T* out) const {
    const T b = beta(u[1]), v = x[2], h = b + x[3];
    out[0] = v * dcos(h);
    out[1] = v * dsin(h);
    out[2] = u[0];
    out[3] = v * dsin(b) / lr;
  }
  // d beta / d delta = (lr + lf) lr (1 + tan^2) / ((lr + lf)^2 + (lr tan)^2).
  __device__ Lin lin(const T* x, const T* u) const {
    const T tn = dtan(u[1]), L = lr + lf, y = lr * tn;
    const T b = datan2(y, L), h = b + x[3];
    return {x[2], dsin(h), dcos(h), dsin(b), dcos(b),
            L * lr * (T(1) + tn * tn) / (L * L + y * y)};
  }
  __device__ void vjp(const Lin& l, const T* g, T* gx, T* gu) const {
    const T v = l.v;
    const T dh = -v * l.sh * g[0] + v * l.ch * g[1];
    if (gx) {
      gx[0] = T(0);
      gx[1] = T(0);
      gx[2] = l.ch * g[0] + l.sh * g[1] + l.sb / lr * g[3];
      gx[3] = dh;
    }
    if (gu) {
      gu[0] = g[2];
      gu[1] = l.db * (dh + v * l.cb / lr * g[3]);
    }
  }
};

// Forward-mode dual number (value, derivative along one seed).
template <typename T>
struct Dual {
  T v, d;
  Dual() = default;
  __device__ Dual(T a, T b = T(0)) : v(a), d(b) {}
};
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.v * b.d + a.d * b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  return {a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) {
  return {a + b.v, b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) {
  return {a - b.v, -b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
  return {a * b.v, a * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) {
  return {a.v / b, a.d / b};
}
// Rotor thrust: max(0, z), whose derivative at z == 0 is 1/2 (the two
// branches tie, as in the reference package and the plain version), or
// softplus(beta z) / beta with smoothing beta > 0.
template <typename T>
__device__ __forceinline__ T softplus(T z) {
  return (z > T(0) ? z : T(0)) + dlog1p(dexp(-absval(z)));
}
template <typename T>
__device__ __forceinline__ T thrust(T z, T beta) {
  if (beta > T(0)) return softplus(beta * z) / beta;
  return z > T(0) ? z : T(0);
}
template <typename T>
__device__ __forceinline__ Dual<T> thrust(Dual<T> z, T beta) {
  if (beta > T(0)) {
    const T s = T(1) / (T(1) + dexp(-beta * z.v));
    return {softplus(beta * z.v) / beta, s * z.d};
  }
  if (z.v > T(0)) return z;
  if (z.v < T(0)) return {T(0), T(0)};
  return {T(0), T(0.5) * z.d};
}

// Quadrotor with MRP attitude: x = [p (3), q (3), v (3), w (3)], u = four
// rotor speeds; F_k = thrust(kf u_k), body force [0, 0, sum F],
// tau = [L (F1 - F3), L (F2 - F0), km (u0 - u1 + u2 - u3)],
//   pdot = v,  qdot = 1/4 ((1 - q'q) w + 2 q x w + 2 q (q'w)),
//   vdot = g + R(q) e3 sum F / mass  (R(q) e3 = e3 + (8 S^2 e3 +
//          4 (1 - q'q) S e3) / (1 + q'q)^2, S = skew(q)),
//   wdot = (tau - w x (J w)) / J.
// Constants: mass, J (3), gravity (3), motor distance L, kf, km, smoothing.
//
// The VJP comes from forward-mode dual numbers: one evaluation of the same
// routine per seeded input gives a Jacobian column, dotted with the
// cotangent.  A hand-derived VJP of the rotation column and the MRP
// kinematics has several dozen terms, each a chance to disagree with the
// reference; the duals derive it from the forward routine itself, exactly,
// and cost 6 evaluations for J_x^T (the attitude and rate inputs; f never
// reads the position, and the velocity enters only pdot = v) and 4 for
// J_u^T.  The trial stays bound by latency, not by these operations.
template <typename T>
struct Quadrotor {
  static constexpr int NI = 12, MI = 4;
  static constexpr bool kStage = true;
  static constexpr bool kStageLam = true;
  static constexpr bool kRowFlags = true;
  using Layout = Interleaved<MI>;
  struct Lin {
    const T *x, *u;
  };
  T mass, J[3], mg[3], L, kf, km, beta;
  __device__ explicit Quadrotor(const ModelConst& c)
      : mass(T(c.c[0])), L(T(c.c[7])), kf(T(c.c[8])), km(T(c.c[9])),
        beta(T(c.c[10])) {
    for (int k = 0; k < 3; ++k) {
      J[k] = T(c.c[1 + k]);
      mg[k] = mass * T(c.c[4 + k]);
    }
  }

  template <typename S>
  __device__ void eval(const S* x, const S* u, S* out) const {
    S F[4];
    for (int k = 0; k < 4; ++k) F[k] = thrust(kf * u[k], beta);
    const S Fs = ((F[0] + F[1]) + F[2]) + F[3];
    const S* q = x + 3;
    const S* v = x + 6;
    const S* w = x + 9;
    const S n2 = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2];
    const S D = T(1) + n2;
    const S om = T(1) - n2;
    const S D2 = D * D;
    const S s2e3[3] = {q[2] * q[0], q[2] * q[1],
                       -(q[0] * q[0] + q[1] * q[1])};
    const S se3[3] = {q[1], -q[0], S(T(0))};
    const S qw = (q[0] * w[0] + q[1] * w[1]) + q[2] * w[2];
    const S qxw[3] = {q[1] * w[2] - q[2] * w[1], q[2] * w[0] - q[0] * w[2],
                      q[0] * w[1] - q[1] * w[0]};
    const S tau[3] = {L * (F[1] - F[3]), L * (F[2] - F[0]),
                      ((km * u[0] - km * u[1]) + km * u[2]) - km * u[3]};
    const S Jw[3] = {J[0] * w[0], J[1] * w[1], J[2] * w[2]};
    const S wxJw[3] = {w[1] * Jw[2] - w[2] * Jw[1],
                       w[2] * Jw[0] - w[0] * Jw[2],
                       w[0] * Jw[1] - w[1] * Jw[0]};
    for (int k = 0; k < 3; ++k) {
      const S col = (T(8) * s2e3[k] + T(4) * om * se3[k]) / D2;
      const S c = (k == 2) ? T(1) + col : col;
      out[k] = v[k];
      out[3 + k] = T(0.25) * ((om * w[k] + T(2) * qxw[k])
                              + T(2) * q[k] * qw);
      out[6 + k] = (mg[k] + c * Fs) / mass;
      out[9 + k] = (tau[k] - wxJw[k]) / J[k];
    }
  }
  __device__ void f(const T* x, const T* u, T* out) const { eval(x, u, out); }
  __device__ Lin lin(const T* x, const T* u) const { return {x, u}; }

  __device__ void vjp(const Lin& l, const T* g, T* gx, T* gu) const {
    if (gx) {
      #pragma unroll
      for (int j = 0; j < 3; ++j) {
        gx[j] = T(0);
        gx[6 + j] = g[j];
      }
    }
    #pragma unroll
    for (int s = 3; s < NI + MI; ++s) {
      const bool xin = s < NI;
      if (xin ? (!gx || (s >= 6 && s < 9)) : !gu) continue;
      Dual<T> xd[NI], ud[MI], od[NI];
      #pragma unroll
      for (int j = 0; j < NI; ++j) xd[j] = Dual<T>(l.x[j], T(j == s ? 1 : 0));
      #pragma unroll
      for (int j = 0; j < MI; ++j)
        ud[j] = Dual<T>(l.u[j], T(NI + j == s ? 1 : 0));
      eval(xd, ud, od);
      T acc = T(0);
      #pragma unroll
      for (int r = 0; r < NI; ++r) acc += od[r].d * g[r];
      if (xin)
        gx[s] = acc;
      else
        gu[s - NI] = acc;
    }
  }
};

// ---------------------------------------------------------------------------
// The per-lane trial
// ---------------------------------------------------------------------------

template <typename T>
struct TrialArgs {
  const T *x, *u, *lam, *dx, *du, *dlam, *alpha, *reg, *Qd, *xf, *Rdp, *ufp,
      *spar, *slam, *smu, *zmax, *zmin, *clam, *cmu, *pmr;
  const SBlock* sb;                   // [nsb], device memory
  const unsigned char* meta;          // TrialMeta's table, device memory
  T *rx0, *ru0, *rd, *sc, *cc, *tn;
  int N, p, nsb, csum, ncb, npair, S;
  T dt, eps_n;
};

// The lane's trial point and current iterate, staged in shared memory
// (rows at an odd stride, so that the knots of a warp read different
// banks): trial x [N], current x [N], trial u [T], current u [T], trial
// lam [p, T], each row of n (or m) values.
template <typename T>
struct Lane {
  const T *xt, *x0, *ut, *u0, *lt;
  int Tn, n, m, ldx, ldu;
  __device__ T X(int k, int c) const { return xt[k * ldx + c]; }
  __device__ T U(int k, int c) const { return ut[k * ldu + c]; }
  __device__ T Lm(int i, int k, int c) const {
    return lt[(i * Tn + k) * ldx + c];
  }
  // The current iterate (the Tikhonov pull's anchor).
  __device__ T X0(int k, int c) const { return x0[k * ldx + c]; }
  __device__ T U0(int k, int c) const { return u0[k * ldu + c]; }
};

// 16 bytes of T, and component k (a compile-time constant once unrolled:
// no address is taken, so the vector stays in registers).
// The same accessors reading device memory directly, for instances that
// do not stage (the double integrators, whose knots read few values),
// through the read-only data path: the compiler may then issue them ahead
// of the knot's stores (with plain loads these µs-long trials ran 4-6%
// longer than the one-warp kernel's on an H100; with __ldg they match it,
// tests/trial_compare.py).
template <typename T>
struct GlobalLane {
  const T *x, *u, *lam, *dx, *du, *dlam;
  T al;
  int Tn, n, m;
  __device__ T X(int k, int c) const {
    const int o = k * n + c;
    return __ldg(x + o) + al * __ldg(dx + o);
  }
  __device__ T U(int k, int c) const {
    const int o = k * m + c;
    return __ldg(u + o) + al * __ldg(du + o);
  }
  __device__ T Lm(int i, int k, int c) const {
    const int o = (i * Tn + k) * n + c;
    return __ldg(lam + o) + al * __ldg(dlam + o);
  }
  __device__ T X0(int k, int c) const { return __ldg(x + k * n + c); }
  __device__ T U0(int k, int c) const { return __ldg(u + k * m + c); }
};

// The lane with its trial point and iterate staged as Lane's and its trial
// multipliers read from device memory as GlobalLane's (Model::kStageLam
// false).
template <typename T>
struct LaneXU : Lane<T> {
  const T *lam, *dlam;
  T al;
  __device__ T Lm(int i, int k, int c) const {
    const int o = (i * this->Tn + k) * this->n + c;
    return __ldg(lam + o) + al * __ldg(dlam + o);
  }
};

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };
__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ double comp(const double2& v, int k) {
  return k == 0 ? v.x : v.y;
}

// Stage ``rows`` rows of ``len`` values (contiguous in device memory):
// trial = cur + al del at row stride ``ld``, and ``cur`` itself where
// ``keep`` is not null.  Neighbouring threads read neighbouring 16-byte
// pieces where the lane's rows start on 16 bytes, else neighbouring values.
template <typename T>
__device__ __forceinline__ void stage(T* trial, T* keep, const T* cur,
                                      const T* del, T al, int rows, int len,
                                      int ld) {
  using V = typename Vec16<T>::type;
  constexpr int per = 16 / (int)sizeof(T);
  const int total = rows * len, tid = threadIdx.x, nth = blockDim.x;
  const bool v16 = ((reinterpret_cast<size_t>(cur) |
                     reinterpret_cast<size_t>(del)) & 15) == 0 &&
                   total % per == 0;
  if (v16) {
    const V* cv = reinterpret_cast<const V*>(cur);
    const V* dv = reinterpret_cast<const V*>(del);
    for (int e = tid; e < total / per; e += nth) {
      const V c4 = cv[e], d4 = dv[e];
      #pragma unroll
      for (int k = 0; k < per; ++k) {
        const int f = e * per + k, r = f / len, c = f - r * len;
        const T v = comp(c4, k);
        trial[r * ld + c] = v + al * comp(d4, k);
        if (keep) keep[r * ld + c] = v;
      }
    }
  } else {
    for (int f = tid; f < total; f += nth) {
      const int r = f / len, c = f - r * len;
      const T v = cur[f];
      trial[r * ld + c] = v + al * del[f];
      if (keep) keep[r * ld + c] = v;
    }
  }
}

// AL weight of one row: lam + Irho c with Irho = mu on an equality row
// (``eq``), else mu where c >= 0 or lam > 0 and 0 elsewhere.
template <typename T>
__device__ __forceinline__ T al_weight(T cv, T lc, T mu, bool eq) {
  return lc + ((eq || cv >= T(0) || lc > T(0)) ? mu : T(0)) * cv;
}

// |x_a - x_b|^2 over ``dim`` (2 or 3) coordinate pairs at knot k, with the
// differences in d [3] (d[2] = 0 in the plane).  The planar sum is one
// expression, d0^2 + d1^2, so that its rounding (and the compiler's
// contraction into fused multiply-adds) stays that of the unicycle kernel
// this one grew from.
template <typename T, class LaneT>
__device__ __forceinline__ T sqdist(const LaneT& L, int k,
                                    const unsigned char* a,
                                    const unsigned char* b, int dim, T* d) {
  #pragma unroll
  for (int j = 0; j < 3; ++j)
    d[j] = j < dim ? L.X(k, a[j]) - L.X(k, b[j]) : T(0);
  const T dd = d[0] * d[0] + d[1] * d[1];
  return dim == 3 ? dd + d[2] * d[2] : dd;
}

// State blocks at knot t+1: values into sc, AL gradients into alx [p n].
// Thread q of the knot's TPK takes the blocks whose owner is q mod TPK, so
// each owner's gradient is summed by one thread in block order.
// ``Flags``: a bound's rows by their flags in the parameter array, after
// z_max and z_min, not by SBlock::mask.
template <typename T, int TPK, bool Flags, class LaneT>
__device__ void state_blocks(const TrialArgs<T>& A, const SBlock* sbs,
                             const LaneT& L, int b, int t, T* alx, int q) {
  const int n = L.n, Tn = L.Tn;
  for (int k = 0; k < A.nsb; ++k) {
    // The record by value: read through a reference, its fields were read
    // again after every store to the shared gradient (which might alias
    // them), and the bicycle's trials ran 10% longer on an H100.
    const SBlock sb = sbs[k];
    if constexpr (TPK > 1) {
      if ((sb.owner & (TPK - 1)) != q) continue;
    }
    T* g = alx + sb.owner * n;
    const size_t o0 = ((size_t)b * A.csum + sb.row) * Tn + t;
    const T* par = A.spar + sb.par;
    if (sb.kind == kCollision) {          // c = r^2 - |x_i - x_j|^2
      T d[3];
      const T cv = par[0] - sqdist(L, t + 1, sb.a, sb.a + 3, sb.cnt, d);
      const T w = al_weight(cv, A.slam[o0], A.smu[o0], sb.eq);
      #pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= sb.cnt) break;
        g[sb.a[j]] += (T(-2) * d[j]) * w;
        g[sb.a[3 + j]] += (T(2) * d[j]) * w;
      }
      A.sc[o0] = cv;
    } else if (sb.kind == kCircle) {      // c_j = r_j^2 - |(x, y) - c_j|^2
      const T px = L.X(t + 1, sb.a[0]), py = L.X(t + 1, sb.a[1]);
      for (int j = 0; j < sb.cnt; ++j) {
        const T* pc = par + 3 * j;
        const T ex = px - pc[0], ey = py - pc[1];
        const T cv = pc[2] * pc[2] - ex * ex - ey * ey;
        const size_t o = o0 + (size_t)j * Tn;
        const T w = al_weight(cv, A.slam[o], A.smu[o], sb.eq);
        g[sb.a[0]] += (T(-2) * ex) * w;
        g[sb.a[1]] += (T(-2) * ey) * w;
        A.sc[o] = cv;
      }
    } else if (sb.kind == kWall2D) {      // c_j = (p - p1_j) . v_j, gated
      const T px = L.X(t + 1, sb.a[0]), py = L.X(t + 1, sb.a[1]);
      for (int j = 0; j < sb.cnt; ++j) {
        const T* pw = par + 6 * j;
        const T x1 = pw[0], y1 = pw[1], x2 = pw[2], y2 = pw[3];
        const bool gate =
            ((px - x1) * (x2 - x1) + (py - y1) * (y2 - y1)) > T(0) &&
            ((px - x2) * (x1 - x2) + (py - y2) * (y1 - y2)) > T(0);
        const T cv = gate ? (px - x1) * pw[4] + (py - y1) * pw[5] : T(0);
        const size_t o = o0 + (size_t)j * Tn;
        const T w = al_weight(cv, A.slam[o], A.smu[o], sb.eq);
        if (gate) {
          g[sb.a[0]] += pw[4] * w;
          g[sb.a[1]] += pw[5] * w;
        }
        A.sc[o] = cv;
      }
    } else if (sb.kind == kWall3D) {      // c_j = (p - p1_j) . v_j, gated
      const T pp[3] = {L.X(t + 1, sb.a[0]), L.X(t + 1, sb.a[1]),
                       L.X(t + 1, sb.a[2])};
      for (int j = 0; j < sb.cnt; ++j) {
        const T* pw = par + 12 * j;
        const T* p1 = pw;
        const T* p2 = pw + 3;
        const T* p3 = pw + 6;
        // (p - a) . (c - a) > 0 for the facet's four edges.
        T e[4] = {T(0), T(0), T(0), T(0)};
        for (int r = 0; r < 3; ++r) {
          e[0] += (pp[r] - p1[r]) * (p2[r] - p1[r]);
          e[1] += (pp[r] - p2[r]) * (p1[r] - p2[r]);
          e[2] += (pp[r] - p3[r]) * (p2[r] - p3[r]);
          e[3] += (pp[r] - p2[r]) * (p3[r] - p2[r]);
        }
        const bool gate = e[0] > T(0) && e[1] > T(0) && e[2] > T(0) &&
                          e[3] > T(0);
        const T cv = gate ? ((pp[0] - p1[0]) * pw[9]
                             + (pp[1] - p1[1]) * pw[10])
                                + (pp[2] - p1[2]) * pw[11]
                          : T(0);
        const size_t o = o0 + (size_t)j * Tn;
        const T w = al_weight(cv, A.slam[o], A.smu[o], sb.eq);
        if (gate) {
          #pragma unroll
          for (int r = 0; r < 3; ++r) g[sb.a[r]] += pw[9 + r] * w;
        }
        A.sc[o] = cv;
      }
    } else if (sb.kind == kCylinder) {    // r^2 - distance^2 to the axis
      const T pp[3] = {L.X(t + 1, sb.a[0]), L.X(t + 1, sb.a[1]),
                       L.X(t + 1, sb.a[2])};
      for (int j = 0; j < sb.cnt; ++j) {
        const T* pc = par + 5 * j;
        const int ax = (int)((sb.mask >> (2 * j)) & 3ull);
        const T t0[3] = {pp[0] - pc[0], pp[1] - pc[1], pp[2] - pc[2]};
        const T ta = ax == 0 ? t0[0] : (ax == 1 ? t0[1] : t0[2]);
        const bool valid = ta > T(0) && ta < pc[3];
        T out = pc[4] * pc[4] - t0[0] * t0[0] - t0[1] * t0[1] - t0[2] * t0[2];
        out = out + ta * ta;
        const T cv = valid ? out : T(0);
        const size_t o = o0 + (size_t)j * Tn;
        const T w = al_weight(cv, A.slam[o], A.smu[o], sb.eq);
        if (valid) {
          #pragma unroll
          for (int r = 0; r < 3; ++r)
            if (r != ax) g[sb.a[r]] += (T(-2) * t0[r]) * w;
        }
        A.sc[o] = cv;
      }
    } else {                              // c = [x - z_max; z_min - x], masked
      const T* zx = par;
      for (int j = 0; j < n; ++j) {
        bool mu_, ml_;
        if constexpr (Flags) {
          mu_ = zx[2 * n + j] != T(0);
          ml_ = zx[3 * n + j] != T(0);
        } else {
          mu_ = (sb.mask >> j) & 1ull;
          ml_ = (sb.mask >> (n + j)) & 1ull;
        }
        const size_t ou = o0 + (size_t)j * Tn, ol = o0 + (size_t)(n + j) * Tn;
        T cu = T(0), cl = T(0), gj = T(0);
        if (mu_) {
          cu = L.X(t + 1, j) - zx[j];
          gj = al_weight(cu, A.slam[ou], A.smu[ou], sb.eq);
        }
        if (ml_) {
          cl = zx[n + j] - L.X(t + 1, j);
          gj -= al_weight(cl, A.slam[ol], A.smu[ol], sb.eq);
        }
        if (mu_ || ml_) g[j] += gj;
        A.sc[ou] = cu;
        A.sc[ol] = cl;
      }
    }
  }
}

// The RK2 step of one player: defects F(x, u) - x_next into rd, and
// returns mid = x + dt/2 f(x, u).
template <typename T, class Model>
__device__ void rk2_mid(const Model& mdl, const T* x, const T* u, T dt,
                        T* mid) {
  T f0[Model::NI];
  mdl.f(x, u, f0);
  #pragma unroll
  for (int c = 0; c < Model::NI; ++c) mid[c] = x[c] + T(0.5) * (f0[c] * dt);
}

// One knot of the trial is shared by its TPK threads (q = 0 .. TPK-1,
// neighbouring lanes of one warp; TPK = 1: one thread per knot).  First
// (knot_blocks) thread q evaluates the state blocks and collision-cost
// pairs owned by the players q mod TPK and the control-bound rows q mod
// TPK into the knot's shared alx [p n], alu [m], cgx [p n]: each owner's
// gradient is summed by one thread, in block order.  Then, after a warp
// barrier, knot_rows adds the dynamics, control and statx rows of the
// players q mod TPK to the thread's part of the 1-norm.

// The knot's constraint and collision-cost terms (see above).
template <typename T, int TPK, bool Flags, class LaneT>
__device__ void knot_blocks(const TrialArgs<T>& A, const TrialMeta& meta,
                            const SBlock* sbs, const LaneT& L, int b, int t,
                            int q, T* alx, T* alu, T* cgx) {
  const int p = A.p, n = L.n, m = L.m, N = A.N, Tn = L.Tn;
  const T dt = A.dt;
  const T scale = (t + 1 < N - 1) ? dt : T(1);
  for (int o = q; o < p; o += TPK)
    for (int c = 0; c < n; ++c) alx[o * n + c] = T(0);
  for (int c = q; c < m; c += TPK) alu[c] = T(0);

  state_blocks<T, TPK, Flags>(A, sbs, L, b, t, alx, q);
  // Control-bound blocks: c = [u - z_max; z_min - u] (masked rows 0).
  for (int k = 0; k < A.ncb; ++k) {
    const size_t o = (((size_t)b * A.ncb + k) * Tn + t) * 2 * m;
    const unsigned char* cm = meta.c_mask + 2 * m * k;
    const bool eq = meta.c_eq[k];
    for (int j = q; j < m; j += TPK) {
      const T uj = L.U(t, j);
      const bool mu_ = cm[j], ml_ = cm[m + j];
      const T cu = mu_ ? uj - A.zmax[k * m + j] : T(0);
      const T cl = ml_ ? A.zmin[k * m + j] - uj : T(0);
      const T wu = al_weight(cu, A.clam[o + j], A.cmu[o + j], eq);
      const T wl = al_weight(cl, A.clam[o + m + j], A.cmu[o + m + j], eq);
      alu[j] += wu * (mu_ ? T(1) : T(0)) - wl * (ml_ ? T(1) : T(0));
      A.cc[o + j] = cu;
      A.cc[o + m + j] = cl;
    }
  }
  // Collision-cost pairs at knot t+1 (scaled like the cost): player i is
  // pushed off player j while |delta| < r,
  //   g = mu (r (eps + delta) / (eps_n + |delta|) - delta).
  if (A.npair) {
    for (int o = q; o < p; o += TPK)
      for (int c = 0; c < n; ++c) cgx[o * n + c] = T(0);
    for (int k = 0; k < A.npair; ++k) {
      const Pair pr = meta.pair[k];
      if constexpr (TPK > 1) {
        if ((pr.owner & (TPK - 1)) != q) continue;
      }
      const int dim = pr.dim;
      T d[3];
      const T dn = dsqrt(sqdist(L, t + 1, pr.a, pr.b, dim, d));
      const T mu = A.pmr[2 * k], r = A.pmr[2 * k + 1];
      if (!(r - dn > T(0))) continue;
      const T eps = T(1e-10);
      T* cg = cgx + pr.owner * n;
      #pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j >= dim) break;
        const T gj = mu * (r * (eps + d[j]) / (A.eps_n + dn) - d[j]) * scale;
        cg[pr.a[j]] -= gj;
        cg[pr.b[j]] += gj;
      }
    }
  }
}

// The knot's dynamics, control and statx rows of the players q mod TPK:
// returns ``part`` plus their terms of the 1-norm, added in the order (and
// grouping) of the unicycle kernel this one grew from: per player its
// dynamics rows as one sum, then its control rows as one sum; then every
// statx row, one at a time.
template <typename T, class Model, int TPK, class LaneT>
__device__ T knot_rows(const TrialArgs<T>& A, const ModelConst& mc,
                       const LaneT& L, int b, int t, int q, T rg,
                       const T* alx, const T* alu, const T* cgx, T part) {
  constexpr int NI = Model::NI, MI = Model::MI;
  using Lay = typename Model::Layout;
  const Model mdl(mc);
  const int p = A.p, n = L.n, m = L.m, N = A.N, Tn = L.Tn;
  const T dt = A.dt, half = T(0.5), halfdt = half * dt;
  const T scale = (t + 1 < N - 1) ? dt : T(1);

  // Dynamics rows and control rows: player j's RK2 step at knot t and the
  // pull of its own multiplier onto its controls.
  for (int j = q; j < p; j += TPK) {
    T xj[NI], uj[MI], mid[NI], fm[NI], g[NI], gx[NI], gu[MI], hu[MI];
    #pragma unroll
    for (int c = 0; c < NI; ++c) xj[c] = L.X(t, Lay::x(c, j, p));
    #pragma unroll
    for (int c = 0; c < MI; ++c)
      uj[c] = Lay::template u_at<T>(L, mc, t, c, j, p);
    rk2_mid<T>(mdl, xj, uj, dt, mid);
    mdl.f(mid, uj, fm);
    T* rd = A.rd + ((size_t)b * Tn + t) * n;
    T sd = T(0), su = T(0);
    #pragma unroll
    for (int c = 0; c < NI; ++c) {
      const int cc = Lay::x(c, j, p);
      const T r = (xj[c] + fm[c] * dt) - L.X(t + 1, cc);
      rd[cc] = r;
      sd += absval(r);
      g[c] = dt * L.Lm(j, t, cc);
    }
    part += sd;
    mdl.vjp(mdl.lin(mid, uj), g, gx, gu);
    mdl.vjp(mdl.lin(xj, uj), gx, (T*)nullptr, hu);
    T* ru0 = A.ru0 + ((size_t)b * Tn + t) * m;
    #pragma unroll
    for (int c = 0; c < MI; ++c) {
      if constexpr (Lay::kRagged) {
        if (!Lay::has_u(mc, c, j)) continue;
      }
      const int o = Lay::u(mc, c, j, p);
      const T ru = A.Rdp[o] * (uj[c] - A.ufp[o]) * dt + (gu[c] + halfdt * hu[c]);
      ru0[o] = ru;
      su += absval(ru + alu[o] + rg * (uj[c] - L.U0(t, o)));
    }
    part += su;
  }

  // Statx rows: cost gradient at x_{t+1} + A_{t+1}^T lam_{t+1} - lam_t, the
  // pulls of every player's multiplier through player j's step at t+1, one
  // multiplier at a time.  At the last knot (no step at t+1) the pulls are
  // computed on zeros, as every other thread of the warp computes its own,
  // and dropped.
  const bool has_next = t + 1 < Tn;
  for (int j = q; j < p; j += TPK) {
    T x1[NI], u1[MI], mid1[NI];
    #pragma unroll
    for (int c = 0; c < NI; ++c) x1[c] = L.X(t + 1, Lay::x(c, j, p));
    #pragma unroll
    for (int c = 0; c < MI; ++c)
      u1[c] = has_next ? Lay::template u_at<T>(L, mc, t + 1, c, j, p) : T(0);
    rk2_mid<T>(mdl, x1, u1, dt, mid1);
    const typename Model::Lin lin_mid = mdl.lin(mid1, u1);
    const typename Model::Lin lin_x = mdl.lin(x1, u1);
    for (int i = 0; i < p; ++i) {
      T g[NI], gx[NI], hx[NI];
      #pragma unroll
      for (int c = 0; c < NI; ++c)
        g[c] = has_next ? dt * L.Lm(i, t + 1, Lay::x(c, j, p)) : T(0);
      mdl.vjp(lin_mid, g, gx, (T*)nullptr);
      mdl.vjp(lin_x, gx, hx, (T*)nullptr);
      T* rx0 = A.rx0 + (((size_t)b * Tn + t) * p + i) * n;
      #pragma unroll
      for (int c = 0; c < NI; ++c) {
        const int cc = Lay::x(c, j, p);
        const T ax = has_next ? (L.Lm(i, t + 1, cc) + gx[c])
                                    + halfdt * hx[c]
                              : T(0);
        T qx = A.Qd[i * n + cc] * (x1[c] - A.xf[i * n + cc]) * scale;
        if (A.npair) qx += cgx[i * n + cc];
        const T r = (qx + ax) - L.Lm(i, t, cc);
        rx0[cc] = r;
        part += absval((r + alx[i * n + cc]) + rg * (x1[c] - L.X0(t + 1, cc)));
      }
    }
  }
  return part;
}

// Threads of a lane: ceil(T TPK / 32) warps, at most kMaxThreads (longer
// horizons loop over the knots).
template <int TPK>
int lane_threads(int Tn) {
  const int want = (Tn * TPK + 31) / 32 * 32;
  return want < kMaxThreads ? want : kMaxThreads;
}

// Shared memory of a lane, in scalars: the staged trial point and iterate
// (see Lane; none without ``stage``) and trial multipliers (none without
// ``stage_lam``), then per knot group (the TPK threads of one knot) its
// alx, alu and, with collision-cost pairs, cgx; then, at the next 8 bytes,
// the state blocks and TrialMeta's table (sblock_offset, lane_bytes).
struct LaneLayout {
  int ldx, ldu, xt, x0, ut, u0, lt, work, per, total;
  __host__ __device__ LaneLayout(int N, int n, int m, int p, int npair,
                                 int groups, bool stage, bool stage_lam) {
    const int Tn = N - 1, rows = stage ? 1 : 0;
    ldx = n | 1;
    ldu = m | 1;
    int o = 0;
    xt = o; o += rows * N * ldx;
    x0 = o; o += rows * N * ldx;
    ut = o; o += rows * Tn * ldu;
    u0 = o; o += rows * Tn * ldu;
    lt = o; o += (stage_lam ? rows : 0) * p * Tn * ldx;
    per = p * n + m + (npair ? p * n : 0);
    work = o; o += groups * per;
    total = o;
  }
};

// Knot groups (TPK threads each) that hold work arrays: one per knot of a
// pass.
__host__ __device__ __forceinline__ int work_groups(int nth, int tpk,
                                                   int Tn) {
  return nth / tpk < Tn ? nth / tpk : Tn;
}

// Where the staged state blocks start (models with Model::kStage; the
// table after them), and a lane's bytes.
__host__ __device__ __forceinline__ size_t sblock_offset(int total,
                                                         size_t scalar) {
  return ((size_t)total * scalar + 7) & ~(size_t)7;
}
template <typename T, class Model>
size_t lane_bytes(const LaneLayout& S, int nsb, size_t table) {
  return Model::kStage ? sblock_offset(S.total, sizeof(T)) +
                             (size_t)nsb * sizeof(SBlock) + table
                       : (size_t)S.total * sizeof(T);
}

// The lane's layout for an instance.
template <class Model>
__host__ __device__ LaneLayout lane_layout(int N, int n, int m, int p,
                                           int npair, int nth, int tpk) {
  return LaneLayout(N, n, m, p, npair, work_groups(nth, tpk, N - 1),
                    Model::kStage, Model::kStageLam);
}

// --- kernel and launch -------------------------------------------------------

// The thread's part of the lane's 1-norm: one pass over the knots (a loop
// past kMaxThreads), TPK threads each, with the knot group's alx, alu and
// cgx at ``work``.  The lane's Tikhonov weight is read before the knots'
// stores, which the compiler may not move a later read across.
template <typename T, class Model, int TPK, class LaneT>
__device__ T lane_part(const TrialArgs<T>& A, const ModelConst& mc,
                       const TrialMeta& meta, const SBlock* sbs,
                       const LaneT& L, int b, T* work, int per) {
  const int tid = threadIdx.x, groups = blockDim.x / TPK;
  const int g = tid / TPK, q = tid & (TPK - 1);
  T* alx = work + g * per;                                 // AL grads
  T* alu = alx + A.p * L.n;
  T* cgx = alu + L.m;                                      // pair grads
  const T rg = A.reg[b];
  T part = T(0);
  for (int t0 = 0; t0 < L.Tn; t0 += groups) {
    const int t = t0 + g;
    if (t < L.Tn)
      knot_blocks<T, TPK, Model::kRowFlags>(
          A, meta, sbs, L, b, t, q, alx, alu, cgx);
    if constexpr (TPK > 1) __syncwarp();
    if (t < L.Tn)
      part = knot_rows<T, Model, TPK>(A, mc, L, b, t, q, rg, alx, alu, cgx,
                                      part);
    if constexpr (TPK > 1) __syncwarp();   // the group's alx, alu, cgx free
  }
  return part;
}

// One lane's trial, in one block: the lane's inputs and the state blocks'
// records staged in shared memory (models with Model::kStage; the others
// read both from device memory, where a barrier after staging the records
// cost the 3D double integrator's trials 4.6% on an H100,
// tests/trial_compare.py), one pass over the knots, the 1-norm summed by
// warp shuffles and then over the warps in order.
template <typename T, class Model, int TPK>
__device__ __forceinline__ void trial_lane(const TrialArgs<T>& A,
                                           const ModelConst& mc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T warp_part[kMaxThreads / 32];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int p = A.p, n = Model::NI * p, m = Model::Layout::m(mc, p);
  const int N = A.N, Tn = N - 1;
  const LaneLayout S = lane_layout<Model>(N, n, m, p, A.npair, nth, TPK);
  const T al = A.alpha[b];
  const size_t ox = (size_t)b * N * n, ou = (size_t)b * Tn * m,
               ol = (size_t)b * p * Tn * n;
  T part;
  if constexpr (Model::kStage) {
    SBlock* sbs = reinterpret_cast<SBlock*>(
        smem_raw + sblock_offset(S.total, sizeof(T)));
    constexpr int kWords = (int)(sizeof(SBlock) / sizeof(int));
    const int* src = reinterpret_cast<const int*>(A.sb);
    int* dst = reinterpret_cast<int*>(sbs);
    for (int i = tid; i < A.nsb * kWords; i += nth) dst[i] = src[i];
    unsigned char* tab = reinterpret_cast<unsigned char*>(sbs + A.nsb);
    const int twords = (int)(meta_bytes(A.npair, A.ncb, m) / sizeof(int));
    const int* tsrc = reinterpret_cast<const int*>(A.meta);
    for (int i = tid; i < twords; i += nth)
      reinterpret_cast<int*>(tab)[i] = tsrc[i];
    const TrialMeta meta(tab, A.npair, A.ncb, m);
    stage(sm + S.xt, sm + S.x0, A.x + ox, A.dx + ox, al, N, n, S.ldx);
    stage(sm + S.ut, sm + S.u0, A.u + ou, A.du + ou, al, Tn, m, S.ldu);
    if constexpr (Model::kStageLam)
      stage(sm + S.lt, (T*)nullptr, A.lam + ol, A.dlam + ol, al, p * Tn, n,
            S.ldx);
    __syncthreads();
    const Lane<T> L{sm + S.xt, sm + S.x0, sm + S.ut, sm + S.u0, sm + S.lt,
                    Tn, n, m, S.ldx, S.ldu};
    if constexpr (Model::kStageLam) {
      part = lane_part<T, Model, TPK>(A, mc, meta, sbs, L, b, sm + S.work,
                                      S.per);
    } else {
      const LaneXU<T> LX{L, A.lam + ol, A.dlam + ol, al};
      part = lane_part<T, Model, TPK>(A, mc, meta, sbs, LX, b, sm + S.work,
                                      S.per);
    }
  } else {
    const TrialMeta meta(A.meta, A.npair, A.ncb, m);
    const GlobalLane<T> L{A.x + ox, A.u + ou, A.lam + ol, A.dx + ox,
                          A.du + ou, A.dlam + ol, al, Tn, n, m};
    part = lane_part<T, Model, TPK>(A, mc, meta, A.sb, L, b, sm + S.work,
                                    S.per);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, off);
  if (nth > 32) {
    if ((tid & 31) == 0) warp_part[tid >> 5] = part;
    __syncthreads();
    if (tid == 0)
      for (int w = 1; w < nth / 32; ++w) part += warp_part[w];
  }
  if (tid == 0) A.tn[b] = part / T(A.S);
}

// One block per lane.  No __launch_bounds__: with one (of 32 to 256
// threads) ptxas kept several f32 instances near 64 registers and spilled
// (CUDA 12.9, -Xptxas -v); without, none spills and every stack frame is at
// most the earlier one-warp kernel's.
template <typename T, class Model, int TPK>
__global__ void trial_fused_kernel(const __grid_constant__ TrialArgs<T> A,
                                   const __grid_constant__ ModelConst mc) {
  trial_lane<T, Model, TPK>(A, mc);
}

// Lanes per SM of an instance for a game of horizon N - 1 knots, p
// players, (with npair) collision-cost pairs, nsb state blocks and ncb
// control-bound blocks; -1 on error.
template <typename T, class Model, int TPK>
int occupancy(const double* mconst, int N, int p, int npair, int nsb,
              int ncb) {
  ModelConst mc;
  for (int k = 0; k < kMaxConst; ++k) mc.c[k] = mconst[k];
  const int nth = lane_threads<TPK>(N - 1), m = Model::Layout::m(mc, p);
  const LaneLayout S =
      lane_layout<Model>(N, Model::NI * p, m, p, npair, nth, TPK);
  const size_t bytes =
      lane_bytes<T, Model>(S, nsb, meta_bytes(npair, ncb, m));
  const auto kernel = trial_fused_kernel<T, Model, TPK>;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes))
    return -1;
  int lanes = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lanes, kernel, nth,
                                                    bytes))
    return -1;
  return lanes;
}

template <typename T, class Model, int TPK>
int run_kernel(const TrialArgs<T>& A, const ModelConst& mc, int B,
               void* stream) {
  const int nth = lane_threads<TPK>(A.N - 1), m = Model::Layout::m(mc, A.p);
  const LaneLayout S =
      lane_layout<Model>(A.N, Model::NI * A.p, m, A.p, A.npair, nth, TPK);
  const size_t bytes =
      lane_bytes<T, Model>(S, A.nsb, meta_bytes(A.npair, A.ncb, m));
  const auto kernel = trial_fused_kernel<T, Model, TPK>;
  if (bytes > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err) return err;
  }
  kernel<<<B, nth, bytes, (cudaStream_t)stream>>>(A, mc);
  return (int)cudaGetLastError();
}

// --- end of kernel and launch ------------------------------------------------

template <typename T, class Model, int TPK>
int launch(const void* const* in, void* const* out, const double* mconst,
           const void* sblocks, const void* meta, int B, int N, int p,
           int nsb, int csum, int ncb, int npair, int S, double dt,
           double eps_n, void* stream) {
  ModelConst mc;
  for (int k = 0; k < kMaxConst; ++k) mc.c[k] = mconst[k];
  const int n = Model::NI * p;
  if ((!Model::kRowFlags && n > kMaxN) ||
      nsb < 0 || ncb < 0 || npair < 0 || (nsb > 0 && sblocks == nullptr) ||
      (npair + ncb > 0 && meta == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  TrialArgs<T> A;
  A.sb = (const SBlock*)sblocks;
  A.meta = (const unsigned char*)meta;
  const T** ins[] = {&A.x, &A.u, &A.lam, &A.dx, &A.du, &A.dlam, &A.alpha,
                     &A.reg, &A.Qd, &A.xf, &A.Rdp, &A.ufp, &A.spar, &A.slam,
                     &A.smu, &A.zmax, &A.zmin, &A.clam, &A.cmu, &A.pmr};
  for (int k = 0; k < 20; ++k) *ins[k] = (const T*)in[k];
  T** outs[] = {&A.rx0, &A.ru0, &A.rd, &A.sc, &A.cc, &A.tn};
  for (int k = 0; k < 6; ++k) *outs[k] = (T*)out[k];
  A.N = N; A.p = p; A.nsb = nsb; A.csum = csum; A.ncb = ncb;
  A.npair = npair; A.S = S; A.dt = (T)dt; A.eps_n = (T)eps_n;
  return run_kernel<T, Model, TPK>(A, mc, B, stream);
}

}  // namespace

// trial_fused_<instance>_<type>(inputs [20], outputs [6], model constants
// [12], the state blocks (device, SBlock [nsb]), TrialMeta's table
// (device, meta_bytes), sizes, stream): the operands in the order of
// TrialArgs;
// trial_fused_<instance>_<type>_occupancy: its lanes per SM (with nsb state
// blocks and the table of npair pairs and ncb control blocks staged).
// An instance is a model with its threads per knot (TPK): one, or two for
// the unicycle games of four or more players ("unicycle_spread"), whose
// knots carry the most blocks and pairs (on the roundabout's trials two
// threads per knot ran faster than one or four on an H100); past 32 states
// (nine players or more) the unicycle's wide instance ("unicycle_wide",
// two threads per knot: bound rows flagged in the parameter array, the
// multipliers not staged).
#define TRIAL_EXPORT(NAME, SUFFIX, T, MODEL, TPK)                             \
  extern "C" int trial_fused_##NAME##_##SUFFIX(                               \
      const void* const* in, void* const* out, const double* mconst,          \
      const void* sblocks, const void* meta, int B, int N, int p, int nsb,    \
      int csum, int ncb, int npair, int S, double dt, double eps_n,           \
      void* stream) {                                                         \
    return launch<T, MODEL, TPK>(in, out, mconst, sblocks, meta, B, N, p,     \
                                 nsb, csum, ncb, npair, S, dt, eps_n,         \
                                 stream);                                     \
  }                                                                           \
  extern "C" int trial_fused_##NAME##_##SUFFIX##_occupancy(                   \
      const double* mconst, int N, int p, int npair, int nsb, int ncb) {      \
    return occupancy<T, MODEL, TPK>(mconst, N, p, npair, nsb, ncb);           \
  }
#define TRIAL_EXPORT_BOTH(NAME, MODEL, TPK)                                   \
  TRIAL_EXPORT(NAME, f32, float, MODEL<float>, TPK)                           \
  TRIAL_EXPORT(NAME, f64, double, MODEL<double>, TPK)

template <typename T> using DoubleIntegrator2 = DoubleIntegrator<T, 2>;
template <typename T> using DoubleIntegrator3 = DoubleIntegrator<T, 3>;
template <typename T> using HeteroDoubleIntegrator2 =
    HeteroDoubleIntegrator<T, 2>;

TRIAL_EXPORT_BOTH(unicycle, Unicycle, 1)
TRIAL_EXPORT_BOTH(unicycle_spread, Unicycle, 2)
TRIAL_EXPORT_BOTH(unicycle_wide, UnicycleWide, 2)
TRIAL_EXPORT_BOTH(di2, DoubleIntegrator2, 1)
TRIAL_EXPORT_BOTH(di3, DoubleIntegrator3, 1)
TRIAL_EXPORT_BOTH(hdi2, HeteroDoubleIntegrator2, 1)
TRIAL_EXPORT_BOTH(bicycle, Bicycle, 1)
TRIAL_EXPORT_BOTH(quadrotor, Quadrotor, 1)

extern "C" int trial_fused_sblock_bytes() { return (int)sizeof(SBlock); }

extern "C" int trial_fused_pair_bytes() { return (int)sizeof(Pair); }

extern "C" const char* trial_fused_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
