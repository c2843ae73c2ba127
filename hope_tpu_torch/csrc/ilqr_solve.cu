// The batched iLQR solve of hope_tpu_torch/planning/ilqr.py (solve_batch),
// the whole of it in one launch: a block per row.
//
// It replaces no Pallas TPU kernel: the JAX package leaves its iLQR
// (hope_tpu/planning/ilqr.py, solve_batch) to XLA. In plain PyTorch a solve
// at the MPC configuration (B = 256 rows, horizon N = 40, E = 512 edge
// slots, 12 iterations, A = 5 step sizes) is ~50 000 small launches: the
// 40-step Riccati pass and rollouts a launch per 3 x 3 product, and the
// clearance cost's distances to every edge written to and read back from
// device memory. Replayed as one CUDA graph the card still spends ~2.5 us a
// node, ~170 ms a solve, for ~29.5 GFLOP of work (portbench/ilqr_work.py),
// 0.44 ms at the float32 peak.
//
// What bounds it on an H100: operations. The clearance cost takes nearly all
// of them: per row and iteration the distance from the 3 body discs of A x
// (N + 1) line-search poses to every live edge (a division and a square
// root among ~25 operations each), against a few KB of inputs per row. The
// rest is serial in the horizon: the Riccati pass (~250 operations a step)
// and the A rollouts (~80 a step, with tan, sin and cos).
//
// Design: one block per row, and one row's solve stays on its SM with its
// working set in shared memory (~31 KB at the configuration above):
//  - the row's live edges are compacted once per solve, in slot order, with
//    their direction and squared length, so a dead slot costs nothing (its
//    distance is +inf in solve_batch and never the minimum);
//  - the iterate, the A candidate rollouts, the derivatives, the gains and,
//    per (pose, disc), the nearest live edge and its distance stay in shared
//    memory for all iterations;
//  - the clearance is a thread per (pose, disc), which walks the live edges
//    in order (every thread of a warp reads the same edge: a broadcast) and
//    keeps the first minimum, as torch.min does;
//  - the line search's pass finds the nearest edges of every candidate pose,
//    so the next iteration's derivatives are formed at the chosen iterate's
//    stored nearest edges, with no second pass over the edges;
//  - the Riccati pass runs in one thread, the A rollouts in A threads, the
//    per-step derivatives and costs a thread per step.
// The arithmetic is solve_batch's, operation for operation where PyTorch's
// order is known (built with -fmad=false; a division by a Python scalar is a
// product with its float32 reciprocal, as PyTorch's CUDA kernels take it).
// Sums over the horizon and the 3 x 3 products of the Riccati pass run in
// another order than PyTorch's reductions and cuBLAS, so results agree to
// float32 rounding, not bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ALPHAS = 16;
constexpr int DISCS = 3;
constexpr int GH = 9;            // a (pose, disc)'s gradient (3) and Hessian (6)

}  // namespace

// The configuration, in float32 as solve_batch's operations see each
// number (ops/ilqr_solve.py fills it).
struct IlqrParams {
  float dt, max_steer, max_speed, inv_wheel_base;
  float w_run, w_control, w_rate, w_obstacle;
  float two_w_run, luu00, luu11;
  float w_term_pos, w_term_heading, two_w_term_pos;
  float two_w_obstacle, margin, radius;
  float offsets[DISCS];
  float reg_init;
  float alphas[MAX_ALPHAS];
  int n_alphas, n_iters;
};

namespace {

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clip_grad(float x, float bound) {
  const float a = fabsf(x);
  return a == bound ? 0.5f : (a < bound ? 1.0f : 0.0f);
}

// (sin h / h, its derivative), ilqr._sinc
__device__ __forceinline__ void sinc(float h, float& s, float& ds) {
  const float h2 = h * h;
  if (fabsf(h) < 0.5f) {
    s = 1.0f - h2 * (1.0f / 6.0f) *
                   (1.0f - h2 * (1.0f / 20.0f) *
                               (1.0f - h2 * (1.0f / 42.0f) * (1.0f - h2 * (1.0f / 72.0f))));
    ds = -h * (1.0f / 3.0f) *
         (1.0f - h2 * (1.0f / 10.0f) * (1.0f - h2 * (1.0f / 28.0f) * (1.0f - h2 * (1.0f / 54.0f))));
  } else {
    s = sinf(h) / h;
    ds = (cosf(h) - s) / h;
  }
}

// The chord-form arc step, ilqr._dynamics: x (3), u (2) -> nx (3); with
// fx02, fx12 (fx's two entries off the identity) and fu (3 x 2, row-major)
// where fu is given.
__device__ void arc_step(const IlqrParams& P, const float* x, float u0, float u1, float* nx,
                         float* fx02 = nullptr, float* fx12 = nullptr, float* fu = nullptr) {
  const float steer = clampf(u0, -P.max_steer, P.max_steer);
  const float v = clampf(u1, -P.max_speed, P.max_speed);
  const float tn = tanf(steer);
  const float curv = tn * P.inv_wheel_base;
  const float vdt = v * P.dt;
  const float dth = vdt * curv;
  const float th = x[2];
  float S, dS;
  sinc(0.5f * dth, S, dS);
  const float mid = th + 0.5f * dth;
  const float cm = cosf(mid), sm = sinf(mid);
  const float dx = vdt * cm * S, dy = vdt * sm * S;
  nx[0] = x[0] + dx;
  nx[1] = x[1] + dy;
  nx[2] = th + dth;
  if (fu == nullptr) return;
  const float g_s = clip_grad(u0, P.max_steer), g_v = clip_grad(u1, P.max_speed);
  const float dx_v = P.dt * cosf(th + dth), dy_v = P.dt * sinf(th + dth);
  const float half = 0.5f * vdt * vdt;
  const float curv_s = (1.0f + tn * tn) * P.inv_wheel_base;
  const float dx_s = half * (cm * dS - sm * S) * curv_s;
  const float dy_s = half * (sm * dS + cm * S) * curv_s;
  const float dth_s = vdt * curv_s;
  *fx02 = -dy;
  *fx12 = dx;
  fu[0] = dx_s * g_s;
  fu[1] = dx_v * g_v;
  fu[2] = dy_s * g_s;
  fu[3] = dy_v * g_v;
  fu[4] = dth_s * g_s;
  fu[5] = curv * P.dt * g_v;
}

// Body disc j's centre at pose x.
__device__ __forceinline__ void disc_centre(const IlqrParams& P, const float* x, int j, float& px,
                                            float& py, float& c, float& s) {
  c = cosf(x[2]);
  s = sinf(x[2]);
  px = x[0] + c * P.offsets[j];
  py = x[1] + s * P.offsets[j];
}

// The foot of (px, py) on live edge e: the offset from it (dx, dy) and the
// unclamped parameter t along the edge.
__device__ __forceinline__ float foot(const float4* seg, const float* den, int e, float px,
                                      float py, float& dx, float& dy) {
  const float4 g = seg[e];
  const float apx = px - g.x, apy = py - g.y;
  const float t = (apx * g.z + apy * g.w) / den[e];
  const float tc = clampf(t, 0.0f, 1.0f);
  dx = apx - tc * g.z;
  dy = apy - tc * g.w;
  return t;
}

// The nearest of the L live edges to (px, py): its distance (+inf with no
// live edge) and index, the first one at a tie; a NaN distance wins, as in
// torch.min.
__device__ float nearest(const float4* seg, const float* den, int L, float px, float py, int& idx) {
  float best = __int_as_float(0x7f800000);
  idx = -1;
  for (int e = 0; e < L; ++e) {
    float dx, dy;
    foot(seg, den, e, px, py, dx, dy);
    const float d = sqrtf(dx * dx + dy * dy);
    if (d < best || (d != d && best == best)) {
      best = d;
      idx = e;
    }
  }
  return best;
}

__device__ __forceinline__ float violation(const IlqrParams& P, float dmin) {
  return clampf(P.margin - (dmin - P.radius), 0.0f, __int_as_float(0x7f800000));
}

// Rows [0, R) of poses xs (R x (N + 1) x 3): every (pose, disc)'s nearest
// live edge, into d and idx (R x (N + 1) x 3).
__device__ void clearance_pass(const IlqrParams& P, const float4* seg, const float* den, int L,
                               const float* xs, int items, float* d, int* idx) {
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    float px, py, c, s;
    disc_centre(P, xs + 3 * (i / DISCS), i % DISCS, px, py, c, s);
    d[i] = nearest(seg, den, L, px, py, idx[i]);
  }
}

// Per-step costs of R rollouts (xs R x (N + 1) x 3, us R x N x 2, with their
// nearest-edge distances d) into stage (R x (N + 1)): make_costs' stage cost
// at t < N, its terminal cost at t = N.
__device__ void cost_pass(const IlqrParams& P, const float* goal, const float* xs, const float* us,
                          const float* d, int R, int N, float* stage) {
  const int N1 = N + 1;
  for (int i = threadIdx.x; i < R * N1; i += blockDim.x) {
    const int r = i / N1, t = i % N1;
    const float* x = xs + 3 * i;
    const float* dd = d + DISCS * i;
    const float v0 = violation(P, dd[0]), v1 = violation(P, dd[1]), v2 = violation(P, dd[2]);
    const float obs = P.w_obstacle * (v0 * v0 + v1 * v1 + v2 * v2);
    const float ex = x[0] - goal[0], ey = x[1] - goal[1];
    if (t < N) {
      const float* u = us + 2 * (r * N + t);
      const float up0 = t == 0 ? u[0] : u[-2];
      const float pos = P.w_run * (ex * ex + ey * ey);
      const float ctrl = P.w_control * (u[0] * u[0] + u[1] * u[1]);
      const float du = u[0] - up0;
      const float rate = P.w_rate * (du * du);
      stage[i] = pos + ctrl + rate + obs;
    } else {
      const float pos = P.w_term_pos * (ex * ex + ey * ey);
      const float hd = P.w_term_heading * (1.0f - cosf(x[2] - goal[2]));
      stage[i] = pos + hd + obs;
    }
  }
}

__device__ __forceinline__ float total_cost(const float* stage, int N) {
  float c = 0.0f;
  for (int t = 0; t < N; ++t) c += stage[t];
  return c + stage[N];
}

// A (pose, disc)'s clearance gradient (3) and Hessian (6: 00 01 02 11 12 22)
// in (x, y, th) at its nearest live edge, as ilqr._obstacle forms them
// (before the sum over discs and its sign); zeros where the disc is clear.
__device__ void clearance_derivs(const IlqrParams& P, const float4* seg, const float* den,
                                 const float* x, int j, float dmin, int idx, float* gh) {
  const float viol = violation(P, dmin);
  if (!(viol > 0.0f)) {
    for (int k = 0; k < GH; ++k) gh[k] = 0.0f;
    return;
  }
  float px, py, c, s;
  disc_centre(P, x, j, px, py, c, s);
  float dsx, dsy;
  const float t = foot(seg, den, idx, px, py, dsx, dsy);
  const float4 g = seg[idx];
  const bool inside = t > 0.0f && t < 1.0f;
  const float along = inside ? (dsx * g.z + dsy * g.w) / den[idx] : 0.0f;
  const float nx = (dsx - along * g.z) / dmin, ny = (dsy - along * g.w) / dmin;
  float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
  if (!inside) {
    h00 = (1.0f - nx * nx) / dmin;
    h01 = (0.0f - nx * ny) / dmin;
    h11 = (1.0f - ny * ny) / dmin;
  }
  const float o = P.offsets[j];
  const float j0 = -s * o, j1 = c * o;
  const float gd[3] = {nx, ny, nx * j0 + ny * j1};
  // J^T Hc J with J = [[1, 0, j0], [0, 1, j1]], then the centre's curvature
  // in the heading
  const float x20 = j0 * h00 + j1 * h01, x21 = j0 * h01 + j1 * h11;
  const float hd[6] = {h00, h01, h00 * j0 + h01 * j1, h11, h01 * j0 + h11 * j1,
                       x20 * j0 + x21 * j1 - (nx * (c * o) + ny * (s * o))};
  const float wv = P.two_w_obstacle * viol;
  gh[0] = wv * gd[0];
  gh[1] = wv * gd[1];
  gh[2] = wv * gd[2];
  const int kk[6] = {0, 0, 0, 1, 1, 2}, ll[6] = {0, 1, 2, 1, 2, 2};
  for (int m = 0; m < 6; ++m)
    gh[3 + m] = P.two_w_obstacle * (gd[kk[m]] * gd[ll[m]] - viol * hd[m]);
}

// Shared-memory layout of one row (the wrapper mirrors it in smem_bytes).
struct Row {
  float4* seg;      // E: live edges (a, b - a), compacted
  float* den;       // E: |b - a|^2, floored at 1e-12
  float* xs;        // (N + 1) x 3: the iterate
  float* us;        // N x 2
  float* d;         // (N + 1) x 3: each (pose, disc)'s nearest live distance
  int* idx;         // (N + 1) x 3: and that edge
  float* xa;        // A x (N + 1) x 3: the line search's rollouts
  float* ua;        // A x N x 2
  float* da;        // A x (N + 1) x 3
  int* ia;          // A x (N + 1) x 3
  float* stage;     // A x (N + 1): per-step costs
  float* gh;        // (N + 1) x 3 x 9: per (pose, disc) derivatives
  float* lx;        // N x 3
  float* lu;        // N x 2
  float* lxx;       // N x 6 (00 01 02 11 12 22)
  float* fx;        // N x 2 (fx02, fx12)
  float* fu;        // N x 6
  float* vx;        // 3: the terminal cost's gradient
  float* vxx;       // 6
  float* ks;        // N x 2
  float* Ks;        // N x 6
  float* goal;      // 3
  float* scal;      // cost, reg, c0
  int* ints;        // live edges, pick
};

__device__ Row carve(void* base, int N, int E, int A) {
  const int N1 = N + 1;
  Row r;
  r.seg = reinterpret_cast<float4*>(base);
  float* f = reinterpret_cast<float*>(r.seg + E);
  auto take = [&f](int n) { float* p = f; f += n; return p; };
  r.den = take(E);
  r.xs = take(3 * N1);
  r.us = take(2 * N);
  r.d = take(DISCS * N1);
  r.idx = reinterpret_cast<int*>(take(DISCS * N1));
  r.xa = take(A * 3 * N1);
  r.ua = take(A * 2 * N);
  r.da = take(A * DISCS * N1);
  r.ia = reinterpret_cast<int*>(take(A * DISCS * N1));
  r.stage = take(A * N1);
  r.gh = take(GH * DISCS * N1);
  r.lx = take(3 * N);
  r.lu = take(2 * N);
  r.lxx = take(6 * N);
  r.fx = take(2 * N);
  r.fu = take(6 * N);
  r.vx = take(3);
  r.vxx = take(6);
  r.ks = take(2 * N);
  r.Ks = take(6 * N);
  r.goal = take(3);
  r.scal = take(3);
  r.ints = reinterpret_cast<int*>(take(2));
  return r;
}

// quadraticize at the iterate, from its stored nearest edges: the stage
// terms' lx, lu, lxx and the dynamics' fx, fu at t < N, the terminal Vx,
// Vxx at t = N; with q (the row's slice of the quad output) also written
// there in full (lx, lu, lxx 3 x 3, fx 3 x 3, fu 3 x 2 per step, then Vx,
// Vxx 3 x 3).
__device__ void quadraticize(const IlqrParams& P, const Row& r, int N, float* q) {
  const int N1 = N + 1;
  for (int i = threadIdx.x; i < DISCS * N1; i += blockDim.x)
    clearance_derivs(P, r.seg, r.den, r.xs + 3 * (i / DISCS), i % DISCS, r.d[i], r.idx[i],
                     r.gh + GH * i);
  __syncthreads();
  for (int t = threadIdx.x; t < N1; t += blockDim.x) {
    const float* x = r.xs + 3 * t;
    const float* g = r.gh + GH * DISCS * t;
    float grad[3], hess[6];
    for (int k = 0; k < 3; ++k) grad[k] = -(g[k] + g[GH + k] + g[2 * GH + k]);
    for (int m = 0; m < 6; ++m) hess[m] = g[3 + m] + g[GH + 3 + m] + g[2 * GH + 3 + m];
    const float ex = x[0] - r.goal[0], ey = x[1] - r.goal[1];
    float *lx, *lxx;
    if (t < N) {
      lx = r.lx + 3 * t;
      lxx = r.lxx + 6 * t;
      lx[0] = grad[0] + P.two_w_run * ex;
      lx[1] = grad[1] + P.two_w_run * ey;
      lx[2] = grad[2] + 0.0f;
      lxx[0] = hess[0] + P.two_w_run;
      lxx[3] = hess[3] + P.two_w_run;
      lxx[5] = hess[5] + 0.0f;
      const float* u = r.us + 2 * t;
      const float up0 = t == 0 ? u[0] : u[-2];
      r.lu[2 * t] = P.w_control * (2.0f * u[0]) + P.w_rate * (2.0f * (u[0] - up0));
      r.lu[2 * t + 1] = P.w_control * (2.0f * u[1]);
      float nx[3];
      arc_step(P, x, u[0], u[1], nx, r.fx + 2 * t, r.fx + 2 * t + 1, r.fu + 6 * t);
    } else {
      lx = r.vx;
      lxx = r.vxx;
      const float dh = x[2] - r.goal[2];
      lx[0] = grad[0] + P.two_w_term_pos * ex;
      lx[1] = grad[1] + P.two_w_term_pos * ey;
      lx[2] = grad[2] + P.w_term_heading * sinf(dh);
      lxx[0] = hess[0] + P.two_w_term_pos;
      lxx[3] = hess[3] + P.two_w_term_pos;
      lxx[5] = hess[5] + P.w_term_heading * cosf(dh);
    }
    lxx[1] = hess[1] + 0.0f;
    lxx[2] = hess[2] + 0.0f;
    lxx[4] = hess[4] + 0.0f;
    if (q != nullptr) {
      const int sym[9] = {0, 1, 2, 1, 3, 4, 2, 4, 5};
      float* o = t < N ? q + 29 * t : q + 29 * N;
      for (int k = 0; k < 3; ++k) o[k] = lx[k];
      if (t < N) {
        o[3] = r.lu[2 * t];
        o[4] = r.lu[2 * t + 1];
        for (int k = 0; k < 9; ++k) o[5 + k] = lxx[sym[k]];
        const float* f = r.fx + 2 * t;
        const float fx[9] = {1.0f, 0.0f, f[0], 0.0f, 1.0f, f[1], 0.0f, 0.0f, 1.0f};
        for (int k = 0; k < 9; ++k) o[14 + k] = fx[k];
        for (int k = 0; k < 6; ++k) o[23 + k] = r.fu[6 * t + k];
      } else {
        for (int k = 0; k < 9; ++k) o[3 + k] = lxx[sym[k]];
      }
    }
  }
}

// The Riccati pass (solve_batch.backward), in one thread: the gains k (2)
// and K (2 x 3) of every step.
__device__ void backward(const IlqrParams& P, const Row& r, int N, float reg) {
  float Vx[3] = {r.vx[0], r.vx[1], r.vx[2]};
  float V[3][3] = {{r.vxx[0], r.vxx[1], r.vxx[2]},
                   {r.vxx[1], r.vxx[3], r.vxx[4]},
                   {r.vxx[2], r.vxx[4], r.vxx[5]}};
  for (int t = N - 1; t >= 0; --t) {
    const float f02 = r.fx[2 * t], f12 = r.fx[2 * t + 1];
    float fu[3][2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 2; ++j) fu[i][j] = r.fu[6 * t + 2 * i + j];
    const float* lx = r.lx + 3 * t;
    const float* lu = r.lu + 2 * t;
    const float* l = r.lxx + 6 * t;
    const float lxx[3][3] = {{l[0], l[1], l[2]}, {l[1], l[3], l[4]}, {l[2], l[4], l[5]}};
    // fx = I + f02 e0 e2^T + f12 e1 e2^T
    const float Qx[3] = {lx[0] + Vx[0], lx[1] + Vx[1], lx[2] + (f02 * Vx[0] + f12 * Vx[1] + Vx[2])};
    float Qu[2];
    for (int j = 0; j < 2; ++j) Qu[j] = lu[j] + (fu[0][j] * Vx[0] + fu[1][j] * Vx[1] + fu[2][j] * Vx[2]);
    // M = fx^T Vxx, then Qxx = lxx + M fx
    float M[3][3];
    for (int k = 0; k < 3; ++k) {
      M[0][k] = V[0][k];
      M[1][k] = V[1][k];
      M[2][k] = f02 * V[0][k] + f12 * V[1][k] + V[2][k];
    }
    float Qxx[3][3];
    for (int i = 0; i < 3; ++i) {
      Qxx[i][0] = lxx[i][0] + M[i][0];
      Qxx[i][1] = lxx[i][1] + M[i][1];
      Qxx[i][2] = lxx[i][2] + (M[i][0] * f02 + M[i][1] * f12 + M[i][2]);
    }
    // Pm = fu^T Vxx; Quu = luu + Pm fu + reg I; Qux = Pm fx
    float Pm[2][3];
    for (int j = 0; j < 2; ++j)
      for (int k = 0; k < 3; ++k) Pm[j][k] = fu[0][j] * V[0][k] + fu[1][j] * V[1][k] + fu[2][j] * V[2][k];
    float PF[2][2];
    for (int j = 0; j < 2; ++j)
      for (int l = 0; l < 2; ++l) PF[j][l] = Pm[j][0] * fu[0][l] + Pm[j][1] * fu[1][l] + Pm[j][2] * fu[2][l];
    const float Quu[2][2] = {{P.luu00 + PF[0][0] + reg, 0.0f + PF[0][1] + 0.0f},
                             {0.0f + PF[1][0] + 0.0f, P.luu11 + PF[1][1] + reg}};
    float Qux[2][3];
    for (int j = 0; j < 2; ++j) {
      Qux[j][0] = Pm[j][0];
      Qux[j][1] = Pm[j][1];
      Qux[j][2] = Pm[j][0] * f02 + Pm[j][1] * f12 + Pm[j][2];
    }
    const float det = Quu[0][0] * Quu[1][1] - Quu[0][1] * Quu[1][0];
    const float inv[2][2] = {{Quu[1][1] / det, -Quu[0][1] / det},
                             {-Quu[1][0] / det, Quu[0][0] / det}};
    float k[2], K[2][3];
    for (int j = 0; j < 2; ++j) {
      k[j] = -inv[j][0] * Qu[0] + -inv[j][1] * Qu[1];
      for (int l = 0; l < 3; ++l) K[j][l] = -inv[j][0] * Qux[0][l] + -inv[j][1] * Qux[1][l];
    }
    // R = K^T Quu; Vx = Qx + R k + K^T Qu + Qux^T k; Vxx likewise, symmetrised
    float R[3][2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 2; ++j) R[i][j] = K[0][i] * Quu[0][j] + K[1][i] * Quu[1][j];
    for (int i = 0; i < 3; ++i)
      Vx[i] = Qx[i] + (R[i][0] * k[0] + R[i][1] * k[1]) + (K[0][i] * Qu[0] + K[1][i] * Qu[1]) +
              (Qux[0][i] * k[0] + Qux[1][i] * k[1]);
    float W[3][3];
    for (int i = 0; i < 3; ++i)
      for (int l = 0; l < 3; ++l)
        W[i][l] = Qxx[i][l] + (R[i][0] * K[0][l] + R[i][1] * K[1][l]) +
                  (K[0][i] * Qux[0][l] + K[1][i] * Qux[1][l]) +
                  (Qux[0][i] * K[0][l] + Qux[1][i] * K[1][l]);
    for (int i = 0; i < 3; ++i)
      for (int l = 0; l < 3; ++l) V[i][l] = 0.5f * (W[i][l] + W[l][i]);
    r.ks[2 * t] = k[0];
    r.ks[2 * t + 1] = k[1];
    for (int m = 0; m < 6; ++m) r.Ks[6 * t + m] = K[m / 3][m % 3];
  }
}

// Step size a's rollout (solve_batch.forward), in one thread.
__device__ void forward(const IlqrParams& P, const Row& r, int N, int a) {
  const float alpha = P.alphas[a];
  const int N1 = N + 1;
  float* xa = r.xa + 3 * N1 * a;
  float* ua = r.ua + 2 * N * a;
  float x[3] = {r.xs[0], r.xs[1], r.xs[2]};
  xa[0] = x[0];
  xa[1] = x[1];
  xa[2] = x[2];
  for (int t = 0; t < N; ++t) {
    const float* xt = r.xs + 3 * t;
    const float dx[3] = {x[0] - xt[0], x[1] - xt[1], x[2] - xt[2]};
    float u[2];
    for (int j = 0; j < 2; ++j) {
      const float* K = r.Ks + 6 * t + 3 * j;
      u[j] = r.us[2 * t + j] + alpha * r.ks[2 * t + j] + (K[0] * dx[0] + K[1] * dx[1] + K[2] * dx[2]);
    }
    u[0] = clampf(u[0], -P.max_steer, P.max_steer);
    u[1] = clampf(u[1], -P.max_speed, P.max_speed);
    float nx[3];
    arc_step(P, x, u[0], u[1], nx);
    for (int k = 0; k < 3; ++k) {
      x[k] = nx[k];
      xa[3 * (t + 1) + k] = nx[k];
    }
    ua[2 * t] = u[0];
    ua[2 * t + 1] = u[1];
  }
}

// nan_to_num(c, nan=inf): the line search's view of a candidate's cost
__device__ __forceinline__ float candidate(float c) {
  const float inf = __int_as_float(0x7f800000), big = 3.40282347e38f;
  if (c != c) return inf;
  if (c == inf) return big;
  if (c == -inf) return -big;
  return c;
}

__global__ void __launch_bounds__(THREADS, 2)
    ilqr_kernel(const float* __restrict__ x0, const float* __restrict__ goal,
                const float4* __restrict__ edges, const uint8_t* __restrict__ mask,
                const float* __restrict__ us_init, float* __restrict__ xs_out,
                float* __restrict__ us_out, float* __restrict__ cost_out,
                uint8_t* __restrict__ conv_out, int* __restrict__ picks_out,
                float* __restrict__ quad_out, int N, int E, IlqrParams P) {
  extern __shared__ float4 smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int A = P.n_alphas, N1 = N + 1;
  const Row r = carve(smem, N, E, A);

  // the row's edges and masks, then the live ones compacted in slot order
  // (in place: the write index never passes the read index)
  for (int e = tid; e < E; e += blockDim.x) {
    r.seg[e] = edges[(size_t)b * E + e];
    r.den[e] = mask[(size_t)b * E + e] ? 1.0f : 0.0f;
  }
  for (int i = tid; i < 2 * N; i += blockDim.x) r.us[i] = us_init[(size_t)b * 2 * N + i];
  if (tid < 3) {
    r.xs[tid] = x0[3 * b + tid];
    r.goal[tid] = goal[3 * b + tid];
  }
  __syncthreads();
  if (tid == 0) {
    int L = 0;
    for (int e = 0; e < E; ++e) {
      if (r.den[e] == 0.0f) continue;
      const float4 g = r.seg[e];
      const float abx = g.z - g.x, aby = g.w - g.y;
      r.seg[L] = make_float4(g.x, g.y, abx, aby);
      r.den[L] = clampf(abx * abx + aby * aby, 1e-12f, __int_as_float(0x7f800000));
      ++L;
    }
    r.ints[0] = L;
    // the warm start's rollout
    for (int t = 0; t < N; ++t) arc_step(P, r.xs + 3 * t, r.us[2 * t], r.us[2 * t + 1], r.xs + 3 * t + 3);
  }
  __syncthreads();
  const int L = r.ints[0];
  clearance_pass(P, r.seg, r.den, L, r.xs, DISCS * N1, r.d, r.idx);
  __syncthreads();
  cost_pass(P, r.goal, r.xs, r.us, r.d, 1, N, r.stage);
  __syncthreads();
  if (tid == 0) {
    const float c0 = total_cost(r.stage, N);
    r.scal[0] = c0;
    r.scal[1] = P.reg_init;
    r.scal[2] = c0;
  }
  __syncthreads();

  for (int it = 0; it < P.n_iters; ++it) {
    // with quad_out, the last iteration's quadraticization is written out
    // (with n_iters 2, the one formed at the nearest edges the first kept)
    float* q = quad_out != nullptr && it == P.n_iters - 1
                   ? quad_out + (size_t)b * (29 * N + 12) : nullptr;
    quadraticize(P, r, N, q);
    __syncthreads();
    if (tid == 0) backward(P, r, N, r.scal[1]);
    __syncthreads();
    if (tid < A) forward(P, r, N, tid);
    __syncthreads();
    clearance_pass(P, r.seg, r.den, L, r.xa, A * DISCS * N1, r.da, r.ia);
    __syncthreads();
    cost_pass(P, r.goal, r.xa, r.ua, r.da, A, N, r.stage);
    __syncthreads();
    if (tid == 0) {
      // the first minimum over [current, alphas...]: a candidate is taken
      // only when strictly below the best so far; a NaN candidate never is,
      // and a NaN current cost takes nothing
      const float cost = r.scal[0], reg = r.scal[1];
      int pick = 0;
      float best = cost, chosen = cost;
      for (int a = 0; a < A; ++a) {
        const float ca = total_cost(r.stage + a * N1, N);
        const float c = candidate(ca);
        if (c < best) {
          best = c;
          pick = a + 1;
          chosen = ca;
        }
      }
      if (cost != cost) pick = 0;
      if (pick > 0) {
        r.scal[0] = chosen;
        r.scal[1] = clampf(reg * 0.7f, 1e-6f, __int_as_float(0x7f800000));
      } else {
        r.scal[1] = reg * 4.0f;
      }
      r.ints[1] = pick;
      if (picks_out != nullptr) picks_out[(size_t)b * P.n_iters + it] = pick;
    }
    __syncthreads();
    const int pick = r.ints[1];
    if (pick > 0) {
      const int a = pick - 1;
      for (int i = tid; i < 3 * N1; i += blockDim.x) r.xs[i] = r.xa[3 * N1 * a + i];
      for (int i = tid; i < 2 * N; i += blockDim.x) r.us[i] = r.ua[2 * N * a + i];
      for (int i = tid; i < DISCS * N1; i += blockDim.x) {
        r.d[i] = r.da[DISCS * N1 * a + i];
        r.idx[i] = r.ia[DISCS * N1 * a + i];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < 3 * N1; i += blockDim.x) xs_out[(size_t)b * 3 * N1 + i] = r.xs[i];
  for (int i = tid; i < 2 * N; i += blockDim.x) us_out[(size_t)b * 2 * N + i] = r.us[i];
  if (tid == 0) {
    const float cost = r.scal[0], c0 = r.scal[2];
    cost_out[b] = cost;
    conv_out[b] = (c0 - cost) / clampf(c0, 1e-9f, __int_as_float(0x7f800000)) > 1e-3f;
  }
}

size_t smem_bytes(int N, int E, int A) {
  const size_t N1 = N + 1;
  const size_t floats = E + 3 * N1 + 2 * N + 2 * DISCS * N1 + A * (3 * N1 + 2 * N + 2 * DISCS * N1) +
                        A * N1 + GH * DISCS * N1 + 19 * N + 9 + 8 * N + 3 + 3 + 2;
  return 16 * (size_t)E + 4 * floats;
}

}  // namespace

extern "C" int ilqr_solve(const void* x0, const void* goal, const void* edges, const void* mask,
                          const void* us_init, void* xs, void* us, void* cost, void* converged,
                          void* picks, void* quad, int B, int N, int E, IlqrParams params,
                          void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || E < 0 || params.n_alphas < 1 || params.n_alphas > MAX_ALPHAS ||
      params.n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, E, params.n_alphas);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(ilqr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ilqr_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>((const float*)x0, (const float*)goal, (const float4*)edges, (const uint8_t*)mask, (const float*)us_init, (float*)xs, (float*)us, (float*)cost, (uint8_t*)converged, (int*)picks, (float*)quad, N, E, params);
  return (int)cudaGetLastError();
}
