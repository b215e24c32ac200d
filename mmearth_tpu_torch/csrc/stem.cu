// The gathered encoder's stem on the visible patches, and its backward.
//
// Replaces no Pallas kernel.  The JAX package composes this part of the
// stem on the gathered rows (mmearth_tpu/models/convnextv2.py:758-765,
// stem_gathered) or on the dense grid before the gather (:746-751); the
// port's composed passes did the same, LayerNorm by LayerNorm.  It is one
// kernel here because nothing else bounds it: per site it is 40-96 channels,
// two normalisations and an s x s tap, far below the card's 295 operations
// a byte, so the bytes it moves set its least time, and the composed passes
// moved each intermediate through device memory many times over on the
// full grid.
//
//   y0   (N, H, W, C): the initial 3x3 conv's output, H = W = grid * P,
//        P = Q s the input side of a patch;
//   rows (N, K, Q, Q, C): for visible patch kept[n, k] and output site
//        (i, j) of it, with a_t the input site (i s + t / s, j s + t % s)
//        of the patch:
//          u_t  = round(LN1(y0[a_t]))           f32 statistics over C
//          g_t  = round(gelu(u_t))               erf GELU
//          z    = round(sum_t g_t * round(w_t) + round(b))   f32 sum, t in order
//          rows = round(LN2(z))
//   round() is to the activation dtype (a no-op in f32), at the points
//   where the composed stem rounds, so nothing is computed in a lower
//   precision than there.
//
// Layout.  A group of G lanes (G = 4, 8, 16 or 32, from the caller's plan)
// computes one output site; lane l of a group holds the channel pairs l,
// l + G, ... (NP of them), so a warp computes 32 / G sites at once and
// LayerNorm's sums take log2 G shuffles, shared by those sites (at atto's
// C = 40, G = 4 and NP = 5: a warp is a patch row of 8 sites, every lane
// busy).  A warp's unit of work is one output row of one patch: the index
// math is done once a row, and the row's sites are contiguous in y0 and in
// the rows.  Warps walk the units in a grid-stride loop over one wave of
// blocks.
//
// Forward.  Per site, a group loads the s^2 input sites first (all loads
// in flight), then per tap reduces LN1's mean and variance, applies LN1,
// the GELU and the tap, then LN2, and stores the site's row.  Reads touch
// only the visible patches (19 of 49 in pretraining); nothing but the rows
// is written.
//
// Backward.  The same walk over the visible patch rows: each recomputes its
// forward from y0 (nothing but y0 is saved) and runs LN2's, the tap's, the GELU's and LN1's backward, rounding
// each cotangent where autograd rounds it in the composed stem (dz, dg, du,
// d(y0)), with f32 between; then a walk over every patch row of the grid
// gives a removed patch's input rows zeros (the dense d(y0) is written once,
// no memset; the visible rows are dealt out evenly, each warp taking as many
// of them as the next).  The six leaves' gradients (LN1's affine, the
// taps, their bias, LN2's affine) are f32 sums: each lane keeps its
// channels' sums in registers over every site its warp walks, the warp adds
// its groups' sums with shuffles, the block adds its warps' in order in
// shared memory and writes one partial row; the last block of each group of
// 16 to finish (ticket counters the entry zeroes) adds the group's partial
// rows in block order, and the last group's adds the group rows in order.
// So the sums are the same from run to run, and the backward is one launch
// with no host sync, which a CUDA graph captures.
//
// The param rows (ops/stem.py::param_rows): (5 + s^2, C) f32, rows LN1 weight,
// LN1 bias, tap bias, LN2 weight, LN2 bias, then one per tap t, the tap bias
// and the taps already rounded to the activation dtype; the gradients come
// back in the same layout.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HEAD = 5;  // param rows before the taps
constexpr int W1 = 0, B1 = 1, BT = 2, W2 = 3, B2 = 4;
constexpr float SQRT1_2 = 0.70710678118654752440f;
constexpr float BETA = 0.39894228040143267794f;  // M_2_SQRTPI * M_SQRT1_2 * 0.5

struct StemGeo {
  int N, K, L, H, W, C, grid, P, Q;
  int G;      // lanes a site
  int units;  // visible (patch, output row) units: N*K*Q
  float inv_c, eps1, eps2;
};

template <typename T> struct Act;
template <> struct Act<float> {
  static __device__ __forceinline__ float2 load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  static __device__ __forceinline__ float2 round(float2 v) { return v; }
};
template <> struct Act<__nv_bfloat16> {
  static __device__ __forceinline__ float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
  }
  // both values rounded to bf16 in one conversion
  static __device__ __forceinline__ float2 round(float2 v) {
    return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  }
};

// The sum over a group of G lanes (xor distances below G), the same value in
// every lane of the group (each butterfly step adds the same two values in
// both lanes of a pair).  Every lane of the warp calls it.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 prm2(const float* prm, int row, int half, int pair) {
  return __ldg(reinterpret_cast<const float2*>(prm) + (size_t)row * half + pair);
}

// The pairs a lane holds: li + G q for q < NP, those below half.
struct Lane {
  int li, G, half;
  __device__ __forceinline__ int pair(int q) const { return li + G * q; }
  __device__ __forceinline__ bool has(int q) const { return li + G * q < half; }
};

// The composed LayerNorm's (x - mean) / sqrt(var + eps) of one site whose
// pairs the group holds (x zero where the lane holds no pair); returns
// 1 / sqrt(var + eps).
template <int NP>
__device__ __forceinline__ float normalize(float2 (&x)[NP], const Lane& ln, float inv_c,
                                           float eps) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q) s += x[q].x + x[q].y;
  const float mean = group_sum(s, ln.G) * inv_c;
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < NP; ++q)
    if (ln.has(q)) {
      const float a = x[q].x - mean, b = x[q].y - mean;
      v += a * a + b * b;
    }
  const float inv = 1.f / sqrtf(group_sum(v, ln.G) * inv_c + eps);
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    x[q].x = (x[q].x - mean) * inv;
    x[q].y = (x[q].y - mean) * inv;
  }
  return inv;
}

// y * w + b with two roundings, as the composed y * weight + bias.
__device__ __forceinline__ float affine(float y, float w, float b) {
  return __fadd_rn(__fmul_rn(y, w), b);
}

// PyTorch's erf GELU, x * 0.5 * (1 + erf(x / sqrt 2)); e = erf(x / sqrt 2).
__device__ __forceinline__ float gelu_of(float x, float e) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, e));
}

// The first input site (in sites of y0) of output row i of patch l of
// sample n.
__device__ __forceinline__ size_t row_site(const StemGeo& g, int n, int l, int i, int s) {
  const int pr = l / g.grid, pc = l - pr * g.grid;
  return ((size_t)n * g.H + pr * g.P + i * s) * g.W + pc * g.P;
}

template <typename T, int NP>
__device__ __forceinline__ void load_site(float2 (&x)[NP], const T* src, const Lane& ln,
                                          bool on) {
#pragma unroll
  for (int q = 0; q < NP; ++q)
    x[q] = on && ln.has(q) ? Act<T>::load(src + 2 * ln.pair(q)) : make_float2(0.f, 0.f);
}

// One output site's conv output z (rounded) from its taps' loaded inputs x,
// which become LN1's output; where E, e = erf(u / sqrt 2) of u = round(LN1)
// (the backward's GELU derivative takes it); inv1 LN1's 1 / den.
template <typename T, int NP, int S, bool E>
__device__ __forceinline__ void stem_taps(float2 (&x)[S][NP], float2 (&e)[S][NP],
                                          float (&inv1)[S], float2 (&z)[NP],
                                          const float* prm, const Lane& ln, const StemGeo& g) {
#pragma unroll
  for (int q = 0; q < NP; ++q) z[q] = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < S; ++t) {
    inv1[t] = normalize<NP>(x[t], ln, g.inv_c, g.eps1);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (!ln.has(q)) continue;
      const int p = ln.pair(q);
      const float2 w = prm2(prm, W1, ln.half, p), b = prm2(prm, B1, ln.half, p);
      const float2 wt = prm2(prm, HEAD + t, ln.half, p);
      const float2 u = Act<T>::round(
          make_float2(affine(x[t][q].x, w.x, b.x), affine(x[t][q].y, w.y, b.y)));
      const float2 ef = make_float2(erff(u.x * SQRT1_2), erff(u.y * SQRT1_2));
      if (E) e[t][q] = ef;
      const float2 gl = Act<T>::round(make_float2(gelu_of(u.x, ef.x), gelu_of(u.y, ef.y)));
      z[q].x = __fadd_rn(z[q].x, __fmul_rn(gl.x, wt.x));
      z[q].y = __fadd_rn(z[q].y, __fmul_rn(gl.y, wt.y));
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    if (!ln.has(q)) continue;
    const float2 bt = prm2(prm, BT, ln.half, ln.pair(q));
    z[q] = Act<T>::round(make_float2(__fadd_rn(z[q].x, bt.x), __fadd_rn(z[q].y, bt.y)));
  }
}

// S = s * s taps (s = 1 or 2); NP pairs of channels a lane at most.
template <typename T, int NP, int S>
__global__ void __launch_bounds__(THREADS)
stem_rows_fwd_kernel(const T* __restrict__ y0, const int* __restrict__ kept,
                     const float* __restrict__ prm, T* __restrict__ rows, StemGeo g) {
  constexpr int s = S == 1 ? 1 : 2;
  static_assert(s * s == S, "taps: 1 or 4");
  const int lane = threadIdx.x & 31;
  const Lane ln{lane & (g.G - 1), g.G, g.C / 2};
  const int grp = lane / g.G, per = 32 / g.G;  // this lane's site of a pass; sites a pass
  const int step = gridDim.x * WARPS;
  for (int unit = blockIdx.x * WARPS + (threadIdx.x >> 5); unit < g.units; unit += step) {
    const int nk = unit / g.Q, i = unit - nk * g.Q;  // nk = n * K + k
    const size_t a_row = row_site(g, nk / g.K, __ldg(kept + nk), i, s);
    T* out_row = rows + (size_t)unit * g.Q * g.C;
    for (int j0 = 0; j0 < g.Q; j0 += per) {
      const int j = j0 + grp;
      const bool on = j < g.Q;
      float2 x[S][NP], e[S][NP], z[NP];
      float inv1[S];
#pragma unroll
      for (int t = 0; t < S; ++t)
        load_site<T, NP>(x[t], y0 + (a_row + (size_t)(t / s) * g.W + j * s + t % s) * g.C, ln,
                         on);
      stem_taps<T, NP, S, false>(x, e, inv1, z, prm, ln, g);
      normalize<NP>(z, ln, g.inv_c, g.eps2);
      if (!on) continue;
      T* dst = out_row + (size_t)j * g.C;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (!ln.has(q)) continue;
        const int p = ln.pair(q);
        const float2 w = prm2(prm, W2, ln.half, p), b = prm2(prm, B2, ln.half, p);
        Act<T>::store(dst + 2 * p,
                      make_float2(affine(z[q].x, w.x, b.x), affine(z[q].y, w.y, b.y)));
      }
    }
  }
}

constexpr int BLOCK_GROUP = 16;  // partial rows a group row adds

// After this block's writes: whether it is the last of `arrivals` blocks to
// take a ticket from *counter (the writes of all of them then visible).
__device__ __forceinline__ bool last_to_arrive(int* counter, int arrivals, int& last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == arrivals - 1;
  __syncthreads();
  return last;
}

// out[e] = the sum of rows[r][e] over r < n in row order (four running sums
// a column, combined in a fixed order), for e < cols.
__device__ __forceinline__ void sum_rows(const float* rows, int n, int cols, float* out) {
  for (int e = threadIdx.x; e < cols; e += blockDim.x) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int r = 0;
    for (; r + 4 <= n; r += 4) {
      a0 += __ldcg(rows + (size_t)r * cols + e);
      a1 += __ldcg(rows + (size_t)(r + 1) * cols + e);
      a2 += __ldcg(rows + (size_t)(r + 2) * cols + e);
      a3 += __ldcg(rows + (size_t)(r + 3) * cols + e);
    }
    for (; r < n; ++r) a0 += __ldcg(rows + (size_t)r * cols + e);
    out[e] = (a0 + a1) + (a2 + a3);
  }
}

__device__ __forceinline__ void add2(float2& acc, float a, float b) {
  acc.x += a;
  acc.y += b;
}

// At most 128 registers a thread with one tap (four blocks an SM), 168 with
// four (three blocks: their inputs and sums would spill at 128).
template <typename T, int NP, int S>
__global__ void __launch_bounds__(THREADS, S == 1 ? 4 : 3)
stem_rows_bwd_kernel(const T* __restrict__ y0, const T* __restrict__ drows,
                     const int* __restrict__ kept, const int* __restrict__ inv,
                     const float* __restrict__ prm,
                     T* __restrict__ dy0, float* __restrict__ part, float* __restrict__ grads,
                     int* __restrict__ ticket, StemGeo g) {
  constexpr int s = S == 1 ? 1 : 2;
  static_assert(s * s == S, "taps: 1 or 4");
  constexpr int ROWS = HEAD + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Lane ln{lane & (g.G - 1), g.G, g.C / 2};
  const int grp = lane / g.G, per = 32 / g.G;
  float2 acc[ROWS][NP];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int q = 0; q < NP; ++q) acc[r][q] = make_float2(0.f, 0.f);

  // the visible rows: the backward proper
  const int step = gridDim.x * WARPS;
  for (int unit = blockIdx.x * WARPS + warp; unit < g.units; unit += step) {
    const int nk = unit / g.Q, i = unit - nk * g.Q;  // nk = n * K + k
    const size_t a_row = row_site(g, nk / g.K, __ldg(kept + nk), i, s);
    const T* drow = drows + (size_t)unit * g.Q * g.C;
    for (int j0 = 0; j0 < g.Q; j0 += per) {
      const int j = j0 + grp;
      const bool on = j < g.Q;
      float2 yh[S][NP], e[S][NP], z[NP], d[NP];
      float inv1[S];
      load_site<T, NP>(d, drow + (size_t)j * g.C, ln, on);
#pragma unroll
      for (int t = 0; t < S; ++t)
        load_site<T, NP>(yh[t], y0 + (a_row + (size_t)(t / s) * g.W + j * s + t % s) * g.C,
                         ln, on);
      // the forward again, keeping LN1's output yh and erf's e
      stem_taps<T, NP, S, true>(yh, e, inv1, z, prm, ln, g);
      const float inv2 = normalize<NP>(z, ln, g.inv_c, g.eps2);  // z: LN2's normalized value
      // LN2's backward: d(rows) -> its affine's sums and dz, rounded
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        if (!ln.has(q)) continue;
        const float2 w = prm2(prm, W2, ln.half, ln.pair(q));
        add2(acc[W2][q], d[q].x * z[q].x, d[q].y * z[q].y);
        add2(acc[B2][q], d[q].x, d[q].y);
        d[q].x *= w.x;
        d[q].y *= w.y;
        s1 += d[q].x + d[q].y;
        s2 += d[q].x * z[q].x + d[q].y * z[q].y;
      }
      float m1 = group_sum(s1, g.G) * g.inv_c, m2 = group_sum(s2, g.G) * g.inv_c;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        d[q] = Act<T>::round(make_float2((d[q].x - m1 - z[q].x * m2) * inv2,
                                         (d[q].y - m1 - z[q].y * m2) * inv2));
        if (ln.has(q)) add2(acc[BT][q], d[q].x, d[q].y);
      }
      // per tap: the tap's, the GELU's and LN1's backward, d(y0) stored
#pragma unroll
      for (int t = 0; t < S; ++t) {
        s1 = s2 = 0.f;
        float2 dv[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          dv[q] = make_float2(0.f, 0.f);
          if (!ln.has(q)) continue;
          const int p = ln.pair(q);
          const float2 w = prm2(prm, W1, ln.half, p), b = prm2(prm, B1, ln.half, p);
          const float2 wt = prm2(prm, HEAD + t, ln.half, p);
          const float2 u = Act<T>::round(
              make_float2(affine(yh[t][q].x, w.x, b.x), affine(yh[t][q].y, w.y, b.y)));
          const float ux = u.x, uy = u.y, ex = e[t][q].x, ey = e[t][q].y;
          const float2 gl = Act<T>::round(make_float2(gelu_of(ux, ex), gelu_of(uy, ey)));
          add2(acc[HEAD + t][q], d[q].x * gl.x, d[q].y * gl.y);
          const float2 dg = Act<T>::round(make_float2(d[q].x * wt.x, d[q].y * wt.y));
          const float cx = 0.5f * (1.f + ex), cy = 0.5f * (1.f + ey);
          const float px = expf(-0.5f * ux * ux) * BETA, py = expf(-0.5f * uy * uy) * BETA;
          const float2 du = Act<T>::round(make_float2(dg.x * (cx + ux * px),
                                                      dg.y * (cy + uy * py)));
          const float dux = du.x, duy = du.y;
          add2(acc[W1][q], dux * yh[t][q].x, duy * yh[t][q].y);
          add2(acc[B1][q], dux, duy);
          dv[q] = make_float2(dux * w.x, duy * w.y);
          s1 += dv[q].x + dv[q].y;
          s2 += dv[q].x * yh[t][q].x + dv[q].y * yh[t][q].y;
        }
        m1 = group_sum(s1, g.G) * g.inv_c;
        m2 = group_sum(s2, g.G) * g.inv_c;
        if (!on) continue;
        T* dst = dy0 + (a_row + (size_t)(t / s) * g.W + j * s + t % s) * g.C;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          if (!ln.has(q)) continue;
          Act<T>::store(dst + 2 * ln.pair(q),
                        make_float2((dv[q].x - m1 - yh[t][q].x * m2) * inv1[t],
                                    (dv[q].y - m1 - yh[t][q].y * m2) * inv1[t]));
        }
      }
    }
  }

  // the removed patches' rows: their s input rows of P sites get zeros
  for (int unit = blockIdx.x * WARPS + warp; unit < g.N * g.L * g.Q; unit += step) {
    const int nl = unit / g.Q, i = unit - nl * g.Q;  // nl = n * L + l
    if (__ldg(inv + nl) < g.K) continue;
    const int n = nl / g.L;
    const size_t a_row = row_site(g, n, nl - n * g.L, i, s);
    const int pairs = g.P * g.C / 2;
    for (int t = 0; t < s; ++t) {
      T* dst = dy0 + (a_row + (size_t)t * g.W) * g.C;
      for (int e = lane; e < pairs; e += 32) Act<T>::store(dst + 2 * e, make_float2(0.f, 0.f));
    }
  }

  // the warp's sums: its groups' added with shuffles (the same in every
  // group), then the block's: its warps' in order in shared memory, then
  // one partial row
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int q = 0; q < NP; ++q)
      for (int o = g.G; o < 32; o <<= 1) {
        acc[r][q].x += __shfl_xor_sync(0xffffffffu, acc[r][q].x, o);
        acc[r][q].y += __shfl_xor_sync(0xffffffffu, acc[r][q].y, o);
      }
  extern __shared__ float red[];  // (ROWS, C)
  const int cols = ROWS * g.C;
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w && grp == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          if (!ln.has(q)) continue;
          float* at = red + r * g.C + 2 * ln.pair(q);
          if (w == 0) {
            at[0] = acc[r][q].x;
            at[1] = acc[r][q].y;
          } else {
            at[0] += acc[r][q].x;
            at[1] += acc[r][q].y;
          }
        }
    }
    __syncthreads();
  }
  float* mine = part + (size_t)blockIdx.x * cols;
  for (int e = threadIdx.x; e < cols; e += THREADS) mine[e] = red[e];
  // the last block of each group of BLOCK_GROUP adds the group's rows into a
  // group row (after the partial rows), the last group's the group rows into
  // grads: every sum in a fixed order, and a tail of a few dozen rows
  const int group = blockIdx.x / BLOCK_GROUP, groups = (gridDim.x + BLOCK_GROUP - 1) / BLOCK_GROUP;
  const int first = group * BLOCK_GROUP, size = min(BLOCK_GROUP, (int)gridDim.x - first);
  float* group_rows = part + (size_t)gridDim.x * cols;
  __shared__ int last;
  if (!last_to_arrive(ticket + group, size, last)) return;
  sum_rows(part + (size_t)first * cols, size, cols, group_rows + (size_t)group * cols);
  if (!last_to_arrive(ticket + groups, groups, last)) return;
  sum_rows(group_rows, groups, cols, grads);
}

// Makes device current for a launch and gives the caller's back.
class OnDevice {
 public:
  explicit OnDevice(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      changed_ = err_ == cudaSuccess;
    }
  }
  ~OnDevice() {
    if (changed_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool changed_ = false;
  cudaError_t err_ = cudaSuccess;
};

// The kernel of a (pairs a lane, taps) instantiation, by direction.
template <typename T, int NP, int S>
const void* kernel_of(bool bwd) {
  return bwd ? (const void*)stem_rows_bwd_kernel<T, NP, S>
             : (const void*)stem_rows_fwd_kernel<T, NP, S>;
}

template <typename T, int NP>
const void* by_taps(int taps, bool bwd) {
  switch (taps) {
    case 1: return kernel_of<T, NP, 1>(bwd);
    case 4: return kernel_of<T, NP, 4>(bwd);
    default: return nullptr;
  }
}

// np: pairs of channels a lane, 1 to 6.
template <typename T>
const void* by_pairs(int np, int taps, bool bwd) {
  switch (np) {
    case 1: return by_taps<T, 1>(taps, bwd);
    case 2: return by_taps<T, 2>(taps, bwd);
    case 3: return by_taps<T, 3>(taps, bwd);
    case 4: return by_taps<T, 4>(taps, bwd);
    case 5: return by_taps<T, 5>(taps, bwd);
    case 6: return by_taps<T, 6>(taps, bwd);
    default: return nullptr;
  }
}

const void* find(int is_bf16, int np, int taps, bool bwd) {
  return is_bf16 ? by_pairs<__nv_bfloat16>(np, taps, bwd) : by_pairs<float>(np, taps, bwd);
}

}  // namespace

// The int arguments of a launch (ops/stem.py::_config).
struct Config {
  int N, K, L, H, W, C, grid, P, Q, np, taps, blocks, is_bf16, G;
};

// The shapes the kernels take; the unit walk stays within int.
static bool valid(const Config& f) {
  return f.N >= 1 && f.K >= 1 && f.grid >= 1 && f.L == f.grid * f.grid && f.L >= f.K &&
         f.Q >= 1 && f.P >= 1 && f.H == f.grid * f.P && f.W == f.H &&
         f.P * f.P == f.Q * f.Q * f.taps && f.C >= 2 && f.C % 2 == 0 &&
         (f.G == 4 || f.G == 8 || f.G == 16 || f.G == 32) && f.C <= 2 * f.np * f.G &&
         (long long)f.N * f.L * f.Q < (1LL << 30) && f.blocks >= 1 &&
         f.blocks <= (1 << 30) / WARPS;
}

static StemGeo geo(const Config& f, float eps1, float eps2) {
  return StemGeo{f.N, f.K, f.L, f.H, f.W, f.C, f.grid, f.P, f.Q, f.G, f.N * f.K * f.Q,
                 1.f / (float)f.C, eps1, eps2};
}

// y0 (N, H, W, C), rows (N, K, Q, Q, C): bf16 or f32, contiguous; kept
// (N, K) int32; prm (5 + taps, C) f32; on device, whose stream is stream.
extern "C" int mm_stem_rows_fwd(const void* y0, const void* kept, const void* prm, void* rows,
                                const Config* cfg, float eps1, float eps2, int device,
                                void* stream) {
  const Config& f = *cfg;
  const void* k = find(f.is_bf16, f.np, f.taps, false);
  if (!valid(f) || k == nullptr) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  StemGeo g = geo(f, eps1, eps2);
  void* args[] = {(void*)&y0, (void*)&kept, (void*)&prm, (void*)&rows, (void*)&g};
  cudaError_t e = cudaLaunchKernel(k, dim3(f.blocks), dim3(THREADS), args, 0,
                                   (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// drows like rows; dy0 like y0 (every element written); part (blocks +
// groups, (5 + taps) C) and grads ((5 + taps) C) f32; ticket groups + 1
// int32, zeroed here; groups = ceil(blocks / 16).
extern "C" int mm_stem_rows_bwd(const void* y0, const void* drows, const void* kept,
                                const void* inv, const void* prm, void* dy0, void* part,
                                void* grads,
                                void* ticket, const Config* cfg, float eps1, float eps2,
                                int device, void* stream) {
  const Config& f = *cfg;
  const void* k = find(f.is_bf16, f.np, f.taps, true);
  if (!valid(f) || k == nullptr) return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t s = (cudaStream_t)stream;
  const int groups = (f.blocks + BLOCK_GROUP - 1) / BLOCK_GROUP;
  cudaError_t e = cudaMemsetAsync(ticket, 0, (groups + 1) * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  StemGeo g = geo(f, eps1, eps2);
  void* args[] = {(void*)&y0, (void*)&drows, (void*)&kept, (void*)&inv, (void*)&prm, (void*)&dy0,
                  (void*)&part, (void*)&grads, (void*)&ticket, (void*)&g};
  const size_t smem = (size_t)(HEAD + f.taps) * f.C * sizeof(float);
  e = cudaLaunchKernel(k, dim3(f.blocks), dim3(THREADS), args, smem, s);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Blocks of the instantiation an SM holds (bwd: with its shared memory for
// C channels), or minus a CUDA error; 0 where there is no instantiation.
extern "C" int mm_stem_occupancy(int bwd, int is_bf16, int np, int taps, int c) {
  const void* k = find(is_bf16, np, taps, bwd != 0);
  if (k == nullptr) return 0;
  const size_t smem = bwd ? (size_t)(HEAD + taps) * c * sizeof(float) : 0;
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, THREADS, smem);
  return e != cudaSuccess ? -(int)e : blocks;
}
