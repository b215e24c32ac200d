// Fused scatter -> depthwise 7x7 SAME conv -> gather on gathered visible rows.
//
// Replaces the Pallas kernels mmearth_tpu/ops/wholeblock.py:127 (_fwd_kernel,
// called from _fwd :216-246) and :150 (_bwd_kernel, _bwd_rule :254-298).
//
//   forward : t[n,k,y,x,c] = bias[c] + sum_{a,b} X[n, Y+a-3, X+b-3, c] * w[c,a,b]
//             where X is the dense grid implied by the gathered rows (zero at
//             masked patches and outside the image) and (Y, X) the dense site
//             of (k, y, x).  The taps are the f32 (C, 1, 7, 7) param rounded
//             to the activation dtype here (wholeblock.py:220); bias and the
//             accumulator are f32 (:221, :141); the output is rounded once.
//   backward: dx = the same scheme over dt with the flipped taps, no bias;
//             dK[c,a,b] = sum over the batch of X[Y+a-3, X+b-3, c] * dt[Y,X,c];
//             db[c] = sum of dt.  dK, db in f32.
//
// Bound on the H100: 2*49 flops per output element (98 for dx and 98 for dK
// in the backward) against 2 bytes read + 2 written per element in bf16.  The
// products of bf16 activations and bf16-rounded taps are exact in f32, so the
// least time at the bf16 tensor-core rate is set by the bytes.  A depthwise
// conv has no sum over channels, so nothing here is a matrix product: the
// FMAs run on the f32 CUDA cores (67 TFLOP/s), where they take about as long
// as the bytes.  What costs time is staging, indexing and shared-memory
// traffic, and the design is about those:
//
// - A block owns a tile of tpy x tpx patches of one image (the whole image
//   where it fits) and a chunk of cc channels.  It looks up inv_ids once for
//   each patch that overlaps the tile plus its 3-site border, then stages the
//   (tpy*p+6) x (tpx*p+6) halo once, in the activation dtype, with 16-byte
//   cp.async copies along the channels (a scalar-load form of the same kernel
//   where cc or C is not a multiple of 16 bytes).  Masked patches and sites
//   outside the image are zero-filled without a read.  A tile with no visible
//   patch returns before it stages anything.
// - p is a template parameter, so site indexing is shifts and masks.
// - Outputs are computed and written only at the tile's visible patches (39%
//   of the sites at mask 0.6), listed in shared memory in patch order.
// - The taps are read from the param once per block and rounded in the
//   kernel.  A work item is one channel (a bf16 pair where cc is even) and a
//   strip of R rows x p sites of one visible patch; its accumulators live in
//   registers.  For each of the R+6 input rows the thread loads a window of
//   p+6 sites once and feeds it to every output row and tap row it meets, so
//   a shared load feeds up to 7*p FMAs per channel.
// - The backward is one launch with two kinds of block (blockIdx.z): 0 stages
//   the dt halo and computes dx as the forward does with the flipped taps; 1
//   stages the x halo, reads dt at its own visible sites into registers and
//   keeps a channel's 49 dK partial sums and its db partial in registers.
//   The block adds them up in shared memory and adds each (tap, channel) to
//   the zeroed f32 output with one atomicAdd, so the order of the dK/db sums
//   varies from run to run.  The TPU kernel's carried accumulator
//   (wholeblock.py:157-160,192-195) has no counterpart: blocks run in no order.
//
// The tile, chunk, thread count and shared-memory bytes are chosen by
// ops/wholeblock.py (tile_plan); the entries below check that the bytes cover
// the layout (smem_layout) before launching.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 7;
constexpr int KT = KS * KS;
constexpr int HALF = KS / 2;
constexpr int MAX_THREADS = 256;
constexpr int MAX_CHUNK = 64;
constexpr int RED_PITCH = KT + 2;  // 49 taps, db and a pad: odd, so no bank conflicts

struct Geo {
  int K, G, C, cc;     // visible patches per image, patches per side, channels, chunk
  int tpy, tpx;        // tile in patches
  int tiles_x, tiles;  // tiles per image row, per image
  int vec;             // 1: stage with 16-byte cp.async
};

// Patch side P: log2, rows of a work item (a whole patch at P = 4, two rows
// at P = 8 to keep its sums in registers, the fastest on an H100; one row at
// P = 16, where a row is already 16 sites and a dK item then holds 49 sums,
// 16 dt values and a 22-site window), and the border patches a tile's halo
// reaches: LO before it, E in all (LO + 2/P + 1: the 3-site border ends 2/P
// patches past the tile).
template <int P> struct Side {
  static constexpr int LOG = P == 1 ? 0 : P == 2 ? 1 : P == 4 ? 2 : P == 8 ? 3 : 4;
  static constexpr int R = P == 4 ? 4 : P == 1 ? 1 : P == 16 ? 1 : 2;
  static constexpr int LO = (HALF + P - 1) / P;
  static constexpr int E = LO + (HALF - 1) / P + 1;
};

struct Layout {
  size_t taps, red, prow, vis, total;  // byte offsets; the halo is at 0
};

__host__ __device__ inline Layout smem_layout(int p, int tpy, int tpx, int cc, int es, bool bwd) {
  const int lo = (HALF + p - 1) / p;
  const int e = lo + (HALF - 1) / p + 1;
  Layout l;
  l.taps = ((size_t)(tpy * p + KS - 1) * (tpx * p + KS - 1) * cc * es + 15) / 16 * 16;
  l.red = l.taps + (size_t)KT * cc * 4;
  l.prow = l.red + (bwd ? (size_t)RED_PITCH * cc * 4 : 0);
  l.vis = l.prow + (size_t)(tpy + e) * (tpx + e) * 4;
  l.total = l.vis + (size_t)2 * tpy * tpx * 4;
  return l;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// CPT channels at p as f32, and back
__device__ __forceinline__ void load_ch(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_ch(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_ch(const __nv_bfloat16* p, float (&v)[2]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_taps(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_taps(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}
__device__ __forceinline__ void store_ch(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_ch(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
__device__ __forceinline__ void store_ch(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  int n, ty0, tx0;  // image; origin in patches
  int nty, ntx;     // extent in patches, clipped at the image's edge
  int hw;           // halo width in sites
  int nvis;         // visible patches in the tile
};

// Find the block's tile, look up each patch its halo reaches (prow: the
// gathered row n*K + r, or -1 where masked or outside the image) and list
// the tile's visible patches in patch order (vis_loc: index in the tile,
// vis_row: gathered row).  False if the tile has no visible patch.
template <int P>
__device__ bool setup_tile(const Geo& g, const int* __restrict__ inv, int* prow, int* vis_loc,
                           int* vis_row, Tile& t) {
  using S = Side<P>;
  __shared__ int nvis_s;
  t.n = blockIdx.x / g.tiles;
  const int tile = blockIdx.x - t.n * g.tiles;
  const int tyi = tile / g.tiles_x;
  t.ty0 = tyi * g.tpy;
  t.tx0 = (tile - tyi * g.tiles_x) * g.tpx;
  t.nty = min(g.tpy, g.G - t.ty0);
  t.ntx = min(g.tpx, g.G - t.tx0);
  t.hw = t.ntx * P + KS - 1;
  const int npx = t.ntx + S::E;
  const int npatch = (t.nty + S::E) * npx;
  const int* inv_n = inv + (size_t)t.n * g.G * g.G;
  for (int i = threadIdx.x; i < npatch; i += blockDim.x) {
    const int qy = i / npx;
    const int py = t.ty0 - S::LO + qy;
    const int px = t.tx0 - S::LO + i - qy * npx;
    int r = -1;
    if (py >= 0 && py < g.G && px >= 0 && px < g.G) {
      const int v = inv_n[py * g.G + px];
      if (v < g.K) r = t.n * g.K + v;
    }
    prow[i] = r;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int count = 0;
    for (int base = 0; base < t.nty * t.ntx; base += 32) {
      const int i = base + threadIdx.x;
      int r = -1;
      if (i < t.nty * t.ntx) {
        const int ly = i / t.ntx;
        r = prow[(ly + S::LO) * npx + i - ly * t.ntx + S::LO];
      }
      const unsigned m = __ballot_sync(0xffffffffu, r >= 0);
      if (r >= 0) {
        const int j = count + __popc(m & ((1u << threadIdx.x) - 1u));
        vis_loc[j] = i;
        vis_row[j] = r;
      }
      count += __popc(m);
    }
    if (threadIdx.x == 0) nvis_s = count;
  }
  __syncthreads();
  t.nvis = nvis_s;
  return t.nvis > 0;
}

// halo[(hy * hw + hx) * cc + c] = the dense value at site (ty0*P - 3 + hy,
// tx0*P - 3 + hx), channel c0 + c; cp.async copies are left in flight.
template <typename T, int P>
__device__ void stage_halo(T* halo, const T* __restrict__ src, const int* prow, const Geo& g,
                           const Tile& t, int c0) {
  using S = Side<P>;
  const int npx = t.ntx + S::E;
  const int y0 = t.ty0 * P - HALF;
  const int x0 = t.tx0 * P - HALF;
  const int sites = (t.nty * P + KS - 1) * t.hw;
  if (g.vec) {
    constexpr int PER = 16 / sizeof(T);
    const int nv = g.cc / PER;
    for (int i = threadIdx.x; i < sites * nv; i += blockDim.x) {
      const int s = i / nv;
      const int v = i - s * nv;
      const int hy = s / t.hw;
      const int y = y0 + hy;
      const int x = x0 + s - hy * t.hw;
      const int r = prow[((y >> S::LOG) - t.ty0 + S::LO) * npx + (x >> S::LOG) - t.tx0 + S::LO];
      const T* p = src;
      if (r >= 0) p += (((size_t)r * P + (y & (P - 1))) * P + (x & (P - 1))) * g.C + c0 + v * PER;
      cp_async16(halo + (size_t)s * g.cc + v * PER, p, r >= 0);
    }
  } else {
    for (int i = threadIdx.x; i < sites * g.cc; i += blockDim.x) {
      const int s = i / g.cc;
      const int c = i - s * g.cc;
      const int hy = s / t.hw;
      const int y = y0 + hy;
      const int x = x0 + s - hy * t.hw;
      const int r = prow[((y >> S::LOG) - t.ty0 + S::LO) * npx + (x >> S::LOG) - t.tx0 + S::LO];
      halo[i] = r >= 0 ? src[(((size_t)r * P + (y & (P - 1))) * P + (x & (P - 1))) * g.C + c0 + c]
                       : from_f<T>(0.f);
    }
  }
}

// taps[t * cc + c] = w[c0 + c, t] rounded to T, from the (C, 49) f32 param
template <typename T>
__device__ void stage_taps(float* taps, const float* __restrict__ w, int cc, int c0) {
  for (int i = threadIdx.x; i < KT * cc; i += blockDim.x) {
    const int c = i / KT;
    const int t = i - c * KT;
    taps[t * cc + c] = to_f(from_f<T>(w[(size_t)(c0 + c) * KT + t]));
  }
}

// The forward (DX false: taps as they are, plus bias) or dx (DX true: the
// flipped taps, no bias) at the tile's visible patches.
template <typename T, int P, int CPT, bool DX>
__device__ void conv_visible(const T* halo, const float* taps, const float* __restrict__ bias,
                             T* __restrict__ out, const int* vis_loc, const int* vis_row,
                             const Geo& g, const Tile& t, int c0) {
  constexpr int R = Side<P>::R;
  constexpr int W = P + KS - 1;
  constexpr int GROUPS = P / R;
  const int nu = g.cc / CPT;
  const int items = t.nvis * GROUPS * nu;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int u = i % nu;
    const int rest = i / nu;
    const int grp = rest % GROUPS;
    const int j = rest / GROUPS;
    const int c = u * CPT;
    const int loc = vis_loc[j];
    const int lpy = loc / t.ntx;
    const int oy = lpy * P + grp * R;
    const int ox = (loc - lpy * t.ntx) * P;
    float acc[R][P][CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const float b0 = DX ? 0.f : bias[c0 + c + q];
#pragma unroll
      for (int o = 0; o < R; ++o)
#pragma unroll
        for (int s = 0; s < P; ++s) acc[o][s][q] = b0;
    }
#pragma unroll
    for (int ir = 0; ir < R + KS - 1; ++ir) {
      const T* hrow = halo + ((size_t)(oy + ir) * t.hw + ox) * g.cc + c;
      float win[W][CPT];
#pragma unroll
      for (int k = 0; k < W; ++k) load_ch(hrow + k * g.cc, win[k]);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int a = ir - o;
        if (a < 0 || a >= KS) continue;
        float tk[KS][CPT];
#pragma unroll
        for (int b = 0; b < KS; ++b)
          load_taps(taps + (DX ? (KS - 1 - a) * KS + KS - 1 - b : a * KS + b) * g.cc + c, tk[b]);
#pragma unroll
        for (int b = 0; b < KS; ++b)
#pragma unroll
          for (int s = 0; s < P; ++s)
#pragma unroll
            for (int q = 0; q < CPT; ++q) acc[o][s][q] = fmaf(win[s + b][q], tk[b][q], acc[o][s][q]);
      }
    }
    T* orow = out + ((size_t)vis_row[j] * P + grp * R) * P * g.C + c0 + c;
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int s = 0; s < P; ++s) store_ch(orow + ((size_t)o * P + s) * g.C, acc[o][s]);
  }
}

// dK and db of the tile: thread (slot, c) walks the work items of its slot for
// channel c, keeps 49 dK partials and a db partial in registers, the block
// adds them in red and then each (tap, channel) to dkdb with one atomicAdd.
template <typename T, int P>
__device__ void dk_visible(const T* halo, const T* __restrict__ dt, float* red,
                           float* __restrict__ dkdb, const int* vis_loc, const int* vis_row,
                           const Geo& g, const Tile& t, int c0) {
  constexpr int R = Side<P>::R;
  constexpr int W = P + KS - 1;
  constexpr int GROUPS = P / R;
  const int c = threadIdx.x % g.cc;
  const int slot = threadIdx.x / g.cc;
  const int nslots = blockDim.x / g.cc;
  float acc[KT];
#pragma unroll
  for (int k = 0; k < KT; ++k) acc[k] = 0.f;
  float dbs = 0.f;
  const int items = slot < nslots ? t.nvis * GROUPS : 0;
  for (int it = slot; it < items; it += nslots) {
    const int grp = it % GROUPS;
    const int j = it / GROUPS;
    const int loc = vis_loc[j];
    const int lpy = loc / t.ntx;
    const int oy = lpy * P + grp * R;
    const int ox = (loc - lpy * t.ntx) * P;
    const T* drow = dt + ((size_t)vis_row[j] * P + grp * R) * P * g.C + c0 + c;
    float d[R][P];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int s = 0; s < P; ++s) {
        d[o][s] = to_f(drow[((size_t)o * P + s) * g.C]);
        dbs += d[o][s];
      }
#pragma unroll
    for (int ir = 0; ir < R + KS - 1; ++ir) {
      const T* hrow = halo + ((size_t)(oy + ir) * t.hw + ox) * g.cc + c;
      float win[W];
#pragma unroll
      for (int k = 0; k < W; ++k) win[k] = to_f(hrow[k * g.cc]);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int a = ir - o;
        if (a < 0 || a >= KS) continue;
#pragma unroll
        for (int b = 0; b < KS; ++b) {
          float sum = acc[a * KS + b];
#pragma unroll
          for (int s = 0; s < P; ++s) sum = fmaf(win[s + b], d[o][s], sum);
          acc[a * KS + b] = sum;
        }
      }
    }
  }
  if (slot < nslots) {
#pragma unroll
    for (int k = 0; k < KT; ++k) atomicAdd(&red[c * RED_PITCH + k], acc[k]);
    atomicAdd(&red[c * RED_PITCH + KT], dbs);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.cc * (KT + 1); i += blockDim.x) {
    const int cl = i / (KT + 1);
    const int k = i - cl * (KT + 1);
    float* dst = k < KT ? dkdb + (size_t)(c0 + cl) * KT + k : dkdb + (size_t)g.C * KT + c0 + cl;
    atomicAdd(dst, red[cl * RED_PITCH + k]);
  }
}

template <typename T, int P, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
dw7_fwd_kernel(const T* __restrict__ xg, const int* __restrict__ inv,
               const float* __restrict__ w, const float* __restrict__ bias, T* __restrict__ out,
               Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = smem_layout(P, g.tpy, g.tpx, g.cc, sizeof(T), false);
  T* halo = reinterpret_cast<T*>(smem);
  float* taps = reinterpret_cast<float*>(smem + l.taps);
  int* prow = reinterpret_cast<int*>(smem + l.prow);
  int* vis_loc = reinterpret_cast<int*>(smem + l.vis);
  int* vis_row = vis_loc + g.tpy * g.tpx;
  Tile t;
  if (!setup_tile<P>(g, inv, prow, vis_loc, vis_row, t)) return;
  const int c0 = blockIdx.y * g.cc;
  stage_halo<T, P>(halo, xg, prow, g, t, c0);
  stage_taps<T>(taps, w, g.cc, c0);
  cp_async_wait_all();
  __syncthreads();
  conv_visible<T, P, CPT, false>(halo, taps, bias, out, vis_loc, vis_row, g, t, c0);
}

// blockIdx.z 0: dx; 1: dK and db (dkdb: (C, 49) dK then (C,) db, zeroed)
template <typename T, int P, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
dw7_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ xg, const int* __restrict__ inv,
               const float* __restrict__ w, T* __restrict__ dx, float* __restrict__ dkdb, Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = smem_layout(P, g.tpy, g.tpx, g.cc, sizeof(T), true);
  T* halo = reinterpret_cast<T*>(smem);
  float* taps = reinterpret_cast<float*>(smem + l.taps);
  float* red = reinterpret_cast<float*>(smem + l.red);
  int* prow = reinterpret_cast<int*>(smem + l.prow);
  int* vis_loc = reinterpret_cast<int*>(smem + l.vis);
  int* vis_row = vis_loc + g.tpy * g.tpx;
  Tile t;
  if (!setup_tile<P>(g, inv, prow, vis_loc, vis_row, t)) return;
  const int c0 = blockIdx.y * g.cc;
  if (blockIdx.z == 0) {
    stage_halo<T, P>(halo, dt, prow, g, t, c0);
    stage_taps<T>(taps, w, g.cc, c0);
    cp_async_wait_all();
    __syncthreads();
    conv_visible<T, P, CPT, true>(halo, taps, nullptr, dx, vis_loc, vis_row, g, t, c0);
  } else {
    stage_halo<T, P>(halo, xg, prow, g, t, c0);
    for (int i = threadIdx.x; i < RED_PITCH * g.cc; i += blockDim.x) red[i] = 0.f;
    cp_async_wait_all();
    __syncthreads();
    dk_visible<T, P>(halo, dt, red, dkdb, vis_loc, vis_row, g, t, c0);
  }
}

bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// The plan from the caller, checked against what the kernel assumes.
bool plan_ok(int p, const Geo& g, int threads, int smem, int es, bool bwd) {
  if (p != 1 && p != 2 && p != 4 && p != 8 && p != 16) return false;
  if (g.cc < 1 || g.cc > MAX_CHUNK || g.C % g.cc != 0 || g.K < 1 || g.G < 1) return false;
  if (g.tpy < 1 || g.tpx < 1 || g.tpy > g.G || g.tpx > g.G) return false;
  if (threads < 64 || threads > MAX_THREADS || threads % 32 != 0) return false;
  if (smem_layout(p, g.tpy, g.tpx, g.cc, es, bwd).total > (size_t)smem) return false;
  return !g.vec || ((g.cc * es) % 16 == 0 && (g.C * es) % 16 == 0);
}

constexpr int MAX_DEVICES = 64;

// Lets kernel take smem bytes of dynamic shared memory on the current device;
// allowed[device] keeps what was granted, so a launch sets it only once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int (&allowed)[MAX_DEVICES]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && allowed[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = smem;
  return e;
}

template <typename T, int P, int CPT>
int fwd(const void* xg, const void* inv, const void* w, const void* bias, void* out, int N,
        const Geo& g, int threads, int smem, cudaStream_t s) {
  static int allowed[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(dw7_fwd_kernel<T, P, CPT>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dw7_fwd_kernel<T, P, CPT><<<dim3(N * g.tiles, g.C / g.cc), threads, smem, s>>>(
      (const T*)xg, (const int*)inv, (const float*)w, (const float*)bias, (T*)out, g);
  return (int)cudaGetLastError();
}

template <typename T, int P, int CPT>
int bwd(const void* dt, const void* xg, const void* inv, const void* w, void* dx, void* dkdb,
        int N, const Geo& g, int threads, int smem, cudaStream_t s) {
  static int allowed[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(dw7_bwd_kernel<T, P, CPT>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dw7_bwd_kernel<T, P, CPT><<<dim3(N * g.tiles, g.C / g.cc, 2), threads, smem, s>>>(
      (const T*)dt, (const T*)xg, (const int*)inv, (const float*)w, (T*)dx, (float*)dkdb, g);
  return (int)cudaGetLastError();
}

template <typename T, int CPT>
int fwd_p(int p, const void* xg, const void* inv, const void* w, const void* bias, void* out,
          int N, const Geo& g, int threads, int smem, cudaStream_t s) {
  switch (p) {
    case 1: return fwd<T, 1, CPT>(xg, inv, w, bias, out, N, g, threads, smem, s);
    case 2: return fwd<T, 2, CPT>(xg, inv, w, bias, out, N, g, threads, smem, s);
    case 4: return fwd<T, 4, CPT>(xg, inv, w, bias, out, N, g, threads, smem, s);
    case 8: return fwd<T, 8, CPT>(xg, inv, w, bias, out, N, g, threads, smem, s);
    case 16: return fwd<T, 16, CPT>(xg, inv, w, bias, out, N, g, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int CPT>
int bwd_p(int p, const void* dt, const void* xg, const void* inv, const void* w, void* dx,
          void* dkdb, int N, const Geo& g, int threads, int smem, cudaStream_t s) {
  switch (p) {
    case 1: return bwd<T, 1, CPT>(dt, xg, inv, w, dx, dkdb, N, g, threads, smem, s);
    case 2: return bwd<T, 2, CPT>(dt, xg, inv, w, dx, dkdb, N, g, threads, smem, s);
    case 4: return bwd<T, 4, CPT>(dt, xg, inv, w, dx, dkdb, N, g, threads, smem, s);
    case 8: return bwd<T, 8, CPT>(dt, xg, inv, w, dx, dkdb, N, g, threads, smem, s);
    case 16: return bwd<T, 16, CPT>(dt, xg, inv, w, dx, dkdb, N, g, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
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

Geo make_geo(int K, int G, int C, int cc, int tpy, int tpx, int vec) {
  Geo g;
  g.K = K;
  g.G = G;
  g.C = C;
  g.cc = cc;
  g.tpy = tpy;
  g.tpx = tpx;
  g.tiles_x = (G + tpx - 1) / tpx;
  g.tiles = ((G + tpy - 1) / tpy) * g.tiles_x;
  g.vec = vec;
  return g;
}

}  // namespace

// The int arguments of a launch (ops/wholeblock.py::_config).
struct Config {
  int N, K, p, grid, C, cc, tpy, tpx, threads, smem, vec, is_bf16;
};

// xg, out: (N, K, p, p, C) bf16 or f32; inv_ids (N, grid^2) int32; weight
// (C, 1, 7, 7) and bias (C,) f32; all on device, whose stream is stream.  The
// plan (cc, tpy, tpx, threads, smem, vec) comes from
// ops/wholeblock.py::tile_plan; 16-byte staging where it allows it and every
// activation pointer is 16-byte aligned, else scalar loads.
extern "C" int mm_dwconv7_fwd(const void* xg, const void* inv_ids, const void* weight,
                              const void* bias, void* out, const Config* cfg, int device,
                              void* stream) {
  const Config& f = *cfg;
  const void* ptrs[] = {xg, out};
  const Geo g = make_geo(f.K, f.grid, f.C, f.cc, f.tpy, f.tpx,
                         f.vec && aligned16(ptrs, 2));
  if (!plan_ok(f.p, g, f.threads, f.smem, f.is_bf16 ? 2 : 4, false))
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t s = (cudaStream_t)stream;
  if (!f.is_bf16)
    return fwd_p<float, 1>(f.p, xg, inv_ids, weight, bias, out, f.N, g, f.threads, f.smem, s);
  if (f.cc % 2 == 0)
    return fwd_p<__nv_bfloat16, 2>(f.p, xg, inv_ids, weight, bias, out, f.N, g, f.threads,
                                   f.smem, s);
  return fwd_p<__nv_bfloat16, 1>(f.p, xg, inv_ids, weight, bias, out, f.N, g, f.threads,
                                 f.smem, s);
}

// dt, xg, dx: (N, K, p, p, C); dkdb: C * 50 f32, zeroed here before the
// launch adds to it: dK in the param's (C, 1, 7, 7) layout, then db (C,).
extern "C" int mm_dwconv7_bwd(const void* dt, const void* xg, const void* inv_ids,
                              const void* weight, void* dx, void* dkdb, const Config* cfg,
                              int device, void* stream) {
  const Config& f = *cfg;
  const void* ptrs[] = {dt, xg, dx};
  const Geo g = make_geo(f.K, f.grid, f.C, f.cc, f.tpy, f.tpx,
                         f.vec && aligned16(ptrs, 3));
  if (!plan_ok(f.p, g, f.threads, f.smem, f.is_bf16 ? 2 : 4, true))
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(dkdb, 0, (size_t)f.C * (KT + 1) * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (!f.is_bf16)
    return bwd_p<float, 1>(f.p, dt, xg, inv_ids, weight, dx, dkdb, f.N, g, f.threads, f.smem, s);
  if (f.cc % 2 == 0)
    return bwd_p<__nv_bfloat16, 2>(f.p, dt, xg, inv_ids, weight, dx, dkdb, f.N, g, f.threads,
                                   f.smem, s);
  return bwd_p<__nv_bfloat16, 1>(f.p, dt, xg, inv_ids, weight, dx, dkdb, f.N, g, f.threads,
                                 f.smem, s);
}

// Shared memory a block of the current device may opt in to (bytes).
extern "C" int mm_dwconv7_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}
