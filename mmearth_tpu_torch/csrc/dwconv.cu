// Weight gradient of a SAME depthwise 7x7 convolution on NHWC maps.
//
// Replaces the Pallas kernel mmearth_tpu/ops/dwconv.py:32 (_dw_grad_kernel,
// called from dw_weight_grad :64-91 in dwconv7x7's VJP :117-127).
//
//   dW[c, t] = sum_{n,h,w} xpad[n, h + t/7, w + t%7, c] * dy[n, h, w, c]
//
// with xpad the input zero-padded by 3 on every side.  x and dy are bf16 or
// f32, contiguous (N, H, W, C); products and sums are f32; dW is (C, 49) f32,
// the (C, 1, 7, 7) layout of the param.
//
// Bound on the H100: 2*49 flops per (n, h, w, c) against 2 + 2 bytes read in
// bf16.  The products are f32 FMAs on the CUDA cores (67 TFLOP/s), which take
// about as long as the bytes at 3.35 TB/s (the masked-dense step: 7.8 G FMAs,
// ~0.23 ms, against 636 MB, ~0.19 ms), so the design keeps the FMA units fed
// and hides the staging behind them:
//
// - The map is cut into tiles of th x tw output sites (th a multiple of 4,
//   tw of 8; the whole map where it fits).  A block is a persistent worker
//   of a chunk of cc channels: it walks the (sample, tile) units u =
//   blockIdx.x, + gridDim.x, ..., one wave of blocks covering the card.  For
//   each unit it stages the tile's x halo ((th+6) x (tw+6) sites, zero
//   outside the image) and its dy tile (zero beyond the map) once, in the
//   activation dtype, with 16-byte cp.async copies along the channels
//   (scalar loads where C or the chunk is not a multiple of 16 bytes).  Two
//   buffers: the next unit's copies are in flight while this one's products
//   run.
// - Thread (slot, c) owns channel c and walks the tile's strips of 4 x 8
//   output sites from its slot; it keeps the channel's 49 f32 sums in
//   registers over every strip and sample of the block.  For a strip it
//   loads the 32 dy values once, then each of the 10 input rows' 14-site
//   window once, and feeds the window to every (output row, tap row) pair it
//   meets: 1,568 FMAs for 172 shared loads, where the kernel this replaces
//   did 4 FMAs a load.
// - After its last unit the block adds its threads' sums in shared memory
//   and each (channel, tap) to dW with one atomicAdd: one wave of workers
//   keeps those atomics few (each address takes one add a worker, where a
//   block a unit made 1,092 at the masked-dense stage 0).  The order of the
//   sums varies from run to run.  The Pallas kernel carried its sum across
//   a sequential grid; blocks here run in no order.
//
// The tile, chunk, workers, threads and shared bytes come from
// ops/dwconv.py (wgrad_plan); the entry checks them and zeroes dW itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 7;
constexpr int KT = KS * KS;
constexpr int PAD = KS / 2;
constexpr int R = 4;               // output rows of a strip
constexpr int SW = 8;              // output columns of a strip
constexpr int WIN = SW + KS - 1;   // input sites a strip row reads
constexpr int MAX_THREADS = 256;
constexpr int MAX_CHUNK = 64;

struct Geo {
  int N, H, W, C;
  int cc, th, tw;  // chunk, tile rows and columns
  int tiles_x;      // tiles along a row of the map
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Copies a rows x width block of sites, origin (gy0, gx0) of sample base,
// channels c0 .. c0 + cc, to dst (site-major, the chunk's channels
// contiguous), zero outside the map.  VEC: 16-byte cp.async copies left in
// flight; else scalar loads stored at once.  The (row, site, vector) of a
// thread's copies advance by the block's stride without a division.
template <typename T, bool VEC, int CC>
__device__ __forceinline__ void stage_region(T* dst, const T* __restrict__ src, const Geo& g,
                                             size_t base, int rows, int width, int gy0,
                                             int gx0, int c0) {
  const int cc = CC ? CC : g.cc;
  constexpr int PER = VEC ? 16 / sizeof(T) : 1;
  const int nv = cc / PER;
  const int rowv = width * nv;
  const int step = blockDim.x;
  int hy = threadIdx.x / rowv;
  int hx = threadIdx.x - hy * rowv;
  int v = hx % nv;
  hx /= nv;
  const int shy = step / rowv, sv = step % nv, shx = (step - shy * rowv) / nv;
  for (; hy < rows; hy += shy) {
    const int gy = gy0 + hy, gx = gx0 + hx;
    const bool ok = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W;
    const size_t off = (base + (size_t)gy * g.W + gx) * g.C + c0 + v * PER;
    T* d = dst + (hy * width + hx) * cc + v * PER;
    if constexpr (VEC) cp_async16(d, ok ? src + off : src, ok);
    else *d = ok ? src[off] : zero<T>();
    v += sv;
    hx += shx;
    if (v >= nv) {
      v -= nv;
      ++hx;
    }
    if (hx >= width) {
      hx -= width;
      ++hy;
    }
  }
}

// One sample's halo (buf[0 : hsites*cc]) and dy tile (after it).
template <typename T, bool VEC, int CC>
__device__ __forceinline__ void stage_sample(T* buf, const T* __restrict__ x,
                                             const T* __restrict__ dy, const Geo& g, int n,
                                             int y0, int x0, int c0) {
  const int cc = CC ? CC : g.cc;
  const int hw = g.tw + KS - 1;
  const size_t base = (size_t)n * g.H * g.W;
  stage_region<T, VEC, CC>(buf, x, g, base, g.th + KS - 1, hw, y0 - PAD, x0 - PAD, c0);
  stage_region<T, VEC, CC>(buf + (size_t)(g.th + KS - 1) * hw * cc, dy, g, base, g.th, g.tw,
                           y0, x0, c0);
}

// acc += the 49 tap sums of channel c over the strip at tile site (oy, ox).
template <typename T, int CC>
__device__ __forceinline__ void strip_sums(const T* hs, const T* ds, const Geo& g, int c, int oy,
                                           int ox, float (&acc)[KT]) {
  const int cc = CC ? CC : g.cc;
  const int hw = g.tw + KS - 1;
  float d[R][SW];
#pragma unroll
  for (int o = 0; o < R; ++o)
#pragma unroll
    for (int k = 0; k < SW; ++k) d[o][k] = to_f(ds[((oy + o) * g.tw + ox + k) * cc + c]);
#pragma unroll
  for (int ir = 0; ir < R + KS - 1; ++ir) {
    const T* row = hs + ((oy + ir) * hw + ox) * cc + c;
    float win[WIN];
#pragma unroll
    for (int k = 0; k < WIN; ++k) win[k] = to_f(row[k * cc]);
#pragma unroll
    for (int o = 0; o < R; ++o) {
      const int a = ir - o;
      if (a < 0 || a >= KS) continue;
#pragma unroll
      for (int b = 0; b < KS; ++b) {
        float s = acc[a * KS + b];
#pragma unroll
        for (int k = 0; k < SW; ++k) s = fmaf(win[k + b], d[o][k], s);
        acc[a * KS + b] = s;
      }
    }
  }
}

// CC: the chunk as a constant (32 or 40, so that the strip's shared loads take
// immediate offsets), or 0 to read it from g.
template <typename T, bool VEC, int CC>
__global__ void __launch_bounds__(MAX_THREADS, 2)  // <= 128 registers: two blocks an SM
dw7_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ dw,
                 Geo g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cc = CC ? CC : g.cc;
  const int hsites = (g.th + KS - 1) * (g.tw + KS - 1);
  const size_t buf_elems = (size_t)(hsites + g.th * g.tw) * cc;
  T* const buf0 = reinterpret_cast<T*>(smem);  // units 1, 3, ... of the block; then 2, 4, ...
  const int tiles = ((g.H + g.th - 1) / g.th) * g.tiles_x;
  const int units = g.N * tiles;  // (sample, tile) pairs, sample-major
  const int c0 = blockIdx.y * cc;
  const int c = threadIdx.x % cc;
  const int slot = threadIdx.x / cc;
  const int nslots = blockDim.x / cc;
  const int sx_n = g.tw / SW;
  const int strips = (g.th / R) * sx_n;

  float acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;

  // unit u: sample u / tiles, tile u % tiles (row-major), origin (y0, x0)
  auto origin = [&](int u, int& n, int& y0, int& x0) {
    n = u / tiles;
    const int t = u - n * tiles, ty = t / g.tiles_x;
    y0 = ty * g.th;
    x0 = (t - ty * g.tiles_x) * g.tw;
  };
  int n, y0, x0;
  origin(blockIdx.x, n, y0, x0);
  stage_sample<T, VEC, CC>(buf0, x, dy, g, n, y0, x0, c0);
  if constexpr (VEC) cp_async_commit();
  for (int u = blockIdx.x, i = 0; u < units; u += gridDim.x, ++i) {
    const T* cur = (i & 1) ? buf0 + buf_elems : buf0;
    if (u + gridDim.x < units) {  // the next unit's copies overlap this one's products
      int nn, ny0, nx0;
      origin(u + gridDim.x, nn, ny0, nx0);
      stage_sample<T, VEC, CC>((i & 1) ? buf0 : buf0 + buf_elems, x, dy, g, nn, ny0, nx0, c0);
      if constexpr (VEC) {
        cp_async_commit();
        cp_async_wait<1>();
      }
    } else if constexpr (VEC) {
      cp_async_wait<0>();
    }
    __syncthreads();
    origin(u, n, y0, x0);
    if (slot < nslots) {
      for (int s = slot; s < strips; s += nslots) {
        const int sy = s / sx_n;
        const int oy = sy * R, ox = (s - sy * sx_n) * SW;
        if (y0 + oy >= g.H || x0 + ox >= g.W) continue;  // wholly beyond the map
        strip_sums<T, CC>(cur, cur + (size_t)hsites * cc, g, c, oy, ox, acc);
      }
    }
    __syncthreads();  // this buffer is restaged two units on
  }

  float* red = reinterpret_cast<float*>(smem);  // (cc, 49); the staging is done
  for (int i = threadIdx.x; i < cc * KT; i += blockDim.x) red[i] = 0.f;
  __syncthreads();
  if (slot < nslots) {
#pragma unroll
    for (int t = 0; t < KT; ++t) atomicAdd(&red[c * KT + t], acc[t]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cc * KT; i += blockDim.x)
    atomicAdd(&dw[(size_t)c0 * KT + i], red[i]);
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

template <typename T, bool VEC, int CC>
int launch(const void* x, const void* dy, void* dw, const Geo& g, int workers, int threads,
           int smem, cudaStream_t s) {
  static int allowed[MAX_DEVICES] = {};
  cudaError_t e = allow_smem(dw7_wgrad_kernel<T, VEC, CC>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 blocks(workers, g.C / g.cc);
  dw7_wgrad_kernel<T, VEC, CC><<<blocks, threads, smem, s>>>((const T*)x, (const T*)dy,
                                                              (float*)dw, g);
  return (int)cudaGetLastError();
}

// The launch for the plan's chunk: a constant one where the kernel has it.
template <typename T>
int by_chunk(bool vec, const void* x, const void* dy, void* dw, const Geo& g, int workers,
             int threads, int smem, cudaStream_t s) {
  if (!vec) return launch<T, false, 0>(x, dy, dw, g, workers, threads, smem, s);
  if (g.cc == 32) return launch<T, true, 32>(x, dy, dw, g, workers, threads, smem, s);
  if (g.cc == 40) return launch<T, true, 40>(x, dy, dw, g, workers, threads, smem, s);
  return launch<T, true, 0>(x, dy, dw, g, workers, threads, smem, s);
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

}  // namespace

// The int arguments of a launch (ops/dwconv.py::_config).
struct Config {
  int N, H, W, C, cc, th, tw, workers, threads, smem, vec, is_bf16;
};

// x, dy: (N, H, W, C) bf16 or f32, contiguous, on device, whose stream is
// stream; dw: (C, 49) f32, zeroed here before the launch adds to it.  The
// plan (cc, th, tw, workers, threads, smem, vec) comes from
// ops/dwconv.py::wgrad_plan: 16-byte staging where it asks for it and both
// inputs are 16-byte aligned, else scalar loads.
extern "C" int mm_dw7_wgrad(const void* x, const void* dy, void* dw, const Config* cfg,
                            int device, void* stream) {
  const Config& f = *cfg;
  const int es = f.is_bf16 ? 2 : 4;
  const bool vec = f.vec && (f.cc * es) % 16 == 0 && (f.C * es) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const size_t sites = (size_t)(f.th + KS - 1) * (f.tw + KS - 1) + (size_t)f.th * f.tw;
  const long long units =
      f.th > 0 && f.tw > 0 ? (long long)f.N * ((f.H + f.th - 1) / f.th) * ((f.W + f.tw - 1) / f.tw)
                           : 0;
  if (f.N < 1 || f.H < 1 || f.W < 1 || f.cc < 1 || f.cc > MAX_CHUNK || f.C % f.cc != 0 ||
      f.th < R || f.th % R != 0 || f.tw < SW || f.tw % SW != 0 || f.workers < 1 ||
      f.workers > units || f.workers > 65535 || f.threads < f.cc || f.threads > MAX_THREADS ||
      f.threads % f.cc != 0 || (size_t)f.smem < 2 * sites * f.cc * es ||
      (size_t)f.smem < (size_t)KT * f.cc * 4)
    return (int)cudaErrorInvalidValue;
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(dw, 0, (size_t)f.C * KT * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  Geo g;
  g.N = f.N;
  g.H = f.H;
  g.W = f.W;
  g.C = f.C;
  g.cc = f.cc;
  g.th = f.th;
  g.tw = f.tw;
  g.tiles_x = (f.W + f.tw - 1) / f.tw;
  return f.is_bf16 ? by_chunk<__nv_bfloat16>(vec, x, dy, dw, g, f.workers, f.threads, f.smem, s)
                   : by_chunk<float>(vec, x, dy, dw, g, f.workers, f.threads, f.smem, s);
}

// Shared memory a block of the current device may opt in to (bytes).
extern "C" int mm_dw7_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}
