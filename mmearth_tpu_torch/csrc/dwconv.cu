// Weight gradient of a SAME depthwise 7x7 convolution on NHWC maps.
//
// Replaces the Pallas kernel mmearth_tpu/ops/dwconv.py:32 (_dw_grad_kernel,
// called from dw_weight_grad :64-91 in dwconv7x7's VJP :117-127).
//
//   dW[t, c] = sum_{n,h,w} xpad[n, h + t/7, w + t%7, c] * dy[n, h, w, c]
//
// with xpad the input zero-padded by 3 on every side.  x and dy are bf16 or
// f32, contiguous (N, H, W, C); products and sums are f32; dW is (49, C) f32.
//
// Bound on the H100: 2*49 flops per (n, h, w, c) against 2 + 2 bytes read
// in bf16, ~25 flop/byte.  The products are f32 FMAs on the CUDA cores (67
// TFLOP/s, ridge ~20 flop/byte), so the least time is set by the operations,
// not by the bytes.
//
// Design: the Pallas kernel carried its (49, lanes) sum in VMEM from one grid
// step to the next over the batch, and folded G = 128 / C samples into the
// lanes.  Neither carries over: blocks run in no order, and a warp wants
// neighbouring channels on neighbouring threads.  Here a block owns one 8x8
// tile of output sites, a chunk of cc <= 32 channels and a run of samples.
// For each sample it stages the 14x14 x halo (zero outside the image) and
// the 8x8 dy tile in shared memory as f32; thread (c, r) owns channel c of
// tile row r and keeps its 49 partial sums in registers.  For each of the 7
// tap rows it loads the 14 x values of its row into registers and does
// 7 x 8 FMAs, so a shared load feeds four FMAs.  After the last sample the
// 8 row-threads of a channel add their sums in shared memory, and the block
// adds each (tap, channel) to the zeroed output with one atomicAdd.  Atomics
// make the order of the sums vary from run to run.  Sites beyond the map's
// edge read dy = 0, so a ragged tile (H = 7, 14, 28) adds nothing there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KS = 7;
constexpr int KT = KS * KS;
constexpr int PAD = KS / 2;
constexpr int TH = 8;  // tile rows: one per thread row
constexpr int TW = 8;  // tile columns: one thread's strip
constexpr int XH = TH + KS - 1;
constexpr int XW = TW + KS - 1;
constexpr int MAX_CC = 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(MAX_CC * TH, 2)  // <= 128 registers: two blocks an SM
dw7_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy, float* __restrict__ dw,
                 int N, int H, int W, int C, int tiles_w, int samples_per_block) {
  extern __shared__ float smem[];
  const int cc = blockDim.x;
  float* xs = smem;               // (XH * XW) sites x cc
  float* ds = xs + XH * XW * cc;  // (TH * TW) sites x cc
  float* red = ds + TH * TW * cc; // KT x cc
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int ty = blockIdx.x / tiles_w;
  const int h0 = ty * TH;
  const int w0 = (blockIdx.x - ty * tiles_w) * TW;
  const int cg = blockIdx.y * cc + c;  // this thread's channel
  const bool live = cg < C;
  const int n0 = blockIdx.z * samples_per_block;
  const int n1 = min(N, n0 + samples_per_block);

  for (int t = r; t < KT; t += TH) red[t * cc + c] = 0.f;
  float acc[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) acc[t] = 0.f;

  for (int n = n0; n < n1; ++n) {
    __syncthreads();  // the previous sample's tiles are no longer read
    const size_t base = (size_t)n * H * W;
    for (int s = r; s < XH * XW; s += TH) {
      const int gy = h0 + s / XW - PAD;
      const int gx = w0 + s % XW - PAD;
      float v = 0.f;
      if (live && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(x[(base + (size_t)gy * W + gx) * C + cg]);
      xs[s * cc + c] = v;
    }
    for (int s = r; s < TH * TW; s += TH) {
      const int gy = h0 + s / TW;
      const int gx = w0 + s % TW;
      float v = 0.f;
      if (live && gy < H && gx < W) v = to_f(dy[(base + (size_t)gy * W + gx) * C + cg]);
      ds[s * cc + c] = v;
    }
    __syncthreads();

    float d[TW];
#pragma unroll
    for (int k = 0; k < TW; ++k) d[k] = ds[(r * TW + k) * cc + c];
#pragma unroll
    for (int a = 0; a < KS; ++a) {
      const float* row = xs + (r + a) * XW * cc + c;
      float xr[XW];
#pragma unroll
      for (int k = 0; k < XW; ++k) xr[k] = row[k * cc];
#pragma unroll
      for (int b = 0; b < KS; ++b) {
        float s = acc[a * KS + b];
#pragma unroll
        for (int k = 0; k < TW; ++k) s = fmaf(xr[k + b], d[k], s);
        acc[a * KS + b] = s;
      }
    }
  }

  __syncthreads();  // red is zeroed everywhere before any thread adds to it
#pragma unroll
  for (int t = 0; t < KT; ++t) atomicAdd(&red[t * cc + c], acc[t]);
  __syncthreads();
  if (live) {
    for (int t = r; t < KT; t += TH) atomicAdd(&dw[(size_t)t * C + cg], red[t * cc + c]);
  }
}

template <typename T>
int wgrad(const void* x, const void* dy, void* dw, int N, int H, int W, int C, int cc,
          int samples_per_block, cudaStream_t s) {
  if (cc < 1 || cc > MAX_CC || samples_per_block < 1) return (int)cudaErrorInvalidValue;
  const int tiles_h = (H + TH - 1) / TH;
  const int tiles_w = (W + TW - 1) / TW;
  const size_t smem = (size_t)(XH * XW + TH * TW + KT) * cc * sizeof(float);
  dim3 blocks(tiles_h * tiles_w, (C + cc - 1) / cc,
              (N + samples_per_block - 1) / samples_per_block);
  dim3 threads(cc, TH);
  dw7_wgrad_kernel<T><<<blocks, threads, smem, s>>>((const T*)x, (const T*)dy, (float*)dw, N, H,
                                                     W, C, tiles_w, samples_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// dw: (49, C) f32, zeroed by the caller (atomicAdd).  cc: channels a block
// (1..32; the last chunk may be ragged).  is_bf16 selects bf16 x and dy
// (else f32).
extern "C" int mm_dw7_wgrad(const void* x, const void* dy, void* dw, int N, int H, int W, int C,
                            int cc, int samples_per_block, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return wgrad<__nv_bfloat16>(x, dy, dw, N, H, W, C, cc, samples_per_block, s);
  return wgrad<float>(x, dy, dw, N, H, W, C, cc, samples_per_block, s);
}
