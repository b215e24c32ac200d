// Fused scatter -> depthwise 7x7 SAME conv -> gather on gathered visible rows.
//
// Replaces the Pallas kernels mmearth_tpu/ops/wholeblock.py:127 (_fwd_kernel,
// called from _fwd :216-246) and :150 (_bwd_kernel, _bwd_rule :254-298).
//
//   forward : t[n,k,y,x,c] = bias[c] + sum_{a,b} X[n, Y+a-3, X+b-3, c] * w[a,b,c]
//             where X is the dense grid implied by the gathered rows (zero at
//             masked patches and outside the image) and (Y, X) the dense site
//             of (k, y, x).  Taps arrive already rounded to the activation
//             dtype (wholeblock.py:220), bias and the accumulator are f32
//             (:221, :141), the output is stored in the activation dtype.
//   backward: dx = the same scheme over dt with the flipped taps, no bias;
//             dK[a,b,c] = sum over the batch of X[Y+a-3, X+b-3, c] * dt[Y,X,c];
//             db[c] = sum of dt.  dK, db in f32.
//
// Bound on the H100: 2*49 flops per output element (98 for dx and 98 for dK
// in the backward) against 2 bytes read + 2 written per element in bf16, i.e.
// ~25 flop/byte.  The products of bf16 activations and bf16-rounded taps are
// exact in f32, so the same sums could run on the bf16 tensor cores (989
// TFLOP/s, ridge ~295 flop/byte): the least time is set by the bytes.  This
// kernel does its FMAs on the f32 CUDA cores (67 TFLOP/s, ridge ~20
// flop/byte), where the arithmetic and the bytes take about the same time.
//
// Design: the TPU kernel scattered a whole image into VMEM; a stage-0 image
// (56*56*40 bf16 = 250 KB) does not fit one SM's shared memory, so here a
// block owns one gathered row (one visible patch) and one chunk of cc
// channels.  It builds the (p+6)^2 x cc halo tile in shared memory straight
// from the gathered rows: each halo site is mapped to its patch and looked up
// in inv_ids, and reads zero where the patch is masked or the site lies
// outside the image.  The 49 taps of the chunk sit in shared memory too, and
// each thread computes whole outputs in an f32 register.  The backward walks
// rows_per_block rows per block, keeps its share of the (49, cc) dK partial
// sums and the db partials in registers, and adds them to the f32 outputs
// with one atomicAdd each at the end; the TPU kernel's carried accumulator
// (wholeblock.py:157-160,192-195) has no counterpart since blocks run in no
// order.  Atomics make the order of the dK/db sums vary from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int KS = 7;
constexpr int KT = KS * KS;
constexpr int BWD_THREADS = 256;
constexpr int BWD_PER_THREAD = 16;  // dK entries per thread: 49 * cc <= 4096

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Fill tile[(hy*(p+6) + hx)*cc + c] with the dense value at (y0+hy, x0+hx),
// channel c0+c, of image n, read from the gathered rows src (N, K, p, p, C).
template <typename T>
__device__ void load_halo(float* tile, const T* __restrict__ src,
                          const int* __restrict__ inv_n, int n, int K, int p,
                          int grid, int C, int c0, int cc, int y0, int x0) {
  const int P6 = p + 6;
  const int h = grid * p;
  const int total = P6 * P6 * cc;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int hs = i / cc;
    const int c = i - hs * cc;
    const int hy = hs / P6;
    const int y = y0 + hy;
    const int x = x0 + hs - hy * P6;
    float v = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < h) {
      const int r = inv_n[(y / p) * grid + x / p];
      if (r < K) {
        v = to_f(src[((((size_t)n * K + r) * p + y % p) * p + x % p) * C + c0 + c]);
      }
    }
    tile[i] = v;
  }
}

template <typename T>
__global__ void dw7_fwd_kernel(const T* __restrict__ xg, const int* __restrict__ kept,
                               const int* __restrict__ inv, const float* __restrict__ taps,
                               const float* __restrict__ bias, T* __restrict__ out,
                               int K, int p, int grid, int C, int cc) {
  extern __shared__ float smem[];
  const int P6 = p + 6;
  float* tile = smem;
  float* tk = smem + P6 * P6 * cc;
  const int row = blockIdx.x;  // n * K + k
  const int c0 = blockIdx.y * cc;
  const int n = row / K;
  const int pid = kept[row];
  for (int i = threadIdx.x; i < KT * cc; i += blockDim.x) {
    const int t = i / cc;
    tk[i] = taps[t * C + c0 + i - t * cc];
  }
  load_halo(tile, xg, inv + (size_t)n * grid * grid, n, K, p, grid, C, c0, cc,
            (pid / grid) * p - 3, (pid % grid) * p - 3);
  __syncthreads();
  const int nout = p * p * cc;
  for (int i = threadIdx.x; i < nout; i += blockDim.x) {
    const int s = i / cc;
    const int c = i - s * cc;
    const int ly = s / p;
    const int lx = s - ly * p;
    float acc = bias[c0 + c];
#pragma unroll
    for (int a = 0; a < KS; ++a) {
#pragma unroll
      for (int b = 0; b < KS; ++b) {
        acc = fmaf(tile[((ly + a) * P6 + lx + b) * cc + c], tk[(a * KS + b) * cc + c], acc);
      }
    }
    out[((size_t)row * p * p + s) * C + c0 + c] = from_f<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
dw7_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ xg,
               const int* __restrict__ kept, const int* __restrict__ inv,
               const float* __restrict__ taps, T* __restrict__ dx,
               float* __restrict__ dk, float* __restrict__ db, int NK, int K,
               int p, int grid, int C, int cc, int rows_per_block) {
  extern __shared__ float smem[];
  const int P6 = p + 6;
  float* xt = smem;
  float* dtt = xt + P6 * P6 * cc;
  float* tk = dtt + P6 * P6 * cc;
  const int c0 = blockIdx.y * cc;
  const int L = grid * grid;
  for (int i = threadIdx.x; i < KT * cc; i += blockDim.x) {
    const int t = i / cc;
    tk[i] = taps[t * C + c0 + i - t * cc];
  }
  float acc_k[BWD_PER_THREAD];
#pragma unroll
  for (int j = 0; j < BWD_PER_THREAD; ++j) acc_k[j] = 0.f;
  float acc_b = 0.f;

  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(NK, row0 + rows_per_block);
  for (int row = row0; row < row1; ++row) {
    const int n = row / K;
    const int pid = kept[row];
    const int y0 = (pid / grid) * p - 3;
    const int x0 = (pid % grid) * p - 3;
    __syncthreads();  // the previous row's tiles are no longer read
    load_halo(xt, xg, inv + (size_t)n * L, n, K, p, grid, C, c0, cc, y0, x0);
    load_halo(dtt, dt, inv + (size_t)n * L, n, K, p, grid, C, c0, cc, y0, x0);
    __syncthreads();

    // dx: correlation of the dt halo with the flipped taps
    const int nout = p * p * cc;
    for (int i = threadIdx.x; i < nout; i += blockDim.x) {
      const int s = i / cc;
      const int c = i - s * cc;
      const int ly = s / p;
      const int lx = s - ly * p;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < KS; ++a) {
#pragma unroll
        for (int b = 0; b < KS; ++b) {
          acc = fmaf(dtt[((ly + a) * P6 + lx + b) * cc + c],
                     tk[((KS - 1 - a) * KS + (KS - 1 - b)) * cc + c], acc);
        }
      }
      dx[((size_t)row * p * p + s) * C + c0 + c] = from_f<T>(acc);
    }

    // dK partials: each thread owns entries e = tid + j * blockDim (tap, c)
#pragma unroll
    for (int j = 0; j < BWD_PER_THREAD; ++j) {
      const int e = threadIdx.x + j * BWD_THREADS;
      if (e < KT * cc) {
        const int t = e / cc;
        const int c = e - t * cc;
        const int a = t / KS;
        const int b = t - a * KS;
        float s = 0.f;
        for (int ly = 0; ly < p; ++ly) {
          for (int lx = 0; lx < p; ++lx) {
            s = fmaf(xt[((ly + a) * P6 + lx + b) * cc + c],
                     dtt[((ly + 3) * P6 + lx + 3) * cc + c], s);
          }
        }
        acc_k[j] += s;
      }
    }
    if (threadIdx.x < cc) {
      float s = 0.f;
      for (int ly = 0; ly < p; ++ly)
        for (int lx = 0; lx < p; ++lx) s += dtt[((ly + 3) * P6 + lx + 3) * cc + threadIdx.x];
      acc_b += s;
    }
  }

#pragma unroll
  for (int j = 0; j < BWD_PER_THREAD; ++j) {
    const int e = threadIdx.x + j * BWD_THREADS;
    if (e < KT * cc) {
      const int t = e / cc;
      atomicAdd(&dk[t * C + c0 + e - t * cc], acc_k[j]);
    }
  }
  if (threadIdx.x < cc) atomicAdd(&db[c0 + threadIdx.x], acc_b);
}

int fwd_threads(int p, int cc) {
  const int nout = p * p * cc;
  return nout < 256 ? ((nout + 31) / 32) * 32 : 256;
}

template <typename T>
int fwd(const void* xg, const void* kept, const void* inv, const void* taps,
        const void* bias, void* out, int N, int K, int p, int grid, int C, int cc,
        cudaStream_t s) {
  const size_t smem = (size_t)((p + 6) * (p + 6) + KT) * cc * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dw7_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 blocks(N * K, C / cc);
  dw7_fwd_kernel<T><<<blocks, fwd_threads(p, cc), smem, s>>>(
      (const T*)xg, (const int*)kept, (const int*)inv, (const float*)taps,
      (const float*)bias, (T*)out, K, p, grid, C, cc);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* dt, const void* xg, const void* kept, const void* inv,
        const void* taps, void* dx, void* dk, void* db, int N, int K, int p, int grid,
        int C, int cc, int rows_per_block, cudaStream_t s) {
  if (KT * cc > BWD_THREADS * BWD_PER_THREAD) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * (p + 6) * (p + 6) + KT) * cc * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dw7_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int NK = N * K;
  dim3 blocks((NK + rows_per_block - 1) / rows_per_block, C / cc);
  dw7_bwd_kernel<T><<<blocks, BWD_THREADS, smem, s>>>(
      (const T*)dt, (const T*)xg, (const int*)kept, (const int*)inv,
      (const float*)taps, (T*)dx, (float*)dk, (float*)db, NK, K, p, grid, C, cc,
      rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// taps: (49, C) f32 holding the activation-dtype-rounded taps; bias: (C,) f32.
// cc must divide C.  is_bf16 selects bf16 activations (else f32).
extern "C" int mm_dwconv7_fwd(const void* xg, const void* kept_ids, const void* inv_ids,
                              const void* taps, const void* bias, void* out, int N, int K,
                              int p, int grid, int C, int cc, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fwd<__nv_bfloat16>(xg, kept_ids, inv_ids, taps, bias, out, N, K, p, grid, C, cc, s);
  return fwd<float>(xg, kept_ids, inv_ids, taps, bias, out, N, K, p, grid, C, cc, s);
}

// dk (49, C) and db (C,) are f32 and must be zeroed by the caller (atomicAdd).
extern "C" int mm_dwconv7_bwd(const void* dt, const void* xg, const void* kept_ids,
                              const void* inv_ids, const void* taps, void* dx, void* dk,
                              void* db, int N, int K, int p, int grid, int C, int cc,
                              int rows_per_block, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return bwd<__nv_bfloat16>(dt, xg, kept_ids, inv_ids, taps, dx, dk, db, N, K, p, grid, C,
                              cc, rows_per_block, s);
  return bwd<float>(dt, xg, kept_ids, inv_ids, taps, dx, dk, db, N, K, p, grid, C, cc,
                    rows_per_block, s);
}
