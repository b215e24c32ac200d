// Patch gather / scatter between a dense NHWC grid and gathered visible rows.
//
// Replaces the Pallas kernels mmearth_tpu/ops/patch_select.py:52
// (_gather_kernel, called at :76-89) and :63 (_scatter_kernel, :92-106).
//
//   gather : x (N, H, W, C) -> out (N, K, p, p, C), out[n, k] = the p x p patch
//            kept_ids[n, k] of x.
//   scatter: xg (N, K, p, p, C) -> out (N, H, W, C); the patch of row
//            inv_ids[n, l] lands on patch l, zeros where inv_ids[n, l] == K.
//
// Bound on the H100: pure data movement, so bytes.  Gather reads and writes
// N*K*p*p*C elements; scatter reads N*K*p*p*C and writes N*H*W*C.  Neither
// does any arithmetic.
//
// Design: a patch row (p*C contiguous elements, 640 bytes at every stage of
// atto 56/8 in bf16) is the unit of contiguity on both sides, so one block
// copies one patch with vector accesses of the widest width (16/8/4/2 bytes)
// that divides the row and the pointers; neighbouring threads touch
// neighbouring addresses.  Scatter runs one block per *dense* patch and reads
// its row through inv_ids: every output element is written exactly once
// (zeros included), so no memset pass and no atomics are needed.  Both are
// bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void gather_kernel(const V* __restrict__ x, const int* __restrict__ kept,
                              V* __restrict__ out, int H, int W, int K, int p,
                              int grid, int row_units, int C_units) {
  const int nk = blockIdx.x;  // n * K + k
  const int n = nk / K;
  const int pid = kept[nk];
  const int y0 = (pid / grid) * p;
  const int x0 = (pid % grid) * p;
  const int total = p * row_units;
  V* dst = out + (size_t)nk * total;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / row_units;
    const int u = i - r * row_units;
    const size_t src = (((size_t)n * H + y0 + r) * W + x0) * C_units + u;
    dst[i] = x[src];
  }
}

template <typename V>
__global__ void scatter_kernel(const V* __restrict__ xg, const int* __restrict__ inv,
                               V* __restrict__ out, int H, int W, int K, int p,
                               int grid, int row_units, int C_units) {
  const int nl = blockIdx.x;  // n * L + l
  const int L = grid * grid;
  const int n = nl / L;
  const int l = nl - n * L;
  const int row = inv[nl];
  const int y0 = (l / grid) * p;
  const int x0 = (l % grid) * p;
  const int total = p * row_units;
  const V* src = xg + ((size_t)n * K + row) * total;
  const V zero{};
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / row_units;
    const int u = i - r * row_units;
    const size_t dst = (((size_t)n * H + y0 + r) * W + x0) * C_units + u;
    out[dst] = row < K ? src[i] : zero;
  }
}

struct U2 { uint16_t v; };

template <typename V>
int launch(bool scatter, const void* a, const int* ids, void* out, int N, int H,
           int W, int K, int p, int grid, int row_bytes, int C_bytes,
           cudaStream_t stream) {
  const int row_units = row_bytes / (int)sizeof(V);
  const int C_units = C_bytes / (int)sizeof(V);
  const int total = p * row_units;
  int threads = total < 256 ? ((total + 31) / 32) * 32 : 256;
  const int blocks = scatter ? N * grid * grid : N * K;
  if (scatter) {
    scatter_kernel<V><<<blocks, threads, 0, stream>>>(
        (const V*)a, ids, (V*)out, H, W, K, p, grid, row_units, C_units);
  } else {
    gather_kernel<V><<<blocks, threads, 0, stream>>>(
        (const V*)a, ids, (V*)out, H, W, K, p, grid, row_units, C_units);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool scatter, const void* a, const int* ids, void* out, int N, int H,
             int W, int C, int K, int p, int grid, int elem_bytes, int vec_bytes,
             void* stream) {
  const int row_bytes = p * C * elem_bytes;
  const int C_bytes = C * elem_bytes;
  cudaStream_t s = (cudaStream_t)stream;
  switch (vec_bytes) {
    case 16: return launch<uint4>(scatter, a, ids, out, N, H, W, K, p, grid, row_bytes, C_bytes, s);
    case 8: return launch<uint2>(scatter, a, ids, out, N, H, W, K, p, grid, row_bytes, C_bytes, s);
    case 4: return launch<unsigned int>(scatter, a, ids, out, N, H, W, K, p, grid, row_bytes, C_bytes, s);
    case 2: return launch<U2>(scatter, a, ids, out, N, H, W, K, p, grid, row_bytes, C_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vec_bytes: the access width, chosen by the caller so that it divides the
// channel row (C * elem_bytes) and both base pointers.
extern "C" int mm_gather_patches(const void* x, const void* kept_ids, void* out,
                                 int N, int H, int W, int C, int K, int p, int grid,
                                 int elem_bytes, int vec_bytes, void* stream) {
  return dispatch(false, x, (const int*)kept_ids, out, N, H, W, C, K, p, grid,
                  elem_bytes, vec_bytes, stream);
}

extern "C" int mm_scatter_patches(const void* xg, const void* inv_ids, void* out,
                                  int N, int H, int W, int C, int K, int p, int grid,
                                  int elem_bytes, int vec_bytes, void* stream) {
  return dispatch(true, xg, (const int*)inv_ids, out, N, H, W, C, K, p, grid,
                  elem_bytes, vec_bytes, stream);
}
