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
// does any arithmetic, so both are bit-exact.
//
// Design.  A "row", p*C contiguous elements, is contiguous on both sides: one
// row of one patch in the dense grid, one row of a gathered patch.  Both
// kernels walk the rows of their OUTPUT in memory order:
//   gather : output row (n, k, r)  <- dense row y = py*p + r of patch kept[n, k]
//   scatter: dense row (n, y, px)  <- row (n, inv[n, l], y % p) of xg, where
//            l = (y / p) * grid + px, or zeros where inv[n, l] == K
// so a run of consecutive rows is one contiguous range of the output, and
// every output byte is written exactly once (no memset, no atomics).  A unit
// of work is a chunk of one row: the whole row where it fits a shared-memory
// slot, else `chunks` chunks of `chunk_bytes` (the last may be shorter).
// Units come in groups of `group` consecutive units: a slot's worth on the
// bulk path, a warp's batch on the register path.  The grid is persistent
// (the SMs times the blocks an SM holds, from the occupancy API), and the
// blocks (on the register path, the warps) take the groups in turn: block b
// of B walks groups b, b + B, b + 2B, ...  So at any time the card writes a
// window of the output some B groups wide that moves through it in order
// (with a contiguous range a block instead, the stem scatters ran about 15%
// slower on an H100).  The plan (path, slots, slot bytes, chunking, grid) is
// made by the caller (ops/patch_select.py::copy_plan) and checked here.
//
// The bulk path (rows of a multiple of 16 bytes, both base pointers 16-byte
// aligned: every atto and pico shape in bf16 and f32) runs on Hopper's bulk
// copies.  A block is one warp with a ring of `slots` slots in shared
// memory, each with an mbarrier.  Lane j computes unit j of a group (one
// row's index math, its id read from kept/inv) and starts its row chunk's
// `cp.async.bulk` load into the slot once lane 0 has armed the slot's
// barrier with the group's bytes (`mbarrier.arrive.expect_tx`); the loads
// of `slots - 2` groups are in flight ahead of the group being stored.  Once
// a slot's barrier completes, lane 0 stores the group with bulk stores
// (`cp.async.bulk.global.shared::cta`) and commits them as one bulk group;
// a slot is loaded again only after `cp.async.bulk.wait_group.read` has seen
// its store read it.  Gather stores a group with one copy; scatter with one
// copy per run of loaded or of masked units, the masked runs straight from
// one slot zeroed once per block, with no load.
//
// The register path (any other row or pointer: C = 37, a view at an odd
// element offset) walks the same units with 256-thread blocks: a warp takes
// a group of four rows, and each lane loads one vector of the widest width
// (8/4/2 bytes) that divides the row and both pointers from each of the
// four before it stores them, four independent loads in flight a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The plan from the caller (ops/patch_select.py::CopyPlan, in its order).
struct Config {
  int N, K, p, grid;       // batch, kept patches a sample, patch side, patches a side
  int row_bytes;           // p * C * element bytes
  int bulk;                // 1: bulk-copy path; 0: register path
  int vec;                 // register path: bytes a vector access
  int chunk_bytes, chunks; // a unit: one chunk of a row; chunks a row
  int group;               // units a group
  int slots, slot_bytes;   // bulk path: the ring
  int units, groups, blocks, smem;
};

constexpr int kRegUnits = 4;  // rows a warp's group on the register path
constexpr int kRegThreads = 256;
constexpr int kBulkThreads = 32;

struct Unit {
  size_t src, dst;  // byte offsets into the input and the output
  int bytes;
  bool zero;        // scatter: a masked patch's row, stored as zeros
};

// Unit u: its source and destination offsets, in size_t (the dense grid of
// pico's stem is 102.8 MB at batch 64).
template <bool SCATTER>
__device__ __forceinline__ Unit unit_of(const Config& f, const int* __restrict__ ids, int u) {
  const int row = u / f.chunks;
  const int ch = u - row * f.chunks;
  const int h = f.grid * f.p;
  const size_t within = (size_t)ch * f.chunk_bytes;
  Unit t;
  t.bytes = min(f.chunk_bytes, f.row_bytes - ch * f.chunk_bytes);
  t.dst = (size_t)row * f.row_bytes + within;
  if (!SCATTER) {
    // row = (n * K + k) * p + r; the source is dense row (n, py * p + r) at
    // column px * p: ((n * H + y) * grid + px) rows of p * C elements
    const int pk = row / f.p;
    const int r = row - pk * f.p;
    const int n = pk / f.K;
    const int pid = ids[pk];
    const int py = pid / f.grid;
    const int px = pid - py * f.grid;
    t.src = (((size_t)n * h + py * f.p + r) * f.grid + px) * f.row_bytes + within;
    t.zero = false;
  } else {
    // row = (n * H + y) * grid + px of the dense output
    const int px = row % f.grid;
    const int ny = row / f.grid;
    const int n = ny / h;
    const int y = ny - n * h;
    const int py = y / f.p;
    const int r = y - py * f.p;
    const int src = ids[n * f.grid * f.grid + py * f.grid + px];
    t.zero = src >= f.K;
    t.src = (((size_t)n * f.K + (t.zero ? 0 : src)) * f.p + r) * f.row_bytes + within;
  }
  return t;
}

// ---------------------------------------------------------------------------
// bulk path: PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `parity` to complete.  A phase that never completes
// (a wrong parity or byte count) traps after ~2^34 cycles rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared memory of a bulk block: the ring, the zero slot (scatter), then a
// barrier and a masked-unit mask a slot.
__host__ __device__ inline size_t bulk_smem(int slots, int slot_bytes, bool scatter) {
  return (size_t)(slots + (scatter ? 1 : 0)) * slot_bytes + (size_t)slots * 12;
}

// Lanes load group G's units into slot s; lane 0 arms the slot's barrier
// with the bytes they load and notes the group's masked units.
template <bool SCATTER>
__device__ __forceinline__ void load_group(const Config& f, const char* __restrict__ src,
                                            const int* __restrict__ ids, unsigned char* slot,
                                            uint64_t* bar, uint32_t* zmask, int G) {
  const int lane = threadIdx.x;
  const int u0 = G * f.group;
  const int nu = min(f.group, f.units - u0);
  Unit t{};
  const bool mine = lane < nu;
  if (mine) t = unit_of<SCATTER>(f, ids, u0 + lane);
  const bool load = mine && !t.zero;
  const uint32_t zero = __ballot_sync(0xffffffffu, mine && t.zero);
  const uint32_t tx = __reduce_add_sync(0xffffffffu, load ? (uint32_t)t.bytes : 0u);
  if (lane == 0) {
    *zmask = zero;
    mbar_arrive_expect_tx(bar, tx);
  }
  __syncwarp();
  // a group is either whole rows (chunks == 1) or one chunk (group == 1)
  if (load) bulk_load(slot + (size_t)lane * f.row_bytes, src + t.src, t.bytes, bar);
}

// Lane 0 stores group G from slot s (and masked runs from the zero slot).
template <bool SCATTER>
__device__ __forceinline__ void store_group(const Config& f, char* __restrict__ out,
                                            const unsigned char* slot,
                                            const unsigned char* zero_slot, uint32_t zmask,
                                            int G) {
  const int u0 = G * f.group;
  const int nu = min(f.group, f.units - u0);
  const int row = u0 / f.chunks;
  const int ch = u0 - row * f.chunks;
  const int ub = min(f.chunk_bytes, f.row_bytes - ch * f.chunk_bytes);  // bytes a unit
  char* dst = out + (size_t)row * f.row_bytes + (size_t)ch * f.chunk_bytes;
  fence_async_shared();
  if (!SCATTER) {
    bulk_store(dst, slot, (uint32_t)(nu * ub));
    return;
  }
  const uint32_t valid = nu >= 32 ? 0xffffffffu : (1u << nu) - 1u;
  const uint32_t z = zmask & valid;
  int a = 0;
  while (a < nu) {
    const bool masked = (z >> a) & 1u;
    const uint32_t other = (masked ? ~z : z) & valid & (uint32_t)(~0ull << (a + 1));
    const int b = other ? __ffs(other) - 1 : nu;
    const size_t off = (size_t)a * ub;
    bulk_store(dst + off, masked ? zero_slot : slot + off, (uint32_t)((b - a) * ub));
    a = b;
  }
}

template <bool SCATTER>
__global__ void __launch_bounds__(kBulkThreads)
    patch_copy_bulk(const char* __restrict__ src, const int* __restrict__ ids,
                    char* __restrict__ out, Config f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x;
  const int S = f.slots;
  unsigned char* ring = smem;
  unsigned char* zero_slot = smem + (size_t)S * f.slot_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)(S + (SCATTER ? 1 : 0)) * f.slot_bytes);
  uint32_t* zmask = reinterpret_cast<uint32_t*>(bars + S);
  // groups blockIdx.x, + gridDim.x, + 2 * gridDim.x, ...
  const int g0 = blockIdx.x;
  const int gs = gridDim.x;
  const int n = (f.groups - g0 + gs - 1) / gs;
  if (n <= 0) return;
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (SCATTER) {
    // the masked runs' source: written once, fenced for the async proxy
    uint4* z = reinterpret_cast<uint4*>(zero_slot);
    for (int i = lane; i < f.slot_bytes / 16; i += kBulkThreads) z[i] = make_uint4(0, 0, 0, 0);
    fence_async_shared();
  }
  __syncthreads();
  // the loads of D groups run ahead of the group being stored.  At step i
  // the stores of groups < i are committed, and the load of group i + D
  // refills the slot of group i + D - S = i - 2: every committed store but
  // the newest (group i - 1) must have read its slot, wait_group.read 1.
  const int D = S - 2;
  for (int i = 0; i < min(D, n); ++i)
    load_group<SCATTER>(f, src, ids, ring + (size_t)i * f.slot_bytes, &bars[i], &zmask[i],
                         g0 + i * gs);
  for (int i = 0; i < n; ++i) {
    if (i + D < n) {
      const int s = (i + D) % S;
      if (lane == 0) bulk_wait_read<1>();
      __syncwarp();
      load_group<SCATTER>(f, src, ids, ring + (size_t)s * f.slot_bytes, &bars[s], &zmask[s],
                           g0 + (i + D) * gs);
    }
    if (lane == 0) {
      const int s = i % S;
      mbar_wait(&bars[s], (uint32_t)((i / S) & 1));
      store_group<SCATTER>(f, out, ring + (size_t)s * f.slot_bytes, zero_slot, zmask[s],
                           g0 + i * gs);
      bulk_commit();
    }
  }
  if (lane == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// register path
// ---------------------------------------------------------------------------
struct U2 {
  uint16_t v;
};

template <typename V, bool SCATTER>
__global__ void __launch_bounds__(kRegThreads)
    patch_copy_reg(const char* __restrict__ src, const int* __restrict__ ids,
                   char* __restrict__ out, Config f) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int nvec = f.row_bytes / (int)sizeof(V);  // a unit is a whole row here
  // the grid's warps in turn: groups w, w + W, w + 2W, ... of warp w of W
  for (int g = blockIdx.x * warps + (threadIdx.x >> 5); g < f.groups; g += warps * gridDim.x) {
    const V* s[kRegUnits];
    V* d[kRegUnits];
#pragma unroll
    for (int q = 0; q < kRegUnits; ++q) {
      const int u = g * kRegUnits + q;
      s[q] = nullptr;
      d[q] = nullptr;
      if (u < f.units) {
        const Unit t = unit_of<SCATTER>(f, ids, u);
        d[q] = reinterpret_cast<V*>(out + t.dst);
        if (!t.zero) s[q] = reinterpret_cast<const V*>(src + t.src);
      }
    }
    for (int i = lane; i < nvec; i += 32) {
      V v[kRegUnits];
#pragma unroll
      for (int q = 0; q < kRegUnits; ++q) v[q] = s[q] ? s[q][i] : V{};
#pragma unroll
      for (int q = 0; q < kRegUnits; ++q)
        if (d[q]) d[q][i] = v[q];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % (uintptr_t)bytes == 0;
}

// The plan, checked against what the kernels assume.
bool plan_ok(const Config& f, bool scatter, const void* src, const void* out) {
  if (f.N < 0 || f.K < 0 || f.p < 1 || f.grid < 1 || f.row_bytes < 1) return false;
  const long long rows = (long long)f.N * (scatter ? f.grid * f.grid : f.K) * f.p;
  if (f.chunks < 1 || (long long)f.units != rows * f.chunks) return false;
  if (f.chunk_bytes < 1 || (long long)(f.chunks - 1) * f.chunk_bytes >= f.row_bytes ||
      (long long)f.chunks * f.chunk_bytes < f.row_bytes)
    return false;
  if (f.group < 1 || (long long)f.groups * f.group < f.units ||
      (f.groups > 0 && (long long)(f.groups - 1) * f.group >= f.units))
    return false;
  if (f.groups > 0 && f.blocks < 1) return false;
  if (f.bulk) {
    return f.vec == 16 && f.row_bytes % 16 == 0 && f.chunk_bytes % 16 == 0 && aligned(src, 16) &&
           aligned(out, 16) && f.slots >= 3 && f.slot_bytes % 128 == 0 &&
           f.group <= 32 && (f.chunks == 1 || f.group == 1) &&
           (long long)f.group * f.chunk_bytes <= f.slot_bytes &&
           (size_t)f.smem >= bulk_smem(f.slots, f.slot_bytes, scatter);
  }
  return (f.vec == 8 || f.vec == 4 || f.vec == 2) && f.row_bytes % f.vec == 0 &&
         aligned(src, f.vec) && aligned(out, f.vec) && f.chunks == 1 && f.group == kRegUnits;
}

template <bool SCATTER>
int launch(const void* src, const int* ids, void* out, const Config& f, cudaStream_t s) {
  if (!plan_ok(f, SCATTER, src, out)) return (int)cudaErrorInvalidValue;
  if (f.groups == 0) return 0;
  const char* a = static_cast<const char*>(src);
  char* o = static_cast<char*>(out);
  if (f.bulk) {
    patch_copy_bulk<SCATTER><<<f.blocks, kBulkThreads, f.smem, s>>>(a, ids, o, f);
  } else {
    switch (f.vec) {
      case 8: patch_copy_reg<uint2, SCATTER><<<f.blocks, kRegThreads, 0, s>>>(a, ids, o, f); break;
      case 4: patch_copy_reg<unsigned int, SCATTER><<<f.blocks, kRegThreads, 0, s>>>(a, ids, o, f); break;
      default: patch_copy_reg<U2, SCATTER><<<f.blocks, kRegThreads, 0, s>>>(a, ids, o, f); break;
    }
  }
  return (int)cudaGetLastError();
}

template <bool SCATTER>
const void* kernel_of(int bulk, int vec) {
  if (bulk) return (const void*)patch_copy_bulk<SCATTER>;
  switch (vec) {
    case 8: return (const void*)patch_copy_reg<uint2, SCATTER>;
    case 4: return (const void*)patch_copy_reg<unsigned int, SCATTER>;
    default: return (const void*)patch_copy_reg<U2, SCATTER>;
  }
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

template <bool SCATTER>
int entry(const void* src, const void* ids, void* out, const int* cfg, int device,
          void* stream) {
  OnDevice on(device);
  if (on.error() != cudaSuccess) return (int)on.error();
  return launch<SCATTER>(src, static_cast<const int*>(ids), out,
                         *reinterpret_cast<const Config*>(cfg), (cudaStream_t)stream);
}

}  // namespace

// cfg: the 16 ints of a CopyPlan and its geometry (Config above); device:
// the tensors' device, made current for the launch when it is not.
extern "C" int mm_gather_patches(const void* x, const void* kept_ids, void* out, const int* cfg,
                                 int device, void* stream) {
  return entry<false>(x, kept_ids, out, cfg, device, stream);
}

extern "C" int mm_scatter_patches(const void* xg, const void* inv_ids, void* out,
                                  const int* cfg, int device, void* stream) {
  return entry<true>(xg, inv_ids, out, cfg, device, stream);
}

// Blocks an SM of the kernel a plan runs (bulk or register path, vector
// bytes, dynamic shared memory) on the current device, after letting it
// take that much shared memory; a negative CUDA error on failure.
extern "C" int mm_patch_occupancy(int scatter, int bulk, int vec, int smem) {
  const void* k = scatter ? kernel_of<true>(bulk, vec) : kernel_of<false>(bulk, vec);
  const int threads = bulk ? kBulkThreads : kRegThreads;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return -(int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, (size_t)smem);
  return e != cudaSuccess ? -(int)e : blocks;
}

// Shared memory a block of the current device may opt in to (bytes).
extern "C" int mm_patch_smem_optin() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}
