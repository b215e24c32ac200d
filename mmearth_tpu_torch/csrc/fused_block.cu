// The spill-g block tail of the gathered encoder: LN -> Linear(C, 4C) -> erf
// GELU -> GRN (grouped L2 over the rows) -> Linear(4C, C) -> + residual, and
// its VJP, on (M, C) rows in bf16 (or f32) with f32 params.
//
// Replaces the Pallas kernels of mmearth_tpu/ops/fused_block.py:
//   spillg_fwd_a_kernel      <- _sg_fwd_a_kernel (:381, called at :538)
//   spillg_fwd_b_kernel      <- _sg_fwd_b_kernel (:411, called at :552)
//   spillg_bwd_c_kernel      <- _sg_bwd_c_kernel (:423, called at :580), with its
//                               dW2 sum (:448) where that fits (below)
//   bwd_dv_kernel<SpillRows> <- _sg_bwd_d_kernel (:463, called at :608), all but
//                               dW1
//   spillg_atb_kernel        <- the dW1 sum of _sg_bwd_d_kernel (:494), and C's
//                               dW2 sum where it does not fold: out += X^T Y
//                               over rows
//
// Numerics follow the Pallas kernels: every product takes operands rounded to
// the activation dtype and sums in f32 (_mm, fused_block.py:69-81), on the
// bf16 tensor cores (mma.sync m16n8k16) for bf16 and as plain f32 FMAs for
// f32; LN and GRN eps 1e-6; g is stored in the activation dtype and the GRN
// sum of squares is taken over the stored value (:397-404), and D reads the
// stored g; erf is erff (the Pallas kernel uses a polynomial with |error| <=
// 1.5e-7).
//
// Forward.  Each of A and B is one product of 2*M*C*4C flops against ~2-3
// bytes of (M, C) / (M, 4C) traffic per row element: bytes bound both at C =
// 40 (stage 0), products at C = 320.  A block owns BM rows of one GRN group
// and walks the 4C columns in tiles of 64 with its rows' C-wide operand
// resident in shared memory, the output columns split over blockIdx.y so that
// the stages with few rows still fill the card; g goes to device memory
// through shared memory, coalesced.  A takes the largest row tile (64 rows in
// bf16, 32 in f32, halved down to 16) whose shared memory fits (C <= 5992 in
// bf16, 3248 in f32); B fits every width JAX runs.  Phase A cannot finish the
// GRN statistic (it needs every block), so A and B are two launches and B
// takes sqrt and nx at its start.
//
// Backward.  C reads dy and g and writes dW2 (products dh and dW2), D reads
// t, dy and g and writes dt and dW1 (products v, dh, du and dW1): bytes bound
// both at stage 0 (C = 40), products at stage 3 (C = 320).  dW1 needs dv,
// which only the end of D's row pass has, so D stores dv and u (rounded to
// the product type, as _mm rounds them) and a second launch sums dv^T u: one
// (M, 4C) + (M, C) write and read more than the Pallas kernel, whose dW1
// accumulator stayed in VMEM.  The dgx step between C and D is (G, 4C)
// elementwise work left to the caller, as JAX leaves it to XLA; it needs the
// finished dnx of every block, so C and D are two launches.  The first design
// of both (a block a 64-row tile, every block re-staging the weights from L2
// for every 64-column tile of 4C, stage / barrier / a few mma.sync / barrier,
// LN and the dLN sums one row a warp, an atomicAdd per column sum and tile)
// ran 15-38x its bound.  Now:
//   D is the masked tail's dv pass (below) on a row source that walks every
//   row of each group in order: persistent blocks, weights resident at C = 40
//   and streamed through a cp.async ring elsewhere, LN over the whole tile at
//   once, column sums in shared memory until the block ends, 16 warps, the
//   wide plan past the rows that fit (huge's C = 2816).  It takes the stored
//   g (each thread fetches its fragment's values before the tile's
//   products, so the loads overlap them) and only gelu'(v) from v.
//   C: a block owns one 64-column slice of 4C and walks a contiguous range of
//   row tiles (several blocks a slice, so that every stage fills the card);
//   W2^T's slice is staged once, each tile's dy rows and g slice come by
//   cp.async while the tile before is computed, the column sums stay in
//   shared memory (dnx until the block's group changes), and dW2's (C x 64)
//   slice is summed in the mma accumulators over the block's tiles (dy^T h:
//   A from the staged dy rows by ldmatrix.trans, h^T from the epilogue) and
//   added once, one atomicAdd an element.  That fold holds where the slice
//   takes at most 5 m-tiles of 16 a warp (40 f32 a thread: bf16 C <= 320, f32
//   C <= 160, every atto width); past it dW2 is the X^T Y pass again, with h
//   computed from g as it is read, and past the rows that fit (bf16 C >~ 540)
//   C's dy rows and W2^T's slice stream by chunk through a ring.
//
// Cross-block sums: the TPU carried its accumulators from one grid step to
// the next.  Blocks run in no order here, so every column sum (sum g^2 per
// group, db1, db2, dgamma, dbeta, dnx, dLN) is reduced inside the block
// (warp shuffles, then shared memory) and added to its f32 output with one
// atomicAdd per column and block (the persistent passes: per block and
// group); dW1 (and dW2 where it does not fold) is split over rows and each
// block adds its 64 x 64 tile once.  The atomics make the order of those sums
// vary from run to run (f32 noise of ~1e-6 of their scale).  The callers zero
// every atomic output.
//
// The masked-dense tail (fused_block_mlp: the same block tail on every site
// of the dense grid, with y = x + keep * (...) and the GRN statistic over the
// kept sites) replaces the two recompute-based Pallas kernels of
// mmearth_tpu/ops/fused_block.py:
//   masked_fwd_rows_kernel   <- the dense grid of _fwd_kernel (:87, called at
//                               :263): the list of kept rows every pass walks
//   masked_fwd_stat_kernel   <- phase 0 of _fwd_kernel: sum (g * keep)^2 of
//                               the f32 g per GRN group
//   masked_fwd_apply_kernel  <- phase 1 of _fwd_kernel: recomputes v and g,
//                               h, o = h W2^T summed C-wide, y = x + (o + b2)
//                               * keep; y = x at masked rows
//   masked_bwd_stat_kernel   <- phase 0 of _bwd_kernel (:129, called at :302),
//                               all but dW2: stores do = dy * keep and h
//   spillg_atb_kernel<MASKED> <- its dW2 sum (:175), h^T do over kept rows
//   bwd_dv_kernel<KeptRows>  <- phase 1 of _bwd_kernel, all but dW1: D on do,
//                               with g = gelu(v) recomputed and the dgx term
//                               g * keep^2 * dgx/gx (:192); dt = 0 at masked
//                               rows
//   spillg_atb_kernel<MASKED> <- its dW1 sum (:194), dv^T u over kept rows
// As on the TPU, g is never stored: the statistic is taken over the f32 g
// before any rounding, and each pass recomputes LN -> W1 -> GELU (one more
// product per pass) instead of moving (M, 4C) values through device memory.
//
// What bounds it on the H100: the Pallas kernel's grid is dense, but only the
// kept sites (19 of 49 patches in pretraining, 39%) reach y, dt or a sum: a
// masked row gives y = x exactly, and do = 0, g * keep = 0 there, so it adds
// exactly 0 everywhere.  At the kept sites the forward moves t (kept), x and
// y (every row) against 2 products of 2*C*4C a site, the backward t and dy
// (kept) and dt (every row) against 5: stage 0 of atto (C = 40) is bound by
// bytes, the later stages by products.  From stage to stage the kept rows
// fall 4x and 4C grows 2x, so a pass holds 49.8 / 24.9 / 12.5 / 6.2 M kept
// (row, 4C) elements at stages 0-3, each with an erf GELU (two in the dv
// pass).
// The earlier design computed every site (2.58x the work), re-staged the
// weights through L2 for every 64-row block (more bytes than t, x and y at
// stage 0), and stalled on each 64 x 64 weight tile (stage, barrier, a few
// mma.sync, barrier).
//
// The design: the passes walk the kept-row list (below), so masked sites
// cost one copy (y) or one zero fill (dt) and nothing else; persistent
// blocks (as many as fit at once) walk its tiles, stage a tile's rows with
// every thread at once (one wait for device memory a tile) and keep their
// column sums in shared memory until the end; at C = 40 the weights are
// staged once per block (RES), elsewhere their 64 x 64 tiles stream through
// a cp.async ring S - 1 steps ahead of the products (RING), and past the
// resident rows (huge's C = 2816) the C-wide operands come by chunk (WIDE),
// with the statistic passes' 4C columns split over blockIdx.y so that the
// few row tiles of the last stages still fill the card.  The products stay
// on mma.sync m16n8k16 (bf16 in, f32 sums); wgmma is not used yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float LN_EPS = 1e-6f;
constexpr float GRN_EPS = 1e-6f;
constexpr int TN = 64;        // output columns per tile
constexpr int KC = 64;        // contraction chunk staged in shared memory
constexpr int LDC = KC + 8;   // padded row of a staged chunk

template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> { static constexpr int BM = 64; };  // rows per block
template <> struct Cfg<float> { static constexpr int BM = 32; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.39894228040143268f;
}
// gelu(v) and gelu_grad(v), the same values, from one erff.
__device__ __forceinline__ void gelu_both(float v, float& g, float& dg) {
  const float e = erff(v * 0.70710678118654752f);
  g = 0.5f * v * (1.f + e);
  dg = 0.5f * (1.f + e) + v * expf(-0.5f * v * v) * 0.39894228040143268f;
}

// h = gamma*(g*nx) + beta + g, rounded after each operation as the plain
// version's elementwise ops round (no FMA contraction), so that h rounds to
// the same product operand as there.
__device__ __forceinline__ float grn_h(float g, float nx, float gamma, float beta) {
  return __fadd_rn(__fadd_rn(__fmul_rn(gamma, __fmul_rn(g, nx)), beta), g);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[nt][*] += A[16 rows][0:kc] . B[nt*8 + n][0:kc] for this warp: A row-major
// (lda), B n-major with k contiguous (ldb), kc a multiple of 16.  The fragment
// element (nt, e) is row (lane/4) + 8*(e/2), column nt*8 + 2*(lane%4) + e%2.
template <typename T> struct WarpMM;

template <> struct WarpMM<__nv_bfloat16> {
  template <int NT>
  __device__ __forceinline__ static void run(const __nv_bfloat16* sA, int lda,
                                             const __nv_bfloat16* sB, int ldb, int kc,
                                             float (&acc)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    for (int k = 0; k < kc; k += 16) {
      const uint32_t a0 = ld32(sA + g * lda + k + 2 * t);
      const uint32_t a1 = ld32(sA + (g + 8) * lda + k + 2 * t);
      const uint32_t a2 = ld32(sA + g * lda + k + 2 * t + 8);
      const uint32_t a3 = ld32(sA + (g + 8) * lda + k + 2 * t + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* b = sB + (nt * 8 + g) * ldb + k + 2 * t;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
};

template <> struct WarpMM<float> {  // true f32 FMAs, same fragment layout
  template <int NT>
  __device__ __forceinline__ static void run(const float* sA, int lda, const float* sB, int ldb,
                                             int kc, float (&acc)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* a = sA + (g + (e >> 1) * 8) * lda;
        const float* b = sB + (nt * 8 + 2 * t + (e & 1)) * ldb;
        float s = acc[nt][e];
        for (int k = 0; k < kc; ++k) s = fmaf(a[k], b[k], s);
        acc[nt][e] = s;
      }
    }
  }
};

__device__ __forceinline__ int frag_row(int e) { return ((threadIdx.x & 31) >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int nt, int e) {
  return nt * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// Sum v over the block's rows for each of a tile's 64 columns and add column
// c to dst[c] for c < nvalid.  The block's warps are NW row-warps (warp w owns
// rows of w % NW) times column groups (warp w holds the NT n-tiles from
// column coloff).  red: NW * 64 floats.  Synchronises the block.
template <int NW, int NT = 8>
__device__ __forceinline__ void col_sum(const float (&v)[NT][4], float* red, float* dst,
                                        int nvalid, int coloff = 0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) % NW;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[nt][e] + v[nt][e + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[w * 64 + coloff + frag_col(nt, e)] = s;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 64; c += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < NW; ++i) s += red[i * 64 + c];
    if (c < nvalid) atomicAdd(dst + c, s);
  }
  __syncthreads();
}

// Staging takes 16-byte loads: every row length, column offset and width
// below is a multiple of 8 elements (C % 8 == 0, checked by the entry points)
// and every array is 16-byte aligned (checked by the Python wrappers).
constexpr int VEC_BYTES = 16;

// s[r][c] = src[r0 + r][c0 + c] for r < nr, c < kc; zero where r0 + r >= rmax
// or c0 + c >= cmax.  src is row-major with row length ld.  CG: src was
// written earlier in this launch by the same block, so it is read through L2
// (ld.global.cg), never through the read-only path.
template <typename T, bool CG = false>
__device__ __forceinline__ void stage(T* s, int lds, const T* __restrict__ src, int ld, int r0,
                                      int nr, int rmax, int c0, int kc, int cmax) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int kv = kc / V;
  for (int i = threadIdx.x; i < nr * kv; i += blockDim.x) {
    const int r = i / kv, c = (i - r * kv) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rmax && c0 + c < cmax) {
      const uint4* q = reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c0 + c);
      if constexpr (CG) v = __ldcg(q);
      else v = *q;
    }
    *reinterpret_cast<uint4*>(s + r * lds + c) = v;
  }
}

// Transposed: s[c][r] = f(r0 + r, c0 + c, src[r0 + r][c0 + c]) for r < nr, c < nc;
// zero where r0 + r >= rmax or c0 + c >= cmax.  Consecutive threads take
// consecutive rows, so the transposed shared-memory writes do not collide.
template <typename T, typename F>
__device__ __forceinline__ void stage_t(T* s, int lds, const T* __restrict__ src, int ld, int r0,
                                        int nr, int rmax, int c0, int nc, int cmax, F f) {
  constexpr int V = VEC_BYTES / sizeof(T);
  for (int i = threadIdx.x; i < nr * (nc / V); i += blockDim.x) {
    const int r = i % nr, c = (i / nr) * V;
    if (r0 + r < rmax && c0 + c < cmax) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * ld + c0 + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int q = 0; q < V; ++q)
        s[(c + q) * lds + r] = from_f<T>(f(r0 + r, c0 + c + q, to_f(e[q])));
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) s[(c + q) * lds + r] = from_f<T>(0.f);
    }
  }
}

// The block's rows: tile `tile` of group `grp`, nvalid of BM rows from row0.
struct Rows {
  int grp, tile, row0, nvalid;
};
template <int BM>
__device__ __forceinline__ Rows block_rows(int GR, int tpg) {
  Rows r;
  r.grp = blockIdx.x / tpg;
  r.tile = blockIdx.x - r.grp * tpg;
  r.row0 = r.grp * GR + r.tile * BM;
  r.nvalid = min(BM, GR - r.tile * BM);
  return r;
}

// LN of the block's rows into sU (activation dtype, zero in the padding)
// unless sU is null; keeps each row's mean and 1/std when the pointers are
// given and writes the rounded u to u_out when given.
template <typename T, int BM>
__device__ void layer_norm_rows(const T* __restrict__ t, const float* __restrict__ lnw,
                                const float* __restrict__ lnb, T* sU, int lda, int C, int Cp,
                                const Rows& rw, float* sMean, float* sRs, T* u_out) {
  const int NW = blockDim.x >> 5, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = w; r < BM; r += NW) {
    if (r >= rw.nvalid) {
      if (sU != nullptr)
        for (int c = lane; c < Cp; c += 32) sU[r * lda + c] = from_f<T>(0.f);
      continue;
    }
    const T* tr = t + (size_t)(rw.row0 + r) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(tr[c]);
    const float mean = warp_sum(s) / C;
    float q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(tr[c]) - mean;
      q += d * d;
    }
    const float rs = rsqrtf(warp_sum(q) / C + LN_EPS);
    if (sMean != nullptr && lane == 0) {
      sMean[r] = mean;
      sRs[r] = rs;
    }
    for (int c = lane; c < Cp; c += 32) {
      T u = from_f<T>(0.f);
      if (c < C) {
        u = from_f<T>((to_f(tr[c]) - mean) * rs * lnw[c] + lnb[c]);
        if (u_out != nullptr) u_out[(size_t)(rw.row0 + r) * C + c] = u;
      }
      if (sU != nullptr) sU[r * lda + c] = u;
    }
  }
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// ---------------------------------------------------------------------------
// A: g = gelu(LN(t) W1^T + b1) stored in T; gxsq[grp] += sum over rows of g^2.
// ---------------------------------------------------------------------------
template <typename T, int BM>
__global__ void __launch_bounds__(BM * 2)
spillg_fwd_a_kernel(const T* __restrict__ t, const float* __restrict__ lnw,
                    const float* __restrict__ lnb, const T* __restrict__ w1,
                    const float* __restrict__ b1, T* __restrict__ g, float* __restrict__ gxsq,
                    int C, int C4, int GR, int tpg) {
  constexpr int NW = BM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15, lda = Cp + 8;
  T* sU = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + align16(sizeof(T) * BM * lda));
  T* sG = sB + TN * LDC;
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sG) +
                                        align16(sizeof(T) * BM * LDC));
  const int w = threadIdx.x >> 5;
  const Rows rw = block_rows<BM>(GR, tpg);
  layer_norm_rows<T, BM>(t, lnw, lnb, sU, lda, C, Cp, rw, nullptr, nullptr, nullptr);

  for (int j0 = blockIdx.y * TN; j0 < C4; j0 += gridDim.y * TN) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < Cp; k0 += KC) {
      const int kc = min(KC, Cp - k0);
      __syncthreads();
      stage(sB, LDC, w1, C, j0, TN, C4, k0, kc, C);
      __syncthreads();
      WarpMM<T>::run(sU + w * 16 * lda + k0, lda, sB, LDC, kc, acc);
    }
    float sq[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), j = j0 + frag_col(nt, e);
        float gv = 0.f;
        if (r < rw.nvalid && j < C4) gv = to_f(from_f<T>(gelu(acc[nt][e] + b1[j])));
        sG[r * LDC + j - j0] = from_f<T>(gv);
        sq[nt][e] = gv * gv;
      }
    }
    col_sum<NW>(sq, red, gxsq + (size_t)rw.grp * C4 + j0, C4 - j0);  // also publishes sG
    for (int i = threadIdx.x; i < BM * TN; i += blockDim.x) {  // coalesced store of g
      const int r = i / TN, jc = i - r * TN;
      if (r < rw.nvalid && j0 + jc < C4)
        g[(size_t)(rw.row0 + r) * C4 + j0 + jc] = sG[r * LDC + jc];
    }
  }
}

// ---------------------------------------------------------------------------
// B: gx = sqrt(gxsq), nx = gx / (mean gx + eps); h = gamma*(g*nx) + beta + g;
//    y = x + (h W2^T + b2).  Tile 0 of each group writes gx and nx.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::BM * 2)
spillg_fwd_b_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const float* __restrict__ gxsq, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ y, float* __restrict__ gx_out,
                    float* __restrict__ nx_out, int C, int C4, int GR, int tpg) {
  constexpr int BM = Cfg<T>::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sNX = reinterpret_cast<float*>(smem);
  float* red = sNX + C4;
  T* sH = reinterpret_cast<T*>(smem + align16(sizeof(float) * (C4 + 32)));
  T* sB = sH + BM * LDC;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const Rows rw = block_rows<BM>(GR, tpg);

  float part = 0.f;
  for (int j = threadIdx.x; j < C4; j += blockDim.x) {
    const float v = sqrtf(gxsq[(size_t)rw.grp * C4 + j]);
    sNX[j] = v;
    part += v;
  }
  part = warp_sum(part);
  if (lane == 0) red[w] = part;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < BM / 16; ++i) total += red[i];
  const float denom = total / C4 + GRN_EPS;
  for (int j = threadIdx.x; j < C4; j += blockDim.x) {
    const float gxv = sNX[j], nxv = gxv / denom;
    if (rw.tile == 0 && blockIdx.y == 0) {
      gx_out[(size_t)rw.grp * C4 + j] = gxv;
      nx_out[(size_t)rw.grp * C4 + j] = nxv;
    }
    sNX[j] = nxv;
  }

  for (int c0 = blockIdx.y * TN; c0 < C; c0 += gridDim.y * TN) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < C4; k0 += KC) {
      const int kc = min(KC, C4 - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < BM * kc; i += blockDim.x) {
        const int r = i / kc, c = i - r * kc, j = k0 + c;
        float v = 0.f;
        if (r < rw.nvalid) {
          const float gv = to_f(g[(size_t)(rw.row0 + r) * C4 + j]);
          v = grn_h(gv, sNX[j], gamma[j], beta[j]);
        }
        sH[r * LDC + c] = from_f<T>(v);
      }
      stage(sB, LDC, w2, C4, c0, TN, C, k0, kc, C4);
      __syncthreads();
      WarpMM<T>::run(sH + w * 16 * LDC, LDC, sB, LDC, kc, acc);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), c = c0 + frag_col(nt, e);
        if (r < rw.nvalid && c < C) {
          const size_t o = (size_t)(rw.row0 + r) * C + c;
          y[o] = from_f<T>(to_f(x[o]) + (acc[nt][e] + b2[c]));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The masked-dense tail (rows 5-6 of the kernel table).  Only kept sites
// (keep != 0) reach y, dt or any sum, so every pass works on a list of them:
//
// masked_fwd_rows_kernel cuts each GRN group into chunks of CHUNK rows and
// writes, for chunk q, its kept rows (ascending) then its masked rows into
// the chunk's own slots of ids (slot p of chunk q lies in q's row range) and
// the number kept into cnt[q].  The row passes walk "virtual tiles" of BM
// slots of a chunk, the same count for every chunk, tile i of every chunk
// before tile i + 1 of any (so that the kept tiles, which come first in each
// chunk, spread evenly over the blocks), with persistent blocks:
// a tile's kept slots are computed, its masked slots only filled (y = x in
// the apply pass, dt = 0 in the dv pass), and a tile past its chunk is
// skipped after one load of cnt.  A tile's rows lie in one group, so its
// column sums still go to one group's row.  The stored operands of the
// weight-gradient passes (do, h, dv, u) are written at the slots, and the
// X^T Y pass sums each chunk's kept slots only.
//
// Weights: RES stages W1 (and W2, W2^T, W1^T) whole in shared memory once
// per block with 16-byte cp.async, where that fits twice on an SM (every
// pass at atto's C = 40, the forward statistic at C = 80); RING streams the
// 64 x 64 weight tiles through a ring of S slots filled by cp.async S - 1
// steps ahead of their use, so that a tile's copy overlaps the products of
// the tiles before it, with one block barrier a step; WIDE (rows whose
// C-wide operands do not fit) is RING with u (and do) computed chunk by
// chunk from t (dy) into shared memory and the C-wide f32 accumulator (o,
// du) in the block's slice of a device-memory scratch.  A block keeps its
// column sums in shared memory and adds them to device memory once (per
// group), not once a tile.
// ---------------------------------------------------------------------------
constexpr int CHUNK = 4096;        // rows of a chunk of the kept-row list
constexpr int ROWS_THREADS = 512;  // threads of masked_fwd_rows_kernel, 8 rows each
enum Mode { RES = 0, RING = 1, WIDE = 2 };
enum Kind { K_STAT = 0, K_APPLY = 1, K_BSTAT = 2, K_DV = 3, K_SC = 4, K_SD = 5 };  // SC, SD: spill-g C, D
// Every masked row pass: BM/16 row-warps times COLW warps across a 64-column
// tile (CNT = 8 / COLW n-tiles of 8 each), so 2 * COLW * BM threads.
constexpr int COLW = 4, CNT = 8 / COLW;

template <typename T>
__host__ __device__ constexpr int ring_slots(int kind) {  // the backward passes hold the most
  return sizeof(T) == 2 && (kind == K_STAT || kind == K_APPLY) ? 3 : 2;
}
__host__ __device__ constexpr int pad64(int n) { return (n + 63) & ~63; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global src to shared dst, or 16 zero bytes where !ok (src is
// then not read).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// s[r][c] = src[r0 + r][c0 + c] for r < 64, c < kc (s padded to LDC), zero
// where r0 + r >= rmax or c0 + c >= cmax, by cp.async; a thread keeps one
// 16-byte column of the tile, so no copy takes a division.
template <typename T>
__device__ __forceinline__ void tile_async(T* s, const T* __restrict__ src, int ld, int r0,
                                           int rmax, int c0, int kc, int cmax) {
  constexpr int V = VEC_BYTES / sizeof(T), PR = TN / V;  // 16-byte pieces a row
  const int c = (threadIdx.x % PR) * V;
  if (c >= kc) return;
  const bool cok = c0 + c < cmax;
  for (int r = threadIdx.x / PR; r < TN; r += blockDim.x / PR) {
    const bool ok = cok && r0 + r < rmax;
    cp16(s + r * LDC + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// s[r][c] = src[r][c] (rows x cols, contiguous) for r < rows_pad, c < cp
// (row pitch lds), zero past rows or cols; by cp.async, once per block.
template <typename T>
__device__ void matrix_async(T* s, int lds, const T* __restrict__ src, int rows, int rows_pad,
                             int cols, int cp) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int pv = cp / V;
  for (int i = threadIdx.x; i < rows_pad * pv; i += blockDim.x) {
    const int r = i / pv, c = (i - r * pv) * V;
    const bool ok = r < rows && c < cols;
    cp16(s + r * lds + c, ok ? src + (size_t)r * cols + c : src, ok);
  }
}

// The kept-row list and its virtual tiles, or (ids and cnt null: spill-g's
// D) every row of each group in order, one chunk a group.
struct Walk {
  const int* ids;
  const int* cnt;
  int GR, ncg, tpc, nvt;  // rows a group, chunks a group, tiles a chunk, tiles
};
struct Tile {
  int grp, p0, nk, nf;  // slots [p0, p0 + nk) kept, the next nf masked
  bool first;           // the group's first tile
};
// SPILL: the spill-g walk, its chunk the group and every row kept (a
// template argument, so that the masked passes' code has no branch on it).
template <int BM, bool SPILL = false>
__device__ __forceinline__ Tile tile_of(const Walk& w, int v) {
  const int nq = w.nvt / w.tpc, i = v / nq, q = v - i * nq;  // chunk-minor: kept tiles first
  const int grp = q / w.ncg, k = q - grp * w.ncg, chunk = SPILL ? w.GR : CHUNK;
  const int len = min(chunk, w.GR - k * chunk), ke = SPILL ? len : __ldg(w.cnt + q);
  const int a = i * BM, b = min(len, a + BM);
  Tile t;
  t.grp = grp;
  t.p0 = grp * w.GR + k * chunk + a;
  t.nk = max(0, min(b, ke) - a);
  t.nf = max(0, b - max(a, ke));
  t.first = k == 0 && i == 0;
  return t;
}

// Chunk q of the list: its kept rows, ascending, then its masked ones.
template <typename T>
__global__ void __launch_bounds__(ROWS_THREADS)
masked_fwd_rows_kernel(const T* __restrict__ keep, int* __restrict__ ids, int* __restrict__ cnt,
                   int GR, int ncg) {
  constexpr int RPT = CHUNK / ROWS_THREADS, NWR = ROWS_THREADS / 32;
  __shared__ int warp_tot[NWR];
  const int q = blockIdx.x, grp = q / ncg, k = q - grp * ncg;
  const int qs = grp * GR + k * CHUNK, len = min(CHUNK, GR - k * CHUNK);
  const int r0 = threadIdx.x * RPT, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < RPT; ++e)
    if (r0 + e < len && to_f(keep[qs + r0 + e]) != 0.f) bits |= 1u << e;
  const int mine = __popc(bits);
  int inc = mine;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_tot[w] = inc;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < NWR; ++i) {
    before += i < w ? warp_tot[i] : 0;
    total += warp_tot[i];
  }
  int kp = before + inc - mine;  // kept rows of the chunk before this thread's
  int mp = total + r0 - kp;      // masked slots start after every kept one
  for (int e = 0; e < RPT && r0 + e < len; ++e) {
    if (bits >> e & 1u) ids[qs + kp++] = qs + r0 + e;
    else ids[qs + mp++] = qs + r0 + e;
  }
  if (threadIdx.x == 0) cnt[q] = total;
}

// dst[r][c] = s[r][c] for r < n, c < C (row pitches ldd, lds; C a multiple
// of 8), 16 bytes a copy.
template <typename T>
__device__ __forceinline__ void copy_rows(T* __restrict__ dst, int ldd, const T* s, int lds,
                                          int n, int C) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int cv = C / V;
  for (int i = threadIdx.x; i < n * cv; i += blockDim.x) {
    const int r = i / cv, c = (i - r * cv) * V;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) =
        *reinterpret_cast<const uint4*>(s + r * lds + c);
  }
}

// The sum of v over each group of L lanes (L a power of two), in every lane.
__device__ __forceinline__ float lane_sum(float v, int L) {
  for (int o = L >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row of slot p: ids[p] on the kept-row list, p itself on the spill-g walk.
template <bool SPILL> __device__ __forceinline__ int row_at(const int* __restrict__ ids, int p) {
  return SPILL ? p : ids[p];
}

// s[r][c] = src[row of slot p0 + r][c] for r < nk, c < C, zero in the
// padding up to Cp and in the rows past nk (row pitch lds), every thread
// loading 16 bytes at a time, so that a tile waits for device memory once.
template <typename T, int BM, bool SPILL = false>
__device__ void gather_rows(T* s, int lds, const T* __restrict__ src, const int* __restrict__ ids,
                            int p0, int nk, int C, int Cp) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int pv = Cp / V;
  for (int i = threadIdx.x; i < BM * pv; i += blockDim.x) {
    const int r = i / pv, c = (i - r * pv) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nk && c < C)
      v = *reinterpret_cast<const uint4*>(src + (size_t)row_at<SPILL>(ids, p0 + r) * C + c);
    *reinterpret_cast<uint4*>(s + r * lds + c) = v;
  }
}

// LN of the tile's kept rows (every row on the spill-g walk, keep 1): keeps
// each row's mean, 1/std, keep and id in shared memory and writes the
// rounded u at the row's slot of u_out when given.  With sU, every thread
// first gathers the raw rows into sU with 16-byte loads (zero in the padding
// and past nk), so that a tile waits for device memory once, and each row is
// normalised in place from shared memory; with sU null (WIDE) each warp
// reads its rows from t.  Syncs the block.
template <typename T, int BM, bool SPILL = false>
__device__ void ln_tile(const T* __restrict__ t, const T* __restrict__ keep, const int* __restrict__ ids,
                        const Tile& tl, const float* __restrict__ lnw,
                        const float* __restrict__ lnb, T* sU, int lda, int C, int Cp,
                        float* sMean, float* sRs, float* sKeep, int* sId, T* u_out) {
  const int nwt = blockDim.x >> 5, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int r = threadIdx.x; r < tl.nk; r += blockDim.x) {
    const int id = row_at<SPILL>(ids, tl.p0 + r);
    sId[r] = id;
    sKeep[r] = SPILL ? 1.f : to_f(keep[id]);
  }
  if (sU != nullptr) gather_rows<T, BM, SPILL>(sU, lda, t, ids, tl.p0, tl.nk, C, Cp);
  __syncthreads();
  // L lanes a row, 32 / L rows a warp at a time (narrow rows take fewer lanes)
  const int L = C <= 64 ? 8 : C <= 256 ? 16 : 32, sub = lane % L;
  for (int r0 = w * (32 / L); r0 < tl.nk; r0 += nwt * (32 / L)) {
    const int r = r0 + lane / L;
    const bool ok = r < tl.nk;
    const T* tr = sU != nullptr ? sU + r * lda : t + (size_t)(ok ? sId[r] : 0) * C;
    float s = 0.f;
    if (ok)
      for (int c = sub; c < C; c += L) s += to_f(tr[c]);
    const float mean = lane_sum(s, L) / C;
    float q = 0.f;
    if (ok)
      for (int c = sub; c < C; c += L) {
        const float d = to_f(tr[c]) - mean;
        q += d * d;
      }
    const float rs = rsqrtf(lane_sum(q, L) / C + LN_EPS);
    if (!ok) continue;
    if (sub == 0) {
      sMean[r] = mean;
      sRs[r] = rs;
    }
    for (int c = sub; c < C; c += L) {
      const T u = from_f<T>((to_f(tr[c]) - mean) * rs * lnw[c] + lnb[c]);
      if (sU != nullptr) sU[r * lda + c] = u;  // in place: this lane read it last
      else if (u_out != nullptr) u_out[(size_t)(tl.p0 + r) * C + c] = u;
    }
  }
  if (sU != nullptr && u_out != nullptr) {  // the rounded u at the slots, 16 bytes a store
    __syncthreads();
    copy_rows(u_out + (size_t)tl.p0 * C, C, sU, lda, tl.nk, C);
  }
}

// WIDE: s[r][c] = u of the tile's row r at column k0 + c (c < kc), from t
// and the row's LN statistics, the value ln_tile gives; zero past nk or C.
// 16 bytes of t a load.
template <typename T, int BM>
__device__ void u_chunk(T* s, const T* __restrict__ t, const float* sMean, const float* sRs,
                        const int* sId, const float* __restrict__ lnw,
                        const float* __restrict__ lnb, int nk, int C, int k0, int kc) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int pv = kc / V;
  for (int i = threadIdx.x; i < BM * pv; i += blockDim.x) {
    const int r = i / pv, c = (i - r * pv) * V, k = k0 + c;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < nk && k < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(t + (size_t)sId[r] * C + k);
      const T* e = reinterpret_cast<const T*>(&raw);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int q = 0; q < V; ++q)
        o[q] = from_f<T>((to_f(e[q]) - sMean[r]) * sRs[r] * lnw[k + q] + lnb[k + q]);
    }
    *reinterpret_cast<uint4*>(s + r * LDC + c) = out;
  }
}

// s[r][c] = do = dy * keep of the tile's row r at column k0 + c, rounded to
// T (c < kc, row pitch lds; zero past nk or C) unless s is null; with
// do_out, also stored at the row's slot (columns < C only).  16 bytes of dy
// a load.
template <typename T, int BM>
__device__ void do_rows(T* s, int lds, T* do_out, const T* __restrict__ dy, const float* sKeep,
                        const int* sId, int p0, int nk, int C, int k0, int kc) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int pv = kc / V;
  for (int i = threadIdx.x; i < BM * pv; i += blockDim.x) {
    const int r = i / pv, c = (i - r * pv) * V, k = k0 + c;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < nk && k < C) {
      const uint4 raw = *reinterpret_cast<const uint4*>(dy + (size_t)sId[r] * C + k);
      const T* e = reinterpret_cast<const T*>(&raw);
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int q = 0; q < V; ++q) o[q] = from_f<T>(to_f(e[q]) * sKeep[r]);
      if (do_out != nullptr) *reinterpret_cast<uint4*>(do_out + (size_t)(p0 + r) * C + k) = out;
    }
    if (s != nullptr) *reinterpret_cast<uint4*>(s + r * lds + c) = out;
  }
}

// dst[row] = src[row] (or 0 with src null) at the tile's masked slots.
template <typename T>
__device__ void fill_rows(T* __restrict__ dst, const T* __restrict__ src,
                          const int* __restrict__ ids, int p0, int n, int C) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int cv = C / V;
  for (int i = threadIdx.x; i < n * cv; i += blockDim.x) {
    const int r = i / cv;
    const size_t o = (size_t)ids[p0 + r] * C + (i - r * cv) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + o);
    *reinterpret_cast<uint4*>(dst + o) = v;
  }
}

// Row pitch of the C-wide f32 accumulators (o, du): 4 past Cp, so that the
// 8 rows of an mma fragment fall on distinct banks.
__host__ __device__ constexpr int acc_pitch(int Cp) { return Cp + 4; }

// acc[r][c] += v by the one warp that owns (r, c): in shared memory, or
// (WIDE) as a fire-and-forget atomic on the block's slice of device memory,
// read back with __ldcg after a fence and a block barrier.
template <int MODE> __device__ __forceinline__ void acc_add(float* p, float v) {
  if constexpr (MODE == WIDE) atomicAdd(p, v);
  else *p += v;
}
template <int MODE> __device__ __forceinline__ float acc_get(const float* p) {
  if constexpr (MODE == WIDE) return __ldcg(p);
  else return *p;
}

// acc[c] += the sum of v over the warp's 16 rows, for its columns c =
// coloff + frag_col(nt, e) < nvalid, by atomicAdd: acc is the block's
// column sums in shared memory (added to device memory once, by flush_sums)
// or, in the WIDE plans, whose blocks take one or two tiles, the output in
// device memory itself.  No block barrier.
template <int NT>
__device__ __forceinline__ void col_acc(const float (&v)[NT][4], float* acc, int nvalid,
                                        int coloff) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[nt][e] + v[nt][e + 2];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int c = coloff + frag_col(nt, e);
      if (lane < 4 && c < nvalid) atomicAdd(acc + c, s);
    }
  }
}

// dst[j] += acc[j] for j < n (one device-memory atomic a column and block),
// and acc back to 0.  Syncs the block.
__device__ void flush_sums(float* acc, float* __restrict__ dst, int n) {
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    if (acc[j] != 0.f) atomicAdd(dst + j, acc[j]);
    acc[j] = 0.f;
  }
  __syncthreads();
}

// Shared-memory carving, the same on the host (sizes) and in the kernels.
struct Carve {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t o = off;
    off += align16(bytes);
    return o;
  }
};

// One step of the ring: wait for step si's tiles, let every thread pass
// (the step before is consumed), start step si + S - 1.  Returns the slot.
template <typename T, int S, typename F>
__device__ __forceinline__ T* ring_step(T* ring, int ntl, int si, F fetch) {
  cp_wait<S - 2>();
  __syncthreads();
  fetch(si + S - 1);
  cp_commit();
  return ring + (size_t)(si % S) * ntl * TN * LDC;
}

// ---------------------------------------------------------------------------
// Statistic pass of the forward (phase 0 of _fwd_kernel): gxsq[grp] += sum of
// (g * keep)^2 of the f32 g = gelu(LN(t) W1^T + b1) over the kept rows; the
// 4C column tiles are split over blockIdx.y.
// ---------------------------------------------------------------------------
template <typename T, int BM, int MODE>
__host__ __device__ size_t stat_smem(int C) {
  Carve c;
  const int Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  c.take(sizeof(T) * BM * lda);
  c.take(MODE == RES ? sizeof(T) * pad64(4 * C) * (Cp + 8)
                     : sizeof(T) * ring_slots<T>(K_STAT) * TN * LDC);
  c.take(4 * sizeof(float) * BM);
  c.take(MODE == WIDE ? 0 : sizeof(float) * 4 * C);
  return c.off;
}

template <typename T, int BM, int MODE>
__global__ void __launch_bounds__(BM * 2 * COLW)
masked_fwd_stat_kernel(const T* __restrict__ t, const T* __restrict__ keep, Walk wk,
                       const float* __restrict__ lnw, const float* __restrict__ lnb,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       float* __restrict__ gxsq, int C) {
  constexpr int NW = BM / 16, S = ring_slots<T>(K_STAT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = 4 * C, Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  const int nj = (C4 + TN - 1) / TN, nk = (Cp + KC - 1) / KC;
  const int njl = (nj - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  Carve cv;
  T* sU = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sW = reinterpret_cast<T*>(smem + cv.take(MODE == RES ? sizeof(T) * pad64(C4) * (Cp + 8)
                                                         : sizeof(T) * S * TN * LDC));
  float* sMean = reinterpret_cast<float*>(smem + cv.take(4 * sizeof(float) * BM));
  float* sRs = sMean + BM;
  float* sKeep = sRs + BM;
  int* sId = reinterpret_cast<int*>(sKeep + BM);
  float* sAcc = reinterpret_cast<float*>(smem + cv.take(MODE == WIDE ? 0 : sizeof(float) * C4));
  const int wt = threadIdx.x >> 5, w = wt % NW, col = (wt / NW) * CNT * 8;
  if constexpr (MODE != WIDE)  // the sum of squares of the block's current group
    for (int j = threadIdx.x; j < C4; j += blockDim.x) sAcc[j] = 0.f;

  auto fetch = [&](int i) {  // step i: W1 tile (column tile jt, contraction chunk kt)
    const int l = i % (njl * nk), jt = blockIdx.y + (l / nk) * gridDim.y, kt = l % nk;
    tile_async(sW + (size_t)(i % S) * TN * LDC, w1, C, jt * TN, C4, kt * KC,
               min(KC, Cp - kt * KC), C);
  };
  if constexpr (MODE == RES) {
    matrix_async(sW, Cp + 8, w1, C4, pad64(C4), C, Cp);
    cp_commit();
  } else {
    for (int i = 0; i < S - 1; ++i) {
      fetch(i);
      cp_commit();
    }
  }
  int si = 0, cur = -1;
  for (int v = blockIdx.x; v < wk.nvt; v += gridDim.x) {
    const Tile tl = tile_of<BM>(wk, v);
    if (tl.nk == 0) continue;
    if (MODE != WIDE && tl.grp != cur && cur >= 0) flush_sums(sAcc, gxsq + (size_t)cur * C4, C4);
    cur = tl.grp;
    __syncthreads();  // the tile before is consumed
    ln_tile<T, BM>(t, keep, wk.ids, tl, lnw, lnb, MODE == WIDE ? nullptr : sU, lda, C, Cp,
                   sMean, sRs, sKeep, sId, nullptr);
    if constexpr (MODE == RES) {
      cp_wait<0>();
      __syncthreads();
    }
    float* sums = MODE == WIDE ? gxsq + (size_t)tl.grp * C4 : sAcc;
    for (int jj = 0; jj < njl; ++jj) {
      const int j0 = (blockIdx.y + jj * gridDim.y) * TN;
      float acc[CNT][4] = {};
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * KC, kc = min(KC, Cp - k0);
        const T* B;
        int ldb;
        if constexpr (MODE == RES) {
          B = sW + (size_t)j0 * (Cp + 8) + k0;
          ldb = Cp + 8;
        } else {
          B = ring_step<T, S>(sW, 1, si++, fetch);
          ldb = LDC;
          if constexpr (MODE == WIDE) {
            u_chunk<T, BM>(sU, t, sMean, sRs, sId, lnw, lnb, tl.nk, C, k0, kc);
            __syncthreads();
          }
        }
        WarpMM<T>::run(sU + w * 16 * lda + (MODE == WIDE ? 0 : k0), lda, B + col * ldb, ldb, kc,
                       acc);
      }
      float sq[CNT][4];
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), j = j0 + col + frag_col(nt, e);
          float gk = 0.f;
          if (r < tl.nk && j < C4) gk = gelu(acc[nt][e] + b1[j]) * sKeep[r];
          sq[nt][e] = gk * gk;
        }
      }
      col_acc(sq, sums + j0, C4 - j0, col);
    }
  }
  if (MODE != WIDE && cur >= 0) flush_sums(sAcc, gxsq + (size_t)cur * C4, C4);
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Apply pass of the forward (phase 1 of _fwd_kernel): gx = sqrt(gxsq), nx;
// per 64-column tile of 4C, v = LN(t) W1^T + b1 is recomputed, h = gamma*(g*nx)
// + beta + g of the f32 g = gelu(v) is rounded to T in shared memory, and o +=
// h W2^T is summed in f32 (C wide: shared memory, WIDE: the block's slice of
// wide_acc); then y = x + (o + b2) * keep at kept rows, y = x at masked ones.
// A group's first tile writes its gx and nx.  D's warp layout (BM/16
// row-warps x two 32-column halves).
// ---------------------------------------------------------------------------
template <typename T, int BM, int MODE>
__host__ __device__ size_t apply_smem(int C) {
  Carve c;
  const int Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8, C4 = 4 * C;
  c.take(sizeof(T) * BM * lda);
  c.take(MODE == RES ? sizeof(T) * ((size_t)pad64(C4) * (Cp + 8) + (size_t)pad64(C) * (C4 + 8))
                     : sizeof(T) * ring_slots<T>(K_APPLY) * TN * LDC);
  c.take(sizeof(T) * BM * LDC);
  c.take(MODE == WIDE ? 0 : sizeof(float) * BM * acc_pitch(Cp));
  c.take(sizeof(float) * C4);
  c.take(4 * sizeof(float) * BM);
  c.take(sizeof(float) * 32);
  return c.off;
}

template <typename T, int BM, int MODE>
__global__ void __launch_bounds__(BM * 2 * COLW)
masked_fwd_apply_kernel(const T* __restrict__ t, const T* __restrict__ x, const T* __restrict__ keep,
                    Walk wk, const float* __restrict__ gxsq, const float* __restrict__ lnw,
                    const float* __restrict__ lnb, const T* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ w2,
                    const float* __restrict__ b2, T* __restrict__ y, float* __restrict__ gx_out,
                    float* __restrict__ nx_out, float* wide_acc, int C) {
  constexpr int NW = BM / 16, S = ring_slots<T>(K_APPLY);
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = 4 * C, Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  const int nj = (C4 + TN - 1) / TN, nk = (Cp + KC - 1) / KC, nc = (C + TN - 1) / TN;
  const int ldw1 = Cp + 8, ldw2 = C4 + 8;
  Carve cv;
  T* sU = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sW = reinterpret_cast<T*>(
      smem + cv.take(MODE == RES ? sizeof(T) * ((size_t)pad64(C4) * ldw1 + (size_t)pad64(C) * ldw2)
                                 : sizeof(T) * S * TN * LDC));
  T* sW2 = sW + (size_t)pad64(C4) * ldw1;  // RES only
  T* sH = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * LDC));
  const int ldo = acc_pitch(Cp);
  float* sO = reinterpret_cast<float*>(smem + cv.take(MODE == WIDE ? 0 : sizeof(float) * BM * ldo));
  if constexpr (MODE == WIDE) sO = wide_acc + (size_t)blockIdx.x * BM * ldo;
  float* sNX = reinterpret_cast<float*>(smem + cv.take(sizeof(float) * C4));
  float* sMean = reinterpret_cast<float*>(smem + cv.take(4 * sizeof(float) * BM));
  float* sRs = sMean + BM;
  float* sKeep = sRs + BM;
  int* sId = reinterpret_cast<int*>(sKeep + BM);
  float* red = reinterpret_cast<float*>(smem + cv.take(sizeof(float) * 32));
  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5, nwt = blockDim.x >> 5;
  const int w = wt % NW, col = (wt / NW) * CNT * 8;

  auto fetch = [&](int i) {  // step i: a W1 tile (jt, kt), then the W2 tiles (ct, jt)
    const int l = i % (nj * (nk + nc)), jt = l / (nk + nc), r = l - jt * (nk + nc);
    T* slot = sW + (size_t)(i % S) * TN * LDC;
    if (r < nk) tile_async(slot, w1, C, jt * TN, C4, r * KC, min(KC, Cp - r * KC), C);
    else tile_async(slot, w2, C4, (r - nk) * TN, C, jt * TN, min(KC, C4 - jt * TN), C4);
  };
  if constexpr (MODE == RES) {
    matrix_async(sW, ldw1, w1, C4, pad64(C4), C, Cp);
    matrix_async(sW2, ldw2, w2, C, pad64(C), C4, C4);
    cp_commit();
  } else {
    for (int i = 0; i < S - 1; ++i) {
      fetch(i);
      cp_commit();
    }
  }
  int si = 0, cur = -1;
  for (int v = blockIdx.x; v < wk.nvt; v += gridDim.x) {
    const Tile tl = tile_of<BM>(wk, v);
    if (tl.nk + tl.nf == 0) continue;
    fill_rows(y, x, wk.ids, tl.p0 + tl.nk, tl.nf, C);
    if (tl.nk == 0 && !tl.first) continue;
    __syncthreads();  // the tile before is consumed
    if (tl.grp != cur || tl.first) {  // the GRN statistic of the tile's group
      float part = 0.f;
      for (int j = threadIdx.x; j < C4; j += blockDim.x) {
        const float gv = sqrtf(gxsq[(size_t)tl.grp * C4 + j]);
        sNX[j] = gv;
        part += gv;
      }
      part = warp_sum(part);
      if (lane == 0) red[wt] = part;
      __syncthreads();
      float total = 0.f;
      for (int i = 0; i < nwt; ++i) total += red[i];
      const float denom = total / C4 + GRN_EPS;
      for (int j = threadIdx.x; j < C4; j += blockDim.x) {
        const float gxv = sNX[j], nxv = gxv / denom;
        if (tl.first) {
          gx_out[(size_t)tl.grp * C4 + j] = gxv;
          nx_out[(size_t)tl.grp * C4 + j] = nxv;
        }
        sNX[j] = nxv;
      }
      cur = tl.grp;
      __syncthreads();  // red is read before the next group rewrites it
    }
    if (tl.nk == 0) continue;
    ln_tile<T, BM>(t, keep, wk.ids, tl, lnw, lnb, MODE == WIDE ? nullptr : sU, lda, C, Cp,
                   sMean, sRs, sKeep, sId, nullptr);
    for (int i = threadIdx.x; i < BM * ldo; i += blockDim.x) sO[i] = 0.f;
    if constexpr (MODE == RES) {
      cp_wait<0>();
      __syncthreads();
    }
    for (int jt = 0; jt < nj; ++jt) {
      const int j0 = jt * TN;
      float av[CNT][4] = {};
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * KC, kc = min(KC, Cp - k0);
        const T* B;
        int ldb;
        if constexpr (MODE == RES) {
          B = sW + (size_t)j0 * ldw1 + k0;
          ldb = ldw1;
        } else {
          B = ring_step<T, S>(sW, 1, si++, fetch);
          ldb = LDC;
          if constexpr (MODE == WIDE) {
            u_chunk<T, BM>(sU, t, sMean, sRs, sId, lnw, lnb, tl.nk, C, k0, kc);
            __syncthreads();
          }
        }
        WarpMM<T>::run(sU + w * 16 * lda + (MODE == WIDE ? 0 : k0), lda, B + col * ldb, ldb, kc,
                       av);
      }
      if constexpr (MODE == RES) __syncthreads();  // the tile before's W2 products read sH
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
          float hv = 0.f;
          if (r < tl.nk && j < C4) hv = grn_h(gelu(av[nt][e] + b1[j]), sNX[j], gamma[j], beta[j]);
          sH[r * LDC + jc] = from_f<T>(hv);
        }
      }
      if constexpr (MODE == RES) __syncthreads();
      const int kj = min(KC, C4 - j0);
      for (int ct = 0; ct < nc; ++ct) {
        const int c0 = ct * TN;
        const T* B;
        int ldb;
        if constexpr (MODE == RES) {
          B = sW2 + (size_t)c0 * ldw2 + j0;
          ldb = ldw2;
        } else {
          B = ring_step<T, S>(sW, 1, si++, fetch);  // also publishes sH
          ldb = LDC;
        }
        float acc[CNT][4] = {};
        WarpMM<T>::run(sH + w * 16 * LDC, LDC, B + col * ldb, ldb, kj, acc);
#pragma unroll
        for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = w * 16 + frag_row(e), c = c0 + col + frag_col(nt, e);
            if (c < C) acc_add<MODE>(sO + r * ldo + c, acc[nt][e]);
          }
        }
      }
    }
    if constexpr (MODE == WIDE) __threadfence();
    __syncthreads();
    constexpr int V = VEC_BYTES / sizeof(T);
    const int cv = C / V;
    for (int i = threadIdx.x; i < tl.nk * cv; i += blockDim.x) {  // 16 bytes of y a step
      const int r = i / cv, c = (i - r * cv) * V;
      const size_t o = (size_t)sId[r] * C + c;
      const uint4 xv = *reinterpret_cast<const uint4*>(x + o);
      const T* xe = reinterpret_cast<const T*>(&xv);
      uint4 yv;
      T* ye = reinterpret_cast<T*>(&yv);
#pragma unroll
      for (int q = 0; q < V; ++q)
        ye[q] = from_f<T>(to_f(xe[q]) + (acc_get<MODE>(sO + r * ldo + c + q) + b2[c + q]) *
                                            sKeep[r]);
      *reinterpret_cast<uint4*>(y + o) = yv;
    }
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Statistic pass of the backward (phase 0 of _bwd_kernel), all but dW2: do =
// dy * keep rounded to T (the operand of the dh and dW2 products), stored at
// the kept slots, with db2 += sum of the f32 do; per 64-column tile of 4C, v
// and dh = do W2 are recomputed, g = gelu(v) in f32, h = gamma*(g*nx) + beta +
// g is stored at the slots rounded to T for the dW2 pass, and dgamma += sum
// dh*(g*nx), dbeta += sum dh, dnx[grp] += sum dh*gamma*g.  D's warp layout;
// the column tiles are split over blockIdx.y (its slice 0 stores do, db2).
// ---------------------------------------------------------------------------
template <typename T, int BM, int MODE>
__host__ __device__ size_t bstat_smem(int C) {
  Carve c;
  const int Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  c.take(sizeof(T) * BM * lda);
  c.take(sizeof(T) * BM * lda);
  c.take(MODE == RES ? sizeof(T) * 2 * (size_t)pad64(4 * C) * (Cp + 8)
                     : sizeof(T) * ring_slots<T>(K_BSTAT) * 2 * TN * LDC);
  c.take(sizeof(T) * BM * LDC);
  c.take(4 * sizeof(float) * BM);
  c.take(MODE == WIDE ? 0 : sizeof(float) * 13 * C);
  return c.off;
}

template <typename T, int BM, int MODE>
__global__ void __launch_bounds__(BM * 2 * COLW)
masked_bwd_stat_kernel(const T* __restrict__ t, const T* __restrict__ dy, const T* __restrict__ keep,
                    Walk wk, const float* __restrict__ nx, const float* __restrict__ lnw,
                    const float* __restrict__ lnb, const T* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ w2t,
                    T* __restrict__ do_out, T* __restrict__ h_out, float* __restrict__ db2,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    float* __restrict__ dnx, int C) {
  constexpr int NW = BM / 16, S = ring_slots<T>(K_BSTAT);
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = 4 * C, Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  const int nj = (C4 + TN - 1) / TN, nk = (Cp + KC - 1) / KC;
  const int njl = (nj - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const bool lead = blockIdx.y == 0;  // stores do and sums db2
  Carve cv;
  T* sU = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sDO = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sW = reinterpret_cast<T*>(smem + cv.take(MODE == RES
                                                  ? sizeof(T) * 2 * (size_t)pad64(C4) * (Cp + 8)
                                                  : sizeof(T) * S * 2 * TN * LDC));
  T* sW2T = sW + (size_t)pad64(C4) * (Cp + 8);  // RES only
  T* sH = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * LDC));
  float* sMean = reinterpret_cast<float*>(smem + cv.take(4 * sizeof(float) * BM));
  float* sRs = sMean + BM;
  float* sKeep = sRs + BM;
  int* sId = reinterpret_cast<int*>(sKeep + BM);
  // the block's dgamma, dbeta, dnx (of its current group), db2
  float* sDG = reinterpret_cast<float*>(smem + cv.take(MODE == WIDE ? 0 : sizeof(float) * 13 * C));
  float *sDB = sDG + C4, *sDN = sDB + C4, *sDB2 = sDN + C4;
  if constexpr (MODE != WIDE)
    for (int j = threadIdx.x; j < 13 * C; j += blockDim.x) sDG[j] = 0.f;
  const int wt = threadIdx.x >> 5, w = wt % NW, col = (wt / NW) * CNT * 8;

  auto fetch = [&](int i) {  // step i: W1 and W2^T tiles (column tile jt, chunk kt)
    const int l = i % (njl * nk), jt = blockIdx.y + (l / nk) * gridDim.y, kt = l % nk;
    T* slot = sW + (size_t)(i % S) * 2 * TN * LDC;
    const int k0 = kt * KC, kc = min(KC, Cp - k0);
    tile_async(slot, w1, C, jt * TN, C4, k0, kc, C);
    tile_async(slot + TN * LDC, w2t, C, jt * TN, C4, k0, kc, C);
  };
  if constexpr (MODE == RES) {
    matrix_async(sW, Cp + 8, w1, C4, pad64(C4), C, Cp);
    matrix_async(sW2T, Cp + 8, w2t, C4, pad64(C4), C, Cp);
    cp_commit();
  } else {
    for (int i = 0; i < S - 1; ++i) {
      fetch(i);
      cp_commit();
    }
  }
  int si = 0, cur = -1;
  for (int v = blockIdx.x; v < wk.nvt; v += gridDim.x) {
    const Tile tl = tile_of<BM>(wk, v);
    if (tl.nk == 0) continue;
    if (MODE != WIDE && tl.grp != cur && cur >= 0) flush_sums(sDN, dnx + (size_t)cur * C4, C4);
    cur = tl.grp;
    __syncthreads();  // the tile before is consumed
    if constexpr (MODE != WIDE) gather_rows<T, BM>(sDO, lda, dy, wk.ids, tl.p0, tl.nk, C, Cp);
    ln_tile<T, BM>(t, keep, wk.ids, tl, lnw, lnb, MODE == WIDE ? nullptr : sU, lda, C, Cp,
                   sMean, sRs, sKeep, sId, nullptr);
    __syncthreads();  // sId, sKeep (and the raw dy rows)
    if (lead) {  // db2 += the f32 dy * keep, each column's rows split over `parts` threads
      const int parts = max(1, (int)blockDim.x / C);
      for (int i = threadIdx.x; i < C * parts; i += blockDim.x) {
        const int c = i % C;
        float s = 0.f;
        for (int r = i / C; r < tl.nk; r += parts) {
          const float d = MODE == WIDE ? to_f(dy[(size_t)sId[r] * C + c]) : to_f(sDO[r * lda + c]);
          s += d * sKeep[r];
        }
        atomicAdd((MODE == WIDE ? db2 : sDB2) + c, s);
      }
    }
    if constexpr (MODE == WIDE) {
      if (lead) do_rows<T, BM>(nullptr, 0, do_out, dy, sKeep, sId, tl.p0, tl.nk, C, 0, C);
    } else {
      __syncthreads();  // db2 read the raw dy
      constexpr int V = VEC_BYTES / sizeof(T);
      const int cv = C / V;
      for (int i = threadIdx.x; i < tl.nk * cv; i += blockDim.x) {  // do in place, and stored
        const int r = i / cv, c = (i - r * cv) * V;
        uint4 q = *reinterpret_cast<const uint4*>(sDO + r * lda + c);
        T* e = reinterpret_cast<T*>(&q);
#pragma unroll
        for (int k = 0; k < V; ++k) e[k] = from_f<T>(to_f(e[k]) * sKeep[r]);
        *reinterpret_cast<uint4*>(sDO + r * lda + c) = q;
        if (lead) *reinterpret_cast<uint4*>(do_out + (size_t)(tl.p0 + r) * C + c) = q;
      }
    }
    if constexpr (MODE == RES) {
      cp_wait<0>();
      __syncthreads();
    }
    const float* nxg = nx + (size_t)tl.grp * C4;
    float* aG = MODE == WIDE ? dgamma : sDG;
    float* aB = MODE == WIDE ? dbeta : sDB;
    float* aN = MODE == WIDE ? dnx + (size_t)tl.grp * C4 : sDN;
    for (int jj = 0; jj < njl; ++jj) {
      const int j0 = (blockIdx.y + jj * gridDim.y) * TN;
      float av[CNT][4] = {}, ah[CNT][4] = {};
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * KC, kc = min(KC, Cp - k0);
        const T *B1, *B2;
        int ldb;
        if constexpr (MODE == RES) {
          B1 = sW + (size_t)j0 * (Cp + 8) + k0;
          B2 = sW2T + (size_t)j0 * (Cp + 8) + k0;
          ldb = Cp + 8;
        } else {
          B1 = ring_step<T, S>(sW, 2, si++, fetch);
          B2 = B1 + TN * LDC;
          ldb = LDC;
          if constexpr (MODE == WIDE) {
            u_chunk<T, BM>(sU, t, sMean, sRs, sId, lnw, lnb, tl.nk, C, k0, kc);
            do_rows<T, BM>(sDO, LDC, nullptr, dy, sKeep, sId, tl.p0, tl.nk, C, k0, kc);
            __syncthreads();
          }
        }
        const int ka = MODE == WIDE ? 0 : k0;
        WarpMM<T>::run(sU + w * 16 * lda + ka, lda, B1 + col * ldb, ldb, kc, av);
        WarpMM<T>::run(sDO + w * 16 * lda + ka, lda, B2 + col * ldb, ldb, kc, ah);
      }
      if constexpr (MODE == RES) __syncthreads();  // the tile before's h store read sH
      float a[CNT][4], b[CNT][4], d[CNT][4];
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
          float gv = 0.f, nxv = 0.f, gm = 0.f, hv = 0.f;
          if (r < tl.nk && j < C4) {
            gv = gelu(av[nt][e] + b1[j]);
            nxv = nxg[j];
            gm = gamma[j];
            hv = grn_h(gv, nxv, gm, beta[j]);
          }
          sH[r * LDC + jc] = from_f<T>(hv);
          const float dh = ah[nt][e];
          a[nt][e] = dh * (gv * nxv);
          b[nt][e] = dh;
          d[nt][e] = dh * gm * gv;
        }
      }
      col_acc(a, aG + j0, C4 - j0, col);
      col_acc(b, aB + j0, C4 - j0, col);
      col_acc(d, aN + j0, C4 - j0, col);
      __syncthreads();  // publishes sH
      copy_rows(h_out + (size_t)tl.p0 * C4 + j0, C4, sH, LDC, tl.nk, min(TN, C4 - j0));
    }
  }
  if constexpr (MODE != WIDE) {
    flush_sums(sDG, dgamma, C4);
    flush_sums(sDB, dbeta, C4);
    if (cur >= 0) flush_sums(sDN, dnx + (size_t)cur * C4, C4);
    flush_sums(sDB2, db2, C);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// dv pass of the backward, all but dW1: u and v = LN(t) W1^T + b1, dh = do
// W2 per 64-column tile of 4C; dv = (dh*(gamma*nx + 1) + g'*dgx/gx) *
// gelu'(v), stored (rounded to T) with u for the dW1 pass; db1 += sum dv; du
// = dv W1 summed C wide; the dLN sums and dt = r*(da - mean da - uhat *
// mean(da*uhat)), da = du*lnw.  D's warp layout.  Two row sources (a tag
// type, so that profiles and ptxas name them):
//   KeptRows (phase 1 of _bwd_kernel): the kept-row list, do = dy * keep at
//     the slots, g' = gelu(v) * keep^2 of the f32 g recomputed (:192), dt = 0
//     at masked rows;
//   SpillRows (row 10, _sg_bwd_d_kernel, :463): every row of each group, do = dy,
//     g' the stored g (the same load for the whole tile: each thread fetches
//     its fragment's g before the tile's products), and only gelu'(v) from v.
// ---------------------------------------------------------------------------
template <typename T, int BM, int MODE>
__host__ __device__ size_t dv_smem(int C) {
  Carve c;
  const int Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8, C4 = 4 * C;
  c.take(sizeof(T) * BM * lda);
  c.take(sizeof(T) * BM * lda);
  c.take(MODE == RES ? sizeof(T) * (2 * (size_t)pad64(C4) * (Cp + 8) + (size_t)pad64(C) * (C4 + 8))
                     : sizeof(T) * ring_slots<T>(K_DV) * 2 * TN * LDC);
  c.take(sizeof(T) * BM * LDC);
  c.take(MODE == WIDE ? 0 : sizeof(float) * BM * acc_pitch(Cp));
  c.take(4 * sizeof(float) * BM);
  c.take(MODE == WIDE ? 0 : sizeof(float) * 6 * C);
  return c.off;
}

// The two values of an mma fragment's column pair (e, e + 1) at p, as f32.
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  a = __low2float(v);
  b = __high2float(v);
}

struct KeptRows {};
struct SpillRows {};

template <typename T, int BM, int MODE, typename Src>
__global__ void __launch_bounds__(BM * 2 * COLW)
bwd_dv_kernel(const T* __restrict__ t, const T* __restrict__ do_in, const T* __restrict__ keep,
              const T* __restrict__ g, Walk wk, const float* __restrict__ nx,
              const float* __restrict__ dgxg, const float* __restrict__ lnw,
              const float* __restrict__ lnb, const T* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ gamma,
              const T* __restrict__ w2t, const T* __restrict__ w1t, T* __restrict__ dt,
              T* __restrict__ dv_out, T* __restrict__ u_out, float* __restrict__ db1,
              float* __restrict__ dlnw, float* __restrict__ dlnb, float* wide_acc, int C) {
  constexpr int NW = BM / 16, S = ring_slots<T>(K_DV);
  constexpr bool SPILL = std::is_same_v<Src, SpillRows>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = 4 * C, Cp = (C + 15) & ~15, lda = MODE == WIDE ? LDC : Cp + 8;
  const int nj = (C4 + TN - 1) / TN, nk = (Cp + KC - 1) / KC, nc = (C + TN - 1) / TN;
  const int ldt = C4 + 8;  // pitch of the resident W1^T
  Carve cv;
  T* sU = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sDY = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * lda));
  T* sW = reinterpret_cast<T*>(smem + cv.take(
      MODE == RES ? sizeof(T) * (2 * (size_t)pad64(C4) * (Cp + 8) + (size_t)pad64(C) * ldt)
                  : sizeof(T) * S * 2 * TN * LDC));
  T* sW2T = sW + (size_t)pad64(C4) * (Cp + 8);  // RES only
  T* sW1T = sW2T + (size_t)pad64(C4) * (Cp + 8);
  T* sDV = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * BM * LDC));
  const int ldo = acc_pitch(Cp);
  float* sDU = reinterpret_cast<float*>(smem + cv.take(MODE == WIDE ? 0 : sizeof(float) * BM * ldo));
  if constexpr (MODE == WIDE) sDU = wide_acc + (size_t)blockIdx.x * BM * ldo;
  float* sMean = reinterpret_cast<float*>(smem + cv.take(4 * sizeof(float) * BM));
  float* sRs = sMean + BM;
  float* sKeep = sRs + BM;
  int* sId = reinterpret_cast<int*>(sKeep + BM);
  // the block's db1, dln_w, dln_b
  float* sDB1 = reinterpret_cast<float*>(smem + cv.take(MODE == WIDE ? 0 : sizeof(float) * 6 * C));
  float *sDLW = sDB1 + C4, *sDLB = sDLW + C;
  if constexpr (MODE != WIDE)
    for (int j = threadIdx.x; j < 6 * C; j += blockDim.x) sDB1[j] = 0.f;
  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5, nwt = blockDim.x >> 5;
  const int w = wt % NW, col = (wt / NW) * CNT * 8;

  auto fetch = [&](int i) {  // step i: W1 and W2^T tiles (jt, kt), then W1^T tiles (ct, jt)
    const int l = i % (nj * (nk + nc)), jt = l / (nk + nc), r = l - jt * (nk + nc);
    T* slot = sW + (size_t)(i % S) * 2 * TN * LDC;
    if (r < nk) {
      const int k0 = r * KC, kc = min(KC, Cp - k0);
      tile_async(slot, w1, C, jt * TN, C4, k0, kc, C);
      tile_async(slot + TN * LDC, w2t, C, jt * TN, C4, k0, kc, C);
    } else {
      tile_async(slot, w1t, C4, (r - nk) * TN, C, jt * TN, min(KC, C4 - jt * TN), C4);
    }
  };
  if constexpr (MODE == RES) {
    matrix_async(sW, Cp + 8, w1, C4, pad64(C4), C, Cp);
    matrix_async(sW2T, Cp + 8, w2t, C4, pad64(C4), C, Cp);
    matrix_async(sW1T, ldt, w1t, C, pad64(C), C4, C4);
    cp_commit();
  } else {
    for (int i = 0; i < S - 1; ++i) {
      fetch(i);
      cp_commit();
    }
  }
  int si = 0;
  for (int v = blockIdx.x; v < wk.nvt; v += gridDim.x) {
    const Tile tl = tile_of<BM, SPILL>(wk, v);
    fill_rows<T>(dt, nullptr, wk.ids, tl.p0 + tl.nk, tl.nf, C);
    if (tl.nk == 0) continue;
    __syncthreads();  // the tile before is consumed
    ln_tile<T, BM, SPILL>(t, keep, wk.ids, tl, lnw, lnb, MODE == WIDE ? nullptr : sU, lda, C,
                          Cp, sMean, sRs, sKeep, sId, u_out);
    if constexpr (MODE != WIDE) stage(sDY, lda, do_in, C, tl.p0, BM, tl.p0 + tl.nk, 0, Cp, C);
    for (int i = threadIdx.x; i < BM * ldo; i += blockDim.x) sDU[i] = 0.f;
    if constexpr (MODE == RES) {
      cp_wait<0>();
      __syncthreads();
    }
    const float* nxg = nx + (size_t)tl.grp * C4;
    const float* dgg = dgxg + (size_t)tl.grp * C4;
    for (int jt = 0; jt < nj; ++jt) {
      const int j0 = jt * TN;
      float av[CNT][4] = {}, ah[CNT][4] = {}, gs[CNT][4] = {};
      if constexpr (SPILL) {  // the stored g of this thread's fragment, in flight over the products
#pragma unroll
        for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = w * 16 + frag_row(e), j = j0 + col + frag_col(nt, e);
            if (r < tl.nk && j < C4) load_pair(g + (size_t)(tl.p0 + r) * C4 + j, gs[nt][e], gs[nt][e + 1]);
          }
        }
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * KC, kc = min(KC, Cp - k0);
        const T *B1, *B2;
        int ldb;
        if constexpr (MODE == RES) {
          B1 = sW + (size_t)j0 * (Cp + 8) + k0;
          B2 = sW2T + (size_t)j0 * (Cp + 8) + k0;
          ldb = Cp + 8;
        } else {
          B1 = ring_step<T, S>(sW, 2, si++, fetch);
          B2 = B1 + TN * LDC;
          ldb = LDC;
          if constexpr (MODE == WIDE) {
            u_chunk<T, BM>(sU, t, sMean, sRs, sId, lnw, lnb, tl.nk, C, k0, kc);
            stage(sDY, LDC, do_in, C, tl.p0, BM, tl.p0 + tl.nk, k0, kc, C);
            __syncthreads();
          }
        }
        const int ka = MODE == WIDE ? 0 : k0;
        WarpMM<T>::run(sU + w * 16 * lda + ka, lda, B1 + col * ldb, ldb, kc, av);
        WarpMM<T>::run(sDY + w * 16 * lda + ka, lda, B2 + col * ldb, ldb, kc, ah);
      }
      if constexpr (MODE == RES) __syncthreads();  // the tile before's du products read sDV
      float dvs[CNT][4];
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
          float dvv = 0.f;
          if (r < tl.nk && j < C4) {
            const float v = av[nt][e] + b1[j];
            float gv, gd;
            if constexpr (SPILL) {
              gv = gs[nt][e];
              gd = gelu_grad(v);
            } else {
              const float k = sKeep[r];
              gelu_both(v, gv, gd);
              gv = gv * k * k;
            }
            const float dg = ah[nt][e] * (gamma[j] * nxg[j] + 1.f) + gv * dgg[j];
            dvv = dg * gd;
          }
          sDV[r * LDC + jc] = from_f<T>(dvv);
          dvs[nt][e] = dvv;
        }
      }
      col_acc(dvs, (MODE == WIDE ? db1 : sDB1) + j0, C4 - j0, col);
      __syncthreads();  // publishes sDV
      copy_rows(dv_out + (size_t)tl.p0 * C4 + j0, C4, sDV, LDC, tl.nk, min(TN, C4 - j0));
      const int kj = min(KC, C4 - j0);
      for (int ct = 0; ct < nc; ++ct) {
        const int c0 = ct * TN;
        const T* B;
        int ldb;
        if constexpr (MODE == RES) {
          B = sW1T + (size_t)c0 * ldt + j0;
          ldb = ldt;
        } else {
          B = ring_step<T, S>(sW, 2, si++, fetch);
          ldb = LDC;
        }
        float acc[CNT][4] = {};
        WarpMM<T>::run(sDV + w * 16 * LDC, LDC, B + col * ldb, ldb, kj, acc);
#pragma unroll
        for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = w * 16 + frag_row(e), c = c0 + col + frag_col(nt, e);
            if (c < C) acc_add<MODE>(sDU + r * ldo + c, acc[nt][e]);
          }
        }
      }
    }
    if constexpr (MODE == WIDE) __threadfence();
    __syncthreads();
    if constexpr (MODE != WIDE) {  // the raw rows of t, in place of u
      gather_rows<T, BM, SPILL>(sU, lda, t, wk.ids, tl.p0, tl.nk, C, Cp);
      __syncthreads();
    }
    // dt of each kept row, L lanes a row as in ln_tile
    const int L = C <= 64 ? 8 : C <= 256 ? 16 : 32, sub = lane % L;
    for (int r0 = wt * (32 / L); r0 < tl.nk; r0 += nwt * (32 / L)) {
      const int r = r0 + lane / L;
      const bool ok = r < tl.nk;
      const int rr = ok ? r : 0;
      const T* tr = MODE == WIDE ? t + (size_t)sId[rr] * C : sU + rr * lda;
      const float mean = sMean[rr], rs = sRs[rr];
      float s1 = 0.f, s2 = 0.f;
      if (ok)
        for (int c = sub; c < C; c += L) {
          const float uh = (to_f(tr[c]) - mean) * rs, da = acc_get<MODE>(sDU + r * ldo + c) * lnw[c];
          s1 += da;
          s2 += da * uh;
        }
      const float md = lane_sum(s1, L) / C, mdu = lane_sum(s2, L) / C;
      if (!ok) continue;
      T* dtr = dt + (size_t)sId[r] * C;
      for (int c = sub; c < C; c += L) {
        const float uh = (to_f(tr[c]) - mean) * rs, da = acc_get<MODE>(sDU + r * ldo + c) * lnw[c];
        dtr[c] = from_f<T>(rs * (da - md - uh * mdu));
      }
    }
    const int parts = max(1, (int)blockDim.x / C);  // threads a column's rows split over
    for (int i = threadIdx.x; i < C * parts; i += blockDim.x) {
      const int c = i % C;
      float s1 = 0.f, s2 = 0.f;
      for (int r = i / C; r < tl.nk; r += parts) {
        const float du = acc_get<MODE>(sDU + r * ldo + c);
        const float tv = MODE == WIDE ? to_f(t[(size_t)sId[r] * C + c]) : to_f(sU[r * lda + c]);
        s1 += du * ((tv - sMean[r]) * sRs[r]);
        s2 += du;
      }
      atomicAdd((MODE == WIDE ? dlnw : sDLW) + c, s1);
      atomicAdd((MODE == WIDE ? dlnb : sDLB) + c, s2);
    }
  }
  if constexpr (MODE != WIDE) {
    flush_sums(sDB1, db1, C4);
    flush_sums(sDLW, dlnw, C);
    flush_sums(sDLB, dlnb, C);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// Row 9, phase C of the spill-g backward (_sg_bwd_c_kernel, :423): dh = dy W2
// (never stored), dgamma += sum dh*(g*nx), dbeta += sum dh, dnx[grp] += sum
// dh*gamma*g, db2 += sum dy, and, where the block's slice of dW2 fits its
// registers (FOLD, MT > 0), dW2 += dy^T h with h = gamma*(g*nx) + beta + g
// rounded to T: the TPU kernel's dw2_acc (:448).  A block owns one 64-column
// slice j0 of 4C and walks a contiguous range of row tiles (see c_range).
// RES: W2^T's slice is staged once, and each tile's dy rows (C wide) and g
// slice come by cp.async two tiles ahead of the products; RING (rows too
// wide for that): the dy rows and W2^T's slice stream by 64-column chunk
// through a ring, the g slice with the tile's first chunk.  Each thread
// keeps gamma, beta, nx and its column sums in registers until the block
// ends (dnx: until its group changes); dW2's slice stays in the mma
// accumulators and is added once.  MT: the m-tiles (16 rows of C) of dW2 a
// warp holds, 0 without the fold.
// ---------------------------------------------------------------------------
constexpr int C_RING_SLOTS = 3;

// s[r][c] = src[r0 + r][c0 + c] for r < nr, c < nc (row pitch lds), zero
// where r0 + r >= rmax or c0 + c >= cmax, by cp.async.
template <typename T>
__device__ __forceinline__ void rows_async(T* s, int lds, const T* __restrict__ src, int ld,
                                           int r0, int nr, int rmax, int c0, int nc, int cmax) {
  constexpr int V = VEC_BYTES / sizeof(T);
  const int pv = nc / V;
  for (int i = threadIdx.x; i < nr * pv; i += blockDim.x) {
    const int r = i / pv, c = (i - r * pv) * V;
    const bool ok = r0 + r < rmax && c0 + c < cmax;
    cp16(s + r * lds + c, ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
  }
}

// acc[mt][nt][*] += A[m0 + 16 mt.. + 16][0:kc] . B[nt*8 + n][0:kc] for this
// warp, with A stored transposed (sA[k][m], pitch lda: the dy rows of a tile)
// and B n-major with k contiguous; the fragment layout of WarpMM.  bf16: A's
// fragments come by ldmatrix.trans.
template <typename T> struct WarpMMt;

template <> struct WarpMMt<__nv_bfloat16> {
  template <int NT>
  __device__ __forceinline__ static void run(const __nv_bfloat16* sA, int lda, int m0,
                                             const __nv_bfloat16* sB, int ldb, int kc,
                                             float (&acc)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, q = lane >> 3, i = lane & 7;
    for (int k = 0; k < kc; k += 16) {
      uint32_t a0, a1, a2, a3;
      const __nv_bfloat16* pa = sA + (k + (q >> 1) * 8 + i) * lda + m0 + (q & 1) * 8;
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(a0), "=r"(a1), "=r"(a2), "=r"(a3)
                   : "r"(smem_addr(pa)));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* b = sB + (nt * 8 + g) * ldb + k + 2 * t;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
};

template <> struct WarpMMt<float> {
  template <int NT>
  __device__ __forceinline__ static void run(const float* sA, int lda, int m0, const float* sB,
                                             int ldb, int kc, float (&acc)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* a = sA + m0 + g + (e >> 1) * 8;
        const float* b = sB + (nt * 8 + 2 * t + (e & 1)) * ldb;
        float s = acc[nt][e];
        for (int k = 0; k < kc; ++k) s = fmaf(a[k * lda], b[k], s);
        acc[nt][e] = s;
      }
    }
  }
};

// p[0] += a, p[1] += b in device memory, one vector atomic (sm_90; p 8-byte
// aligned).
__device__ __forceinline__ void red_add2(float* p, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(a, b));
}

// The block's slice y of the nj 64-column slices of 4C and its row tiles
// [t0, t1) of nt: block b takes slice b % nj, and the blocks of a slice cut
// its tiles into even ranges, so that any number of blocks >= nj fills the
// card at every stage.
__device__ __forceinline__ void c_range(int nt, int nj, int& y, int& t0, int& t1) {
  const int nb = gridDim.x, b = blockIdx.x;
  y = b % nj;
  const int ri = b / nj, rr = nb / nj + (y < nb % nj ? 1 : 0);
  t0 = (int)((long long)ri * nt / rr);
  t1 = (int)((long long)(ri + 1) * nt / rr);
}

// Tiles of dy rows and g in flight in RES: the copy of tile u + 2 overlaps
// the products of tile u.
constexpr int C_TILE_BUFS = 3;

template <typename T, int BM, int MODE, int MT>
__host__ __device__ size_t c_smem(int C) {
  Carve c;
  const int Cp = (C + 15) & ~15;
  if (MODE == RES) {
    c.take(sizeof(T) * TN * (Cp + 8));                // W2^T's slice
    c.take(sizeof(T) * C_TILE_BUFS * BM * (Cp + 8));  // dy rows of the tiles in flight
    c.take(sizeof(T) * C_TILE_BUFS * BM * LDC);       // their g slices
  } else {
    c.take(sizeof(T) * C_RING_SLOTS * 2 * TN * LDC);  // W2^T chunk, dy chunk
    c.take(sizeof(T) * 2 * BM * LDC);                 // g slices of two tiles
  }
  c.take(MT > 0 ? sizeof(T) * TN * (BM + 8) : 0);  // h^T of a tile
  c.take(sizeof(float) * (3 * TN + C));             // dgamma, dbeta, dnx, db2
  return c.off;
}

// v (the warp's per-thread column sums of a tile, CNT x 2 columns) into acc[c]
// (shared memory): a warp shuffle over its rows, then one shared atomic a
// column and warp.
__device__ __forceinline__ void col_acc2(const float (&v)[CNT][2], float* acc, int nvalid,
                                         int coloff) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[nt][e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      const int c = coloff + frag_col(nt, e);
      if (lane < 4 && c < nvalid) atomicAdd(acc + c, s);
    }
  }
}

// Two blocks an SM where one would leave the card half idle: RING (huge's
// widths) has one block a 64-column slice of 4C, 176 at C = 2816, and the
// half tile (8 warps a block) relies on a second block to hide its waits.
template <typename T, int BM, int MODE, int MT>
__global__ void __launch_bounds__(BM * 2 * COLW, MODE == RING || BM < Cfg<T>::BM ? 2 : 1)
spillg_bwd_c_kernel(const T* __restrict__ dy, const T* __restrict__ g,
                    const float* __restrict__ nx, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const T* __restrict__ w2t,
                    float* __restrict__ db2, float* __restrict__ dgamma,
                    float* __restrict__ dbeta, float* __restrict__ dnx, float* __restrict__ dw2,
                    int M, int C, int GR) {
  constexpr int NW = BM / 16, S = C_RING_SLOTS, ldh = BM + 8, NB = C_TILE_BUFS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C4 = 4 * C, Cp = (C + 15) & ~15, ldy = Cp + 8;
  const int nj = (C4 + TN - 1) / TN, nk = (Cp + KC - 1) / KC, tpg = (GR + BM - 1) / BM;
  int y, t0, t1;
  c_range((M / GR) * tpg, nj, y, t0, t1);
  if (t0 >= t1) return;
  const int j0 = y * TN, jn = min(TN, C4 - j0);
  Carve cv;
  T* sW = reinterpret_cast<T*>(smem + cv.take(MODE == RES ? sizeof(T) * TN * ldy
                                                         : sizeof(T) * S * 2 * TN * LDC));
  T* sDY = reinterpret_cast<T*>(smem + cv.take(MODE == RES ? sizeof(T) * NB * BM * ldy : 0));
  T* sG = reinterpret_cast<T*>(smem + cv.take(sizeof(T) * (MODE == RES ? NB : 2) * BM * LDC));
  T* sHT = reinterpret_cast<T*>(smem + cv.take(MT > 0 ? sizeof(T) * TN * ldh : 0));
  float* sDG = reinterpret_cast<float*>(smem + cv.take(sizeof(float) * (3 * TN + C)));
  float *sDB = sDG + TN, *sDN = sDB + TN, *sDB2 = sDN + TN;
  for (int j = threadIdx.x; j < 3 * TN + C; j += blockDim.x) sDG[j] = 0.f;
  const int wt = threadIdx.x >> 5, w = wt % NW, col = (wt / NW) * CNT * 8;
  // this thread's columns of the slice: gamma, beta (and nx of the current
  // group) in registers, and its running column sums over the block's rows
  float gmr[CNT][2], btr[CNT][2], nxr[CNT][2], sg[CNT][2] = {}, sb[CNT][2] = {}, sn[CNT][2] = {};
#pragma unroll
  for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jc = col + frag_col(nt, e);
      gmr[nt][e] = jc < jn ? gamma[j0 + jc] : 0.f;
      btr[nt][e] = jc < jn ? beta[j0 + jc] : 0.f;
    }
  }

  auto rows_of = [&](int u, int& grp, int& row0, int& nr) {  // tile u: its group and rows
    grp = u / tpg;
    const int i = u - grp * tpg;
    row0 = grp * GR + i * BM;
    nr = min(BM, GR - i * BM);
  };
  auto fetch_g = [&](int u, T* dst) {
    int grp, row0, nr;
    rows_of(u, grp, row0, nr);
    rows_async(dst, LDC, g, C4, row0, BM, row0 + nr, j0, TN, C4);
  };
  auto fetch_tile = [&](int u) {  // RES: tile u's dy rows and g slice, if it is the block's
    if (u >= t1) return;
    int grp, row0, nr;
    rows_of(u, grp, row0, nr);
    const int b = (u - t0) % NB;
    rows_async(sDY + b * BM * ldy, ldy, dy, C, row0, BM, row0 + nr, 0, Cp, C);
    fetch_g(u, sG + b * BM * LDC);
  };
  auto fetch = [&](int i) {  // RING step i: chunk i % nk of tile t0 + i / nk
    const int u = t0 + i / nk, kt = i % nk;
    if (u >= t1) return;
    int grp, row0, nr;
    rows_of(u, grp, row0, nr);
    const int k0 = kt * KC, kc = min(KC, Cp - k0);
    T* slot = sW + (size_t)(i % S) * 2 * TN * LDC;
    rows_async(slot, LDC, w2t, C, j0, TN, C4, k0, kc, C);
    rows_async(slot + TN * LDC, LDC, dy, C, row0, BM, row0 + nr, k0, kc, C);
    if (kt == 0) fetch_g(u, sG + ((u - t0) & 1) * BM * LDC);
  };
  // the group's column sums of dnx out: registers -> shared -> device memory
  auto flush_dnx = [&](int grp) {
    col_acc2(sn, sDN, jn, col);
    flush_sums(sDN, dnx + (size_t)grp * C4 + j0, jn);
#pragma unroll
    for (int nt = 0; nt < CNT; ++nt) sn[nt][0] = sn[nt][1] = 0.f;
  };
  if constexpr (MODE == RES) {
    rows_async(sW, ldy, w2t, C, j0, TN, C4, 0, Cp, C);
    fetch_tile(t0);
    cp_commit();
    fetch_tile(t0 + 1);
    cp_commit();
  } else {
    for (int i = 0; i < S - 1; ++i) {
      fetch(i);
      cp_commit();
    }
  }
  float acc2[MT > 0 ? MT : 1][CNT][4] = {};
  int si = 0, cur = -1;
  for (int u = t0; u < t1; ++u) {
    int grp, row0, nr;
    rows_of(u, grp, row0, nr);
    const int b = MODE == RES ? (u - t0) % NB : (u - t0) & 1;
    const T* dyb = MODE == RES ? sDY + b * BM * ldy : nullptr;
    const T* gb = sG + b * BM * LDC;
    float acc[CNT][4] = {};
    if constexpr (MODE == RES) {
      cp_wait<1>();
      __syncthreads();  // tile u is in; tile u - 1 is consumed
      fetch_tile(u + 2);
      cp_commit();
      WarpMM<T>::run(dyb + w * 16 * ldy, ldy, sW + col * ldy, ldy, Cp, acc);
    } else {
      for (int kt = 0; kt < nk; ++kt) {
        const T* B = ring_step<T, S>(sW, 2, si++, fetch);
        WarpMM<T>::run(B + TN * LDC + w * 16 * LDC, LDC, B + col * LDC, LDC, min(KC, Cp - kt * KC),
                       acc);
      }
    }
    if (grp != cur) {  // the group's nx; the group before's dnx out
      if (cur >= 0) flush_dnx(cur);
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jc = col + frag_col(nt, e);
          nxr[nt][e] = jc < jn ? nx[(size_t)grp * C4 + j0 + jc] : 0.f;
        }
      }
      cur = grp;
    }
#pragma unroll
    for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), q = e & 1;
        float gv = 0.f, hv = 0.f;
        if (r < nr && jc < jn) {
          gv = to_f(gb[r * LDC + jc]);
          hv = grn_h(gv, nxr[nt][q], gmr[nt][q], btr[nt][q]);
        }
        if constexpr (MT > 0) sHT[jc * ldh + r] = from_f<T>(hv);
        const float dh = acc[nt][e];
        sg[nt][q] += dh * (gv * nxr[nt][q]);
        sb[nt][q] += dh;
        sn[nt][q] += dh * gmr[nt][q] * gv;
      }
    }
    if (y == 0) {  // db2 += the tile's dy, each column's rows split over `parts` threads
      const int parts = max(1, (int)blockDim.x / C);
      for (int i = threadIdx.x; i < C * parts; i += blockDim.x) {
        const int c = i % C;
        float sum = 0.f;
        for (int r = i / C; r < nr; r += parts)
          sum += MODE == RES ? to_f(dyb[r * ldy + c]) : to_f(dy[(size_t)(row0 + r) * C + c]);
        atomicAdd(sDB2 + c, sum);
      }
    }
    if constexpr (MT > 0) {
      __syncthreads();  // publishes h^T
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = w + i * NW;
        if (mt * 16 < Cp) WarpMMt<T>::run(dyb, ldy, mt * 16, sHT + col * ldh, ldh, BM, acc2[i]);
      }
    }
  }
  if constexpr (MT > 0) {  // the block's dW2 slice, one atomic a pair of elements
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int nt = 0; nt < CNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int c = (w + i * NW) * 16 + frag_row(e), jc = col + frag_col(nt, e);
          if (c < C && jc < jn)
            red_add2(dw2 + (size_t)c * C4 + j0 + jc, acc2[i][nt][e], acc2[i][nt][e + 1]);
        }
      }
    }
  }
  col_acc2(sg, sDG, jn, col);
  col_acc2(sb, sDB, jn, col);
  flush_sums(sDG, dgamma + j0, jn);
  flush_sums(sDB, dbeta + j0, jn);
  flush_dnx(cur);
  if (y == 0) flush_sums(sDB2, db2, C);
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// out (I, J) += X^T Y over rows [s*rps, (s+1)*rps): X (M, I), Y (M, J).  With
// nx given, Y is g and each element becomes h = gamma*(g*nx[grp]) + beta + g
// (rounded to T) as it is staged.  Block: BM x 64 output tile, one row split.
// MASKED (the masked tail's weight gradients, X and Y at the slots of the
// kept-row list): blockIdx.y is (chunk q, part s of rps parts), and the
// block sums its part of chunk q's cnt[q] kept slots.
// ---------------------------------------------------------------------------
template <typename T, bool MASKED>
__global__ void __launch_bounds__(Cfg<T>::BM * 2)
spillg_atb_kernel(const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ nx,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  float* __restrict__ out, int M, int I, int J, int GR, int rps, int nIT,
                  const int* __restrict__ cnt, int ncg) {
  constexpr int BM = Cfg<T>::BM;
  __shared__ __align__(16) T sA[BM * LDC];
  __shared__ __align__(16) T sB[TN * LDC];
  const int w = threadIdx.x >> 5;
  const int it = blockIdx.x % nIT, jt = blockIdx.x / nIT;
  const int i0 = it * BM, j0 = jt * TN;
  int m0, m1;
  if constexpr (MASKED) {
    const int q = blockIdx.y / rps, part = blockIdx.y - q * rps, grp = q / ncg;
    const int qs = grp * GR + (q - grp * ncg) * CHUNK, n = cnt[q];
    const int per = ((n + rps - 1) / rps + KC - 1) / KC * KC;
    m0 = qs + part * per;
    m1 = qs + min(n, (part + 1) * per);
    if (m0 >= m1) return;
  } else {
    m0 = blockIdx.y * rps;
    m1 = min(M, m0 + rps);
  }
  float acc[8][4] = {};
  auto as_is = [](int, int, float v) { return v; };
  auto h_of_g = [=](int m, int j, float v) {
    return nx == nullptr ? v : grn_h(v, nx[(size_t)(m / GR) * J + j], gamma[j], beta[j]);
  };
  for (int mb = m0; mb < m1; mb += KC) {
    __syncthreads();
    stage_t(sA, LDC, X, I, mb, KC, m1, i0, BM, I, as_is);
    stage_t(sB, LDC, Y, J, mb, KC, m1, j0, TN, J, h_of_g);
    __syncthreads();
    WarpMM<T>::run(sA + w * 16 * LDC, LDC, sB, LDC, KC, acc);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = i0 + w * 16 + frag_row(e), c = j0 + frag_col(nt, e);
      if (r < I && c < J) atomicAdd(out + (size_t)r * J + c, acc[nt][e]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// Shared memory of A (rows_smem) and B (b_smem) at a row tile of BM rows.
template <typename T> size_t rows_smem(int C, int BM) {
  const int lda = ((C + 15) & ~15) + 8;
  return align16(sizeof(T) * BM * lda) + sizeof(T) * TN * LDC +
         align16(sizeof(T) * BM * LDC) + sizeof(float) * (BM / 16) * 64;
}

template <typename T> size_t b_smem(int C) {
  return align16(sizeof(float) * (4 * C + 32)) + sizeof(T) * (Cfg<T>::BM + TN) * LDC;
}

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

size_t smem_limit() {  // opt-in shared memory per block of the current device
  return (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
}

// The largest row tile (Cfg<T>::BM halved down to 16 rows) whose shared
// memory fits, or 0 when none does.
template <typename T> int pick_bm(size_t (*smem)(int, int), int C, size_t limit) {
  for (int bm = Cfg<T>::BM; bm >= 16; bm /= 2)
    if (smem(C, bm) <= limit) return bm;
  return 0;
}

// f(std::integral_constant<int, bm>) for a picked row tile.
template <typename T, typename F> int with_bm(int bm, F f) {
  if constexpr (Cfg<T>::BM >= 64) {
    if (bm == 64) return f(std::integral_constant<int, 64>{});
  }
  if (bm == 32) return f(std::integral_constant<int, 32>{});
  if (bm == 16) return f(std::integral_constant<int, 16>{});
  return (int)cudaErrorInvalidConfiguration;  // no row tile fits: a bug for C <= 2816
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int grid_rows(int M, int GR, int BM) { return (M / GR) * ((GR + BM - 1) / BM); }

// Row blocks times a split of the ncols output columns over blockIdx.y, so
// that the few-row stages (C = 160, 320) still fill the card.
constexpr int TARGET_BLOCKS = 1056;  // 8 per SM on 132 SMs
dim3 grid_2d(int M, int GR, int ncols, int BM) {
  const int rows = grid_rows(M, GR, BM), tiles = (ncols + TN - 1) / TN;
  const int ny = max(1, min(tiles, (TARGET_BLOCKS + rows - 1) / rows));
  return dim3(rows, ny);
}

template <typename T>
int fwd_a(const void* t, const void* lnw, const void* lnb, const void* w1, const void* b1,
          void* g, void* gxsq, int M, int C, int GR, cudaStream_t s) {
  return with_bm<T>(pick_bm<T>(rows_smem<T>, C, smem_limit()), [&](auto bm) {
    constexpr int BM = decltype(bm)::value;
    const size_t smem = rows_smem<T>(C, BM);
    cudaError_t e = prepare(spillg_fwd_a_kernel<T, BM>, smem);
    if (e != cudaSuccess) return (int)e;
    spillg_fwd_a_kernel<T, BM><<<grid_2d(M, GR, 4 * C, BM), BM * 2, smem, s>>>(
        (const T*)t, (const float*)lnw, (const float*)lnb, (const T*)w1, (const float*)b1,
        (T*)g, (float*)gxsq, C, 4 * C, GR, (GR + BM - 1) / BM);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int fwd_b(const void* g, const void* x, const void* gxsq, const void* gamma, const void* beta,
          const void* w2, const void* b2, void* y, void* gx, void* nx, int M, int C, int GR,
          cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  const size_t smem = b_smem<T>(C);
  cudaError_t e = prepare(spillg_fwd_b_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  spillg_fwd_b_kernel<T><<<grid_2d(M, GR, C, BM), BM * 2, smem, s>>>(
      (const T*)g, (const T*)x, (const float*)gxsq, (const float*)gamma, (const float*)beta,
      (const T*)w2, (const float*)b2, (T*)y, (float*)gx, (float*)nx, C, 4 * C, GR,
      (GR + BM - 1) / BM);
  return (int)cudaGetLastError();
}

template <typename T>
int atb(const void* X, const void* Y, const void* nx, const void* gamma, const void* beta,
        void* out, int M, int I, int J, int GR, int rps, int splits, cudaStream_t s) {
  if (rps % KC != 0) return (int)cudaErrorInvalidValue;
  const int nIT = (I + Cfg<T>::BM - 1) / Cfg<T>::BM, nJT = (J + TN - 1) / TN;
  dim3 blocks(nIT * nJT, splits);
  spillg_atb_kernel<T, false><<<blocks, Cfg<T>::BM * 2, 0, s>>>(
      (const T*)X, (const T*)Y, (const float*)nx, (const float*)gamma, (const float*)beta,
      (float*)out, M, I, J, GR, rps, nIT, nullptr, 0);
  return (int)cudaGetLastError();
}

// ---- the persistent passes: the masked-dense tail and spill-g's C and D ----
int chunks_per_group(int GR) { return (GR + CHUNK - 1) / CHUNK; }

Walk make_walk(const void* ids, const void* cnt, int M, int GR, int BM) {
  Walk w;
  w.ids = (const int*)ids;
  w.cnt = (const int*)cnt;
  w.GR = GR;
  w.ncg = chunks_per_group(GR);
  w.tpc = (min(CHUNK, GR) + BM - 1) / BM;
  w.nvt = (M / GR) * w.ncg * w.tpc;
  return w;
}

// Every row of each group, in order: spill-g's D.
Walk spill_walk(int M, int GR, int BM) {
  Walk w;
  w.ids = nullptr;
  w.cnt = nullptr;
  w.GR = GR;
  w.ncg = 1;
  w.tpc = (GR + BM - 1) / BM;
  w.nvt = (M / GR) * w.tpc;
  return w;
}

template <typename T, int BM, int MODE> size_t pass_smem(int kind, int C) {
  switch (kind) {
    case K_STAT: return stat_smem<T, BM, MODE>(C);
    case K_APPLY: return apply_smem<T, BM, MODE>(C);
    case K_BSTAT: return bstat_smem<T, BM, MODE>(C);
    default: return dv_smem<T, BM, MODE>(C);  // the dv passes, masked and spill-g D
  }
}

template <typename T, int BM> size_t pass_smem(int kind, int mode, int C) {
  return mode == RES ? pass_smem<T, BM, RES>(kind, C)
         : mode == RING ? pass_smem<T, BM, RING>(kind, C)
                        : pass_smem<T, BM, WIDE>(kind, C);
}

template <typename T, int MODE> const void* pass_kernel(int kind) {
  constexpr int BM = Cfg<T>::BM;
  switch (kind) {
    case K_STAT: return (const void*)masked_fwd_stat_kernel<T, BM, MODE>;
    case K_APPLY: return (const void*)masked_fwd_apply_kernel<T, BM, MODE>;
    case K_BSTAT: return (const void*)masked_bwd_stat_kernel<T, BM, MODE>;
    case K_DV: return (const void*)bwd_dv_kernel<T, BM, MODE, KeptRows>;
    default: return (const void*)bwd_dv_kernel<T, BM, MODE, SpillRows>;
  }
}

// f(std::integral_constant<int, mode>) for a plan's mode.
template <typename F> int with_mode(int mode, F f) {
  if (mode == RES) return f(std::integral_constant<int, RES>{});
  if (mode == RING) return f(std::integral_constant<int, RING>{});
  return f(std::integral_constant<int, WIDE>{});
}

// C's dW2 fold: the m-tiles a warp holds (its instantiations: 1, 2, 3, 5), 0
// for none.
template <typename F> int with_mt(int mt, F f) {
  switch (mt) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    default: return (int)cudaErrorInvalidValue;
  }
}
constexpr int MAX_FOLD_MT = 5;  // 40 f32 sums a thread of the bf16 block at C = 320

// Threads, shared bytes, occupancy and blocks of a chosen kernel, into
// plan[2..6] (see pass_plan).
int finish_plan(const void* kernel, int threads, size_t smem, int ny, int units, bool sliced,
                int* plan) {
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int occ = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int fit = occ * device_attr(cudaDevAttrMultiProcessorCount);
  plan[2] = threads;
  plan[3] = (int)smem;
  plan[4] = sliced ? max(ny, min(ny * units, fit)) : min(units, fit);
  plan[5] = ny;
  plan[6] = occ;
  return 0;
}

// C's plan at a row tile of BM rows: RES where W2^T's slice, two tiles of dy
// rows and of g (and h^T) fit a block, else RING; the fold where the slice
// of dW2 takes at most MAX_FOLD_MT m-tiles a warp (bf16 at 64 rows: C <=
// 320, f32: C <= 160).  Blocks: as many as fit at once, at least one a slice
// (c_range).
template <typename T, int BM> int c_plan(int M, int C, int GR, int* plan) {
  constexpr int NW = BM / 16;
  const size_t limit = smem_limit();
  const int Cp = (C + 15) & ~15, need = (Cp / 16 + NW - 1) / NW;
  int mt = need <= 3 ? need : need <= MAX_FOLD_MT ? MAX_FOLD_MT : 0;
  int mode = RES;
  size_t smem = with_mt(mt, [&](auto m) { return (int)c_smem<T, BM, RES, decltype(m)::value>(C); });
  if (smem > limit && mt > 0) {
    mt = 0;
    smem = c_smem<T, BM, RES, 0>(C);
  }
  if (smem > limit) {
    mode = RING;
    smem = c_smem<T, BM, RING, 0>(C);
    if (smem > limit || Cp <= KC) return (int)cudaErrorInvalidValue;  // RING needs >= 2 chunks
  }
  const void* kernel = mode == RING ? (const void*)spillg_bwd_c_kernel<T, BM, RING, 0>
                                    : nullptr;
  if (mode == RES)
    with_mt(mt, [&](auto m) {
      kernel = (const void*)spillg_bwd_c_kernel<T, BM, RES, decltype(m)::value>;
      return 0;
    });
  plan[0] = mode;
  plan[1] = BM;
  plan[7] = grid_rows(M, GR, BM);
  plan[8] = mt;
  return finish_plan(kernel, 2 * COLW * BM, smem, (4 * C + TN - 1) / TN, plan[7], true, plan);
}

// f(std::integral_constant<int, bm>) for the default row tile or (bf16) its half.
template <typename T, typename F> int with_tile(int bm, F f) {
  constexpr int BM = Cfg<T>::BM;
  if (bm == BM) return f(std::integral_constant<int, BM>{});
  if constexpr (BM == 64) {
    if (bm == BM / 2) return f(std::integral_constant<int, BM / 2>{});
  }
  return (int)cudaErrorInvalidValue;
}

// A persistent pass's launch plan, as plan[0..8]: mode (RES where the
// resident weights fit twice on an SM, else RING where the C-wide row
// operands fit, else WIDE; C: see c_plan), row tile, threads, shared bytes,
// blocks (as many as fit on the card at once, at most one a tile; C: at
// least one a slice), the column split over blockIdx.y (the statistic
// passes: enough blocks for ~2 waves, the backward's ~4, at 40% of the tiles
// kept, since each column split repeats a tile's LN; C: its 64-column slices
// of 4C, over blockIdx.x), blocks an SM, row tiles (the masked passes: the
// list's virtual tiles), and C's dW2 fold (m-tiles a warp, 0 for none).  bm:
// 0 for the plan's own row tile, else the tile its half-tile step tries:
// spill-g C (bf16) and D (on a RING plan) take half the default where two or
// three blocks of 8 warps an SM then hide each other's waits, which one
// block of 16 (its registers allow no more) cannot: D on a RING plan, from
// RES or RING, where its tiles still give every block two; C where its dW2
// fold then takes at most 3 m-tiles a warp (stages 0-1 of atto; more spill).
template <typename T> int pass_plan(int kind, int M, int C, int GR, int bm, int* plan) {
  constexpr int BM = Cfg<T>::BM;
  if (kind == K_SC) {
    if (bm == 0 && BM == 64) {  // the half tile where its fold takes at most 3 m-tiles a warp
      int half[9];
      if (pass_plan<T>(kind, M, C, GR, BM / 2, half) == 0 && half[8] > 0 && half[8] <= 3) {
        for (int i = 0; i < 9; ++i) plan[i] = half[i];
        return 0;
      }
    }
    return with_tile<T>(bm == 0 ? BM : bm, [&](auto b) {
      return c_plan<T, decltype(b)::value>(M, C, GR, plan);
    });
  }
  const size_t limit = smem_limit();
  const size_t sm_bytes = (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerMultiprocessor);
  if (kind == K_SD && bm == 0 && BM == 64) {
    int half[9];
    const int e = pass_plan<T>(kind, M, C, GR, BM, plan);
    if (e || plan[0] == WIDE || pass_plan<T>(kind, M, C, GR, BM / 2, half)) return e;
    if (half[7] >= 2 * half[4])
      for (int i = 0; i < 9; ++i) plan[i] = half[i];
    return 0;
  }
  if (bm == 0) bm = BM;
  plan[8] = 0;
  if (bm != BM) {  // spill-g D's half tile, on its RING plan
    if constexpr (BM == 64) {
      constexpr int H = BM / 2;
      const size_t smem = dv_smem<T, H, RING>(C);
      if (kind != K_SD || smem > limit) return (int)cudaErrorInvalidValue;
      plan[0] = RING;
      plan[1] = H;
      plan[7] = spill_walk(M, GR, H).nvt;
      return finish_plan((const void*)bwd_dv_kernel<T, H, RING, SpillRows>, 2 * COLW * H, smem, 1,
                         plan[7], false, plan);
    }
    return (int)cudaErrorInvalidValue;
  }
  const int mode = 2 * (pass_smem<T, BM>(kind, RES, C) + 1024) <= sm_bytes ? RES
                   : pass_smem<T, BM>(kind, RING, C) <= limit              ? RING
                                                                           : WIDE;
  const size_t smem = pass_smem<T, BM>(kind, mode, C);
  if (smem > limit) return (int)cudaErrorInvalidValue;
  const void* kernel = mode == RES ? pass_kernel<T, RES>(kind)
                       : mode == RING ? pass_kernel<T, RING>(kind)
                                      : pass_kernel<T, WIDE>(kind);
  const int nvt = kind == K_SD ? spill_walk(M, GR, BM).nvt : make_walk(nullptr, nullptr, M, GR, BM).nvt;
  int ny = 1;
  if (kind == K_STAT || kind == K_BSTAT) {
    // probe the occupancy first: the split depends on it
    int e = finish_plan(kernel, 2 * COLW * BM, smem, 1, nvt, false, plan);
    if (e) return e;
    const int nj = (4 * C + TN - 1) / TN, fit = plan[6] * device_attr(cudaDevAttrMultiProcessorCount);
    const int waves = kind == K_STAT ? 5 : 10;  // the backward statistic has twice the work a tile
    ny = max(1, min(nj, (waves * fit + nvt - 1) / nvt));
  }
  plan[0] = mode;
  plan[1] = BM;
  plan[7] = nvt;
  return finish_plan(kernel, 2 * COLW * BM, smem, ny, nvt, false, plan);
}

template <typename T>
int masked_rows(const void* keep, void* ids, void* cnt, int M, int GR, cudaStream_t s) {
  const int ncg = chunks_per_group(GR);
  masked_fwd_rows_kernel<T><<<(M / GR) * ncg, ROWS_THREADS, 0, s>>>((const T*)keep, (int*)ids,
                                                                (int*)cnt, GR, ncg);
  return (int)cudaGetLastError();
}

template <typename T>
int masked_stat(const void* t, const void* keep, const void* ids, const void* cnt,
                const void* lnw, const void* lnb, const void* w1, const void* b1, void* gxsq,
                int M, int C, int GR, const int* plan, cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  return with_mode(plan[0], [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    cudaError_t e = prepare(masked_fwd_stat_kernel<T, BM, MODE>, plan[3]);
    if (e != cudaSuccess) return (int)e;
    masked_fwd_stat_kernel<T, BM, MODE><<<dim3(plan[4], plan[5]), plan[2], plan[3], s>>>(
        (const T*)t, (const T*)keep, make_walk(ids, cnt, M, GR, BM), (const float*)lnw,
        (const float*)lnb, (const T*)w1, (const float*)b1, (float*)gxsq, C);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int masked_apply(const void* t, const void* x, const void* keep, const void* ids,
                 const void* cnt, const void* gxsq, const void* lnw, const void* lnb,
                 const void* w1, const void* b1, const void* gamma, const void* beta,
                 const void* w2, const void* b2, void* y, void* gx, void* nx, void* wide_acc,
                 int M, int C, int GR, const int* plan, cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  if (plan[0] == WIDE && wide_acc == nullptr) return (int)cudaErrorInvalidValue;
  return with_mode(plan[0], [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    cudaError_t e = prepare(masked_fwd_apply_kernel<T, BM, MODE>, plan[3]);
    if (e != cudaSuccess) return (int)e;
    masked_fwd_apply_kernel<T, BM, MODE><<<plan[4], plan[2], plan[3], s>>>(
        (const T*)t, (const T*)x, (const T*)keep, make_walk(ids, cnt, M, GR, BM),
        (const float*)gxsq, (const float*)lnw, (const float*)lnb, (const T*)w1,
        (const float*)b1, (const float*)gamma, (const float*)beta, (const T*)w2,
        (const float*)b2, (T*)y, (float*)gx, (float*)nx, (float*)wide_acc, C);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int masked_bstat(const void* t, const void* dy, const void* keep, const void* ids,
                 const void* cnt, const void* nx, const void* lnw, const void* lnb,
                 const void* w1, const void* b1, const void* gamma, const void* beta,
                 const void* w2t, void* do_out, void* h, void* db2, void* dgamma, void* dbeta,
                 void* dnx, int M, int C, int GR, const int* plan, cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  return with_mode(plan[0], [&](auto m) {
    constexpr int MODE = decltype(m)::value;
    cudaError_t e = prepare(masked_bwd_stat_kernel<T, BM, MODE>, plan[3]);
    if (e != cudaSuccess) return (int)e;
    masked_bwd_stat_kernel<T, BM, MODE><<<dim3(plan[4], plan[5]), plan[2], plan[3], s>>>(
        (const T*)t, (const T*)dy, (const T*)keep, make_walk(ids, cnt, M, GR, BM),
        (const float*)nx, (const float*)lnw, (const float*)lnb, (const T*)w1, (const float*)b1,
        (const float*)gamma, (const float*)beta, (const T*)w2t, (T*)do_out, (T*)h,
        (float*)db2, (float*)dgamma, (float*)dbeta, (float*)dnx, C);
    return (int)cudaGetLastError();
  });
}

// The dv pass on the kept-row list (masked) or on every row (spill-g D: ids,
// cnt and keep null, g the stored g).
template <typename T, int BM, int MODE, typename Src>
int dv_launch(const void* t, const void* do_in, const void* keep, const void* g, const Walk& wk,
              const void* nx, const void* dgxg, const void* lnw, const void* lnb, const void* w1,
              const void* b1, const void* gamma, const void* w2t, const void* w1t, void* dt,
              void* dv, void* u, void* db1, void* dlnw, void* dlnb, void* wide_acc, int C,
              const int* plan, cudaStream_t s) {
  cudaError_t e = prepare(bwd_dv_kernel<T, BM, MODE, Src>, plan[3]);
  if (e != cudaSuccess) return (int)e;
  bwd_dv_kernel<T, BM, MODE, Src><<<plan[4], plan[2], plan[3], s>>>(
      (const T*)t, (const T*)do_in, (const T*)keep, (const T*)g, wk, (const float*)nx,
      (const float*)dgxg, (const float*)lnw, (const float*)lnb, (const T*)w1, (const float*)b1,
      (const float*)gamma, (const T*)w2t, (const T*)w1t, (T*)dt, (T*)dv, (T*)u, (float*)db1,
      (float*)dlnw, (float*)dlnb, (float*)wide_acc, C);
  return (int)cudaGetLastError();
}

template <typename T>
int masked_dv(const void* t, const void* do_in, const void* keep, const void* ids,
              const void* cnt, const void* nx, const void* dgxg, const void* lnw,
              const void* lnb, const void* w1, const void* b1, const void* gamma,
              const void* w2t, const void* w1t, void* dt, void* dv, void* u, void* db1,
              void* dlnw, void* dlnb, void* wide_acc, int M, int C, int GR, const int* plan,
              cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  if (plan[0] == WIDE && wide_acc == nullptr) return (int)cudaErrorInvalidValue;
  const Walk wk = make_walk(ids, cnt, M, GR, BM);
  return with_mode(plan[0], [&](auto m) {
    return dv_launch<T, BM, decltype(m)::value, KeptRows>(t, do_in, keep, nullptr, wk, nx, dgxg, lnw,
                                                       lnb, w1, b1, gamma, w2t, w1t, dt, dv, u,
                                                       db1, dlnw, dlnb, wide_acc, C, plan, s);
  });
}

template <typename T>
int spillg_d(const void* t, const void* dy, const void* g, const void* nx, const void* dgxg,
             const void* lnw, const void* lnb, const void* w1, const void* b1,
             const void* gamma, const void* w2t, const void* w1t, void* dt, void* dv, void* u,
             void* db1, void* dlnw, void* dlnb, void* wide_acc, int M, int C, int GR,
             const int* plan, cudaStream_t s) {
  constexpr int BM = Cfg<T>::BM;
  if (plan[0] == WIDE && wide_acc == nullptr) return (int)cudaErrorInvalidValue;
  const Walk wk = spill_walk(M, GR, plan[1]);
  if (plan[1] == BM)
    return with_mode(plan[0], [&](auto m) {
      return dv_launch<T, BM, decltype(m)::value, SpillRows>(t, dy, nullptr, g, wk, nx, dgxg, lnw, lnb,
                                                        w1, b1, gamma, w2t, w1t, dt, dv, u, db1,
                                                        dlnw, dlnb, wide_acc, C, plan, s);
    });
  if constexpr (BM == 64) {
    if (plan[1] == BM / 2 && plan[0] == RING)
      return dv_launch<T, BM / 2, RING, SpillRows>(t, dy, nullptr, g, wk, nx, dgxg, lnw, lnb, w1, b1,
                                              gamma, w2t, w1t, dt, dv, u, db1, dlnw, dlnb,
                                              wide_acc, C, plan, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int spillg_c(const void* dy, const void* g, const void* nx, const void* gamma, const void* beta,
             const void* w2t, void* db2, void* dgamma, void* dbeta, void* dnx, void* dw2, int M,
             int C, int GR, const int* plan, cudaStream_t s) {
  if (plan[8] > 0 && dw2 == nullptr) return (int)cudaErrorInvalidValue;
  auto launch = [&](auto kernel) {
    cudaError_t e = prepare(kernel, plan[3]);
    if (e != cudaSuccess) return (int)e;
    kernel<<<plan[4], plan[2], plan[3], s>>>(
        (const T*)dy, (const T*)g, (const float*)nx, (const float*)gamma, (const float*)beta,
        (const T*)w2t, (float*)db2, (float*)dgamma, (float*)dbeta, (float*)dnx, (float*)dw2, M,
        C, GR);
    return (int)cudaGetLastError();
  };
  return with_tile<T>(plan[1], [&](auto b) {
    constexpr int BM = decltype(b)::value;
    if (plan[0] == RING)
      return plan[8] == 0 ? launch(spillg_bwd_c_kernel<T, BM, RING, 0>) : (int)cudaErrorInvalidValue;
    return with_mt(plan[8], [&](auto m) {
      return launch(spillg_bwd_c_kernel<T, BM, RES, decltype(m)::value>);
    });
  });
}

template <typename T>
int masked_atb(const void* X, const void* Y, const void* cnt, void* out, int M, int I, int J,
               int GR, int parts, cudaStream_t s) {
  const int nIT = (I + Cfg<T>::BM - 1) / Cfg<T>::BM, nJT = (J + TN - 1) / TN;
  const int ncg = chunks_per_group(GR);
  dim3 blocks(nIT * nJT, (M / GR) * ncg * parts);
  spillg_atb_kernel<T, true><<<blocks, Cfg<T>::BM * 2, 0, s>>>(
      (const T*)X, (const T*)Y, nullptr, nullptr, nullptr, (float*)out, M, I, J, GR, parts,
      nIT, (const int*)cnt, ncg);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: t, x, y, dy, dt, u (M, C); g, dv (M, 4C); gxsq, gx, nx, dnx, dgxg
// (M / GR, 4C) f32; weights in the activation dtype, w1 (4C, C), w2 (C, 4C),
// w1t = w1^T, w2t = w2^T, contiguous; every vector f32; dW2 (C, 4C) f32.  GR
// (rows per GRN group) divides M; C is a multiple of 8; every array is
// 16-byte aligned.  Outputs taken by atomicAdd (gxsq, db*, dgamma, dbeta,
// dnx, dln*, dW2, out) must be zeroed by the caller.
extern "C" int mm_spillg_fwd_a(const void* t, const void* lnw, const void* lnb, const void* w1,
                               const void* b1, void* g, void* gxsq, int M, int C, int GR,
                               int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return fwd_a<__nv_bfloat16>(t, lnw, lnb, w1, b1, g, gxsq, M, C, GR, s);
  return fwd_a<float>(t, lnw, lnb, w1, b1, g, gxsq, M, C, GR, s);
}

extern "C" int mm_spillg_fwd_b(const void* g, const void* x, const void* gxsq, const void* gamma,
                               const void* beta, const void* w2, const void* b2, void* y,
                               void* gx, void* nx, int M, int C, int GR, int is_bf16,
                               void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_b<__nv_bfloat16>(g, x, gxsq, gamma, beta, w2, b2, y, gx, nx, M, C, GR, s);
  return fwd_b<float>(g, x, gxsq, gamma, beta, w2, b2, y, gx, nx, M, C, GR, s);
}

// The plan of a persistent pass (kind 0 masked statistic, 1 apply, 2
// backward statistic, 3 dv; 4 spill-g C; 5 spill-g D) at this M, C, GR, as
// the int[9] of pass_plan.  Where the dv passes' mode is 2 (WIDE), they and
// the apply pass take wide_acc, plan[4] * plan[1] rows of Cp + 4 f32 (Cp: C
// rounded up to 16), else null.
extern "C" int mm_tail_plan(int kind, int M, int C, int GR, int is_bf16, int* plan) {
  if (C % 8 != 0 || kind < 0 || kind > K_SD) return (int)cudaErrorInvalidValue;
  return is_bf16 ? pass_plan<__nv_bfloat16>(kind, M, C, GR, 0, plan)
                 : pass_plan<float>(kind, M, C, GR, 0, plan);
}

// Row 9: db2, dgamma, dbeta, dnx and, where plan[8] > 0, dW2 (else dw2 may be
// null and dW2 is the mm_spillg_atb pass of dy and g with h_of).
extern "C" int mm_spillg_bwd_c(const void* dy, const void* g, const void* nx, const void* gamma,
                               const void* beta, const void* w2t, void* db2, void* dgamma,
                               void* dbeta, void* dnx, void* dw2, int M, int C, int GR,
                               int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return spillg_c<__nv_bfloat16>(dy, g, nx, gamma, beta, w2t, db2, dgamma, dbeta, dnx, dw2, M,
                                   C, GR, plan, s);
  return spillg_c<float>(dy, g, nx, gamma, beta, w2t, db2, dgamma, dbeta, dnx, dw2, M, C, GR,
                         plan, s);
}

// Row 10's row pass: dt, db1, dln_w, dln_b, and the dv and u of the dW1 pass.
extern "C" int mm_spillg_bwd_d(const void* t, const void* dy, const void* g, const void* nx,
                               const void* dgxg, const void* lnw, const void* lnb,
                               const void* w1, const void* b1, const void* gamma,
                               const void* w2t, const void* w1t, void* dt, void* dv, void* u,
                               void* db1, void* dlnw, void* dlnb, void* wide_acc, int M, int C,
                               int GR, int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return spillg_d<__nv_bfloat16>(t, dy, g, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t, dt, dv,
                                   u, db1, dlnw, dlnb, wide_acc, M, C, GR, plan, s);
  return spillg_d<float>(t, dy, g, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t, dt, dv, u, db1,
                         dlnw, dlnb, wide_acc, M, C, GR, plan, s);
}

// out (I, J) f32 += X^T Y; nx/gamma/beta null for plain Y, else Y is g and
// is turned into h on the fly.  rows_per_split is a multiple of 64.
extern "C" int mm_spillg_atb(const void* X, const void* Y, const void* nx, const void* gamma,
                             const void* beta, void* out, int M, int I, int J, int GR,
                             int rows_per_split, int splits, int is_bf16, void* stream) {
  if (I % 8 != 0 || J % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return atb<__nv_bfloat16>(X, Y, nx, gamma, beta, out, M, I, J, GR, rows_per_split, splits,
                              s);
  return atb<float>(X, Y, nx, gamma, beta, out, M, I, J, GR, rows_per_split, splits, s);
}

// The masked-dense tail.  keep (M) in the activation dtype; the kept-row
// list: ids (M) and cnt (M / GR * ceil(GR / 4096)) int32, from
// mm_masked_rows; do_out (M, C), h (M, 4C), dv (M, 4C) and u (M, C) in the
// activation dtype are written at the kept slots of the list (the operands
// of the dW2 and dW1 passes, mm_masked_atb).  plan: mm_tail_plan's for the
// pass at this M, C, GR.
extern "C" int mm_masked_rows(const void* keep, void* ids, void* cnt, int M, int GR, int is_bf16,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return masked_rows<__nv_bfloat16>(keep, ids, cnt, M, GR, s);
  return masked_rows<float>(keep, ids, cnt, M, GR, s);
}

extern "C" int mm_masked_fwd_stat(const void* t, const void* keep, const void* ids,
                                  const void* cnt, const void* lnw, const void* lnb,
                                  const void* w1, const void* b1, void* gxsq, int M, int C,
                                  int GR, int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_stat<__nv_bfloat16>(t, keep, ids, cnt, lnw, lnb, w1, b1, gxsq, M, C, GR, plan,
                                      s);
  return masked_stat<float>(t, keep, ids, cnt, lnw, lnb, w1, b1, gxsq, M, C, GR, plan, s);
}

extern "C" int mm_masked_fwd_apply(const void* t, const void* x, const void* keep,
                                   const void* ids, const void* cnt, const void* gxsq,
                                   const void* lnw, const void* lnb, const void* w1,
                                   const void* b1, const void* gamma, const void* beta,
                                   const void* w2, const void* b2, void* y, void* gx, void* nx,
                                   void* wide_acc, int M, int C, int GR, int is_bf16,
                                   const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_apply<__nv_bfloat16>(t, x, keep, ids, cnt, gxsq, lnw, lnb, w1, b1, gamma,
                                       beta, w2, b2, y, gx, nx, wide_acc, M, C, GR, plan, s);
  return masked_apply<float>(t, x, keep, ids, cnt, gxsq, lnw, lnb, w1, b1, gamma, beta, w2, b2,
                             y, gx, nx, wide_acc, M, C, GR, plan, s);
}

extern "C" int mm_masked_bwd_stat(const void* t, const void* dy, const void* keep,
                                  const void* ids, const void* cnt, const void* nx,
                                  const void* lnw, const void* lnb, const void* w1,
                                  const void* b1, const void* gamma, const void* beta,
                                  const void* w2t, void* do_out, void* h, void* db2,
                                  void* dgamma, void* dbeta, void* dnx, int M, int C, int GR,
                                  int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_bstat<__nv_bfloat16>(t, dy, keep, ids, cnt, nx, lnw, lnb, w1, b1, gamma, beta,
                                       w2t, do_out, h, db2, dgamma, dbeta, dnx, M, C, GR, plan,
                                       s);
  return masked_bstat<float>(t, dy, keep, ids, cnt, nx, lnw, lnb, w1, b1, gamma, beta, w2t,
                             do_out, h, db2, dgamma, dbeta, dnx, M, C, GR, plan, s);
}

extern "C" int mm_masked_bwd_dv(const void* t, const void* do_in, const void* keep,
                                const void* ids, const void* cnt, const void* nx,
                                const void* dgxg, const void* lnw, const void* lnb,
                                const void* w1, const void* b1, const void* gamma,
                                const void* w2t, const void* w1t, void* dt, void* dv, void* u,
                                void* db1, void* dlnw, void* dlnb, void* wide_acc, int M, int C,
                                int GR, int is_bf16, const int* plan, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_dv<__nv_bfloat16>(t, do_in, keep, ids, cnt, nx, dgxg, lnw, lnb, w1, b1, gamma,
                                    w2t, w1t, dt, dv, u, db1, dlnw, dlnb, wide_acc, M, C, GR,
                                    plan, s);
  return masked_dv<float>(t, do_in, keep, ids, cnt, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t,
                          dt, dv, u, db1, dlnw, dlnb, wide_acc, M, C, GR, plan, s);
}

// out (I, J) f32 += X^T Y over the kept slots of the list (X (M, I), Y (M,
// J) at the slots), each chunk's split over `parts` blocks.
extern "C" int mm_masked_atb(const void* X, const void* Y, const void* cnt, void* out, int M,
                             int I, int J, int GR, int parts, int is_bf16, void* stream) {
  if (I % 8 != 0 || J % 8 != 0 || parts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return masked_atb<__nv_bfloat16>(X, Y, cnt, out, M, I, J, GR, parts, s);
  return masked_atb<float>(X, Y, cnt, out, M, I, J, GR, parts, s);
}
