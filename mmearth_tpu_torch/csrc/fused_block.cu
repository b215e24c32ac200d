// The spill-g block tail of the gathered encoder: LN -> Linear(C, 4C) -> erf
// GELU -> GRN (grouped L2 over the rows) -> Linear(4C, C) -> + residual, and
// its VJP, on (M, C) rows in bf16 (or f32) with f32 params.
//
// Replaces the Pallas kernels of mmearth_tpu/ops/fused_block.py:
//   spillg_fwd_a_kernel  <- _sg_fwd_a_kernel (:381, called at :538)
//   spillg_fwd_b_kernel  <- _sg_fwd_b_kernel (:411, called at :552)
//   spillg_bwd_c_kernel  <- _sg_bwd_c_kernel (:423, called at :580), all but dW2
//   spillg_atb_kernel    <- the dW2 sum of _sg_bwd_c_kernel (:448) and the dW1
//                           sum of _sg_bwd_d_kernel (:494): out += X^T Y over rows
//   spillg_bwd_d_kernel  <- _sg_bwd_d_kernel (:463, called at :608), all but dW1
//
// Numerics follow the Pallas kernels: every product takes operands rounded to
// the activation dtype and sums in f32 (_mm, fused_block.py:69-81), on the
// bf16 tensor cores (mma.sync m16n8k16) for bf16 and as plain f32 FMAs for
// f32; LN and GRN eps 1e-6; g is stored in the activation dtype and the GRN
// sum of squares is taken over the stored value (:397-404); erf is erff
// (the Pallas kernel uses a polynomial with |error| <= 1.5e-7).
//
// Bound on the H100: each of the 2 (forward) and 6 (backward, counting the
// recomputed v and dh) products is 2*M*C*4C flops against ~2-3 bytes of
// (M, C) / (M, 4C) traffic per row element: at C = 40 (stage 0) the bytes
// bound every kernel (~37-52 us at 3.35 TB/s); at C = 320 the products do
// (D: ~16 us at 989 TFLOP/s).  The design keeps every 4C-wide intermediate
// except the spilled g (and, in the backward, dv) out of device memory: a
// block owns BM rows of one GRN group and walks the 4C columns in tiles of 64,
// with the C-wide operand of its rows resident in shared memory.  A, B and C
// also split a row block's output columns over blockIdx.y, so that the stages
// with few rows (C = 160, 320) still fill the card; D cannot (its du needs
// every column) and runs twice the warps instead.  Operands are staged with
// 16-byte loads, and g and dv go to and from device memory through shared
// memory so that those accesses are coalesced.  dW1 needs dv, which only the
// end of D's row pass has: D stores dv and u (rounded to the product type,
// as _mm rounds them) and a second launch sums dv^T u, one (M, 4C) + (M, C)
// write and read more than the Pallas kernel, whose dW1 accumulator stayed
// in VMEM.
//
// Width: a block keeps its rows' C-wide operands (and, in D, the f32 du of
// its rows) in shared memory, so that memory grows with C.  Each launch takes
// the largest row tile (64 rows in bf16, 32 in f32, halved down to 16) whose
// shared memory fits the card: at atto widths (C <= 320) every launch keeps
// its full tile; in bf16 D takes 32 rows above C = 368 and 16 above C = 784
// (f32: 16 above C = 384).  Where no tile of this resident layout fits (on
// the H100's 227 KB: D above C = 1616 in bf16 and 960 in f32, the masked dv
// pass above 1632 / 976, the masked apply above 1968 / 1440, the masked
// backward statistic above 3296 / 1472), the launch takes a wide plan at the
// full row tile (47-82 KB): the C-wide operands are staged one 64-column
// chunk at a time (u from where LN wrote it in device memory, dy and do from
// their arrays) and the f32 du (o in the masked apply) is summed in the
// block's own slice of a device-memory scratch (64 x 2816 f32, 721 KB, at
// huge's widest bf16 stage), read and written once per 64-column tile of
// 4C, through L2.  A (C <= 5992 bf16, 3248 f32), B and C fit every width JAX
// runs, so with the wide plans every stage up to huge's C = 2816 has a plan.

// Cross-block sums: the TPU carried its accumulators from one grid step to
// the next.  Blocks run in no order here, so every column sum (sum g^2 per
// group, db1, db2, dgamma, dbeta, dnx, dLN) is reduced inside the block
// (warp shuffles, then shared memory) and added to its f32 output with one
// atomicAdd per column and block; dW1/dW2 are split over rows (a few
// thousand rows per block) and each block adds its 64 x 64 tile once.  The
// atomics make the order of those sums vary from run to run (f32 noise of
// ~1e-6 of their scale).  The callers zero every atomic output.
//
// Phase A cannot finish the GRN statistic (it needs every block), so A and B
// are two launches and B takes sqrt and nx at its start.  The dgx step
// between C and D is (G, 4C) elementwise work left to the caller, as JAX
// leaves it to XLA.
//
// The masked-dense tail (fused_block_mlp: the same block tail on every site
// of the dense grid, with y = x + keep * (...) and the GRN statistic over the
// kept sites) replaces the two recompute-based Pallas kernels:
//   masked_fwd_stat_kernel   <- phase 0 of _fwd_kernel (:87, called at :263):
//                               A's body, summing (g * keep)^2 of the f32 g
//   masked_fwd_apply_kernel  <- phase 1 of _fwd_kernel: recomputes v and g,
//                               h in shared memory, o = h W2^T summed C-wide
//                               in shared memory, y = x + (o + b2) * keep
//   masked_bwd_stat_kernel   <- phase 0 of _bwd_kernel (:129, called at :302),
//                               all but dW2: stores do = dy * keep and h
//   spillg_atb_kernel        <- its dW2 sum (:175), h^T do
//   masked_bwd_dv_kernel     <- phase 1 of _bwd_kernel, all but dW1: D's body
//                               on do, with g = gelu(v) recomputed and the
//                               dgx term g * keep^2 * dgx/gx (:192)
//   spillg_atb_kernel        <- its dW1 sum (:194), dv^T u
// As on the TPU, g is never stored: the statistic is taken over the f32 g
// before any rounding, and each pass recomputes LN -> W1 -> GELU (one more
// product per pass) instead of moving (M, 4C) values through device memory.
// Bound: the forward reads t, x, keep and writes y (3 (M, C) passes in bf16,
// 194 MB at stage 0 of atto at batch 256) against 2 products of 2*M*C*4C;
// the backward reads t, dy, keep and writes dt against 5 products.  Stage 0
// is bound by bytes, the later stages by products.  Masked rows cost as much
// as kept ones (the Pallas kernel also computes them); their y is x exactly
// and their dt and every sum they enter are exactly 0, since do = 0 and g *
// keep = 0 there.
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
// MASKED (the first phase of the masked-dense forward): gxsq[grp] += sum of
// (g * keep)^2 over the f32 g, and nothing is stored.
// ---------------------------------------------------------------------------
template <typename T, int BM, bool MASKED>
__device__ __forceinline__ void fwd_a_body(const T* __restrict__ t, const float* __restrict__ lnw,
                                           const float* __restrict__ lnb,
                                           const T* __restrict__ w1, const float* __restrict__ b1,
                                           const T* __restrict__ keep, T* __restrict__ g,
                                           float* __restrict__ gxsq, int C, int C4, int GR,
                                           int tpg) {
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
        if (r < rw.nvalid && j < C4) {
          const float gf = gelu(acc[nt][e] + b1[j]);
          if constexpr (MASKED) gv = gf * to_f(keep[rw.row0 + r]);
          else gv = to_f(from_f<T>(gf));
        }
        if constexpr (!MASKED) sG[r * LDC + j - j0] = from_f<T>(gv);
        sq[nt][e] = gv * gv;
      }
    }
    col_sum<NW>(sq, red, gxsq + (size_t)rw.grp * C4 + j0, C4 - j0);  // also publishes sG
    if constexpr (!MASKED) {
      for (int i = threadIdx.x; i < BM * TN; i += blockDim.x) {  // coalesced store of g
        const int r = i / TN, jc = i - r * TN;
        if (r < rw.nvalid && j0 + jc < C4)
          g[(size_t)(rw.row0 + r) * C4 + j0 + jc] = sG[r * LDC + jc];
      }
    }
  }
}

// One signature for both, so that the host picks either by pointer.
#define FWD_A_PARAMS                                                                      \
  const T *__restrict__ t, const float *__restrict__ lnw, const float *__restrict__ lnb,   \
      const T *__restrict__ w1, const float *__restrict__ b1, const T *__restrict__ keep, \
      T *__restrict__ g, float *__restrict__ gxsq, int C, int C4, int GR, int tpg

template <typename T, int BM>
__global__ void __launch_bounds__(BM * 2) spillg_fwd_a_kernel(FWD_A_PARAMS) {
  fwd_a_body<T, BM, false>(t, lnw, lnb, w1, b1, keep, g, gxsq, C, C4, GR, tpg);
}

template <typename T, int BM>
__global__ void __launch_bounds__(BM * 2) masked_fwd_stat_kernel(FWD_A_PARAMS) {
  fwd_a_body<T, BM, true>(t, lnw, lnb, w1, b1, keep, g, gxsq, C, C4, GR, tpg);
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
// C: dh = dy W2 (recomputed per 64-column tile, never stored);
//    dgamma += sum dh*(g*nx), dbeta += sum dh, dnx[grp] += sum dh*gamma*g,
//    db2 += sum dy.
// ---------------------------------------------------------------------------
template <typename T, int BM>
__global__ void __launch_bounds__(BM * 2)
spillg_bwd_c_kernel(const T* __restrict__ dy, const T* __restrict__ g,
                    const float* __restrict__ nx, const float* __restrict__ gamma,
                    const T* __restrict__ w2t, float* __restrict__ db2,
                    float* __restrict__ dgamma, float* __restrict__ dbeta,
                    float* __restrict__ dnx, int C, int C4, int GR, int tpg) {
  constexpr int NW = BM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15, lda = Cp + 8;
  T* sDY = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + align16(sizeof(T) * BM * lda));
  T* sG = sB + TN * LDC;
  float* red = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sG) +
                                        align16(sizeof(T) * BM * LDC));
  const int w = threadIdx.x >> 5;
  const Rows rw = block_rows<BM>(GR, tpg);
  stage(sDY, lda, dy, C, rw.row0, BM, rw.row0 + rw.nvalid, 0, Cp, C);
  __syncthreads();
  for (int c = threadIdx.x; c < C && blockIdx.y == 0; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rw.nvalid; ++r) s += to_f(sDY[r * lda + c]);
    atomicAdd(db2 + c, s);
  }
  const float* nxg = nx + (size_t)rw.grp * C4;

  for (int j0 = blockIdx.y * TN; j0 < C4; j0 += gridDim.y * TN) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < Cp; k0 += KC) {
      const int kc = min(KC, Cp - k0);
      __syncthreads();
      if (k0 == 0) stage(sG, LDC, g, C4, rw.row0, BM, rw.row0 + rw.nvalid, j0, TN, C4);
      stage(sB, LDC, w2t, C, j0, TN, C4, k0, kc, C);
      __syncthreads();
      WarpMM<T>::run(sDY + w * 16 * lda + k0, lda, sB, LDC, kc, acc);
    }
    float a[8][4], b[8][4], d[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), j = j0 + frag_col(nt, e);
        float gv = 0.f, nxv = 0.f, gm = 0.f;
        if (r < rw.nvalid && j < C4) {
          gv = to_f(sG[r * LDC + j - j0]);
          nxv = nxg[j];
          gm = gamma[j];
        }
        const float dh = acc[nt][e];
        a[nt][e] = dh * (gv * nxv);
        b[nt][e] = dh;
        d[nt][e] = dh * gm * gv;
      }
    }
    col_sum<NW>(a, red, dgamma + j0, C4 - j0);
    col_sum<NW>(b, red, dbeta + j0, C4 - j0);
    col_sum<NW>(d, red, dnx + (size_t)rw.grp * C4 + j0, C4 - j0);
  }
}

// ---------------------------------------------------------------------------
// D: u, v = LN(t) W1^T + b1 and dh = dy W2 recomputed per 64-column tile;
//    dv = (dh*(gamma*nx + 1) + g*dgxg) * gelu'(v), stored rounded to T for
//    the dW1 pass; db1 += sum dv; du = dv W1 accumulated in shared memory;
//    dLN sums and dt = r*(da - mean da - uhat*mean(da*uhat)), da = du*lnw.
//    The rounded u is stored for the dW1 pass too.  Twice the warps of the
//    other kernels (each of BM/16 row-warps split over two 32-column halves
//    of a tile): the block holds the most shared memory, so few fit an SM.
//    MASKED (the second phase of the masked-dense backward): dy is the
//    stored do = dy * keep, and the g of the dgx term is g * keep^2 with g =
//    gelu(v) recomputed in f32 (no g is read).
//    WIDE (rows too wide for the resident layout): u and dy are staged one
//    64-column chunk at a time (u from u_out, which LN writes first) and du
//    is summed in the block's slice of wide_acc (BM x Cp f32 in device
//    memory, mostly held in L2) in place of shared memory.
// ---------------------------------------------------------------------------
#define BWD_D_PARAMS                                                                           \
  const T *__restrict__ t, const T *__restrict__ dy, const T *__restrict__ g,                 \
      const T *__restrict__ keep, const float *__restrict__ nx, const float *__restrict__ dgxg, \
      const float *__restrict__ lnw, const float *__restrict__ lnb, const T *__restrict__ w1,  \
      const float *__restrict__ b1, const float *__restrict__ gamma, const T *__restrict__ w2t, \
      const T *__restrict__ w1t, T *__restrict__ dt, T *__restrict__ dv_out,                   \
      T *__restrict__ u_out, float *__restrict__ db1, float *__restrict__ dlnw,               \
      float *__restrict__ dlnb, float *wide_acc, int C, int C4, int GR, int tpg

template <typename T, int BM, bool MASKED, bool WIDE>
__device__ __forceinline__ void bwd_d_body(BWD_D_PARAMS) {
  constexpr int NW = BM / 16, NTH = 4;  // row-warps; n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15, lda = WIDE ? LDC : Cp + 8;
  unsigned char* p = smem;
  T* sU = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * lda);
  T* sDY = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * lda);
  T* sB1 = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * TN * LDC);
  T* sB2 = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * TN * LDC);
  T* sDV = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * LDC);
  T* sG = reinterpret_cast<T*>(p);  // spill-g only: MASKED recomputes g
  if constexpr (!MASKED) p += align16(sizeof(T) * BM * LDC);
  float* sDU = reinterpret_cast<float*>(p);  // du of the block's rows
  if constexpr (WIDE) sDU = wide_acc + (size_t)blockIdx.x * BM * Cp;
  else p += align16(sizeof(float) * BM * Cp);
  float* sMean = reinterpret_cast<float*>(p);
  float* sRs = sMean + BM;
  float* red = sRs + BM;

  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5, nwt = blockDim.x >> 5;
  const int w = wt % NW, col = (wt / NW) * NTH * 8;  // row-warp; first column of the warp
  const Rows rw = block_rows<BM>(GR, tpg);
  layer_norm_rows<T, BM>(t, lnw, lnb, WIDE ? nullptr : sU, lda, C, Cp, rw, sMean, sRs, u_out);
  if constexpr (!WIDE) stage(sDY, lda, dy, C, rw.row0, BM, rw.row0 + rw.nvalid, 0, Cp, C);
  for (int i = threadIdx.x; i < BM * Cp; i += blockDim.x) sDU[i] = 0.f;
  const float* nxg = nx + (size_t)rw.grp * C4;
  const float* dgg = dgxg + (size_t)rw.grp * C4;

  for (int j0 = 0; j0 < C4; j0 += TN) {
    float av[NTH][4] = {}, ah[NTH][4] = {};
    for (int k0 = 0; k0 < Cp; k0 += KC) {
      const int kc = min(KC, Cp - k0), ka = WIDE ? 0 : k0;
      __syncthreads();
      if constexpr (!MASKED)
        if (k0 == 0) stage(sG, LDC, g, C4, rw.row0, BM, rw.row0 + rw.nvalid, j0, TN, C4);
      if constexpr (WIDE) {
        stage<T, true>(sU, LDC, u_out, C, rw.row0, BM, rw.row0 + rw.nvalid, k0, kc, C);
        stage(sDY, LDC, dy, C, rw.row0, BM, rw.row0 + rw.nvalid, k0, kc, C);
      }
      stage(sB1, LDC, w1, C, j0, TN, C4, k0, kc, C);
      stage(sB2, LDC, w2t, C, j0, TN, C4, k0, kc, C);
      __syncthreads();
      WarpMM<T>::run(sU + w * 16 * lda + ka, lda, sB1 + col * LDC, LDC, kc, av);
      WarpMM<T>::run(sDY + w * 16 * lda + ka, lda, sB2 + col * LDC, LDC, kc, ah);
    }
    float dvs[NTH][4];
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
        float dvv = 0.f;
        if (r < rw.nvalid && j < C4) {
          const float v = av[nt][e] + b1[j];
          float gv;  // the g of the dgx term
          if constexpr (MASKED) {
            const float k = to_f(keep[rw.row0 + r]);
            gv = gelu(v) * k * k;
          } else {
            gv = to_f(sG[r * LDC + jc]);
          }
          const float dg = ah[nt][e] * (gamma[j] * nxg[j] + 1.f) + gv * dgg[j];
          dvv = dg * gelu_grad(v);
        }
        const T q = from_f<T>(dvv);
        sDV[r * LDC + jc] = q;
        dvs[nt][e] = dvv;
      }
    }
    col_sum<NW, NTH>(dvs, red, db1 + j0, C4 - j0, col);  // also publishes sDV
    for (int i = threadIdx.x; i < BM * TN; i += blockDim.x) {  // coalesced store of dv
      const int r = i / TN, jc = i - r * TN;
      if (r < rw.nvalid && j0 + jc < C4)
        dv_out[(size_t)(rw.row0 + r) * C4 + j0 + jc] = sDV[r * LDC + jc];
    }
    const int kj = min(KC, C4 - j0);
    for (int c0 = 0; c0 < C; c0 += TN) {
      stage(sB1, LDC, w1t, C4, c0, TN, C, j0, kj, C4);
      __syncthreads();
      float acc[NTH][4] = {};
      WarpMM<T>::run(sDV + w * 16 * LDC, LDC, sB1 + col * LDC, LDC, kj, acc);
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), c = c0 + col + frag_col(nt, e);
          if (c < C) sDU[r * Cp + c] += acc[nt][e];
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();

  for (int r = wt; r < rw.nvalid; r += nwt) {
    const T* tr = t + (size_t)(rw.row0 + r) * C;
    const float mean = sMean[r], rs = sRs[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float uh = (to_f(tr[c]) - mean) * rs, da = sDU[r * Cp + c] * lnw[c];
      s1 += da;
      s2 += da * uh;
    }
    const float md = warp_sum(s1) / C, mdu = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float uh = (to_f(tr[c]) - mean) * rs, da = sDU[r * Cp + c] * lnw[c];
      dt[(size_t)(rw.row0 + r) * C + c] = from_f<T>(rs * (da - md - uh * mdu));
    }
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < rw.nvalid; ++r) {
      const float du = sDU[r * Cp + c];
      s1 += du * ((to_f(t[(size_t)(rw.row0 + r) * C + c]) - sMean[r]) * sRs[r]);
      s2 += du;
    }
    atomicAdd(dlnw + c, s1);
    atomicAdd(dlnb + c, s2);
  }
}

template <typename T, int BM, bool WIDE>
__global__ void __launch_bounds__(BM * 4) spillg_bwd_d_kernel(BWD_D_PARAMS) {
  bwd_d_body<T, BM, false, WIDE>(t, dy, g, keep, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t,
                                 dt, dv_out, u_out, db1, dlnw, dlnb, wide_acc, C, C4, GR, tpg);
}

template <typename T, int BM, bool WIDE>
__global__ void __launch_bounds__(BM * 4) masked_bwd_dv_kernel(BWD_D_PARAMS) {
  bwd_d_body<T, BM, true, WIDE>(t, dy, g, keep, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t,
                                dt, dv_out, u_out, db1, dlnw, dlnb, wide_acc, C, C4, GR, tpg);
}

// ---------------------------------------------------------------------------
// The masked-dense tail (rows 5-6 of the kernel table) runs on every site of
// the dense grid with a keep mask.  Its statistic pass is A's body (MASKED)
// and its dv pass is D's; the two kernels below are the rest.
//
// Masked apply (the second phase of _fwd_kernel): gx = sqrt(gxsq), nx; per
// 64-column tile of 4C, v = LN(t) W1^T + b1 is recomputed, h = gamma*(g*nx) +
// beta + g of the f32 g = gelu(v) is rounded to T in shared memory, and o +=
// h W2^T is summed in f32 in shared memory (C wide, D's du pattern); then y =
// x + (o + b2) * keep.  Tile 0 of each group writes gx and nx.  WIDE: as D's
// (u written to wide_u by LN and staged by chunk, o summed in the block's
// slice of wide_acc).
// ---------------------------------------------------------------------------
template <typename T, int BM, bool WIDE>
__global__ void __launch_bounds__(BM * 4)
masked_fwd_apply_kernel(const T* __restrict__ t, const T* __restrict__ x, const T* __restrict__ keep,
                        const float* __restrict__ gxsq, const float* __restrict__ lnw,
                        const float* __restrict__ lnb, const T* __restrict__ w1,
                        const float* __restrict__ b1, const float* __restrict__ gamma,
                        const float* __restrict__ beta, const T* __restrict__ w2,
                        const float* __restrict__ b2, T* __restrict__ y, float* __restrict__ gx_out,
                        float* __restrict__ nx_out, float* wide_acc, T* wide_u, int C, int C4,
                        int GR, int tpg) {
  constexpr int NW = BM / 16, NTH = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15, lda = WIDE ? LDC : Cp + 8;
  unsigned char* p = smem;
  T* sU = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * lda);
  T* sB = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * TN * LDC);
  T* sH = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * LDC);
  float* sO = reinterpret_cast<float*>(p);  // o of the block's rows
  if constexpr (WIDE) sO = wide_acc + (size_t)blockIdx.x * BM * Cp;
  else p += align16(sizeof(float) * BM * Cp);
  float* sNX = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * C4);
  float* red = reinterpret_cast<float*>(p);

  const int lane = threadIdx.x & 31, wt = threadIdx.x >> 5, nwt = blockDim.x >> 5;
  const int w = wt % NW, col = (wt / NW) * NTH * 8;
  const Rows rw = block_rows<BM>(GR, tpg);

  float part = 0.f;
  for (int j = threadIdx.x; j < C4; j += blockDim.x) {
    const float v = sqrtf(gxsq[(size_t)rw.grp * C4 + j]);
    sNX[j] = v;
    part += v;
  }
  part = warp_sum(part);
  if (lane == 0) red[wt] = part;
  __syncthreads();
  float total = 0.f;
  for (int i = 0; i < nwt; ++i) total += red[i];
  const float denom = total / C4 + GRN_EPS;
  for (int j = threadIdx.x; j < C4; j += blockDim.x) {
    const float gxv = sNX[j], nxv = gxv / denom;
    if (rw.tile == 0) {
      gx_out[(size_t)rw.grp * C4 + j] = gxv;
      nx_out[(size_t)rw.grp * C4 + j] = nxv;
    }
    sNX[j] = nxv;
  }
  layer_norm_rows<T, BM>(t, lnw, lnb, WIDE ? nullptr : sU, lda, C, Cp, rw, nullptr, nullptr,
                         WIDE ? wide_u : nullptr);
  for (int i = threadIdx.x; i < BM * Cp; i += blockDim.x) sO[i] = 0.f;

  for (int j0 = 0; j0 < C4; j0 += TN) {
    float av[NTH][4] = {};
    for (int k0 = 0; k0 < Cp; k0 += KC) {
      const int kc = min(KC, Cp - k0);
      __syncthreads();
      if constexpr (WIDE)
        stage<T, true>(sU, LDC, wide_u, C, rw.row0, BM, rw.row0 + rw.nvalid, k0, kc, C);
      stage(sB, LDC, w1, C, j0, TN, C4, k0, kc, C);
      __syncthreads();
      WarpMM<T>::run(sU + w * 16 * lda + (WIDE ? 0 : k0), lda, sB + col * LDC, LDC, kc, av);
    }
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
        float hv = 0.f;
        if (r < rw.nvalid && j < C4) hv = grn_h(gelu(av[nt][e] + b1[j]), sNX[j], gamma[j], beta[j]);
        sH[r * LDC + jc] = from_f<T>(hv);
      }
    }
    const int kj = min(KC, C4 - j0);
    for (int c0 = 0; c0 < C; c0 += TN) {
      __syncthreads();  // publishes sH; frees sB
      stage(sB, LDC, w2, C4, c0, TN, C, j0, kj, C4);
      __syncthreads();
      float acc[NTH][4] = {};
      WarpMM<T>::run(sH + w * 16 * LDC, LDC, sB + col * LDC, LDC, kj, acc);
#pragma unroll
      for (int nt = 0; nt < NTH; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = w * 16 + frag_row(e), c = c0 + col + frag_col(nt, e);
          if (c < C) sO[r * Cp + c] += acc[nt][e];  // each (r, c) has one owning warp
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rw.nvalid * C; i += blockDim.x) {
    const int r = i / C, c = i - r * C;
    const size_t o = (size_t)(rw.row0 + r) * C + c;
    y[o] = from_f<T>(to_f(x[o]) + (sO[r * Cp + c] + b2[c]) * to_f(keep[rw.row0 + r]));
  }
}

// ---------------------------------------------------------------------------
// Masked statistic pass of the backward (the first phase of _bwd_kernel):
// do = dy * keep, stored rounded to T (the operand of the dh and dW2
// products) with db2 += sum of the f32 do; per 64-column tile of 4C, v and
// dh = do W2 are recomputed, g = gelu(v) in f32, h = gamma*(g*nx) + beta + g
// is stored rounded to T for the dW2 pass, and dgamma += sum dh*(g*nx), dbeta
// += sum dh, dnx[grp] += sum dh*gamma*g.  D's warp layout.  WIDE: u (written
// to wide_u by LN) and do (from do_out) are staged one chunk at a time.
// ---------------------------------------------------------------------------
template <typename T, int BM, bool WIDE>
__global__ void __launch_bounds__(BM * 4)
masked_bwd_stat_kernel(const T* __restrict__ t, const T* __restrict__ dy, const T* __restrict__ keep,
                       const float* __restrict__ nx, const float* __restrict__ lnw,
                       const float* __restrict__ lnb, const T* __restrict__ w1,
                       const float* __restrict__ b1, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const T* __restrict__ w2t,
                       T* __restrict__ do_out, T* __restrict__ h_out, float* __restrict__ db2,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       float* __restrict__ dnx, T* wide_u, int C, int C4, int GR, int tpg) {
  constexpr int NW = BM / 16, NTH = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cp = (C + 15) & ~15, lda = WIDE ? LDC : Cp + 8;
  unsigned char* p = smem;
  T* sU = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * lda);
  T* sDO = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * lda);
  T* sB1 = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * TN * LDC);
  T* sB2 = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * TN * LDC);
  T* sH = reinterpret_cast<T*>(p);
  p += align16(sizeof(T) * BM * LDC);
  float* red = reinterpret_cast<float*>(p);

  const int wt = threadIdx.x >> 5;
  const int w = wt % NW, col = (wt / NW) * NTH * 8;
  const Rows rw = block_rows<BM>(GR, tpg);
  layer_norm_rows<T, BM>(t, lnw, lnb, WIDE ? nullptr : sU, lda, C, Cp, rw, nullptr, nullptr,
                         WIDE ? wide_u : nullptr);
  for (int i = threadIdx.x; i < BM * Cp; i += blockDim.x) {
    const int r = i / Cp, c = i - r * Cp;
    T q = from_f<T>(0.f);
    if (r < rw.nvalid && c < C) {
      const size_t o = (size_t)(rw.row0 + r) * C + c;
      q = from_f<T>(to_f(dy[o]) * to_f(keep[rw.row0 + r]));
      do_out[o] = q;
    }
    if constexpr (!WIDE) sDO[r * lda + c] = q;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rw.nvalid; ++r)
      s += to_f(dy[(size_t)(rw.row0 + r) * C + c]) * to_f(keep[rw.row0 + r]);
    atomicAdd(db2 + c, s);
  }
  const float* nxg = nx + (size_t)rw.grp * C4;

  for (int j0 = 0; j0 < C4; j0 += TN) {
    float av[NTH][4] = {}, ah[NTH][4] = {};
    for (int k0 = 0; k0 < Cp; k0 += KC) {
      const int kc = min(KC, Cp - k0), ka = WIDE ? 0 : k0;
      __syncthreads();
      if constexpr (WIDE) {
        stage<T, true>(sU, LDC, wide_u, C, rw.row0, BM, rw.row0 + rw.nvalid, k0, kc, C);
        stage<T, true>(sDO, LDC, do_out, C, rw.row0, BM, rw.row0 + rw.nvalid, k0, kc, C);
      }
      stage(sB1, LDC, w1, C, j0, TN, C4, k0, kc, C);
      stage(sB2, LDC, w2t, C, j0, TN, C4, k0, kc, C);
      __syncthreads();
      WarpMM<T>::run(sU + w * 16 * lda + ka, lda, sB1 + col * LDC, LDC, kc, av);
      WarpMM<T>::run(sDO + w * 16 * lda + ka, lda, sB2 + col * LDC, LDC, kc, ah);
    }
    float a[NTH][4], b[NTH][4], d[NTH][4];
#pragma unroll
    for (int nt = 0; nt < NTH; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = w * 16 + frag_row(e), jc = col + frag_col(nt, e), j = j0 + jc;
        float gv = 0.f, nxv = 0.f, gm = 0.f, hv = 0.f;
        if (r < rw.nvalid && j < C4) {
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
    col_sum<NW, NTH>(a, red, dgamma + j0, C4 - j0, col);  // also publishes sH
    col_sum<NW, NTH>(b, red, dbeta + j0, C4 - j0, col);
    col_sum<NW, NTH>(d, red, dnx + (size_t)rw.grp * C4 + j0, C4 - j0, col);
    for (int i = threadIdx.x; i < BM * TN; i += blockDim.x) {  // coalesced store of h
      const int r = i / TN, jc = i - r * TN;
      if (r < rw.nvalid && j0 + jc < C4)
        h_out[(size_t)(rw.row0 + r) * C4 + j0 + jc] = sH[r * LDC + jc];
    }
  }
}

// ---------------------------------------------------------------------------
// out (I, J) += X^T Y over rows [s*rps, (s+1)*rps): X (M, I), Y (M, J).  With
// nx given, Y is g and each element becomes h = gamma*(g*nx[grp]) + beta + g
// (rounded to T) as it is staged.  Block: BM x 64 output tile, one row split.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(Cfg<T>::BM * 2)
spillg_atb_kernel(const T* __restrict__ X, const T* __restrict__ Y, const float* __restrict__ nx,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  float* __restrict__ out, int M, int I, int J, int GR, int rps, int nIT) {
  constexpr int BM = Cfg<T>::BM;
  __shared__ __align__(16) T sA[BM * LDC];
  __shared__ __align__(16) T sB[TN * LDC];
  const int w = threadIdx.x >> 5;
  const int it = blockIdx.x % nIT, jt = blockIdx.x / nIT;
  const int i0 = it * BM, j0 = jt * TN;
  const int m0 = blockIdx.y * rps, m1 = min(M, m0 + rps);
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
// Shared memory of A and C (rows_smem), D (d_smem; MASKED: the dv pass, which
// holds no g tile) and B (b_smem) at a row tile of BM rows; WIDE: the plan
// that stages the C-wide operands by chunk and keeps du (o) in device memory.
template <typename T> size_t rows_smem(int C, int BM) {
  const int lda = ((C + 15) & ~15) + 8;
  return align16(sizeof(T) * BM * lda) + sizeof(T) * TN * LDC +
         align16(sizeof(T) * BM * LDC) + sizeof(float) * (BM / 16) * 64;
}

template <typename T, bool MASKED, bool WIDE> size_t d_smem(int C, int BM) {
  const int Cp = (C + 15) & ~15, lda = WIDE ? LDC : Cp + 8;
  return 2 * align16(sizeof(T) * BM * lda) + 2 * align16(sizeof(T) * TN * LDC) +
         (MASKED ? 1 : 2) * align16(sizeof(T) * BM * LDC) +
         (WIDE ? 0 : align16(sizeof(float) * BM * Cp)) + sizeof(float) * (2 * BM + (BM / 16) * 64);
}

template <typename T> size_t b_smem(int C) {
  return align16(sizeof(float) * (4 * C + 32)) + sizeof(T) * (Cfg<T>::BM + TN) * LDC;
}

template <typename T, bool WIDE> size_t apply_smem(int C, int BM) {  // masked apply
  const int Cp = (C + 15) & ~15, lda = WIDE ? LDC : Cp + 8;
  return align16(sizeof(T) * BM * lda) + align16(sizeof(T) * TN * LDC) +
         align16(sizeof(T) * BM * LDC) + (WIDE ? 0 : align16(sizeof(float) * BM * Cp)) +
         align16(sizeof(float) * 4 * C) + sizeof(float) * 32;
}

template <typename T, bool WIDE> size_t bstat_smem(int C, int BM) {  // masked backward statistic
  const int lda = WIDE ? LDC : ((C + 15) & ~15) + 8;
  return 2 * align16(sizeof(T) * BM * lda) + 2 * align16(sizeof(T) * TN * LDC) +
         align16(sizeof(T) * BM * LDC) + sizeof(float) * (BM / 16) * 64;
}

size_t smem_limit() {  // opt-in shared memory per block of the current device
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)v;
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

// The row plan of a launch with a wide form (D, the masked dv, apply and
// statistic passes): the largest row tile of the resident layout that fits
// (today's plan wherever it fits), else the largest tile of the wide layout.
struct RowPlan {
  int bm;
  bool wide;
};
template <typename T> RowPlan row_plan(size_t (*resident)(int, int), size_t (*wide)(int, int),
                                       int C, size_t limit) {
  const int bm = pick_bm<T>(resident, C, limit);
  if (bm) return {bm, false};
  return {pick_bm<T>(wide, C, limit), true};
}

// f(bm, std::bool_constant<wide>) for a row plan.
template <typename T, typename F> int with_plan(RowPlan plan, F f) {
  if (plan.wide) return with_bm<T>(plan.bm, [&](auto bm) { return f(bm, std::true_type{}); });
  return with_bm<T>(plan.bm, [&](auto bm) { return f(bm, std::false_type{}); });
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

template <typename T, bool MASKED>
int fwd_a(const void* t, const void* lnw, const void* lnb, const void* w1, const void* b1,
          const void* keep, void* g, void* gxsq, int M, int C, int GR, cudaStream_t s) {
  return with_bm<T>(pick_bm<T>(rows_smem<T>, C, smem_limit()), [&](auto bm) {
    constexpr int BM = decltype(bm)::value;
    const size_t smem = rows_smem<T>(C, BM);
    auto kernel = MASKED ? masked_fwd_stat_kernel<T, BM> : spillg_fwd_a_kernel<T, BM>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid_2d(M, GR, 4 * C, BM), BM * 2, smem, s>>>(
        (const T*)t, (const float*)lnw, (const float*)lnb, (const T*)w1, (const float*)b1,
        (const T*)keep, (T*)g, (float*)gxsq, C, 4 * C, GR, (GR + BM - 1) / BM);
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
int bwd_c(const void* dy, const void* g, const void* nx, const void* gamma, const void* w2t,
          void* db2, void* dgamma, void* dbeta, void* dnx, int M, int C, int GR,
          cudaStream_t s) {
  return with_bm<T>(pick_bm<T>(rows_smem<T>, C, smem_limit()), [&](auto bm) {
    constexpr int BM = decltype(bm)::value;
    const size_t smem = rows_smem<T>(C, BM);
    cudaError_t e = prepare(spillg_bwd_c_kernel<T, BM>, smem);
    if (e != cudaSuccess) return (int)e;
    spillg_bwd_c_kernel<T, BM><<<grid_2d(M, GR, 4 * C, BM), BM * 2, smem, s>>>(
        (const T*)dy, (const T*)g, (const float*)nx, (const float*)gamma, (const T*)w2t,
        (float*)db2, (float*)dgamma, (float*)dbeta, (float*)dnx, C, 4 * C, GR,
        (GR + BM - 1) / BM);
    return (int)cudaGetLastError();
  });
}

template <typename T, bool MASKED> RowPlan d_plan(int C) {
  return row_plan<T>(d_smem<T, MASKED, false>, d_smem<T, MASKED, true>, C, smem_limit());
}

template <typename T, bool MASKED>
int bwd_d(const void* t, const void* dy, const void* g, const void* keep, const void* nx,
          const void* dgxg, const void* lnw, const void* lnb, const void* w1, const void* b1,
          const void* gamma, const void* w2t, const void* w1t, void* dt, void* dv, void* u,
          void* db1, void* dlnw, void* dlnb, void* wide_acc, int M, int C, int GR,
          cudaStream_t s) {
  const RowPlan plan = d_plan<T, MASKED>(C);
  if (plan.wide && wide_acc == nullptr) return (int)cudaErrorInvalidValue;
  return with_plan<T>(plan, [&](auto bm, auto wide) {
    constexpr int BM = decltype(bm)::value;
    constexpr bool WIDE = decltype(wide)::value;
    const size_t smem = d_smem<T, MASKED, WIDE>(C, BM);
    auto kernel = MASKED ? masked_bwd_dv_kernel<T, BM, WIDE> : spillg_bwd_d_kernel<T, BM, WIDE>;
    cudaError_t e = prepare(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid_rows(M, GR, BM), BM * 4, smem, s>>>(
        (const T*)t, (const T*)dy, (const T*)g, (const T*)keep, (const float*)nx,
        (const float*)dgxg, (const float*)lnw, (const float*)lnb, (const T*)w1,
        (const float*)b1, (const float*)gamma, (const T*)w2t, (const T*)w1t, (T*)dt, (T*)dv,
        (T*)u, (float*)db1, (float*)dlnw, (float*)dlnb, (float*)wide_acc, C, 4 * C, GR,
        (GR + BM - 1) / BM);
    return (int)cudaGetLastError();
  });
}

template <typename T> RowPlan apply_plan(int C) {
  return row_plan<T>(apply_smem<T, false>, apply_smem<T, true>, C, smem_limit());
}

template <typename T>
int masked_apply(const void* t, const void* x, const void* keep, const void* gxsq,
                 const void* lnw, const void* lnb, const void* w1, const void* b1,
                 const void* gamma, const void* beta, const void* w2, const void* b2, void* y,
                 void* gx, void* nx, void* wide_acc, void* wide_u, int M, int C, int GR,
                 cudaStream_t s) {
  const RowPlan plan = apply_plan<T>(C);
  if (plan.wide && (wide_acc == nullptr || wide_u == nullptr)) return (int)cudaErrorInvalidValue;
  return with_plan<T>(plan, [&](auto bm, auto wide) {
    constexpr int BM = decltype(bm)::value;
    constexpr bool WIDE = decltype(wide)::value;
    const size_t smem = apply_smem<T, WIDE>(C, BM);
    cudaError_t e = prepare(masked_fwd_apply_kernel<T, BM, WIDE>, smem);
    if (e != cudaSuccess) return (int)e;
    masked_fwd_apply_kernel<T, BM, WIDE><<<grid_rows(M, GR, BM), BM * 4, smem, s>>>(
        (const T*)t, (const T*)x, (const T*)keep, (const float*)gxsq, (const float*)lnw,
        (const float*)lnb, (const T*)w1, (const float*)b1, (const float*)gamma,
        (const float*)beta, (const T*)w2, (const float*)b2, (T*)y, (float*)gx, (float*)nx,
        (float*)wide_acc, (T*)wide_u, C, 4 * C, GR, (GR + BM - 1) / BM);
    return (int)cudaGetLastError();
  });
}

template <typename T> RowPlan bstat_plan(int C) {
  return row_plan<T>(bstat_smem<T, false>, bstat_smem<T, true>, C, smem_limit());
}

template <typename T>
int masked_bstat(const void* t, const void* dy, const void* keep, const void* nx,
                 const void* lnw, const void* lnb, const void* w1, const void* b1,
                 const void* gamma, const void* beta, const void* w2t, void* do_out, void* h,
                 void* db2, void* dgamma, void* dbeta, void* dnx, void* wide_u, int M, int C,
                 int GR, cudaStream_t s) {
  const RowPlan plan = bstat_plan<T>(C);
  if (plan.wide && wide_u == nullptr) return (int)cudaErrorInvalidValue;
  return with_plan<T>(plan, [&](auto bm, auto wide) {
    constexpr int BM = decltype(bm)::value;
    constexpr bool WIDE = decltype(wide)::value;
    const size_t smem = bstat_smem<T, WIDE>(C, BM);
    cudaError_t e = prepare(masked_bwd_stat_kernel<T, BM, WIDE>, smem);
    if (e != cudaSuccess) return (int)e;
    masked_bwd_stat_kernel<T, BM, WIDE><<<grid_rows(M, GR, BM), BM * 4, smem, s>>>(
        (const T*)t, (const T*)dy, (const T*)keep, (const float*)nx, (const float*)lnw,
        (const float*)lnb, (const T*)w1, (const float*)b1, (const float*)gamma,
        (const float*)beta, (const T*)w2t, (T*)do_out, (T*)h, (float*)db2, (float*)dgamma,
        (float*)dbeta, (float*)dnx, (T*)wide_u, C, 4 * C, GR, (GR + BM - 1) / BM);
    return (int)cudaGetLastError();
  });
}

template <typename T> int wide_bm(int kind, int C) {
  const RowPlan plan = kind == 0   ? d_plan<T, false>(C)
                       : kind == 1 ? d_plan<T, true>(C)
                       : kind == 2 ? apply_plan<T>(C)
                                   : bstat_plan<T>(C);
  return plan.wide ? plan.bm : 0;
}

template <typename T>
int atb(const void* X, const void* Y, const void* nx, const void* gamma, const void* beta,
        void* out, int M, int I, int J, int GR, int rps, int splits, cudaStream_t s) {
  if (rps % KC != 0) return (int)cudaErrorInvalidValue;
  const int nIT = (I + Cfg<T>::BM - 1) / Cfg<T>::BM, nJT = (J + TN - 1) / TN;
  dim3 blocks(nIT * nJT, splits);
  spillg_atb_kernel<T><<<blocks, Cfg<T>::BM * 2, 0, s>>>(
      (const T*)X, (const T*)Y, (const float*)nx, (const float*)gamma, (const float*)beta,
      (float*)out, M, I, J, GR, rps, nIT);
  return (int)cudaGetLastError();
}

}  // namespace

// Shapes: t, x, y, dy, dt (M, C); g, dv (M, 4C); gxsq, gx, nx, dnx, dgxg
// (M / GR, 4C) f32; weights in the activation dtype, w1 (4C, C), w2 (C, 4C),
// w1t = w1^T, w2t = w2^T, contiguous; every vector f32.  GR (rows per GRN
// group) divides M; C is a multiple of 8; every array is 16-byte aligned.
// Outputs taken by atomicAdd (gxsq, db*, dgamma, dbeta, dnx, dln*, out) must
// be zeroed by the caller.  Where mm_fused_wide_bm gives a launch a wide plan
// of BM rows, it takes scratch from the caller: wide_acc, (M / GR) * ceil(GR
// / BM) * BM rows of Cp = C rounded up to 16 f32 values; wide_u, (M, C) in
// the activation dtype.  Elsewhere they may be null.
extern "C" int mm_spillg_fwd_a(const void* t, const void* lnw, const void* lnb, const void* w1,
                               const void* b1, void* g, void* gxsq, int M, int C, int GR,
                               int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_a<__nv_bfloat16, false>(t, lnw, lnb, w1, b1, nullptr, g, gxsq, M, C, GR, s);
  return fwd_a<float, false>(t, lnw, lnb, w1, b1, nullptr, g, gxsq, M, C, GR, s);
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

extern "C" int mm_spillg_bwd_c(const void* dy, const void* g, const void* nx, const void* gamma,
                               const void* w2t, void* db2, void* dgamma, void* dbeta, void* dnx,
                               int M, int C, int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return bwd_c<__nv_bfloat16>(dy, g, nx, gamma, w2t, db2, dgamma, dbeta, dnx, M, C, GR, s);
  return bwd_c<float>(dy, g, nx, gamma, w2t, db2, dgamma, dbeta, dnx, M, C, GR, s);
}

extern "C" int mm_spillg_bwd_d(const void* t, const void* dy, const void* g, const void* nx,
                               const void* dgxg, const void* lnw, const void* lnb,
                               const void* w1, const void* b1, const void* gamma,
                               const void* w2t, const void* w1t, void* dt, void* dv, void* u,
                               void* db1, void* dlnw, void* dlnb, void* wide_acc, int M, int C,
                               int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return bwd_d<__nv_bfloat16, false>(t, dy, g, nullptr, nx, dgxg, lnw, lnb, w1, b1, gamma,
                                       w2t, w1t, dt, dv, u, db1, dlnw, dlnb, wide_acc, M, C, GR,
                                       s);
  return bwd_d<float, false>(t, dy, g, nullptr, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t, w1t,
                             dt, dv, u, db1, dlnw, dlnb, wide_acc, M, C, GR, s);
}

// The row tile of the wide plan a launch takes at width C on the current
// device, or 0 where its resident plan fits (and it takes no scratch).  kind:
// 0 the spill-g D row pass, 1 the masked dv pass, 2 the masked apply pass,
// 3 the masked statistic pass of the backward.
extern "C" int mm_fused_wide_bm(int kind, int C, int is_bf16) {
  return is_bf16 ? wide_bm<__nv_bfloat16>(kind, C) : wide_bm<float>(kind, C);
}

// The masked-dense tail.  keep (M) in the activation dtype; gxsq, gx, nx,
// dnx, dgxg (M / GR, 4C) f32; do_out (M, C) and h (M, 4C) in the activation
// dtype are the dW2 pass's operands, and dv, u (as in D) the dW1 pass's;
// both passes are mm_spillg_atb with null nx.
extern "C" int mm_masked_fwd_stat(const void* t, const void* keep, const void* lnw,
                                  const void* lnb, const void* w1, const void* b1, void* gxsq,
                                  int M, int C, int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return fwd_a<__nv_bfloat16, true>(t, lnw, lnb, w1, b1, keep, nullptr, gxsq, M, C, GR, s);
  return fwd_a<float, true>(t, lnw, lnb, w1, b1, keep, nullptr, gxsq, M, C, GR, s);
}

extern "C" int mm_masked_fwd_apply(const void* t, const void* x, const void* keep,
                                   const void* gxsq, const void* lnw, const void* lnb,
                                   const void* w1, const void* b1, const void* gamma,
                                   const void* beta, const void* w2, const void* b2, void* y,
                                   void* gx, void* nx, void* wide_acc, void* wide_u, int M,
                                   int C, int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_apply<__nv_bfloat16>(t, x, keep, gxsq, lnw, lnb, w1, b1, gamma, beta, w2, b2,
                                       y, gx, nx, wide_acc, wide_u, M, C, GR, s);
  return masked_apply<float>(t, x, keep, gxsq, lnw, lnb, w1, b1, gamma, beta, w2, b2, y, gx,
                             nx, wide_acc, wide_u, M, C, GR, s);
}

extern "C" int mm_masked_bwd_stat(const void* t, const void* dy, const void* keep,
                                  const void* nx, const void* lnw, const void* lnb,
                                  const void* w1, const void* b1, const void* gamma,
                                  const void* beta, const void* w2t, void* do_out, void* h,
                                  void* db2, void* dgamma, void* dbeta, void* dnx, void* wide_u,
                                  int M, int C, int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return masked_bstat<__nv_bfloat16>(t, dy, keep, nx, lnw, lnb, w1, b1, gamma, beta, w2t,
                                       do_out, h, db2, dgamma, dbeta, dnx, wide_u, M, C, GR, s);
  return masked_bstat<float>(t, dy, keep, nx, lnw, lnb, w1, b1, gamma, beta, w2t, do_out, h,
                             db2, dgamma, dbeta, dnx, wide_u, M, C, GR, s);
}

extern "C" int mm_masked_bwd_dv(const void* t, const void* do_in, const void* keep,
                                const void* nx, const void* dgxg, const void* lnw,
                                const void* lnb, const void* w1, const void* b1,
                                const void* gamma, const void* w2t, const void* w1t, void* dt,
                                void* dv, void* u, void* db1, void* dlnw, void* dlnb,
                                void* wide_acc, int M, int C, int GR, int is_bf16, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return bwd_d<__nv_bfloat16, true>(t, do_in, nullptr, keep, nx, dgxg, lnw, lnb, w1, b1,
                                      gamma, w2t, w1t, dt, dv, u, db1, dlnw, dlnb, wide_acc, M,
                                      C, GR, s);
  return bwd_d<float, true>(t, do_in, nullptr, keep, nx, dgxg, lnw, lnb, w1, b1, gamma, w2t,
                            w1t, dt, dv, u, db1, dlnw, dlnb, wide_acc, M, C, GR, s);
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
