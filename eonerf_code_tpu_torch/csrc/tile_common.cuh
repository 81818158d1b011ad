// Device code shared by the port's two CUDA sources: fused_render.cu (the
// production kernels) and kernel_variants.cu (the kernel-variant bench, which
// measures that design's costs one by one). The tile machinery: the 128-row
// bf16 activation tiles and their stride, the mma.sync products with weights
// staged 32 deep (gemm, dgemm), the trunk over a tile, the PE lanes, the
// packed weight layout, the fixed-order reduction of per-block partial sums,
// and the int8 pieces (mma, quantization, the group amax fold).
//
// The build (ops/_build.py) hashes every .cuh beside the sources, so an edit
// here rebuilds both libraries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int W = 256;        // trunk width
constexpr int PE = 64;        // PE width: 63 lanes + one zero lane
constexpr int HALF = 128;     // head width
constexpr int CAT = W + PE;   // layer-5 input and transient input width
constexpr int MT = 128;       // sample rows per tile: 8 warps x 16 rows
constexpr int THREADS = 256;
constexpr int LDA = CAT + 8;  // activation row stride; +8 keeps fragment loads conflict-free
constexpr int KC = 32;        // depth of one staged weight chunk
constexpr int LDW = KC + 8;   // staged weight row stride
constexpr int NC = 128;       // output columns per pass
// per-sample results kept in shared memory: sigma, albedo x3, t_s, t_beta,
// and (backward) transmittance and d_weight
constexpr int RES = 8;
constexpr float HALF_PI = 1.57079632679489661923f;

// Backward scratch streams, one bf16 row per sample (row ray * KPAD + k).
// Activations: [h0..h4 | pe | h5..h7 | bott | emb64 | albedo hidden | t0..t3],
// laid out so that each layer's input is one contiguous column range
// ([h4 | pe] for trunk layer 5, [bott | emb64] for the transient head).
constexpr int A_PE = 5 * W;                 // 1280
constexpr int A_BOTT = 8 * W + PE;          // 2112
constexpr int A_AH = A_BOTT + CAT;          // 2432
constexpr int A_T0 = A_AH + HALF;           // 2560
constexpr int ACT_CAM = A_T0 + 4 * HALF;    // 3072 columns (camera)
constexpr int ACT_SH = A_BOTT;              // 2112 columns (shadow: trunk and pe)
constexpr int WG_TILE = 128;                // weight-gradient output tile (in x out)
constexpr int MAX_SPLITS = 16;              // sample splits of the weight-gradient sums

// Matrix offsets (elements) in the packed bf16 buffer, each matrix (out, in)
// row-major. The density prefix (trunk + sigma head) ends at M_BOTT.
constexpr long long M_T0 = 0;
constexpr long long M_T1 = M_T0 + (long long)W * PE;
constexpr long long M_T5 = M_T1 + 4LL * W * W;
constexpr long long M_T6 = M_T5 + (long long)W * CAT;
constexpr long long M_SIG = M_T6 + 2LL * W * W;
constexpr long long M_BOTT = M_SIG + W;
constexpr long long M_ALB0 = M_BOTT + (long long)W * W;
constexpr long long M_ALB1 = M_ALB0 + (long long)HALF * W;
constexpr long long M_TR0 = M_ALB1 + 3LL * HALF;
constexpr long long M_TR1 = M_TR0 + (long long)HALF * CAT;
constexpr long long M_TS = M_TR1 + 3LL * HALF * HALF;
constexpr long long M_TB = M_TS + HALF;
constexpr long long M_END = M_TB + HALF;
// Bias offsets (elements) in the packed f32 buffer.
constexpr int B_T = 0;
constexpr int B_SIG = B_T + 8 * W;
constexpr int B_BOTT = B_SIG + 1;
constexpr int B_ALB0 = B_BOTT + W;
constexpr int B_ALB1 = B_ALB0 + HALF;
constexpr int B_TR = B_ALB1 + 3;
constexpr int B_TS = B_TR + 4 * HALF;
constexpr int B_TB = B_TS + 1;
constexpr int B_END = B_TB + 1;

__device__ __forceinline__ long long trunk_offset(int i) {
  if (i == 0) return M_T0;
  if (i <= 4) return M_T1 + (long long)(i - 1) * W * W;
  if (i == 5) return M_T5;
  return M_T6 + (long long)(i - 6) * W * W;
}

// column of trunk activation h_i in the activation stream
__device__ __forceinline__ int act_h(int i) { return i < 5 ? i * W : A_PE + PE + (i - 5) * W; }

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float bf_round(float x) { return bf(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// One row of a bf16 tile dotted with one bf16 weight row, f32 accumulation
// (each bf16 product is exact in f32). For the 1- and 3-wide heads.
__device__ __forceinline__ float dot_row(const bf16* a, const bf16* __restrict__ w, int k_dim) {
  float s = 0.f;
  for (int k = 0; k < k_dim; k += 2) {
    const float2 av = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + k));
    const float2 wv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
    s = fmaf(av.x, wv.x, s);
    s = fmaf(av.y, wv.y, s);
  }
  return s;
}

// out[r, n] = act(sum_k A[r, a_col0 + k] * Wt[n, k] + bias[n]) for the
// ROWS rows of the tile, n < n_dim, rounded to bf16; LD is the tiles' row
// stride. Wt (n_dim x k_dim, row-major) is staged 128 x 32 at a time. The
// 8 warps split the tile's CH row blocks (independent chains, ROWS / CH
// rows each) into WR = ROWS / (16 CH) row groups and a pass's 128 output
// columns into WC = 8 / WR column groups: a warp owns 16 rows of every block
// and 128 / WC columns, and issues the CH blocks' products back to back on
// each weight fragment it loads. The defaults (WR = 8, WC = 1) are the
// production kernels': 16 rows and all 128 columns a warp. A and out must be
// different tiles. Starts with a block barrier, so writes made before the
// call by any thread are visible.
template <bool RELU, int LD = LDA, int ROWS = MT, int CH = 1>
__device__ void gemm(const bf16* A, int a_col0, int k_dim, const bf16* __restrict__ Wt,
                     const float* __restrict__ bias, int n_dim, bf16* out, bf16* wst) {
  constexpr int WR = ROWS / (16 * CH), WC = 8 / WR, NJ = NC / WC / 8, BLK = ROWS / CH;
  static_assert(WR * WC == THREADS / 32 && NJ * WC * 8 == NC, "the 8 warps cover the tile");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % WR, wc = warp / WR;
  const bf16* arow = A + (wr * 16 + g) * LD + a_col0 + 2 * t;
  bf16* orow = out + (wr * 16 + g) * LD + wc * (NC / WC) + 2 * t;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    float acc[CH][NJ][4];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[c][j][0] = acc[c][j][1] = acc[c][j][2] = acc[c][j][3] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += KC) {
      __syncthreads();
      for (int v = threadIdx.x; v < NC * KC / 8; v += THREADS) {
        const int n = v / (KC / 8), kv = (v % (KC / 8)) * 8;
        *reinterpret_cast<uint4*>(wst + n * LDW + kv) =
            __ldg(reinterpret_cast<const uint4*>(Wt + (long long)(n0 + n) * k_dim + k0 + kv));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        uint32_t a[CH][4];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const bf16* ap = arow + c * BLK * LD + k0 + kk;
          a[c][0] = ld_u32(ap);
          a[c][1] = ld_u32(ap + 8 * LD);
          a[c][2] = ld_u32(ap + 8);
          a[c][3] = ld_u32(ap + 8 * LD + 8);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const bf16* bp = wst + (wc * (NC / WC) + j * 8 + g) * LDW + kk + 2 * t;
          const uint32_t b0 = ld_u32(bp), b1 = ld_u32(bp + 8);
#pragma unroll
          for (int c = 0; c < CH; ++c) mma_bf16(acc[c][j], a[c][0], a[c][1], a[c][2], a[c][3], b0, b1);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + wc * (NC / WC) + j * 8 + 2 * t;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        float v0 = acc[c][j][0] + b0, v1 = acc[c][j][1] + b1;
        float v2 = acc[c][j][2] + b0, v3 = acc[c][j][3] + b1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
        }
        bf16* op = orow + c * BLK * LD + n0 + j * 8;
        *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * LD) = __floats2bfloat162_rn(v2, v3);
      }
  }
}

// Copy rows [0, nrows) of a shared tile's columns [c0, c0 + ncols) into a
// bf16 stream (rows row0.., columns dc0..). ncols, c0, dc0 multiples of 8.
// The stores are streaming (st.global.cs, evict-first): a stream is hundreds
// of MB written once per pass, and stored normally it evicts from L2 the
// weights that every tile re-reads (chip_smoke.py on NVIDIA H100 80GB HBM3,
// 700 W: the camera save forward at 1024 x 127 took 3.2 ms with plain
// stores, 2.5 ms with these).
__device__ void tile_to_stream(const bf16* tile, int c0, int ncols, bf16* stream,
                               long long stride, long long row0, int nrows, int dc0) {
  const int nv = ncols / 8;
  for (int v = threadIdx.x; v < nrows * nv; v += THREADS) {
    const int r = v / nv, c = (v % nv) * 8;
    __stcs(reinterpret_cast<uint4*>(stream + (row0 + r) * stride + dc0 + c),
           *reinterpret_cast<const uint4*>(tile + r * LDA + c0 + c));
  }
}

// The eight trunk layers on one 128-row tile whose PE sits in columns
// 256..319 of both tiles: layer i reads src, writes dst; h4 lands in the
// second tile, next to its PE copy, so layer 5 reads [h4, pe] as one
// 320-wide operand. Returns the tile holding h7 (the other one is free).
// STREAM: each layer's output is also copied to the activation stream.
// RELU = false drops the ReLU (bias, then the bf16 rounding); CH: gemm's row
// blocks, each warp's chains issued back to back.
template <bool STREAM, bool RELU = true, int CH = 1>
__device__ __forceinline__ bf16* trunk_tile(bf16* bufX, bf16* bufY,
                                            const bf16* __restrict__ wm,
                                            const float* __restrict__ wb, bf16* wst,
                                            bf16* acts, long long as, long long g0,
                                            int nrows) {
  bf16 *src = bufX, *dst = bufY;
  for (int i = 0; i < 8; ++i) {
    const int k_dim = i == 0 ? PE : (i == 5 ? CAT : W);
    gemm<RELU, LDA, MT, CH>(src, i == 0 ? W : 0, k_dim, wm + trunk_offset(i), wb + B_T + i * W,
                           W, dst, wst);
    if (STREAM) {
      __syncthreads();
      tile_to_stream(dst, 0, W, acts, as, g0, nrows, act_h(i));
    }
    bf16* tmp = src; src = dst; dst = tmp;
  }
  __syncthreads();
  return src;
}

// PE lane c (< 63) of the point x: the coordinate it reads and its
// power-of-two scale.
__device__ __forceinline__ void pe_lane(int c, int& j, float& sc) {
  int deg;
  if (c < 3) { j = c; deg = 0; }
  else if (c < 33) { j = (c - 3) % 3; deg = (c - 3) / 3; }
  else { j = (c - 33) % 3; deg = (c - 33) / 3; }
  sc = ldexpf(1.f, deg);
}

// PE argument of a ray sample: xb = o*B + (d*B)*z, the products by the
// power-of-two scale exact, then a product and a sum each rounded (never
// contracted into an fma), as the plain versions compute it.
__device__ __forceinline__ float ray_xb(const float* ri, int j, float sc, float z) {
  return __fadd_rn(__fmul_rn(ri[j], sc), __fmul_rn(__fmul_rn(ri[3 + j], sc), z));
}

// PE value of lane c from its argument xb: xb itself on the 3 identity
// lanes, one phased sin (cos y = sin(y + pi/2)) on the others.
__device__ __forceinline__ float pe_value(int c, float xb) {
  return c < 3 ? xb : sinf(c < 33 ? xb : __fadd_rn(xb, HALF_PI));
}

// out[r, oc0 + n] = round(sum_k A[r, a_col0 + k] * Wp[k, n]) for n < n_dim,
// Wp a packed (out, in) matrix read as (k = out) x (n = in), i.e. the
// product g @ W^T of the JAX package's _mm_t: f32 accumulation, bf16
// rounding at the output. ADD: out = round(out + round(product)). A and out
// may be one tile if their column ranges are disjoint. Starts with a block
// barrier; the caller syncs before reading out.
template <bool ADD>
__device__ void dgemm(const bf16* A, int a_col0, int k_dim, const bf16* __restrict__ Wp,
                      int n_dim, bf16* out, int oc0, bf16* wst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* arow = A + (warp * 16 + g) * LDA + a_col0 + 2 * t;
  bf16* orow = out + (warp * 16 + g) * LDA + oc0 + 2 * t;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    float acc[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += KC) {
      __syncthreads();
      // stage the (n, k) chunk transposed from the (k, n) rows of Wp
      for (int v = threadIdx.x; v < KC * NC / 8; v += THREADS) {
        const int kk = v / (NC / 8), nv = (v % (NC / 8)) * 8;
        uint4 w8 = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + nv < n_dim)
          w8 = __ldg(reinterpret_cast<const uint4*>(Wp + (long long)(k0 + kk) * n_dim + n0 + nv));
        const bf16* we = reinterpret_cast<const bf16*>(&w8);
#pragma unroll
        for (int j = 0; j < 8; ++j) wst[(nv + j) * LDW + kk] = we[j];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        const bf16* ap = arow + k0 + kk;
        const uint32_t a0 = ld_u32(ap), a1 = ld_u32(ap + 8 * LDA);
        const uint32_t a2 = ld_u32(ap + 8), a3 = ld_u32(ap + 8 * LDA + 8);
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const bf16* bp = wst + (j * 8 + g) * LDW + kk + 2 * t;
          mma_bf16(acc[j], a0, a1, a2, a3, ld_u32(bp), ld_u32(bp + 8));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = n0 + j * 8;
      if (col >= n_dim) continue;
      float v0 = bf_round(acc[j][0]), v1 = bf_round(acc[j][1]);
      float v2 = bf_round(acc[j][2]), v3 = bf_round(acc[j][3]);
      __nv_bfloat162* p0 = reinterpret_cast<__nv_bfloat162*>(orow + col);
      __nv_bfloat162* p1 = reinterpret_cast<__nv_bfloat162*>(orow + col + 8 * LDA);
      if (ADD) {
        const float2 e0 = __bfloat1622float2(*p0), e1 = __bfloat1622float2(*p1);
        v0 += e0.x; v1 += e0.y; v2 += e1.x; v3 += e1.y;
      }
      *p0 = __floats2bfloat162_rn(v0, v1);
      *p1 = __floats2bfloat162_rn(v2, v3);
    }
  }
}

// Last pass: the fixed-order reduction of the partial sums, so the result
// does not depend on scheduling (deterministic from run to run). Matrix
// elements from mat0 on and biases from bias0 on (the int8_full backward
// reduces the trunk's own partials in q8_reduce_kernel).
__global__ void reduce_kernel(const float* __restrict__ wpart, int splits, long long n_mat,
                              const float* __restrict__ bpart, int nblocks, int n_bias,
                              float* __restrict__ dmats, float* __restrict__ dbias,
                              long long mat0, int bias0) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nm = n_mat - mat0, n = nm + n_bias - bias0;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n; e += stride) {
    float s = 0.f;
    if (e < nm) {
      const long long em = mat0 + e;
      for (int p = 0; p < splits; ++p) s += wpart[p * n_mat + em];
      dmats[em] = s;
    } else {
      const long long eb = bias0 + e - nm;
      for (int b = 0; b < nblocks; ++b) s += bpart[(long long)b * n_bias + eb];
      dbias[eb] = s;
    }
  }
}

constexpr int Q8P = 8;            // quantization points per group: PE, h0..h6

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_s8x4(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// inv = 127 / max(amax, 1e-12); the scale is 1 / inv (not amax / 127)
__device__ __forceinline__ float q8_inv(float amax) { return __fdiv_rn(127.f, fmaxf(amax, 1e-12f)); }

// round(v * inv), half to even, as a byte of a packed int8 word
__device__ __forceinline__ uint32_t q8_byte(float v, float inv) {
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fmul_rn(v, inv));
}

__device__ __forceinline__ float deq(int acc, float sw, float s) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(sw, s));
}

// Fold a tile's per-row maxima (float bits of values >= 0) into the amax of
// the groups its rows belong to: one atomicMax per group the tile touches.
__device__ void fold_group_max(const unsigned* rowmax, long long row0, int nrows,
                               long long group_rows, float* amax, int q) {
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= nrows) return;
  const long long g = (row0 + r) / group_rows;
  if (r > 0 && (row0 + r - 1) / group_rows == g) return;
  unsigned m = 0u;
  for (int s = r; s < nrows && (row0 + s) / group_rows == g; ++s) m = max(m, rowmax[s]);
  atomicMax(reinterpret_cast<unsigned*>(amax) + g * Q8P + q, m);
}

}  // namespace
