// Kernel-variant bench for NVIDIA Hopper (sm_90a): stripped-down versions of
// the port's field kernel, each removing one cost, and the compositing
// epilogues on top of the density trunk. They replace the research kernels
// that the JAX package times on the TPU:
//   scripts/bench_kernel_variants.py, `build` (17 forward bodies) and
//   `build_bwd` (the saved-versus-recompute slabs, 3 bodies);
//   scripts/proto_composite.py, `build` (4 compositing bodies).
// No training or render path runs them: python -m
// eonerf_code_tpu_torch.bench.kernel_variants and .composite do, and
// chip_smoke.py's phase `variants` holds each against its plain version in
// eonerf_code_tpu_torch/bench/variants.py.
//
// The variants are an attribution of fused_render.cu's design, so they are
// built from its tile machinery (tile_common.cuh): 128-row bf16 tiles
// ping-ponged in shared memory, every layer a wgmma product with the weights
// streamed 32 deep through a cp.async ring and the bias/ReLU/bf16 rounding
// in its epilogue (gemm), the trunk over a tile (trunk_tile), the per-point PE (as
// point_kernel), the cotangent product (dgemm), the weight gradients as
// per-split partials summed in a fixed order (reduce_kernel), and the int8
// tier's m16n8k32 products with the group amax folded by atomicMax on the
// float's bits. Four templates:
//   K1 slab chains (bf16_chain_kernel, q_chain_kernel, the dyn_* pair):
//      mm_only and its schedules, the K=512, int8, dynamic int8 and fp8
//      chains, and mm_fwd_save;
//   K2 the slab backward (slab_dgrad_kernel, slab_wgrad_kernel,
//      reduce_kernel): mm_bwd_rec and mm_bwd_saved;
//   K3 trunk_variant_kernel: nope, norelu, nocast, trunk_int2, and their
//      baseline trunk_gemm (trunk's function on this design; trunk and
//      full launch fused_render.cu's streamed density and field forwards);
//   K4 composite_kernel: reshape, colscan, accmm (base is the density
//      kernel).
//
// What bounds them on this card: operations for every chain and trunk
// (a 256 x 256 product per layer and row: 131 k operations against 12 B of
// position in and 4 B out), bytes for mm_fwd_save (4 KB of activation stream
// a row) and, in this design, for the backward slabs, whose dgrad and wgrad
// passes read and write the activation and cotangent streams (4 KB a row
// each) as fused_render.cu's backwards do.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tile_common.cuh"

namespace {

constexpr int ACTS_COLS = 8 * W;   // mm_fwd_save's stream: h0..h7 of every row
constexpr int QC = 64;             // output columns a pass of the 8-bit chains
constexpr float INV_127 = (float)(1.0 / 127.0);

__device__ float kZeroBias[2 * W];  // the mm_* chains' products have no bias

// The seed of row r's chain: coordinate `coord` of the first row of its seed
// block (blocks of `seg` rows: the TPU grid tile, or its 1/nsub part).
__device__ __forceinline__ float seed_of(const float* __restrict__ pos, long long r,
                                         long long seg, int coord) {
  return pos[(r / seg) * seg * 3 + coord];
}

__device__ __forceinline__ uint4 splat_bf16(float v) {
  const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16_rn(v));
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&s2);
  return make_uint4(u, u, u, u);
}

template <typename F>
cudaError_t set_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// K1, bf16: `kernel_mm_only` :122, `kernel_mm_merged2` :152,
// `kernel_mm_merged4` :175, `kernel_mm_int2`/`kernel_mm_int4` :240-246
// (`_mm_interleaved` :134), `kernel_mm_seq2` :188, `kernel_mm_k512` :303,
// `kernel_mm_fwd_save` :359.
//
// h = round_bf16(act(h @ W)) `depth` times, W the packed (out, in) matrix
// `wt` (KW x KW), from h0 (n, KW) bf16 or, without it, each row's seed
// pos[first row of its block, 0] broadcast over the row; out = h[:, 0].
// The schedules (template): CH independent accumulator chains a warpgroup
// issues back to back on each k step (gemm's chains; int2 and int4: the
// warpgroup's 128 columns as 2 x 64 or 4 x 32, since a wgmma covers 64
// rows and the TPU's row sub-blocks would be 32 rows at CH = 4), TILES
// 128-row tiles a block walks one after the other (seq2), 64-row tiles at
// K = 512 (two 64 x 520 bf16 tiles, each warpgroup 64 of a pass's columns;
// at 128 rows they would take 266 KB of shared memory), SAVE the ReLU chain that also
// streams h0..h7 into `acts` (n, 2048).
// ---------------------------------------------------------------------------

template <int KW>
__host__ __device__ constexpr int chain_ld() { return KW == W ? LDA : KW + 8; }

template <int KW, int ROWS>
constexpr size_t chain_smem() {
  return (size_t)(2 * ROWS * chain_ld<KW>() + WST) * sizeof(bf16);
}

template <int KW, int ROWS, int CH, bool RELU, bool SAVE, int TILES>
__global__ void __launch_bounds__(THREADS, 1)
bf16_chain_kernel(const float* __restrict__ pos, const bf16* __restrict__ h0,
                  const bf16* __restrict__ wt, int depth, float* __restrict__ out,
                  bf16* __restrict__ acts, long long n, long long seg) {
  static_assert(!SAVE || (KW == W && ROWS == MT), "the saved stream is the 8x256 trunk's");
  constexpr int LD = chain_ld<KW>(), NV = KW / 8;
  static_assert(2 * ROWS * LD * 2 % 1024 == 0, "the weight ring stays 1024-byte aligned");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + ROWS * LD;
  bf16* wst = bufY + ROWS * LD;
  for (int tt = 0; tt < TILES; ++tt) {
    const long long row0 = ((long long)blockIdx.x * TILES + tt) * ROWS;
    if (row0 >= n) break;
    const int nrows = (int)min((long long)ROWS, n - row0);
    for (int v = threadIdx.x; v < ROWS * NV; v += THREADS) {
      const int r = v / NV, c = (v % NV) * 8;
      uint4 x8 = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows)
        x8 = h0 != nullptr ? *reinterpret_cast<const uint4*>(h0 + (row0 + r) * KW + c)
                           : splat_bf16(seed_of(pos, row0 + r, seg, 0));
      *reinterpret_cast<uint4*>(bufX + r * LD + c) = x8;
    }
    bf16 *src = bufX, *dst = bufY;
    for (int i = 0; i < depth; ++i) {
      gemm<RELU, LD, ROWS, CH>(src, 0, KW, wt, kZeroBias, KW, dst, wst);
      if (SAVE) {
        __syncthreads();
        tile_to_stream(dst, 0, W, acts, ACTS_COLS, row0, nrows, i * W);
      }
      bf16* tmp = src; src = dst; dst = tmp;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nrows; r += THREADS) out[row0 + r] = bf(src[r * LD]);
    __syncthreads();
  }
}

template <int KW, int ROWS, int CH, bool RELU, bool SAVE, int TILES>
int launch_bf16_chain(const float* pos, const void* h0, const void* wt, int depth, float* out,
                      void* acts, long long n, long long seg, cudaStream_t stream) {
  auto* k = bf16_chain_kernel<KW, ROWS, CH, RELU, SAVE, TILES>;
  const size_t smem = chain_smem<KW, ROWS>();
  cudaError_t e = set_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)ROWS * TILES;
  k<<<(unsigned)((n + rows - 1) / rows), THREADS, smem, stream>>>(
      pos, static_cast<const bf16*>(h0), static_cast<const bf16*>(wt), depth, out,
      static_cast<bf16*>(acts), n, seg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1, 8-bit: `kernel_mm_i8` :248, `kernel_mm_i8_k512` :320, `kernel_mm_f8`
// :288. The weights are quantized once per call (q_weights_kernel, the TPU
// kernel's in-body quantization hoisted out of the grid); the chain keeps
// its tile in shared memory as int8 or e4m3 bytes and runs
// mma.sync m16n8k32 (s8 -> s32 exact, e4m3 -> f32), 64 output columns a
// pass with the weight rows staged at full depth, as q8_layer_kernel does.
// int8: h = int8(clip(f32(acc) * f32(1/127), +-127)), truncated toward zero
// as XLA converts. The TPU body writes f32(acc) * f32(1/127^2) * 127; XLA
// folds the two constants into f32(1/127) (the same bits) and so computes
// one rounding, not two, which moves a truncation now and then; the
// kernel computes what the JAX package computes. fp8: h = e4m3(acc).
// ---------------------------------------------------------------------------

// e4m3 as ml_dtypes' float8_e4m3fn rounds: to nearest even, NaN above 464
// (the midpoint between the largest finite value 448 and the next step);
// the satfinite conversion agrees with it up to 464 and on NaN.
__device__ __forceinline__ uint8_t f8_of(float x) {
  if (fabsf(x) > 464.f) return 0x7F;
  return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float f8_val(uint8_t b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw((__nv_fp8_storage_t)b, __NV_E4M3)));
}

// int8 of a float as the TPU (XLA) converts: toward zero, saturating
__device__ __forceinline__ uint8_t i8_trunc(float x) {
  return (uint8_t)(int8_t)(int)truncf(fminf(fmaxf(x, -128.f), 127.f));
}

__device__ __forceinline__ void mma_f8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// w8 (KW x KW, (out, in)) from the packed bf16 matrix (256 x 256): at
// KW = 512 tiled as [[w, w], [w, w]] * 0.25. int8: trunc(clip(w * 127));
// fp8: e4m3(w).
template <bool FP8>
__global__ void q_weights_kernel(const bf16* __restrict__ wt, uint8_t* __restrict__ w8, int kw) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kw * kw) return;
  const int o = e / kw, i = e % kw;
  float v = bf(wt[(o % W) * W + (i % W)]);
  if (kw != W) v = __fmul_rn(v, 0.25f);
  w8[e] = FP8 ? f8_of(v) : i8_trunc(fminf(fmaxf(__fmul_rn(v, 127.f), -127.f), 127.f));
}

template <int KW>
constexpr size_t q_chain_smem() { return (size_t)(2 * MT + QC) * (KW + 16); }

template <bool FP8, int KW>
__global__ void __launch_bounds__(THREADS, 1)
q_chain_kernel(const float* __restrict__ pos, const uint8_t* __restrict__ h0,
               const uint8_t* __restrict__ w8, int depth, float* __restrict__ out, long long n,
               long long seg) {
  using Acc = std::conditional_t<FP8, float, int>;
  constexpr int LQ = KW + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* qa = smem;
  uint8_t* qb = qa + MT * LQ;
  uint8_t* qw = qb + MT * LQ;   // QC weight rows (out) x KW (in)
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, n - row0);
  for (int v = threadIdx.x; v < MT * (KW / 16); v += THREADS) {
    const int r = v / (KW / 16), c = (v % (KW / 16)) * 16;
    uint4 x16 = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      if (h0 != nullptr) {
        x16 = *reinterpret_cast<const uint4*>(h0 + (row0 + r) * KW + c);
      } else {
        const float s = seed_of(pos, row0 + r, seg, 0);
        const uint32_t b = FP8 ? f8_of(s) : i8_trunc(s);
        const uint32_t u = b * 0x01010101u;
        x16 = make_uint4(u, u, u, u);
      }
    }
    *reinterpret_cast<uint4*>(qa + r * LQ + c) = x16;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g;
  uint8_t *src = qa, *dst = qb;
  for (int i = 0; i < depth; ++i) {
    for (int n0 = 0; n0 < KW; n0 += QC) {
      __syncthreads();
      for (int v = threadIdx.x; v < QC * (KW / 16); v += THREADS) {
        const int o = v / (KW / 16), c = (v % (KW / 16)) * 16;
        *reinterpret_cast<uint4*>(qw + o * LQ + c) =
            __ldg(reinterpret_cast<const uint4*>(w8 + (long long)(n0 + o) * KW + c));
      }
      __syncthreads();
      Acc acc[QC / 8][4];
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      for (int k0 = 0; k0 < KW; k0 += 32) {
        const uint8_t* ap = src + ra * LQ + k0 + 4 * t;
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
        const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LQ);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
        const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LQ + 16);
#pragma unroll
        for (int j = 0; j < QC / 8; ++j) {
          const uint8_t* bp = qw + (j * 8 + g) * LQ + k0 + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 16);
          if constexpr (FP8) mma_f8(acc[j], a0, a1, a2, a3, b0, b1);
          else mma_s8(acc[j], a0, a1, a2, a3, b0, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = ra + (q >= 2 ? 8 : 0);
          uint8_t b;
          if constexpr (FP8) {
            b = f8_of(acc[j][q]);
          } else {
            const float hf = __fmul_rn(__int2float_rn(acc[j][q]), INV_127);
            b = i8_trunc(fminf(fmaxf(hf, -127.f), 127.f));
          }
          dst[r * LQ + col + (q & 1)] = b;
        }
      }
    }
    uint8_t* tmp = src; src = dst; dst = tmp;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += THREADS)
    out[row0 + r] = FP8 ? f8_val(src[r * LQ]) : (float)(int8_t)src[r * LQ];
}

template <bool FP8, int KW>
int launch_q_chain(const float* pos, const void* h0, const void* wt, void* w8, int depth,
                   float* out, long long n, long long seg, cudaStream_t stream) {
  q_weights_kernel<FP8><<<(KW * KW + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const bf16*>(wt), static_cast<uint8_t*>(w8), KW);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto* k = q_chain_kernel<FP8, KW>;
  const size_t smem = q_chain_smem<KW>();
  e = set_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)((n + MT - 1) / MT), THREADS, smem, stream>>>(
      pos, static_cast<const uint8_t*>(h0), static_cast<const uint8_t*>(w8), depth, out, n, seg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1, dynamic int8: `kernel_mm_i8_dyn` :269. Each layer quantizes its input
// with the amax of the whole 2048-row TPU grid tile (a group of 16 of this
// card's 128-row tiles): s = max(amax, 1e-12) / 127, h8 = round(hf / s) (half
// to even), acc = h8 @ w8 (s32, exact), hf = f32(acc) * (s / 127). As the
// int8 trunk tier does (q8_layer_kernel), the chain runs layer-major, one
// launch a layer, the running f32 activation in device memory, each tile
// folding its outputs' max |hf| into its group's amax with atomicMax on the
// float's bits (order-free, so deterministic): 1 launch for the weights, 1
// for h0's amax, 8 layers.
// ---------------------------------------------------------------------------

// h0's group amax (quantization point 0), from h0 (n, 256) f32 or the seeds
__global__ void __launch_bounds__(THREADS)
dyn_amax0_kernel(const float* __restrict__ pos, const float* __restrict__ h0,
                 float* __restrict__ amax, long long n, long long seg, long long group) {
  __shared__ unsigned rowmax[MT];
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, n - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nrows; r += THREADS / 32) {
    float m = 0.f;
    if (h0 != nullptr) {
      for (int c = lane; c < W; c += 32) m = fmaxf(m, fabsf(h0[(row0 + r) * W + c]));
#pragma unroll
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    } else {
      m = fabsf(seed_of(pos, row0 + r, seg, 0));
    }
    if (lane == 0) rowmax[r] = __float_as_uint(m);
  }
  fold_group_max(rowmax, row0, nrows, group, amax, 0);
}

size_t dyn_layer_smem() { return (size_t)(MT + QC) * (W + 16) + (size_t)MT * 2 * sizeof(float); }

// Layer `layer` of the chain: hin (layer 0: h0, or the seeds when null),
// quantized with its group's scale, times w8; layers 0-6 write hout and fold
// its group amax into point layer + 1, layer 7 writes out = hf[:, 0].
__global__ void __launch_bounds__(THREADS, 2)
dyn_layer_kernel(int layer, const float* __restrict__ pos, const float* __restrict__ hin,
                 float* __restrict__ hout, const uint8_t* __restrict__ w8,
                 float* __restrict__ amax, float* __restrict__ out, long long n, long long seg,
                 long long group) {
  constexpr int LQ = W + 16;
  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* qa = smem;
  uint8_t* qw = qa + MT * LQ;
  float* s_row = reinterpret_cast<float*>(qw + QC * LQ);
  unsigned* rowmax = reinterpret_cast<unsigned*>(s_row + MT);
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, n - row0);
  if (tid < MT) {
    rowmax[tid] = 0u;
    const long long grp = (row0 + min(tid, nrows - 1)) / group;
    s_row[tid] = __fmul_rn(fmaxf(amax[grp * Q8P + layer], 1e-12f), INV_127);
  }
  __syncthreads();
  for (int v = tid; v < MT * (W / 4); v += THREADS) {
    const int r = v / (W / 4), c = (v % (W / 4)) * 4;
    uint32_t packed = 0u;
    if (r < nrows) {
      const long long row = row0 + r;
      float4 f;
      if (hin != nullptr) {
        f = *reinterpret_cast<const float4*>(hin + row * W + c);
      } else {
        const float s = seed_of(pos, row, seg, 0);
        f = make_float4(s, s, s, s);
      }
      const float s = s_row[r];
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = fminf(fmaxf(rintf(__fdiv_rn(fv[q], s)), -128.f), 127.f);
        packed |= (uint32_t)(uint8_t)(int8_t)(int)x << (8 * q);
      }
    }
    *reinterpret_cast<uint32_t*>(qa + r * LQ + c) = packed;
  }
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;
  float ma = 0.f, mb = 0.f;
  for (int n0 = 0; n0 < W; n0 += QC) {
    __syncthreads();
    for (int v = tid; v < QC * (W / 16); v += THREADS) {
      const int o = v / (W / 16), c = (v % (W / 16)) * 16;
      *reinterpret_cast<uint4*>(qw + o * LQ + c) =
          __ldg(reinterpret_cast<const uint4*>(w8 + (long long)(n0 + o) * W + c));
    }
    __syncthreads();
    int acc[QC / 8][4];
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k0 = 0; k0 < W; k0 += 32) {
      const uint8_t* ap = qa + ra * LQ + k0 + 4 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ap);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ap + 8 * LQ);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ap + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ap + 8 * LQ + 16);
#pragma unroll
      for (int j = 0; j < QC / 8; ++j) {
        const uint8_t* bp = qw + (j * 8 + g) * LQ + k0 + 4 * t;
        mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < QC / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= nrows) continue;
        const float sd = __fmul_rn(s_row[r], INV_127);
        const float h0v = __fmul_rn(__int2float_rn(acc[j][2 * half]), sd);
        const float h1v = __fmul_rn(__int2float_rn(acc[j][2 * half + 1]), sd);
        const long long row = row0 + r;
        if (layer < 7)
          *reinterpret_cast<float2*>(hout + row * W + col) = make_float2(h0v, h1v);
        else if (col == 0)
          out[row] = h0v;
        const float m = fmaxf(fabsf(h0v), fabsf(h1v));
        if (half) mb = fmaxf(mb, m); else ma = fmaxf(ma, m);
      }
    }
  }
  if (layer < 7) {
    if (ra < nrows) atomicMax(&rowmax[ra], __float_as_uint(ma));
    if (rb < nrows) atomicMax(&rowmax[rb], __float_as_uint(mb));
    fold_group_max(rowmax, row0, nrows, group, amax, layer + 1);
  }
}

// workspace: w8 (256 x 256), then two f32 (n, 256) activation buffers
size_t dyn_ws_bytes(long long n) { return (size_t)W * W + 2 * (size_t)n * W * sizeof(float); }

int launch_dyn(const float* pos, const float* h0, const void* wt, void* ws, float* amax,
               float* out, long long n, long long seg, long long group, cudaStream_t stream) {
  uint8_t* w8 = static_cast<uint8_t*>(ws);
  float* hbuf[2] = {reinterpret_cast<float*>(w8 + W * W),
                    reinterpret_cast<float*>(w8 + W * W) + n * W};
  q_weights_kernel<false><<<(W * W + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const bf16*>(wt), w8, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((n + MT - 1) / MT);
  dyn_amax0_kernel<<<grid, THREADS, 0, stream>>>(pos, h0, amax, n, seg, group);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = dyn_layer_smem();
  e = set_smem(dyn_layer_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  for (int layer = 0; layer < 8; ++layer) {
    const float* hin = layer == 0 ? h0 : hbuf[(layer - 1) & 1];
    dyn_layer_kernel<<<grid, THREADS, smem, stream>>>(layer, pos, hin, hbuf[layer & 1], w8, amax,
                                                      out, n, seg, group);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// K2, the slab backward: `kernel_mm_bwd_rec` :399 and `kernel_mm_bwd_saved`
// :420 (`_bwd_core` :374). Per layer i = 7..0: g *= (acts[i] > 0);
// dW_i += inp_i^T g (inp_i = acts[i - 1], or h0 for layer 0);
// g = round_bf16(g @ W^T); out = g[:, 0]. g starts as pos[first row of the
// block, 1] broadcast. The TPU sums dW over its grid in order; here, as in
// fused_render.cu's backwards: (rec) the ReLU chain streams its activations
// (bf16_chain_kernel<.., SAVE>), slab_dgrad_kernel runs the cotangent chain
// per 128-row tile and streams each layer's masked cotangent,
// slab_wgrad_kernel forms every dW as a tensor-core product over the rows
// into per-split partials, and reduce_kernel sums them in a fixed order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
slab_dgrad_kernel(const float* __restrict__ pos, const bf16* __restrict__ acts,
                  const bf16* __restrict__ wt, bf16* __restrict__ gp, float* __restrict__ out,
                  long long n, long long seg) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, n - row0);
  constexpr int NV = W / 8;
  for (int v = threadIdx.x; v < MT * NV; v += THREADS) {
    const int r = v / NV, c = (v % NV) * 8;
    *reinterpret_cast<uint4*>(bufX + r * LDA + c) =
        r < nrows ? splat_bf16(seed_of(pos, row0 + r, seg, 1)) : make_uint4(0u, 0u, 0u, 0u);
  }
  bf16 *src = bufX, *dst = bufY;
  for (int i = 7; i >= 0; --i) {
    __syncthreads();
    for (int v = threadIdx.x; v < MT * NV; v += THREADS) {
      const int r = v / NV, c = (v % NV) * 8;
      uint4 t8 = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        t8 = *reinterpret_cast<const uint4*>(src + r * LDA + c);
        const uint4 a8 = *reinterpret_cast<const uint4*>(acts + (row0 + r) * ACTS_COLS + i * W + c);
        const bf16* ae = reinterpret_cast<const bf16*>(&a8);
        bf16* te = reinterpret_cast<bf16*>(&t8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!(bf(ae[j]) > 0.f)) te[j] = __float2bfloat16_rn(0.f);
        __stcs(reinterpret_cast<uint4*>(gp + (row0 + r) * ACTS_COLS + i * W + c), t8);
      }
      *reinterpret_cast<uint4*>(src + r * LDA + c) = t8;
    }
    dgemm<false>(src, 0, W, wt, W, dst, 0, wst);
    bf16* tmp = src; src = dst; dst = tmp;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < nrows; r += THREADS) out[row0 + r] = bf(src[r * LDA]);
}

// dW_i (in x out, row-major f32) = inp_i^T g_i over the rows of split
// blockIdx.y, for the 128 x 128 output tile blockIdx.x % 4 of layer
// blockIdx.x / 4, into wpart[split][i]: fused_render.cu's wgrad_kernel on
// the same shared product (tile_common.cuh wgemm: the stream rows staged as
// they lie by cp.async, the transposes in wgmma), no atomics. Layer 0's
// input is h0, or without it the row's seed, written into the ring by
// st.shared in the swizzled layout the copies have.
__global__ void __launch_bounds__(THREADS, 2)
slab_wgrad_kernel(const float* __restrict__ pos, const bf16* __restrict__ h0,
                  const bf16* __restrict__ acts, const bf16* __restrict__ gp,
                  float* __restrict__ wpart, long long n, long long chunk, long long seg) {
  extern __shared__ __align__(1024) unsigned char wring[];
  const int layer = blockIdx.x / 4, m0 = ((blockIdx.x % 4) / 2) * WG_TILE,
            n0 = (blockIdx.x % 2) * WG_TILE;
  const long long sbeg = blockIdx.y * chunk;
  const long long send = min(n, sbeg + chunk);
  const uint32_t ring = smem_addr(wring);
  float acc[64];
  wgemm(acc, (int)max(0LL, (send - sbeg + WKC - 1) / WKC), true, wring, [&](int s, int q) {
    const uint32_t st = ring + s * WSTAGE_BYTES;
    const long long r0 = sbeg + (long long)q * WKC;
    if (layer > 0) {
      stage_rows(st, acts + (layer - 1) * W + m0, ACTS_COLS, r0, send, WG_TILE);
    } else if (h0 != nullptr) {
      stage_rows(st, h0 + m0, W, r0, send, WG_TILE);
    } else {
#pragma unroll
      for (int i = 0; i < WKC * 16 / THREADS; ++i) {
        const int v = threadIdx.x + i * THREADS, k = v >> 4;
        const uint4 x = r0 + k < send ? splat_bf16(seed_of(pos, r0 + k, seg, 0))
                                      : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(wring + s * WSTAGE_BYTES + wunit(k, v & 15)) = x;
      }
    }
    stage_rows(st + WOP_BYTES, gp + layer * W + n0, ACTS_COLS, r0, send, WG_TILE);
  });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* dst = wpart + ((long long)blockIdx.y * 8 + layer) * W * W;
  const int mm = m0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) {
    const int nn = n0 + j * 8 + 2 * tq;
    dst[(long long)mm * W + nn] = acc[4 * j];
    dst[(long long)mm * W + nn + 1] = acc[4 * j + 1];
    dst[(long long)(mm + 8) * W + nn] = acc[4 * j + 2];
    dst[(long long)(mm + 8) * W + nn + 1] = acc[4 * j + 3];
  }
}

struct SlabBwdLayout {
  int splits;
  long long chunk;
  size_t acts, gp, dummy, wpart, total;   // byte offsets; total = size
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// rec: the recomputed activation stream first; saved: the caller's
SlabBwdLayout slab_bwd_layout(bool saved, long long n) {
  SlabBwdLayout L;
  L.splits = (int)std::max(1LL, std::min((long long)MAX_SPLITS, n / 1024));
  L.chunk = ((n + L.splits - 1) / L.splits + KC - 1) / KC * KC;
  const size_t stream = (size_t)n * ACTS_COLS * sizeof(bf16);
  L.acts = 0;
  L.gp = align256(saved ? 0 : stream);
  L.dummy = align256(L.gp + stream);
  L.wpart = align256(L.dummy + (size_t)n * sizeof(float));
  L.total = align256(L.wpart + (size_t)L.splits * 8 * W * W * sizeof(float));
  return L;
}

// pass < 0: the whole backward; 0, 1, 2: only slab_dgrad_kernel,
// slab_wgrad_kernel or reduce_kernel of a saved backward, on a workspace
// that the passes before it filled (to time each pass on its own)
int launch_slab_bwd(const float* pos, const void* h0, const void* acts_in, const void* wt_,
                    void* ws, float* out, float* dw, long long n, long long seg,
                    cudaStream_t stream, int pass = -1) {
  const bool saved = acts_in != nullptr;
  if (pass >= 0 && !saved) return (int)cudaErrorInvalidValue;
  const SlabBwdLayout L = slab_bwd_layout(saved, n);
  unsigned char* base = static_cast<unsigned char*>(ws);
  const bf16* wt = static_cast<const bf16*>(wt_);
  bf16* gp = reinterpret_cast<bf16*>(base + L.gp);
  float* wpart = reinterpret_cast<float*>(base + L.wpart);
  const bf16* acts = static_cast<const bf16*>(acts_in);
  if (!saved) {
    bf16* rec = reinterpret_cast<bf16*>(base + L.acts);
    const int err = launch_bf16_chain<W, MT, 1, true, true, 1>(
        pos, h0, wt, 8, reinterpret_cast<float*>(base + L.dummy), rec, n, seg, stream);
    if (err != 0) return err;
    acts = rec;
  }
  cudaError_t e = cudaSuccess;
  if (pass < 0 || pass == 0) {
    const size_t smem = chain_smem<W, MT>();
    e = set_smem(slab_dgrad_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    slab_dgrad_kernel<<<(unsigned)((n + MT - 1) / MT), THREADS, smem, stream>>>(pos, acts, wt,
                                                                                gp, out, n, seg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (pass < 0 || pass == 1) {
    e = set_smem(slab_wgrad_kernel, WRING_BYTES);
    if (e != cudaSuccess) return (int)e;
    slab_wgrad_kernel<<<dim3(8 * 4, L.splits), THREADS, WRING_BYTES, stream>>>(
        pos, static_cast<const bf16*>(h0), acts, gp, wpart, n, L.chunk, seg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (pass < 0 || pass == 2)
    reduce_kernel<<<1024, THREADS, 0, stream>>>(wpart, L.splits, 8LL * W * W, nullptr, 0, 0, dw,
                                                nullptr, 0, 0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3, the trunk variants: `kernel_nope` :82 (a linear PE, xb = pos @ B, no
// sin), `kernel_norelu` :93 (bias and bf16 rounding, no ReLU; the layer-5
// skip kept), `kernel_nocast` :107 (the exact f32 sin/cos PE; its f32
// activations round to bf16 at each product's input, the values of trunk's
// rounding after the ReLU), `kernel_trunk_int2` :211 (nocast's function over
// two independent chains a tile, layers interleaved: gemm's two chains a
// warpgroup). The design the per-point density forward had before the
// streamed one (one block a 128-point tile on gemm) with a PE mode and a
// ReLU switch: sigma = softplus(h7 . w_sigma + b_sigma), (n,). The phased
// PE with the ReLU is trunk_gemm, `kernel_trunk` :71 on this design: the
// baseline each variant here and each compositing epilogue below is read
// against (the production `trunk` runs fused_render.cu's streamed forward,
// a design of its own).
// ---------------------------------------------------------------------------

enum PeMode { PE_PHASED = 0, PE_LINEAR = 1, PE_EXACT = 2 };

template <int PEM>
__device__ __forceinline__ float pe_variant(int c, float xb) {
  if (PEM == PE_LINEAR || c < 3) return xb;
  if (PEM == PE_EXACT) return c < 33 ? sinf(xb) : cosf(xb);
  return pe_value(c, xb);
}

// PE of a tile's points into columns 256..319 of both tiles (rows past
// nrows zero)
template <int PEM>
__device__ __forceinline__ void point_pe(const float* __restrict__ pos, long long p0, int nrows,
                                         bf16* bufX, bf16* bufY) {
  for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
    const int r = e / PE, c = e % PE;
    float v = 0.f;
    if (r < nrows && c < 63) {
      int j;
      float sc;
      pe_lane(c, j, sc);
      v = pe_variant<PEM>(c, __fmul_rn(pos[(p0 + r) * 3 + j], sc));
    }
    const bf16 pv = __float2bfloat16_rn(v);
    bufX[r * LDA + W + c] = pv;
    bufY[r * LDA + W + c] = pv;
  }
}

constexpr size_t trunk_smem() { return (size_t)(2 * MT * LDA + WST) * sizeof(bf16); }

template <int PEM, bool RELU, int CH>
__global__ void __launch_bounds__(THREADS, 1)
trunk_variant_kernel(const float* __restrict__ pos, const bf16* __restrict__ wm,
                     const float* __restrict__ wb, float* __restrict__ out, long long n) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  const long long p0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, n - p0);
  point_pe<PEM>(pos, p0, nrows, bufX, bufY);
  const bf16* P = trunk_tile<false, RELU, CH>(bufX, bufY, wm, wb, wst, nullptr, 0, p0, nrows);
  for (int r = threadIdx.x; r < nrows; r += THREADS)
    out[p0 + r] = softplus(dot_row(P + r * LDA, wm + M_SIG, W) + wb[B_SIG]);
}

template <int PEM, bool RELU, int CH>
int launch_trunk_variant(const float* pos, const void* wm, const float* wb, float* out,
                         long long n, cudaStream_t stream) {
  auto* k = trunk_variant_kernel<PEM, RELU, CH>;
  cudaError_t e = set_smem(k, trunk_smem());
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)((n + MT - 1) / MT), THREADS, trunk_smem(), stream>>>(
      pos, static_cast<const bf16*>(wm), wb, out, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4, the compositing epilogues: scripts/proto_composite.py `kernel_reshape`
// :65, `kernel_colscan` :76, `kernel_accmm` :93. The density trunk, then per
// ray of KPAD = 128 samples (exactly one 128-row tile, so the scan stays in
// the block): sdelta = sigma * sd, T = exp(-exclusive cumsum of sdelta),
// w = T * (1 - exp(-sdelta)). reshape and colscan compute the same function
// and differ in the TPU's layout only; on this card they are the two ways
// to scan a tile's column:
//   EPI_RESHAPE, the row layout: one warp owns the ray, 4 samples a lane,
//     the lanes' sums scanned with warp shuffles (no shared memory, no
//     block barrier);
//   EPI_COLSCAN, the column layout: the TPU kernel's Hillis-Steele scan down
//     the column in shared memory, one thread a sample, 7 steps, each behind
//     a block barrier (its order of additions, bit for bit);
//   EPI_ACCMM: the reshape scan, then per ray sum_k w_k sigma_k (a warp
//     reduction in place of the TPU's 0/1 selector product) written to all
//     8 columns of out (R, 8).
// ---------------------------------------------------------------------------

enum Epi { EPI_RESHAPE = 0, EPI_COLSCAN = 1, EPI_ACCMM = 2 };

template <int EPI>
__global__ void __launch_bounds__(THREADS, 1)
composite_kernel(const float* __restrict__ pos, const float* __restrict__ sd,
                 const bf16* __restrict__ wm, const float* __restrict__ wb,
                 float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* sig = reinterpret_cast<float*>(wst + WST);
  float* sdl = sig + MT;
  float* zs = sdl + MT;   // two MT buffers of the column scan
  const long long p0 = (long long)blockIdx.x * MT;
  const int tid = threadIdx.x;
  point_pe<PE_PHASED>(pos, p0, MT, bufX, bufY);
  const bf16* P = trunk_tile<false>(bufX, bufY, wm, wb, wst, nullptr, 0, p0, MT);
  if (tid < MT) {
    const float s = softplus(dot_row(P + tid * LDA, wm + M_SIG, W) + wb[B_SIG]);
    sig[tid] = s;
    sdl[tid] = __fmul_rn(s, sd[p0 + tid]);
  }
  __syncthreads();
  if constexpr (EPI == EPI_COLSCAN) {
    if (tid < MT) zs[tid] = tid == 0 ? 0.f : sdl[tid - 1];
    int cur = 0;
    for (int d = 1; d < MT; d *= 2) {
      __syncthreads();
      if (tid < MT)
        zs[(cur ^ 1) * MT + tid] = zs[cur * MT + tid] + (tid >= d ? zs[cur * MT + tid - d] : 0.f);
      cur ^= 1;
    }
    __syncthreads();
    if (tid < MT) out[p0 + tid] = __fmul_rn(expf(-zs[cur * MT + tid]), 1.f - expf(-sdl[tid]));
  } else {
    if (tid >= 32) return;
    const int lane = tid;
    float x[4], e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = sdl[4 * lane + k];
    e[0] = 0.f;
#pragma unroll
    for (int k = 1; k < 4; ++k) e[k] = e[k - 1] + x[k - 1];
    float incl = e[3] + x[3];
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    float pre = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) pre = 0.f;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float w = __fmul_rn(expf(-(pre + e[k])), 1.f - expf(-x[k]));
      if constexpr (EPI == EPI_RESHAPE) out[p0 + 4 * lane + k] = w;
      else acc += w * sig[4 * lane + k];
    }
    if constexpr (EPI == EPI_ACCMM) {
#pragma unroll
      for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane < 8) out[blockIdx.x * 8 + lane] = acc;
    }
  }
}

constexpr size_t composite_smem() { return trunk_smem() + 4 * MT * sizeof(float); }

template <int EPI>
int launch_composite(const float* pos, const float* sd, const void* wm, const float* wb,
                     float* out, long long n, cudaStream_t stream) {
  auto* k = composite_kernel<EPI>;
  cudaError_t e = set_smem(k, composite_smem());
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)(n / MT), THREADS, composite_smem(), stream>>>(
      pos, sd, static_cast<const bf16*>(wm), wb, out);
  return (int)cudaGetLastError();
}

// The L2 read rate that the streamed forwards' weight ring sees
// (bench/stream_fwd.py, step 1 of its design): every block reads the same
// `bytes` of src (L2-resident after the first pass) `reps` times in 16 KB
// chunks. mode 1: by bulk copies (the TMA) into an 8-stage shared ring, one
// thread issuing, each stage re-armed once its last copy has landed, as the
// forward's producer warp streams its weights; mode 0: by 16-byte
// ld.global.cg loads of all the block's threads. out[block]: a word of what
// was read, so nothing is optimized away.
constexpr int L2_CHUNK = 16384, L2_STAGES = 8;

__global__ void __launch_bounds__(THREADS, 1)
l2_read_kernel(int mode, const uint4* __restrict__ src, long long bytes, int reps,
               unsigned* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (mode == 0) {
    unsigned x = 0u;
    const long long n = bytes / 16;
    for (int r = 0; r < reps; ++r)
      for (long long v = threadIdx.x; v < n; v += THREADS) {
        const uint4 u = __ldcg(src + v);
        x ^= u.x ^ u.y ^ u.z ^ u.w;
      }
    if (threadIdx.x == 0 || x == 0x9e3779b9u) out[blockIdx.x] = x;
    return;
  }
  const uint32_t ring = smem_addr(smem), bars = ring + L2_STAGES * L2_CHUNK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L2_STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const uint64_t policy = l2_evict_last();
  const long long nch = bytes / L2_CHUNK, total = nch * reps;
  for (long long q = 0; q < total; ++q) {
    const int s = (int)(q % L2_STAGES);
    if (q >= L2_STAGES) mbar_wait(bars + 8 * s, (uint32_t)((q / L2_STAGES - 1) & 1));
    mbar_expect_tx(bars + 8 * s, L2_CHUNK);
    bulk_g2s(ring + s * L2_CHUNK, reinterpret_cast<const char*>(src) + (q % nch) * L2_CHUNK,
             L2_CHUNK, bars + 8 * s, policy);
  }
  for (long long q = total > L2_STAGES ? total - L2_STAGES : 0; q < total; ++q)
    mbar_wait(bars + 8 * (int)(q % L2_STAGES), (uint32_t)((q / L2_STAGES) & 1));
  out[blockIdx.x] = *reinterpret_cast<const unsigned*>(smem);
}

}  // namespace

extern "C" {

// The bf16 slab chains (K1). schedule: 0 one chain a warpgroup (mm_only,
// mm_merged2/4 by depth), 1 two chains a warpgroup (mm_int2), 2 four
// (mm_int4), 3 two 128-row tiles a block (mm_seq2), 4 K = 512 on 64-row
// tiles (mm_k512; wt 512 x 512), 5 the ReLU chain streaming h0..h7 into
// acts (mm_fwd_save). h0 (n, KW) bf16 or null for the seeds of blocks of seg
// rows; out (n,).
int kv_bf16_chain(int schedule, const float* pos, const void* h0, const void* wt, int depth,
                  float* out, void* acts, long long n, long long seg, void* stream) {
  if (n <= 0 || seg <= 0 || depth <= 0 || (schedule == 5 && depth != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (schedule) {
    case 0: return launch_bf16_chain<W, MT, 1, false, false, 1>(pos, h0, wt, depth, out, acts, n, seg, st);
    case 1: return launch_bf16_chain<W, MT, 2, false, false, 1>(pos, h0, wt, depth, out, acts, n, seg, st);
    case 2: return launch_bf16_chain<W, MT, 4, false, false, 1>(pos, h0, wt, depth, out, acts, n, seg, st);
    case 3: return launch_bf16_chain<W, MT, 1, false, false, 2>(pos, h0, wt, depth, out, acts, n, seg, st);
    case 4: return launch_bf16_chain<2 * W, MT / 2, 1, false, false, 1>(pos, h0, wt, depth, out, acts, n, seg, st);
    case 5: return launch_bf16_chain<W, MT, 1, true, true, 1>(pos, h0, wt, depth, out, acts, n, seg, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The 8-bit chains (K1): fp8 = 0 int8 (kw 256: mm_i8, 512: mm_i8_k512),
// 1 e4m3 (kw 256: mm_f8). wt the packed bf16 256 x 256 matrix, w8 kw * kw
// bytes of scratch, h0 (n, kw) bytes or null.
int kv_q_chain(int fp8, int kw, const float* pos, const void* h0, const void* wt, void* w8,
               int depth, float* out, long long n, long long seg, void* stream) {
  if (n <= 0 || seg <= 0 || depth <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!fp8 && kw == W) return launch_q_chain<false, W>(pos, h0, wt, w8, depth, out, n, seg, st);
  if (!fp8 && kw == 2 * W) return launch_q_chain<false, 2 * W>(pos, h0, wt, w8, depth, out, n, seg, st);
  if (fp8 && kw == W) return launch_q_chain<true, W>(pos, h0, wt, w8, depth, out, n, seg, st);
  return (int)cudaErrorInvalidValue;
}

long long kv_dyn_workspace_bytes(long long n) { return (long long)dyn_ws_bytes(n); }

// mm_i8_dyn (K1): h0 (n, 256) f32 or null; amax (n / group, 8) f32 zeroed by
// the caller, returned with the amax each layer quantized with.
int kv_i8_dyn(const float* pos, const float* h0, const void* wt, void* ws, float* amax,
              float* out, long long n, long long seg, long long group, void* stream) {
  if (n <= 0 || seg <= 0 || group <= 0 || n % group != 0) return (int)cudaErrorInvalidValue;
  return launch_dyn(pos, h0, wt, ws, amax, out, n, seg, group, static_cast<cudaStream_t>(stream));
}

long long kv_slab_bwd_workspace_bytes(int saved, long long n) {
  return (long long)slab_bwd_layout(saved != 0, n).total;
}

// mm_bwd_rec (acts null) and mm_bwd_saved (acts (n, 2048) bf16) (K2): out
// (n,), dw (8, 256, 256) f32, each (in, out).
int kv_slab_bwd(const float* pos, const void* h0, const void* acts, const void* wt, void* ws,
                float* out, float* dw, long long n, long long seg, void* stream) {
  if (n <= 0 || seg <= 0) return (int)cudaErrorInvalidValue;
  return launch_slab_bwd(pos, h0, acts, wt, ws, out, dw, n, seg, static_cast<cudaStream_t>(stream));
}

// One pass of mm_bwd_saved (K2), as kv_slab_bwd runs it, on a workspace the
// passes before it filled: 0 slab_dgrad_kernel (the cotangent chain on
// dgemm: the masked cotangents into the workspace, out), 1
// slab_wgrad_kernel (the per-split partials of dW), 2 reduce_kernel (dw).
// For timing each pass on its own.
int kv_slab_bwd_pass(int pass, const float* pos, const void* h0, const void* acts,
                     const void* wt, void* ws, float* out, float* dw, long long n, long long seg,
                     void* stream) {
  if (n <= 0 || seg <= 0 || acts == nullptr || pass < 0 || pass > 2)
    return (int)cudaErrorInvalidValue;
  return launch_slab_bwd(pos, h0, acts, wt, ws, out, dw, n, seg, static_cast<cudaStream_t>(stream),
                         pass);
}

// The trunk variants (K3), packed weights as fused_render.cu's: mode 0 nope,
// 1 norelu, 2 nocast, 3 trunk_int2, 4 trunk_gemm (their baseline); out (n,).
int kv_trunk_variant(int mode, const float* pos, const void* wm, const float* wb, float* out,
                     long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_trunk_variant<PE_LINEAR, true, 1>(pos, wm, wb, out, n, st);
    case 1: return launch_trunk_variant<PE_PHASED, false, 1>(pos, wm, wb, out, n, st);
    case 2: return launch_trunk_variant<PE_EXACT, true, 1>(pos, wm, wb, out, n, st);
    case 3: return launch_trunk_variant<PE_EXACT, true, 2>(pos, wm, wb, out, n, st);
    case 4: return launch_trunk_variant<PE_PHASED, true, 1>(pos, wm, wb, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The compositing epilogues (K4): epi 0 reshape, 1 colscan (out (n,)),
// 2 accmm (out (n / 128, 8)); n a multiple of 128, sd (n,) f32.
int kv_composite(int epi, const float* pos, const float* sd, const void* wm, const float* wb,
                 float* out, long long n, void* stream) {
  if (n <= 0 || n % MT != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case 0: return launch_composite<EPI_RESHAPE>(pos, sd, wm, wb, out, n, st);
    case 1: return launch_composite<EPI_COLSCAN>(pos, sd, wm, wb, out, n, st);
    case 2: return launch_composite<EPI_ACCMM>(pos, sd, wm, wb, out, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The L2 read rate (l2_read_kernel): `blocks` blocks each read the first
// `bytes` (a multiple of 16,384) of src `reps` times; mode 1 by bulk
// copies, 0 by loads. out: `blocks` words.
int kv_l2_read(int mode, const void* src, long long bytes, int reps, int blocks, void* out,
               void* stream) {
  if (bytes <= 0 || bytes % L2_CHUNK != 0 || reps <= 0 || blocks <= 0 || mode < 0 || mode > 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mode == 1 ? L2_STAGES * L2_CHUNK + 8 * L2_STAGES : 0;
  cudaError_t e = set_smem(l2_read_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  l2_read_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const uint4*>(src), bytes, reps, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

const char* kv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
