// Fused EO-NeRF render kernels for NVIDIA Hopper (sm_90a), forward and
// backward.
//
// camera: replaces the Pallas kernel `_camera_fwd_kernel` of the JAX
//   package's ops/pallas/fused_render.py (reached through
//   make_fused_camera). Per ray: positional encoding built from the ray's
//   origin/direction and each sample's z, the 8x256 skip trunk, the sigma,
//   bottleneck, albedo and 4x128 transient heads, exclusive-transmittance
//   compositing, and the per-ray sums
//   acc = [depth, albedo r g b, t_s, t_beta, opacity, 0].
// shadow: replaces `_shadow_fwd_kernel` of the same file (make_fused_shadow).
//   Density trunk and sigma head, then the sun visibility
//   exp(-sum of sigma*delta over the samples before the last valid one);
//   a ray with no valid sample gets 1.
//
// What bounds them on this card: operations. Every sample runs the trunk
// (0.49 M multiply-adds) and, for the camera, the heads (0.19 M more), while
// a ray brings in 64 B plus 8 B per sample and takes out 32 B; the 1.2 MB of
// bf16 weights are shared by every block and stay in L2. So the work is
// bf16 matrix products at a few thousand operations per byte moved, far on
// the compute side of the H100's ~295 op/B ridge.
//
// What the design does about it: the per-sample activations never leave the
// SM. A block owns whole rays (128 sample rows per tile, looping over tiles
// when a ray has more than 128 samples); the activations ping-pong between
// two bf16 tiles in shared memory (128 x 328 each, 164 KB together), every
// layer is a tensor-core product (mma.sync m16n8k16, bf16 in, f32 accumulate)
// with 32-deep chunks of the weights staged through shared memory, and the
// f32 bias + ReLU + bf16 rounding happen in the product's epilogue. The TPU
// kernel's 0/1 selector matmuls (its only way to move between the
// (points, features) and (rays, samples) shapes) become plain indexing, and
// the compositing scan runs per ray in f32 from per-sample results kept in
// shared memory. This first version does not pipeline the weight loads
// (no cp.async/TMA) and uses mma.sync rather than wgmma.
//
// Semantics kept from the TPU kernel: xb = o*B + (d*B)*z in f32, B the
// power-of-two frequency pattern, cos lanes as one phased sin(xb + pi/2);
// activations rounded to bf16 after each ReLU; the layer-5 input is
// [h4, pe]; the transient input is [bottleneck, embedding(4), 0...];
// padded samples (deltam = 0) add no extinction.
//
// Backward: camera_bwd replaces `_camera_bwd_kernel` (make_fused_camera's
// backward), shadow_bwd `_shadow_bwd_kernel` (make_fused_shadow's). Both
// recompute the forward (flash-style; nothing is saved by the forward) and
// return f32 gradients of every packed weight plus the per-ray
// d_rayin = [d_o, d_d, d_emb]. They are bound by operations as the forwards
// are: three times the forward's products per sample (recompute, dgrad,
// wgrad). A 128-row tile's eight trunk activations (512 KB in bf16) do not
// fit in shared memory, and the TPU kernel's running sum of the weight
// gradients over a sequential grid has no counterpart on 132 parallel SMs,
// so the work runs in four launches over a workspace in device memory:
//   1. fused_fwd_kernel<_, true>: the forward recompute, which also streams
//      every activation (the trunk's, the PE, the heads') to an activation
//      stream, then the compositing backward per ray in f32 (the reverse
//      exclusive scan as a running suffix), giving each sample's head
//      cotangents;
//   2. dgrad_kernel: per 128-sample tile, the cotangent chain from the heads
//      down to the PE in bf16 tiles in shared memory (each g @ W^T an
//      mma.sync product, f32 accumulation, bf16 rounding at its output, as
//      the JAX package's _mm_t), ReLU masks read back from the activation
//      stream; it writes every layer's pre-activation cotangent to a
//      cotangent stream, its block's f32 bias-gradient sums, and d_rayin;
//   3. wgrad_kernel: every weight gradient as inputs^T @ cotangents over all
//      samples (mma.sync, f32), split over the sample axis into per-block
//      partial sums;
//   4. reduce_kernel: the partial sums added in a fixed order, so the
//      gradients are the same bits from run to run (no atomics).
// The streams cost (3072 + 2976) bf16 per camera sample: 1.6 GB at 1024
// rays x 128 samples, read back once by each later pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int W = 256;        // trunk width
constexpr int PE = 64;        // PE width: 63 lanes + one zero lane
constexpr int HALF = 128;     // head width
constexpr int CAT = W + PE;   // layer-5 input and transient input width
constexpr int RAYIN = 16;     // [o(3), d(3), emb(4), 0*6]
constexpr int ACC = 8;
constexpr int MT = 128;       // sample rows per tile: 8 warps x 16 rows
constexpr int THREADS = 256;
constexpr int LDA = CAT + 8;  // activation row stride; +8 keeps fragment loads conflict-free
constexpr int KC = 32;        // depth of one staged weight chunk
constexpr int LDW = KC + 8;   // staged weight row stride
constexpr int NC = 128;       // output columns per pass
constexpr int MAX_KPAD = 1024;
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
// Cotangents at each layer's pre-activation (the weight gradients' right
// operand): trunk g0..g7, bottleneck, albedo hidden, transient 0..3, then
// the 1- and 3-wide heads, each padded to 8 columns.
constexpr int G_BOTT = 8 * W;               // 2048
constexpr int G_AH = G_BOTT + W;            // 2304
constexpr int G_TR0 = G_AH + HALF;          // 2432
constexpr int G_SIG_CAM = G_TR0 + 4 * HALF; // 2944
constexpr int G_ALB1 = G_SIG_CAM + 8;
constexpr int G_TS = G_ALB1 + 8;
constexpr int G_TB = G_TS + 8;
constexpr int GP_CAM = G_TB + 8;            // 2976 columns (camera)
constexpr int G_SIG_SH = 8 * W;             // 2048
constexpr int GP_SH = G_SIG_SH + 8;         // 2056 columns (shadow)
constexpr int HG = 8;  // f32 head cotangents per sample: sigma, albedo x3, t_s, t_beta, 0, 0
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

// out[r, n] = act(sum_k A[r, a_col0 + k] * Wt[n, k] + bias[n]) for the 128
// rows of the tile, n < n_dim, rounded to bf16. Each warp owns 16 rows of A
// and of out; Wt (n_dim x k_dim, row-major) is staged 128 x 32 at a time.
// A and out must be different tiles. Starts with a block barrier, so writes
// made before the call by any thread are visible.
template <bool RELU>
__device__ void gemm(const bf16* A, int a_col0, int k_dim, const bf16* __restrict__ Wt,
                     const float* __restrict__ bias, int n_dim, bf16* out, bf16* wst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* arow = A + (warp * 16 + g) * LDA + a_col0 + 2 * t;
  bf16* orow = out + (warp * 16 + g) * LDA + 2 * t;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    float acc[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
      const int col = n0 + j * 8 + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
      float v0 = acc[j][0] + b0, v1 = acc[j][1] + b1;
      float v2 = acc[j][2] + b0, v3 = acc[j][3] + b1;
      if (RELU) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<__nv_bfloat162*>(orow + n0 + j * 8) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(orow + n0 + j * 8 + 8 * LDA) =
          __floats2bfloat162_rn(v2, v3);
    }
  }
}

// Copy rows [0, nrows) of a shared tile's columns [c0, c0 + ncols) into a
// bf16 stream (rows row0.., columns dc0..). ncols, c0, dc0 multiples of 8.
__device__ void tile_to_stream(const bf16* tile, int c0, int ncols, bf16* stream,
                               long long stride, long long row0, int nrows, int dc0) {
  const int nv = ncols / 8;
  for (int v = threadIdx.x; v < nrows * nv; v += THREADS) {
    const int r = v / nv, c = (v % nv) * 8;
    *reinterpret_cast<uint4*>(stream + (row0 + r) * stride + dc0 + c) =
        *reinterpret_cast<const uint4*>(tile + r * LDA + c0 + c);
  }
}

// One block per group of `rpb` whole rays; KPAD samples per ray (a multiple
// of 8, <= MAX_KPAD); rows s = ray * KPAD + k of the block's sample axis are
// processed 128 at a time.
//
// BWD = false: the forward (acc or geo into `out`).
// BWD = true: the first pass of the backward. The same recompute, which
// also streams every activation to `acts`, then the compositing backward
// per ray in f32 for the per-ray cotangent `gin` (camera: gacc (R, 8);
// shadow: ggeo (R,)), writing the per-sample head cotangents to `hg`.
template <bool CAMERA, bool BWD>
__global__ void __launch_bounds__(THREADS, 1)
fused_fwd_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                 const float* __restrict__ deltam, const float* __restrict__ mask,
                 const bf16* __restrict__ wm, const float* __restrict__ wb,
                 float* __restrict__ out, int R, int KPAD, int rpb,
                 const float* __restrict__ gin, bf16* __restrict__ acts,
                 float* __restrict__ hg) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* res = reinterpret_cast<float*>(wst + NC * LDW);
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int S = nray * KPAD;

  for (int s0 = 0; s0 < S; s0 += MT) {
    const int nrows = min(MT, S - s0);
    const long long g0 = (long long)ray0 * KPAD + s0;   // stream row of tile row 0
    // positional encoding into the PE columns of both tiles; rows past the
    // block's samples get zeros
    for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
      const int r = e / PE, c = e % PE, s = s0 + r;
      float v = 0.f;
      if (s < S && c < 63) {
        const int ray = ray0 + s / KPAD;
        const float* ri = rayin + (long long)ray * RAYIN;
        int j, deg;
        if (c < 3) { j = c; deg = 0; }
        else if (c < 33) { j = (c - 3) % 3; deg = (c - 3) / 3; }
        else { j = (c - 33) % 3; deg = (c - 33) / 3; }
        const float sc = ldexpf(1.f, deg);
        const float zs = z[(long long)ray * KPAD + s % KPAD];
        const float xb = __fadd_rn(__fmul_rn(ri[j], sc), __fmul_rn(__fmul_rn(ri[3 + j], sc), zs));
        v = c < 3 ? xb : sinf(c < 33 ? xb : __fadd_rn(xb, HALF_PI));
      }
      const bf16 pv = __float2bfloat16_rn(v);
      bufX[r * LDA + W + c] = pv;
      bufY[r * LDA + W + c] = pv;
    }
    if (BWD) {
      __syncthreads();
      tile_to_stream(bufX, W, PE, acts, AS, g0, nrows, A_PE);
    }
    // trunk: layer i reads src, writes dst; h4 lands in bufY, next to its PE
    // copy, so layer 5 reads [h4, pe] as one 320-wide operand
    bf16 *src = bufX, *dst = bufY;
    for (int i = 0; i < 8; ++i) {
      const int k_dim = i == 0 ? PE : (i == 5 ? CAT : W);
      gemm<true>(src, i == 0 ? W : 0, k_dim, wm + trunk_offset(i), wb + B_T + i * W, W, dst, wst);
      if (BWD) {
        __syncthreads();
        tile_to_stream(dst, 0, W, acts, AS, g0, nrows, act_h(i));
      }
      bf16* tmp = src; src = dst; dst = tmp;
    }
    __syncthreads();
    bf16 *P = src, *Q = dst;   // P holds h7
    for (int r = threadIdx.x; r < MT; r += THREADS) {
      const int s = s0 + r;
      if (s < S) res[s * RES] = softplus(dot_row(P + r * LDA, wm + M_SIG, W) + wb[B_SIG]);
    }
    if (CAMERA) {
      gemm<false>(P, 0, W, wm + M_BOTT, wb + B_BOTT, W, Q, wst);   // bottleneck -> Q
      // the ray's transient embedding into Q's cols 256..259 (260..319 zero)
      for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
        const int r = e / PE, c = e % PE, s = s0 + r;
        float v = 0.f;
        if (s < S && c < 4) v = rayin[(long long)(ray0 + s / KPAD) * RAYIN + 6 + c];
        Q[r * LDA + W + c] = __float2bfloat16_rn(v);
      }
      if (BWD) {
        __syncthreads();
        tile_to_stream(Q, 0, CAT, acts, AS, g0, nrows, A_BOTT);   // [bott | emb64]
      }
      gemm<true>(Q, 0, W, wm + M_ALB0, wb + B_ALB0, HALF, P, wst);  // albedo hidden -> P
      __syncthreads();
      if (BWD) tile_to_stream(P, 0, HALF, acts, AS, g0, nrows, A_AH);
      for (int r = threadIdx.x; r < MT; r += THREADS) {
        const int s = s0 + r;
        if (s < S) {
          for (int c = 0; c < 3; ++c) {
            res[s * RES + 1 + c] =
                sigmoid(dot_row(P + r * LDA, wm + M_ALB1 + c * HALF, HALF) + wb[B_ALB1 + c]);
          }
        }
      }
      gemm<true>(Q, 0, CAT, wm + M_TR0, wb + B_TR, HALF, P, wst);  // [bott | emb] -> P
      if (BWD) { __syncthreads(); tile_to_stream(P, 0, HALF, acts, AS, g0, nrows, A_T0); }
      gemm<true>(P, 0, HALF, wm + M_TR1, wb + B_TR + HALF, HALF, Q, wst);
      if (BWD) { __syncthreads(); tile_to_stream(Q, 0, HALF, acts, AS, g0, nrows, A_T0 + HALF); }
      gemm<true>(Q, 0, HALF, wm + M_TR1 + HALF * HALF, wb + B_TR + 2 * HALF, HALF, P, wst);
      if (BWD) { __syncthreads(); tile_to_stream(P, 0, HALF, acts, AS, g0, nrows, A_T0 + 2 * HALF); }
      gemm<true>(P, 0, HALF, wm + M_TR1 + 2 * HALF * HALF, wb + B_TR + 3 * HALF, HALF, Q, wst);
      __syncthreads();
      if (BWD) tile_to_stream(Q, 0, HALF, acts, AS, g0, nrows, A_T0 + 3 * HALF);
      for (int r = threadIdx.x; r < MT; r += THREADS) {
        const int s = s0 + r;
        if (s < S) {
          res[s * RES + 4] = sigmoid(dot_row(Q + r * LDA, wm + M_TS, HALF) + wb[B_TS]);
          res[s * RES + 5] = softplus(dot_row(Q + r * LDA, wm + M_TB, HALF) + wb[B_TB]);
        }
      }
    }
    __syncthreads();
  }

  // compositing (forward) or its backward, one thread per ray, in f32
  for (int lr = threadIdx.x; lr < nray; lr += THREADS) {
    const long long ray = ray0 + lr;
    const float* zr = z + ray * KPAD;
    const float* dr = deltam + ray * KPAD;
    float* rs = res + lr * KPAD * RES;
    if (CAMERA && !BWD) {
      float excl = 0.f, a[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < KPAD; ++k) {
        const float sd = rs[k * RES] * dr[k];
        const float wgt = expf(-excl) * (1.f - expf(-sd));
        a[0] += wgt * zr[k];
        for (int c = 1; c < 6; ++c) a[c] += wgt * rs[k * RES + c];
        a[6] += wgt;
        excl += sd;
      }
      for (int c = 0; c < 7; ++c) out[ray * ACC + c] = a[c];
      out[ray * ACC + 7] = 0.f;
    } else if (CAMERA) {
      // weights w = T (1 - e^-sd); d_w from acc's cotangent; the reverse
      // EXCLUSIVE scan of d_excl runs as a running suffix added before the
      // sample's own term (never a total minus a prefix: the 1e10 sentinel
      // of the last valid sample would cancel catastrophically). The
      // softplus heads' derivative sigmoid(x) is 1 - exp(-softplus(x)).
      const float* g = gin + ray * ACC;
      float excl = 0.f;
      for (int k = 0; k < KPAD; ++k) {
        const float sd = rs[k * RES] * dr[k];
        rs[k * RES + 6] = expf(-excl);
        rs[k * RES + 7] = g[0] * zr[k] + g[1] * rs[k * RES + 1] + g[2] * rs[k * RES + 2] +
                          g[3] * rs[k * RES + 3] + g[4] * rs[k * RES + 4] +
                          g[5] * rs[k * RES + 5] + g[6];
        excl += sd;
      }
      float suffix = 0.f;
      for (int k = KPAD - 1; k >= 0; --k) {
        const float sigma = rs[k * RES];
        const float sd = sigma * dr[k];
        const float em = expf(-sd), alpha = 1.f - em;
        const float trans = rs[k * RES + 6], dw = rs[k * RES + 7];
        const float d_sdelta = dw * trans * em + suffix;
        suffix += -trans * (dw * alpha);
        const float wgt = trans * alpha;
        float* o = hg + (ray * KPAD + k) * HG;
        o[0] = d_sdelta * dr[k] * -expm1f(-sigma);
        for (int c = 1; c < 4; ++c) {
          const float a = rs[k * RES + c];
          o[c] = g[c] * wgt * a * (1.f - a);
        }
        const float ts = rs[k * RES + 4];
        o[4] = g[4] * wgt * ts * (1.f - ts);
        o[5] = g[5] * wgt * -expm1f(-rs[k * RES + 5]);
        o[6] = 0.f;
        o[7] = 0.f;
      }
    } else {
      // a sample counts when at least two valid samples remain from it on,
      // i.e. it lies strictly before the ray's last valid sample
      const float* mr = mask + ray * KPAD;
      float remaining = 0.f, ev = 0.f;
      for (int k = 0; k < KPAD; ++k) remaining += mr[k];
      const float total = remaining;
      for (int k = 0; k < KPAD; ++k) {
        if (remaining >= 2.f) ev += rs[k * RES] * dr[k];
        remaining -= mr[k];
      }
      if (!BWD) {
        out[ray] = expf(-ev);
      } else {
        const float d_ev = -expf(-ev) * gin[ray];
        remaining = total;
        for (int k = 0; k < KPAD; ++k) {
          hg[(ray * KPAD + k) * HG] =
              remaining >= 2.f ? d_ev * dr[k] * -expm1f(-rs[k * RES]) : 0.f;
          remaining -= mr[k];
        }
      }
    }
  }
}

int rays_per_block(int KPAD) { return KPAD >= MT ? 1 : MT / KPAD; }

size_t fwd_smem(int KPAD) {
  return (size_t)(2 * MT * LDA + NC * LDW) * sizeof(bf16) +
         (size_t)rays_per_block(KPAD) * KPAD * RES * sizeof(float);
}

template <bool CAMERA, bool BWD>
int launch(const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, float* out, int R, int KPAD, cudaStream_t stream,
           const float* gin = nullptr, bf16* acts = nullptr, float* hg = nullptr) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD) return (int)cudaErrorInvalidValue;
  const int rpb = rays_per_block(KPAD);
  const int grid = (R + rpb - 1) / rpb;
  const size_t smem = fwd_smem(KPAD);
  cudaError_t err = cudaFuncSetAttribute(fused_fwd_kernel<CAMERA, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<CAMERA, BWD><<<grid, THREADS, smem, stream>>>(
      rayin, z, deltam, mask, static_cast<const bf16*>(wm), wb, out, R, KPAD, rpb, gin, acts,
      hg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: the cotangent chain (dgrad) and the weight gradients (wgrad)
// ---------------------------------------------------------------------------

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

// The cotangent of a layer's pre-activation, in tile cols [0, n): multiply
// by the ReLU mask (activation > 0, read from the activation stream at
// column acol; rows past the block's samples become 0), store it to the
// cotangent stream at column gcol, and add its f32 column sums (the bias
// gradient) into bsum. MASK = false skips the mask (a linear layer).
template <bool MASK>
__device__ void cotangent_out(bf16* tile, int n, const bf16* __restrict__ acts, long long as,
                              int acol, bf16* __restrict__ gp, long long gs, int gcol,
                              float* bsum, long long g0, int nrows) {
  __syncthreads();
  const int nv = n / 8;
  for (int v = threadIdx.x; v < MT * nv; v += THREADS) {
    const int r = v / nv, c = (v % nv) * 8;
    uint4 t8 = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows) {
      t8 = *reinterpret_cast<const uint4*>(tile + r * LDA + c);
      if (MASK) {
        const uint4 a8 = *reinterpret_cast<const uint4*>(acts + (g0 + r) * as + acol + c);
        const bf16* ae = reinterpret_cast<const bf16*>(&a8);
        bf16* te = reinterpret_cast<bf16*>(&t8);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (!(bf(ae[j]) > 0.f)) te[j] = __float2bfloat16_rn(0.f);
      }
      *reinterpret_cast<uint4*>(gp + (g0 + r) * gs + gcol + c) = t8;
    }
    *reinterpret_cast<uint4*>(tile + r * LDA + c) = t8;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < nrows; ++r) s += bf(tile[r * LDA + c]);
    bsum[c] += s;
  }
}

// Second pass of the backward: per block of whole rays (as the forward),
// per 128-sample tile, the cotangent chain from the head cotangents `hg`
// down to the PE, in bf16 tiles in shared memory, with the ReLU masks read
// back from the activation stream. Writes every layer's pre-activation
// cotangent to `gpre`, the block's f32 bias-gradient sums to `bias_part`
// (one row per block, reduced in a fixed order later) and the per-ray
// d_rayin = [d_o, d_d, d_emb].
template <bool CAMERA>
__global__ void __launch_bounds__(THREADS, 1)
dgrad_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
             const bf16* __restrict__ wm, const bf16* __restrict__ acts,
             const float* __restrict__ hg, bf16* __restrict__ gpre,
             float* __restrict__ bias_part, float* __restrict__ drayin, int R, int KPAD,
             int rpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = CAMERA ? B_END : B_BOTT;
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  constexpr long long GS = CAMERA ? GP_CAM : GP_SH;
  constexpr int GSIG = CAMERA ? G_SIG_CAM : G_SIG_SH;
  constexpr int NH = CAMERA ? 6 : 1;        // head cotangents per sample
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* bsum = reinterpret_cast<float*>(wst + NC * LDW);  // B_END floats
  float* hs = bsum + B_END + 2;      // MT x 8: bf16-rounded head cotangents
  float* rowacc = hs + MT * 8;       // MT x 10: per-sample [d_o, d_d, d_emb]
  float* rayacc = rowacc + MT * 10;  // rpb x 10
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int S = nray * KPAD;
  for (int e = tid; e < NB; e += THREADS) bsum[e] = 0.f;
  for (int e = tid; e < rpb * 10; e += THREADS) rayacc[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += MT) {
    const int nrows = min(MT, S - s0);
    const long long g0 = (long long)ray0 * KPAD + s0;
    __syncthreads();
    for (int e = tid; e < MT * 8; e += THREADS) {
      const int r = e / 8, c = e % 8;
      hs[e] = (r < nrows && c < NH) ? bf_round(hg[(g0 + r) * HG + c]) : 0.f;
    }
    if (tid < NH) {   // the head biases' gradients sum the f32 cotangents
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += hg[(g0 + r) * HG + tid];
      const int b = tid == 0 ? B_SIG : (tid < 4 ? B_ALB1 + tid - 1 : (tid == 4 ? B_TS : B_TB));
      bsum[b] += s;
    }
    __syncthreads();
    // the heads' bf16 cotangents into the stream: [sigma | albedo | t_s | t_beta], 8 wide each
    constexpr int ncol = CAMERA ? 32 : 8;
    for (int e = tid; e < nrows * ncol; e += THREADS) {
      const int r = e / ncol, c = e % ncol, grp = c / 8, j = c % 8;
      float v = 0.f;
      if (grp == 0) v = j == 0 ? hs[r * 8] : 0.f;
      else if (grp == 1) v = j < 3 ? hs[r * 8 + 1 + j] : 0.f;
      else v = j == 0 ? hs[r * 8 + 2 + grp] : 0.f;
      gpre[(g0 + r) * GS + GSIG + c] = __float2bfloat16_rn(v);
    }
    bf16 *C, *O;   // C: the tile holding the current cotangent
    if (CAMERA) {
      bf16 *X = bufX, *Y = bufY;
      // transient output layer: g_t = round(g_ts w_ts) + round(g_tb w_tb)
      for (int e = tid; e < MT * HALF; e += THREADS) {
        const int r = e / HALF, n = e % HALF;
        const float a = bf_round(hs[r * 8 + 4] * bf(wm[M_TS + n]));
        const float b = bf_round(hs[r * 8 + 5] * bf(wm[M_TB + n]));
        X[r * LDA + n] = __float2bfloat16_rn(a + b);
      }
      for (int i = 3; i >= 0; --i) {
        cotangent_out<true>(X, HALF, acts, AS, A_T0 + i * HALF, gpre, GS, G_TR0 + i * HALF,
                            bsum + B_TR + i * HALF, g0, nrows);
        dgemm<false>(X, 0, HALF, wm + (i == 0 ? M_TR0 : M_TR1 + (i - 1) * HALF * HALF),
                     i == 0 ? CAT : HALF, Y, 0, wst);
        bf16* tmp = X; X = Y; Y = tmp;
      }
      __syncthreads();
      // X = [g_bott from the transient head | g_emb | 0]
      if (tid < MT)
        for (int j = 0; j < 4; ++j)
          rowacc[tid * 10 + 6 + j] = tid < nrows ? bf(X[tid * LDA + W + j]) : 0.f;
      // albedo output layer, then the albedo hidden layer's mask
      for (int e = tid; e < MT * HALF; e += THREADS) {
        const int r = e / HALF, n = e % HALF;
        const float s = hs[r * 8 + 1] * bf(wm[M_ALB1 + n]) +
                        hs[r * 8 + 2] * bf(wm[M_ALB1 + HALF + n]) +
                        hs[r * 8 + 3] * bf(wm[M_ALB1 + 2 * HALF + n]);
        Y[r * LDA + n] = __float2bfloat16_rn(s);
      }
      cotangent_out<true>(Y, HALF, acts, AS, A_AH, gpre, GS, G_AH, bsum + B_ALB0, g0, nrows);
      dgemm<true>(Y, 0, HALF, wm + M_ALB0, W, X, 0, wst);     // g_bott += g_ah W_alb0^T
      cotangent_out<false>(X, W, acts, AS, 0, gpre, GS, G_BOTT, bsum + B_BOTT, g0, nrows);
      dgemm<false>(X, 0, W, wm + M_BOTT, W, Y, 0, wst);       // g_h = g_bott W_bott^T
      __syncthreads();
      for (int e = tid; e < MT * W; e += THREADS) {           // + round(g_sig w_sig)
        const int r = e / W, n = e % W;
        Y[r * LDA + n] = __float2bfloat16_rn(bf(Y[r * LDA + n]) +
                                             bf_round(hs[r * 8] * bf(wm[M_SIG + n])));
      }
      C = Y; O = X;
    } else {
      for (int e = tid; e < MT * W; e += THREADS) {           // g_h = round(g_sig w_sig)
        const int r = e / W, n = e % W;
        bufY[r * LDA + n] = __float2bfloat16_rn(hs[r * 8] * bf(wm[M_SIG + n]));
      }
      C = bufY; O = bufX;
    }
    // trunk: layer 5's PE part lands in cols 256..319 of the tile that layer
    // 0's cotangent sits in, and layer 0 adds its own PE part to it in bf16
    for (int i = 7; i >= 0; --i) {
      cotangent_out<true>(C, W, acts, AS, act_h(i), gpre, GS, i * W, bsum + B_T + i * W, g0,
                          nrows);
      if (i == 0) {
        dgemm<true>(C, 0, W, wm + M_T0, PE, C, W, wst);
      } else {
        dgemm<false>(C, 0, W, wm + trunk_offset(i), i == 5 ? CAT : W, O, 0, wst);
        bf16* tmp = C; C = O; O = tmp;
      }
    }
    __syncthreads();
    // d_xb = g_pe * pe'(xb), routed through B's transpose to d_o and d_d
    if (tid < MT) {
      float a6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (tid < nrows) {
        const int s = s0 + tid;
        const long long ray = ray0 + s / KPAD;
        const float* ri = rayin + ray * RAYIN;
        const float zs = z[ray * KPAD + s % KPAD];
        for (int c = 0; c < 63; ++c) {
          int j, deg;
          if (c < 3) { j = c; deg = 0; }
          else if (c < 33) { j = (c - 3) % 3; deg = (c - 3) / 3; }
          else { j = (c - 33) % 3; deg = (c - 33) / 3; }
          const float sc = ldexpf(1.f, deg);
          const float xb =
              __fadd_rn(__fmul_rn(ri[j], sc), __fmul_rn(__fmul_rn(ri[3 + j], sc), zs));
          const float der = c < 3 ? 1.f
                          : sinf(c < 33 ? __fadd_rn(xb, HALF_PI)
                                        : __fadd_rn(__fadd_rn(xb, HALF_PI), HALF_PI));
          const float dxs = bf(C[tid * LDA + W + c]) * der * sc;
          a6[j] += dxs;
          a6[3 + j] += dxs * zs;
        }
      }
      for (int j = 0; j < 6; ++j) rowacc[tid * 10 + j] = a6[j];
      if (!CAMERA)
        for (int j = 6; j < 10; ++j) rowacc[tid * 10 + j] = 0.f;
    }
    __syncthreads();
    for (int lr = tid; lr < nray; lr += THREADS) {   // per-ray sums in sample order
      const int lo = max(lr * KPAD, s0), hi = min((lr + 1) * KPAD, s0 + nrows);
      for (int s = lo; s < hi; ++s)
        for (int c = 0; c < 10; ++c) rayacc[lr * 10 + c] += rowacc[(s - s0) * 10 + c];
    }
  }
  __syncthreads();
  for (int e = tid; e < nray * 10; e += THREADS) {
    const int lr = e / 10, c = e % 10;
    if (CAMERA || c < 6) drayin[(long long)(ray0 + lr) * RAYIN + c] = rayacc[e];
  }
  for (int e = tid; e < NB; e += THREADS) bias_part[(long long)blockIdx.x * NB + e] = bsum[e];
}

// One weight matrix's gradient: dW (in x out) = A^T G over the samples, A
// the layer input (activation stream columns a_col..), G the pre-activation
// cotangent (cotangent stream columns b_col..), packed as (out, in) at m_off.
struct MatJob {
  int in, out, a_col, b_col;
  long long m_off;
};

__device__ MatJob mat_job(int i, bool camera) {
  if (i < 8)
    return {i == 0 ? PE : (i == 5 ? CAT : W), W, i == 0 ? A_PE : (i == 5 ? act_h(4) : act_h(i - 1)),
            i * W, trunk_offset(i)};
  switch (i) {
    case 8: return {W, 1, act_h(7), camera ? G_SIG_CAM : G_SIG_SH, M_SIG};
    case 9: return {W, W, act_h(7), G_BOTT, M_BOTT};
    case 10: return {W, HALF, A_BOTT, G_AH, M_ALB0};
    case 11: return {HALF, 3, A_AH, G_ALB1, M_ALB1};
    case 12: return {CAT, HALF, A_BOTT, G_TR0, M_TR0};
    case 13: case 14: case 15:
      return {HALF, HALF, A_T0 + (i - 13) * HALF, G_TR0 + (i - 12) * HALF,
              M_TR1 + (long long)(i - 13) * HALF * HALF};
    case 16: return {HALF, 1, A_T0 + 3 * HALF, G_TS, M_TS};
    default: return {HALF, 1, A_T0 + 3 * HALF, G_TB, M_TB};
  }
}

int n_mats(bool camera) { return camera ? 18 : 9; }

int n_wgrad_tiles(bool camera) {
  // host-side mirror of mat_job's shapes: (in, out) per matrix
  const int in[18] = {PE, W, W, W, W, CAT, W, W, W, W, W, HALF, CAT, HALF, HALF, HALF, HALF, HALF};
  const int out[18] = {W, W, W, W, W, W, W, W, 1, W, HALF, 3, HALF, HALF, HALF, HALF, 1, 1};
  int n = 0;
  for (int i = 0; i < n_mats(camera); ++i)
    n += ((in[i] + WG_TILE - 1) / WG_TILE) * ((out[i] + WG_TILE - 1) / WG_TILE);
  return n;
}

// Third pass: every weight gradient as a tensor-core product over the
// samples. blockIdx.x walks the (matrix, 128 x 128 output tile) list,
// blockIdx.y the split of the sample axis; each block writes its partial
// sums to its own slice of `wpart` (no atomics).
template <bool CAMERA>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const bf16* __restrict__ acts, const bf16* __restrict__ gpre,
             float* __restrict__ wpart, long long S, long long chunk) {
  __shared__ __align__(16) bf16 sa[WG_TILE * LDW];
  __shared__ __align__(16) bf16 sb[WG_TILE * LDW];
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  constexpr long long GS = CAMERA ? GP_CAM : GP_SH;
  constexpr long long NMAT = CAMERA ? M_END : M_BOTT;
  int t = blockIdx.x, mt = 0, nt = 0;
  MatJob jb = mat_job(0, CAMERA);
  for (int i = 0; i < 18; ++i) {
    jb = mat_job(i, CAMERA);
    const int tm = (jb.in + WG_TILE - 1) / WG_TILE, tn = (jb.out + WG_TILE - 1) / WG_TILE;
    if (t < tm * tn) { mt = t / tn; nt = t % tn; break; }
    t -= tm * tn;
  }
  const int m0 = mt * WG_TILE, n0 = nt * WG_TILE;
  const int out_pad = (jb.out + 7) / 8 * 8;
  const long long sbeg = blockIdx.y * chunk;
  const long long send = min(S, sbeg + chunk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float acc[WG_TILE / 8][4];
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (long long k0 = sbeg; k0 < send; k0 += KC) {
    __syncthreads();
    // stage A^T and G^T chunks: (feature, sample) in shared memory
    for (int v = threadIdx.x; v < KC * (WG_TILE / 8); v += THREADS) {
      const int kk = v / (WG_TILE / 8), cv = (v % (WG_TILE / 8)) * 8;
      const long long s = k0 + kk;
      uint4 a8 = make_uint4(0u, 0u, 0u, 0u), b8 = make_uint4(0u, 0u, 0u, 0u);
      if (s < send) {
        if (m0 + cv < jb.in)
          a8 = *reinterpret_cast<const uint4*>(acts + s * AS + jb.a_col + m0 + cv);
        if (n0 + cv < out_pad)
          b8 = *reinterpret_cast<const uint4*>(gpre + s * GS + jb.b_col + n0 + cv);
      }
      const bf16* ae = reinterpret_cast<const bf16*>(&a8);
      const bf16* be = reinterpret_cast<const bf16*>(&b8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sa[(cv + j) * LDW + kk] = ae[j];
        sb[(cv + j) * LDW + kk] = be[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      const bf16* ap = sa + (warp * 16 + g) * LDW + kk + 2 * tq;
      const uint32_t a0 = ld_u32(ap), a1 = ld_u32(ap + 8 * LDW);
      const uint32_t a2 = ld_u32(ap + 8), a3 = ld_u32(ap + 8 * LDW + 8);
#pragma unroll
      for (int j = 0; j < WG_TILE / 8; ++j) {
        const bf16* bp = sb + (j * 8 + g) * LDW + kk + 2 * tq;
        mma_bf16(acc[j], a0, a1, a2, a3, ld_u32(bp), ld_u32(bp + 8));
      }
    }
  }
  float* dst = wpart + blockIdx.y * NMAT + jb.m_off;
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) {
    const int n = n0 + j * 8 + 2 * tq;
    const int m = m0 + warp * 16 + g;
    for (int q = 0; q < 4; ++q) {
      const int mm = m + (q >= 2 ? 8 : 0), nn = n + (q & 1);
      if (mm < jb.in && nn < jb.out) dst[(long long)nn * jb.in + mm] = acc[j][q];
    }
  }
}

// Last pass: the fixed-order reduction of the partial sums, so the result
// does not depend on scheduling (deterministic from run to run).
__global__ void reduce_kernel(const float* __restrict__ wpart, int splits, long long n_mat,
                              const float* __restrict__ bpart, int nblocks, int n_bias,
                              float* __restrict__ dmats, float* __restrict__ dbias) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n_mat + n_bias;
       e += stride) {
    float s = 0.f;
    if (e < n_mat) {
      for (int p = 0; p < splits; ++p) s += wpart[p * n_mat + e];
      dmats[e] = s;
    } else {
      const long long eb = e - n_mat;
      for (int b = 0; b < nblocks; ++b) s += bpart[(long long)b * n_bias + eb];
      dbias[eb] = s;
    }
  }
}

// Scratch of one backward call, carved out of one workspace in this order.
struct BwdLayout {
  long long S;
  int nblocks, splits;
  long long chunk;
  size_t acts, gpre, hg, bpart, wpart, total;   // byte offsets; total = size
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

BwdLayout bwd_layout(bool camera, int R, int KPAD) {
  BwdLayout L;
  const int rpb = rays_per_block(KPAD);
  L.S = (long long)R * KPAD;
  L.nblocks = (R + rpb - 1) / rpb;
  L.splits = (int)std::max(1LL, std::min((long long)MAX_SPLITS, L.S / 1024));
  L.chunk = ((L.S + L.splits - 1) / L.splits + KC - 1) / KC * KC;
  const long long as = camera ? ACT_CAM : ACT_SH, gs = camera ? GP_CAM : GP_SH;
  const long long n_mat = camera ? M_END : M_BOTT, n_bias = camera ? B_END : B_BOTT;
  L.acts = 0;
  L.gpre = align256(L.acts + (size_t)L.S * as * sizeof(bf16));
  L.hg = align256(L.gpre + (size_t)L.S * gs * sizeof(bf16));
  L.bpart = align256(L.hg + (size_t)L.S * HG * sizeof(float));
  L.wpart = align256(L.bpart + (size_t)L.nblocks * n_bias * sizeof(float));
  L.total = align256(L.wpart + (size_t)L.splits * n_mat * sizeof(float));
  return L;
}

size_t dgrad_smem(int KPAD) {
  return (size_t)(2 * MT * LDA + NC * LDW) * sizeof(bf16) +
         (size_t)(B_END + 2 + MT * 8 + MT * 10 + rays_per_block(KPAD) * 10) * sizeof(float);
}

template <bool CAMERA>
int launch_bwd(const float* rayin, const float* z, const float* deltam, const float* mask,
               const float* gin, const void* wm_, const float* wb, void* ws, float* dmats,
               float* dbias, float* drayin, int R, int KPAD, cudaStream_t stream) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD) return (int)cudaErrorInvalidValue;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const BwdLayout L = bwd_layout(CAMERA, R, KPAD);
  unsigned char* base = static_cast<unsigned char*>(ws);
  bf16* acts = reinterpret_cast<bf16*>(base + L.acts);
  bf16* gpre = reinterpret_cast<bf16*>(base + L.gpre);
  float* hg = reinterpret_cast<float*>(base + L.hg);
  float* bpart = reinterpret_cast<float*>(base + L.bpart);
  float* wpart = reinterpret_cast<float*>(base + L.wpart);
  int err = launch<CAMERA, true>(rayin, z, deltam, mask, wm, wb, nullptr, R, KPAD, stream, gin,
                                 acts, hg);
  if (err != 0) return err;
  const int rpb = rays_per_block(KPAD);
  const size_t smem = dgrad_smem(KPAD);
  cudaError_t e = cudaFuncSetAttribute(dgrad_kernel<CAMERA>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dgrad_kernel<CAMERA><<<L.nblocks, THREADS, smem, stream>>>(rayin, z, wm, acts, hg, gpre, bpart,
                                                             drayin, R, KPAD, rpb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<CAMERA><<<dim3(n_wgrad_tiles(CAMERA), L.splits), THREADS, 0, stream>>>(
      acts, gpre, wpart, L.S, L.chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n_mat = CAMERA ? M_END : M_BOTT;
  const int n_bias = CAMERA ? B_END : B_BOTT;
  reduce_kernel<<<1024, THREADS, 0, stream>>>(wpart, L.splits, n_mat, bpart, L.nblocks, n_bias,
                                              dmats, dbias);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// [bf16 matrix elements, f32 bias elements] of the full packed weights, then
// of the density prefix the shadow kernel reads.
void eonerf_weight_layout(long long* sizes) {
  sizes[0] = M_END;
  sizes[1] = B_END;
  sizes[2] = M_BOTT;
  sizes[3] = B_BOTT;
}

int eonerf_camera_fwd(const float* rayin, const float* z, const float* deltam, const void* wm,
                      const float* wb, float* acc, int R, int KPAD, void* stream) {
  return launch<true, false>(rayin, z, deltam, nullptr, wm, wb, acc, R, KPAD,
                             static_cast<cudaStream_t>(stream));
}

int eonerf_shadow_fwd(const float* rayin, const float* z, const float* deltam, const float* mask,
                      const void* wm, const float* wb, float* geo, int R, int KPAD, void* stream) {
  return launch<false, false>(rayin, z, deltam, mask, wm, wb, geo, R, KPAD,
                              static_cast<cudaStream_t>(stream));
}

// Bytes of scratch one backward call needs (camera != 0: the camera's).
long long eonerf_bwd_workspace_bytes(int camera, int R, int KPAD) {
  return (long long)bwd_layout(camera != 0, R, KPAD).total;
}

// Backward of the camera op: gacc (R, 8) -> d_mats, d_biases (packed,
// float32) and d_rayin (R, 16, columns 0..9 written).
int eonerf_camera_bwd(const float* rayin, const float* z, const float* deltam, const float* gacc,
                      const void* wm, const float* wb, void* ws, float* dmats, float* dbias,
                      float* drayin, int R, int KPAD, void* stream) {
  return launch_bwd<true>(rayin, z, deltam, nullptr, gacc, wm, wb, ws, dmats, dbias, drayin, R,
                          KPAD, static_cast<cudaStream_t>(stream));
}

// Backward of the shadow op: ggeo (R,) -> the density prefix of d_mats and
// d_biases, and d_rayin columns 0..5.
int eonerf_shadow_bwd(const float* rayin, const float* z, const float* deltam, const float* mask,
                      const float* ggeo, const void* wm, const float* wb, void* ws, float* dmats,
                      float* dbias, float* drayin, int R, int KPAD, void* stream) {
  return launch_bwd<false>(rayin, z, deltam, mask, ggeo, wm, wb, ws, dmats, dbias, drayin, R,
                           KPAD, static_cast<cudaStream_t>(stream));
}

const char* eonerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
