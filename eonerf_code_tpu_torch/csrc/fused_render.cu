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
// coarse: replaces `_coarse_fwd_kernel` of the same file (make_fused_coarse),
//   the hierarchical sampler's PDF source. The shadow kernel's density work
//   with another epilogue: the per-sample weights T_i (1 - e^-sigma_i
//   deltam_i), T the EXCLUSIVE transmittance, written as (R, KPAD). The
//   last valid sample carries the 1e10 sentinel in deltam, so its alpha
//   saturates to 1. Forward only.
// density: replaces `_density_fwd_kernel` of the JAX package's
//   ops/pallas/fused_field.py (make_fused_density): per-point sigma for
//   points (N, 3). The PE is built from xyz directly (xb = x*2^deg, the ray
//   form with d = 0, z = 0, bit for bit), and the points fill the 128-row
//   tiles directly: no ray structure, no padding to 8 samples a point.
// field: replaces `_field_fwd_kernel` of the same file (make_fused_field):
//   the density kernel's points with the camera heads after the trunk, the
//   4-wide embedding read per point, written as (N, 8) =
//   [sigma, albedo r g b, t_s, t_beta, 0, 0]. Both are point_kernel.
// int8 trunk tier: replaces the int8 bodies of the camera, shadow and
//   coarse kernels (`_trunk_fwd_q8`, `_trunk_bwd_q8`); see its section below.
//
// What bounds them on this card: operations. Every sample runs the trunk
// (0.49 M multiply-adds) and, for the camera, the heads (0.19 M more), while
// a ray brings in 64 B plus 8 B per sample and takes out 32 B; the 1.2 MB of
// bf16 weights are shared by every block and stay in L2. So the work is
// bf16 matrix products at a few thousand operations per byte moved, far on
// the compute side of the H100's ~295 op/B ridge.
//
// The coarse and density kernels are bound the same way: the density trunk's
// 0.49 M multiply-adds per sample against 12-40 B per sample moved.
//
// What the design does about it: the per-sample activations never leave the
// SM. A block owns whole rays (128 sample rows per tile, looping over tiles;
// a tile may hold the end of one ray and the start of the next, and a block
// takes as many rays as fill its tiles exactly, see rays_per_block); the
// activations ping-pong between two bf16 tiles in shared memory (128 x 328
// each, 164 KB together), every
// layer is a tensor-core product (tile_common.cuh gemm: wgmma m64nNk16, bf16
// in, f32 accumulate, the tile's rows from registers) with 32-deep chunks of
// the weights streamed through a 3-stage cp.async ring in shared memory, and
// the f32 bias + ReLU + bf16 rounding happen in the product's epilogue. The
// TPU kernel's 0/1 selector matmuls (its only way to move between the
// (points, features) and (rays, samples) shapes) become plain indexing, and
// the compositing scan runs per ray in f32 from per-sample results kept in
// shared memory.
//
// Semantics kept from the TPU kernel: xb = o*B + (d*B)*z in f32, B the
// power-of-two frequency pattern, cos lanes as one phased sin(xb + pi/2);
// activations rounded to bf16 after each ReLU; the layer-5 input is
// [h4, pe]; the transient input is [bottleneck, embedding(4), 0...];
// padded samples (deltam = 0) add no extinction.
//
// Backward: camera_bwd replaces `_camera_bwd_kernel` (make_fused_camera's
// backward), shadow_bwd `_shadow_bwd_kernel` (make_fused_shadow's). Both
// recompute the forward (flash-style; the plain forward saves nothing) and
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
//      down to the PE in bf16 tiles in shared memory (each g @ W^T a
//      wgmma product, tile_common.cuh dgemm, f32 accumulation, bf16
//      rounding at its output, as the JAX package's _mm_t), ReLU masks read
//      back from the activation
//      stream; it writes every layer's pre-activation cotangent to a
//      cotangent stream, its block's f32 bias-gradient sums, and d_rayin;
//   3. wgrad_kernel: every weight gradient as inputs^T @ cotangents over all
//      samples (tile_common.cuh wgemm: both streams' rows staged as they lie
//      by cp.async, the transposes in wgmma, f32), split over the sample
//      axis into per-block partial sums;
//   4. reduce_kernel: the partial sums added in a fixed order, so the
//      gradients are the same bits from run to run (no atomics).
// The streams cost (3072 + 2976) bf16 per camera sample: 1.6 GB at 1024
// rays x 128 samples, read back once by each later pass.
//
// Saved activations (the JAX package's default bwd_acts="saved"):
// camera_fwd_save and shadow_fwd_save replace `_camera_fwd_kernel` and
// `_shadow_fwd_kernel` run with save=True, camera_bwd_saved and
// shadow_bwd_saved their backwards with saved=True. The differentiated
// forward is fused_fwd_kernel<MODE, false, false, /*SAVE=*/true>: the
// plain forward (its outputs bit for bit) that also writes the PE and
// h0..h7 of every sample row (ray * KPAD + k) into an activation stream
// with the backward's layout and stride (ACT_CAM, ACT_SH), which the caller
// keeps from forward to backward. The saved backward then skips the PE and
// the eight trunk products: its first pass is fused_fwd_kernel<MODE, true,
// /*FROM_STREAM=*/true>, the heads and the compositing backward from h7 in
// that stream (the camera's head activations written into it), then the
// same dgrad, wgrad and reduction, reading the stream in place of the
// workspace's activation region, which the saved workspace leaves out. The
// trunk's bf16 activations are the same bits in both modes, so the saved
// gradients equal the recompute backward's. What bounds the saving: the
// stream's bytes (2112 bf16 a sample, written once and read by the three
// later passes) against the trunk's 0.49 M multiply-adds a sample that the
// recompute would redo.
//
// field_bwd and density_bwd replace `_field_bwd_kernel` and
// `_density_bwd_kernel` (make_fused_field's and make_fused_density's
// backward) with the same four passes in a per-point mode: tile rows are
// points (a block owns 128 of them, none padded), the first pass is
// point_kernel<_, true>, whose head cotangents come from the output
// cotangent (N, 8) or (N,) instead of a compositing VJP, and dgrad writes
// each point's d_pos (and, for the field, d_emb) instead of per-ray sums.
// Their streams have the camera's and the shadow's layouts, so wgrad and
// the reduction are shared unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>

#include "tile_common.cuh"   // the tile machinery, shared with kernel_variants.cu

namespace {

constexpr int RAYIN = 16;     // [o(3), d(3), emb(4), 0*6]
constexpr int ACC = 8;
constexpr int MAX_KPAD = 1024;

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

// What a launch of fused_fwd_kernel computes per ray after the trunk.
enum Mode { CAM = 0, SHADOW = 1, COARSE = 2 };

// The camera heads of one 128-row tile whose trunk output h7 sits in P (Q is
// free; both are overwritten): the bottleneck, the albedo head into
// res[r * RES + 1..3], the 4x128 transient MLP over [bottleneck | embedding
// (4) | 0...] and its t_s and t_beta heads into res[r * RES + 4, 5], for the
// tile's rows r < nrows (rows past them run on zeros and are not written).
// emb(r, c) is component c of row r's embedding. STREAM: every activation
// also goes to the activation stream (ACT_CAM layout, rows g0..). The caller
// syncs before reading res.
template <bool STREAM, typename Emb>
__device__ __forceinline__ void camera_heads(bf16* P, bf16* Q, const bf16* __restrict__ wm,
                                             const float* __restrict__ wb, bf16* wst, float* res,
                                             int nrows, Emb emb, bf16* acts, long long g0) {
  gemm<false>(P, 0, W, wm + M_BOTT, wb + B_BOTT, W, Q, wst);   // bottleneck -> Q
  // the embedding into Q's cols 256..259 (260..319 zero)
  for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
    const int r = e / PE, c = e % PE;
    Q[r * LDA + W + c] = __float2bfloat16_rn(r < nrows && c < 4 ? emb(r, c) : 0.f);
  }
  if (STREAM) {
    __syncthreads();
    tile_to_stream(Q, 0, CAT, acts, ACT_CAM, g0, nrows, A_BOTT);   // [bott | emb64]
  }
  gemm<true>(Q, 0, W, wm + M_ALB0, wb + B_ALB0, HALF, P, wst);  // albedo hidden -> P
  __syncthreads();
  if (STREAM) tile_to_stream(P, 0, HALF, acts, ACT_CAM, g0, nrows, A_AH);
  for (int r = threadIdx.x; r < nrows; r += THREADS)
    for (int c = 0; c < 3; ++c)
      res[r * RES + 1 + c] =
          sigmoid(dot_row(P + r * LDA, wm + M_ALB1 + c * HALF, HALF) + wb[B_ALB1 + c]);
  gemm<true>(Q, 0, CAT, wm + M_TR0, wb + B_TR, HALF, P, wst);  // [bott | emb] -> P
  if (STREAM) { __syncthreads(); tile_to_stream(P, 0, HALF, acts, ACT_CAM, g0, nrows, A_T0); }
  gemm<true>(P, 0, HALF, wm + M_TR1, wb + B_TR + HALF, HALF, Q, wst);
  if (STREAM) {
    __syncthreads();
    tile_to_stream(Q, 0, HALF, acts, ACT_CAM, g0, nrows, A_T0 + HALF);
  }
  gemm<true>(Q, 0, HALF, wm + M_TR1 + HALF * HALF, wb + B_TR + 2 * HALF, HALF, P, wst);
  if (STREAM) {
    __syncthreads();
    tile_to_stream(P, 0, HALF, acts, ACT_CAM, g0, nrows, A_T0 + 2 * HALF);
  }
  gemm<true>(P, 0, HALF, wm + M_TR1 + 2 * HALF * HALF, wb + B_TR + 3 * HALF, HALF, Q, wst);
  __syncthreads();
  if (STREAM) tile_to_stream(Q, 0, HALF, acts, ACT_CAM, g0, nrows, A_T0 + 3 * HALF);
  for (int r = threadIdx.x; r < nrows; r += THREADS) {
    res[r * RES + 4] = sigmoid(dot_row(Q + r * LDA, wm + M_TS, HALF) + wb[B_TS]);
    res[r * RES + 5] = softplus(dot_row(Q + r * LDA, wm + M_TB, HALF) + wb[B_TB]);
  }
}

// One block per group of `rpb` whole rays; KPAD samples per ray (a multiple
// of 8, <= MAX_KPAD); rows s = ray * KPAD + k of the block's sample axis are
// processed 128 at a time.
//
// BWD = false: the forward (CAM: acc (R, 8); SHADOW: geo (R,); COARSE: the
// weights (R, KPAD) into `out`).
// BWD = true (CAM and SHADOW): the first pass of the backward. The same
// recompute, which also streams every activation to `acts`, then the
// compositing backward per ray in f32 for the per-ray cotangent `gin`
// (camera: gacc (R, 8); shadow: ggeo (R,)), writing the per-sample head
// cotangents to `hg`.
// FROM_STREAM: the heads from an activation stream. The trunk output h7
// is read from `acts` (written there by the int8 trunk, or by any pass that
// fills the stream's layout) instead of running the PE and the bf16 trunk;
// the heads, their stream writes (BWD) and the compositing are unchanged.
// SAVE (CAM and SHADOW forwards): the forward also writes the PE and the
// trunk activations h0..h7 to `acts`, as the backward's recompute does.
template <int MODE, bool BWD, bool FROM_STREAM = false, bool SAVE = false>
__global__ void __launch_bounds__(THREADS, 1)
fused_fwd_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                 const float* __restrict__ deltam, const float* __restrict__ mask,
                 const bf16* __restrict__ wm, const float* __restrict__ wb,
                 float* __restrict__ out, int R, int KPAD, int rpb,
                 const float* __restrict__ gin, bf16* __restrict__ acts,
                 float* __restrict__ hg) {
  static_assert(!SAVE || (!BWD && !FROM_STREAM && MODE != COARSE),
                "SAVE is a camera or shadow forward");
  constexpr bool CAMERA = MODE == CAM;
  constexpr bool STREAM = BWD || SAVE;   // the PE and the trunk go to `acts`
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* res = reinterpret_cast<float*>(wst + WST);
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int S = nray * KPAD;

  for (int s0 = 0; s0 < S; s0 += MT) {
    const int nrows = min(MT, S - s0);
    const long long g0 = (long long)ray0 * KPAD + s0;   // stream row of tile row 0
    bf16* P;
    if (FROM_STREAM) {
      for (int v = threadIdx.x; v < MT * (W / 8); v += THREADS) {
        const int r = v / (W / 8), c = (v % (W / 8)) * 8;
        uint4 h8 = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrows) h8 = *reinterpret_cast<const uint4*>(acts + (g0 + r) * AS + act_h(7) + c);
        *reinterpret_cast<uint4*>(bufX + r * LDA + c) = h8;
      }
      __syncthreads();
      P = bufX;
    } else {
      // positional encoding into the PE columns of both tiles; rows past the
      // block's samples get zeros
      for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
        const int r = e / PE, c = e % PE, s = s0 + r;
        float v = 0.f;
        if (s < S && c < 63) {
          const int ray = ray0 + s / KPAD;
          const float* ri = rayin + (long long)ray * RAYIN;
          int j;
          float sc;
          pe_lane(c, j, sc);
          const float zs = z[(long long)ray * KPAD + s % KPAD];
          v = pe_value(c, ray_xb(ri, j, sc, zs));
        }
        const bf16 pv = __float2bfloat16_rn(v);
        bufX[r * LDA + W + c] = pv;
        bufY[r * LDA + W + c] = pv;
      }
      if (STREAM) {
        __syncthreads();
        tile_to_stream(bufX, W, PE, acts, AS, g0, nrows, A_PE);
      }
      P = trunk_tile<STREAM>(bufX, bufY, wm, wb, wst, acts, AS, g0, nrows);   // P holds h7
    }
    for (int r = threadIdx.x; r < nrows; r += THREADS)
      res[(s0 + r) * RES] = softplus(dot_row(P + r * LDA, wm + M_SIG, W) + wb[B_SIG]);
    if constexpr (CAMERA) {
      // the ray's transient embedding, one per row
      camera_heads<BWD>(P, P == bufX ? bufY : bufX, wm, wb, wst, res + s0 * RES, nrows,
                        [&](int r, int c) {
                          return rayin[(long long)(ray0 + (s0 + r) / KPAD) * RAYIN + 6 + c];
                        },
                        acts, g0);
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
    } else if (MODE == COARSE) {
      // render_weights: w = T (1 - e^-sd), T the exclusive transmittance;
      // kept in the sample's result row until the block writes them out
      float excl = 0.f;
      for (int k = 0; k < KPAD; ++k) {
        const float sd = rs[k * RES] * dr[k];
        rs[k * RES + 1] = expf(-excl) * (1.f - expf(-sd));
        excl += sd;
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
  if (MODE == COARSE) {
    // the block's weights out in sample order (row ray * KPAD + k of the
    // (R, KPAD) output), neighbouring threads on neighbouring samples
    __syncthreads();
    for (int e = threadIdx.x; e < S; e += THREADS)
      out[(long long)ray0 * KPAD + e] = res[e * RES + 1];
  }
}

// Per-point density and field: one block per 128 points, which fill the
// tile's rows directly. PE from xyz into both tiles, the trunk and the sigma
// head, then with FIELD the camera heads (the embedding read per point).
// BWD = false: the forward; FIELD writes out (N, 8) = [sigma, albedo r g b,
// t_s, t_beta, 0, 0], the density sigma (N,).
// BWD = true: the first pass of the backward. The same recompute, which also
// streams every activation to `acts` (FIELD: the camera's layout, else the
// shadow's), then each point's head cotangents at the pre-activations, from
// the output cotangent `gin` ((N, 8) in the forward's layout, or (N,)), into
// `hg`. The softplus heads' derivative sigmoid(x) is 1 - exp(-softplus(x)).
template <bool FIELD, bool BWD>
__global__ void __launch_bounds__(THREADS, 1)
point_kernel(const float* __restrict__ pos, const float* __restrict__ emb,
             const bf16* __restrict__ wm, const float* __restrict__ wb, float* __restrict__ out,
             int N, const float* __restrict__ gin, bf16* __restrict__ acts,
             float* __restrict__ hg) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* res = reinterpret_cast<float*>(wst + WST);   // MT x RES
  constexpr long long AS = FIELD ? ACT_CAM : ACT_SH;
  constexpr int NO = FIELD ? ACC : 1;                     // outputs per point
  const long long p0 = (long long)blockIdx.x * MT;
  const int nrows = N - p0 < MT ? (int)(N - p0) : MT;
  for (int e = threadIdx.x; e < MT * PE; e += THREADS) {
    const int r = e / PE, c = e % PE;
    float v = 0.f;
    if (r < nrows && c < 63) {
      int j;
      float sc;
      pe_lane(c, j, sc);
      v = pe_value(c, __fmul_rn(pos[(p0 + r) * 3 + j], sc));
    }
    const bf16 pv = __float2bfloat16_rn(v);
    bufX[r * LDA + W + c] = pv;
    bufY[r * LDA + W + c] = pv;
  }
  if (BWD) {
    __syncthreads();
    tile_to_stream(bufX, W, PE, acts, AS, p0, nrows, A_PE);
  }
  bf16* P = trunk_tile<BWD>(bufX, bufY, wm, wb, wst, acts, AS, p0, nrows);   // P holds h7
  for (int r = threadIdx.x; r < nrows; r += THREADS)
    res[r * RES] = softplus(dot_row(P + r * LDA, wm + M_SIG, W) + wb[B_SIG]);
  if constexpr (FIELD) {
    camera_heads<BWD>(P, P == bufX ? bufY : bufX, wm, wb, wst, res, nrows,
                      [&](int r, int c) { return emb[(p0 + r) * 4 + c]; }, acts, p0);
  }
  __syncthreads();
  // outputs or head cotangents, neighbouring threads on neighbouring addresses
  for (int e = threadIdx.x; e < nrows * NO; e += THREADS) {
    const int r = e / NO, c = e % NO;
    const float* rs = res + r * RES;
    if (!BWD) {
      out[p0 * NO + e] = c < 6 ? rs[c] : 0.f;
    } else {
      const float g = gin[p0 * NO + e];
      float v = 0.f;
      if (c == 0 || c == 5) v = g * -expm1f(-rs[c]);       // sigma, t_beta (softplus)
      else if (c < 5) v = g * rs[c] * (1.f - rs[c]);        // albedo, t_s (sigmoid)
      hg[(p0 + r) * HG + c] = v;
    }
  }
}

// Rays a block owns: as many as fill its 128-row tiles exactly (KPAD 96:
// 4 rays in 3 tiles; KPAD 144: 8 rays in 9 tiles), unless that keeps more
// than MAX_BLOCK_SAMPLES per-sample results in shared memory; then as many
// whole rays as one tile holds, at least one.
constexpr int MAX_BLOCK_SAMPLES = 1280;

int rays_per_block(int KPAD) {
  const int fill = MT / std::gcd(MT, KPAD);
  if (fill * KPAD <= MAX_BLOCK_SAMPLES) return fill;
  return KPAD >= MT ? 1 : MT / KPAD;
}

size_t fwd_smem(int KPAD) {
  return (size_t)(2 * MT * LDA + WST) * sizeof(bf16) +
         (size_t)rays_per_block(KPAD) * KPAD * RES * sizeof(float);
}

template <int MODE, bool BWD, bool FROM_STREAM = false, bool SAVE = false>
int launch(const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, float* out, int R, int KPAD, cudaStream_t stream,
           const float* gin = nullptr, bf16* acts = nullptr, float* hg = nullptr) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD) return (int)cudaErrorInvalidValue;
  const int rpb = rays_per_block(KPAD);
  const int grid = (R + rpb - 1) / rpb;
  const size_t smem = fwd_smem(KPAD);
  cudaError_t err = cudaFuncSetAttribute(fused_fwd_kernel<MODE, BWD, FROM_STREAM, SAVE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<MODE, BWD, FROM_STREAM, SAVE><<<grid, THREADS, smem, stream>>>(
      rayin, z, deltam, mask, static_cast<const bf16*>(wm), wb, out, R, KPAD, rpb, gin, acts,
      hg);
  return (int)cudaGetLastError();
}

template <bool FIELD, bool BWD>
int launch_point(const float* pos, const float* emb, const void* wm, const float* wb, float* out,
                 int N, cudaStream_t stream, const float* gin = nullptr, bf16* acts = nullptr,
                 float* hg = nullptr) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * MT * LDA + WST) * sizeof(bf16) + (size_t)MT * RES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(point_kernel<FIELD, BWD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  point_kernel<FIELD, BWD><<<(N + MT - 1) / MT, THREADS, smem, stream>>>(
      pos, emb, static_cast<const bf16*>(wm), wb, out, N, gin, acts, hg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: the cotangent chain (dgrad) and the weight gradients (wgrad)
// ---------------------------------------------------------------------------

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
// d_rayin = [d_o, d_d, d_emb] into `dout`.
// POINT: rows are points (R = N, KPAD = 1, rpb = MT: 128 points a block,
// one tile), `rayin` holds the points (N, 3) and z is not read; each point's
// d_pos goes to `dout` (N, 3) and, with CAMERA, its d_emb to `demb` (N, 4).
// TRUNK = false (the int8_full backward, whose trunk chain runs layer by
// layer in q8_dgrad_kernel): the heads' chain only; the trunk output's
// cotangent g_h7 goes to `gh` (one bf16 row of 256 per sample), and d_rayin
// gets d_emb with zeros in place of d_o and d_d.
template <bool CAMERA, bool POINT, bool TRUNK = true>
__global__ void __launch_bounds__(THREADS, 1)
dgrad_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
             const bf16* __restrict__ wm, const bf16* __restrict__ acts,
             const float* __restrict__ hg, bf16* __restrict__ gpre,
             float* __restrict__ bias_part, float* __restrict__ dout, float* __restrict__ demb,
             int R, int KPAD, int rpb, bf16* __restrict__ gh) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int NB = CAMERA ? B_END : B_BOTT;
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  constexpr long long GS = CAMERA ? GP_CAM : GP_SH;
  constexpr int GSIG = CAMERA ? G_SIG_CAM : G_SIG_SH;
  constexpr int NH = CAMERA ? 6 : 1;        // head cotangents per sample
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* bsum = reinterpret_cast<float*>(wst + WST);  // B_END floats
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
    if (!TRUNK) {
      __syncthreads();
      tile_to_stream(C, 0, W, gh, W, g0, nrows, 0);
    }
    // trunk: layer 5's PE part lands in cols 256..319 of the tile that layer
    // 0's cotangent sits in, and layer 0 adds its own PE part to it in bf16
    for (int i = 7; TRUNK && i >= 0; --i) {
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
    // (d_pos for points)
    if (tid < MT) {
      float a6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (TRUNK && tid < nrows) {
        const int s = s0 + tid;
        const long long ray = ray0 + s / KPAD;
        const float* ri = rayin + ray * (POINT ? 3 : RAYIN);
        const float zs = POINT ? 0.f : z[ray * KPAD + s % KPAD];
        for (int c = 0; c < 63; ++c) {
          int j;
          float sc;
          pe_lane(c, j, sc);
          const float xb =
              POINT ? __fmul_rn(ri[j], sc)
                    : ray_xb(ri, j, sc, zs);
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
    const long long row = ray0 + lr;
    if (!POINT) {
      if (CAMERA || c < 6) dout[row * RAYIN + c] = rayacc[e];
    } else if (c < 3) {
      dout[row * 3 + c] = rayacc[e];
    } else if (CAMERA && c >= 6) {
      demb[row * 4 + c - 6] = rayacc[e];
    }
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

// 128 x 128 weight-gradient tiles of the first n matrices (host-side mirror of
// mat_job's (in, out) shapes)
int wgrad_tiles_of(int n) {
  const int in[18] = {PE, W, W, W, W, CAT, W, W, W, W, W, HALF, CAT, HALF, HALF, HALF, HALF, HALF};
  const int out[18] = {W, W, W, W, W, W, W, W, 1, W, HALF, 3, HALF, HALF, HALF, HALF, 1, 1};
  int t = 0;
  for (int i = 0; i < n; ++i)
    t += ((in[i] + WG_TILE - 1) / WG_TILE) * ((out[i] + WG_TILE - 1) / WG_TILE);
  return t;
}

int n_wgrad_tiles(bool camera) { return wgrad_tiles_of(n_mats(camera)); }

int n_trunk_wgrad_tiles() { return wgrad_tiles_of(8); }

// Third pass: every weight gradient as a tensor-core product over the
// samples (tile_common.cuh wgemm: the stream rows staged as they lie through
// a cp.async ring, the transposes in wgmma). blockIdx.x walks the (matrix,
// 128 x 128 output tile) list from tile0, blockIdx.y the split of the
// sample axis; each block writes its partial sums to its own slice of
// `wpart` (no atomics). Consecutive blocks are the tiles of one split, so a
// split's tiles stream its rows together and the rows they share are read
// from HBM about once.
template <bool CAMERA>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_kernel(const bf16* __restrict__ acts, const bf16* __restrict__ gpre,
             float* __restrict__ wpart, long long S, long long chunk, int tile0) {
  extern __shared__ __align__(1024) unsigned char wring[];
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  constexpr long long GS = CAMERA ? GP_CAM : GP_SH;
  constexpr long long NMAT = CAMERA ? M_END : M_BOTT;
  int t = blockIdx.x + tile0, mt = 0, nt = 0;
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
  const bf16* a_src = acts + jb.a_col + m0;
  const bf16* g_src = gpre + jb.b_col + n0;
  const int a_cols = min(WG_TILE, jb.in - m0), g_cols = min(WG_TILE, out_pad - n0);
  const uint32_t ring = smem_addr(wring);
  float acc[64];
  wgemm(acc, (int)max(0LL, (send - sbeg + WKC - 1) / WKC), m0 + (threadIdx.x >> 7) * 64 < jb.in,
        wring, [&](int s, int q) {
          const uint32_t st = ring + s * WSTAGE_BYTES;
          const long long r0 = sbeg + (long long)q * WKC;
          stage_rows(st, a_src, AS, r0, send, a_cols);
          stage_rows(st + WOP_BYTES, g_src, GS, r0, send, g_cols);
        });
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* dst = wpart + blockIdx.y * NMAT + jb.m_off;
  const int m = m0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) {
    const int n = n0 + j * 8 + 2 * tq;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mm = m + (q >= 2 ? 8 : 0), nn = n + (q & 1);
      if (mm < jb.in && nn < jb.out) dst[(long long)nn * jb.in + mm] = acc[4 * j + q];
    }
  }
}

// Launch the weight-gradient pass: the tiles from tile0 over L.splits
// sample splits of L.chunk rows.
template <bool CAMERA>
int launch_wgrad(const bf16* acts, const bf16* gpre, float* wpart, long long S, int splits,
                 long long chunk, int tile0, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<CAMERA>, cudaFuncAttributeMaxDynamicSharedMemorySize, WRING_BYTES);
  if (e != cudaSuccess) return (int)e;
  wgrad_kernel<CAMERA><<<dim3(n_wgrad_tiles(CAMERA) - tile0, splits), THREADS, WRING_BYTES,
                         stream>>>(acts, gpre, wpart, S, chunk, tile0);
  return (int)cudaGetLastError();
}

// Scratch of one backward call, carved out of one workspace in this order.
struct BwdLayout {
  long long S;
  int nblocks, splits;
  long long chunk;
  size_t acts, gpre, hg, bpart, wpart, total;   // byte offsets; total = size
};

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// S stream rows (samples or points) in nblocks dgrad blocks. Without
// `with_acts` (the saved backward) the activation stream is the caller's and
// the workspace starts at the cotangent stream.
BwdLayout bwd_layout(bool camera, long long S, int nblocks, bool with_acts = true) {
  BwdLayout L;
  L.S = S;
  L.nblocks = nblocks;
  L.splits = (int)std::max(1LL, std::min((long long)MAX_SPLITS, L.S / 1024));
  L.chunk = ((L.S + L.splits - 1) / L.splits + KC - 1) / KC * KC;
  const long long as = camera ? ACT_CAM : ACT_SH, gs = camera ? GP_CAM : GP_SH;
  const long long n_mat = camera ? M_END : M_BOTT, n_bias = camera ? B_END : B_BOTT;
  L.acts = 0;
  L.gpre = align256(L.acts + (with_acts ? (size_t)L.S * as * sizeof(bf16) : 0));
  L.hg = align256(L.gpre + (size_t)L.S * gs * sizeof(bf16));
  L.bpart = align256(L.hg + (size_t)L.S * HG * sizeof(float));
  L.wpart = align256(L.bpart + (size_t)L.nblocks * n_bias * sizeof(float));
  L.total = align256(L.wpart + (size_t)L.splits * n_mat * sizeof(float));
  return L;
}

// Rays: blocks of whole rays. Points: KPAD = 1, whose rays_per_block is MT,
// so 128 points a block, the point kernels' blocks.
BwdLayout ray_bwd_layout(bool camera, int R, int KPAD, bool with_acts = true) {
  const int rpb = rays_per_block(KPAD);
  return bwd_layout(camera, (long long)R * KPAD, (R + rpb - 1) / rpb, with_acts);
}

struct Scratch {
  bf16* acts;
  bf16* gpre;
  float* hg;
  float* bpart;
  float* wpart;
};

Scratch carve(const BwdLayout& L, void* ws) {
  unsigned char* base = static_cast<unsigned char*>(ws);
  return {reinterpret_cast<bf16*>(base + L.acts), reinterpret_cast<bf16*>(base + L.gpre),
          reinterpret_cast<float*>(base + L.hg), reinterpret_cast<float*>(base + L.bpart),
          reinterpret_cast<float*>(base + L.wpart)};
}

size_t dgrad_smem(int KPAD) {
  return (size_t)(2 * MT * LDA + WST) * sizeof(bf16) +
         (size_t)(B_END + 2 + MT * 8 + MT * 10 + rays_per_block(KPAD) * 10) * sizeof(float);
}

// Passes 2-4 of a backward, once its first pass has filled the activation
// stream and the head cotangents: dgrad, wgrad and the fixed-order reduction.
// HEADS_ONLY (the int8_full backward): dgrad stops at the trunk output,
// writing g_h7 to `gh`; wgrad and the reduction skip the trunk's matrices and
// biases, which the int8 passes compute. pass 1, 2 or 3 (measurement): that
// pass alone (dgrad, wgrad, the reduction), on scratch the passes before it
// filled; < 0 all three.
template <bool CAMERA, bool POINT, bool HEADS_ONLY = false>
int bwd_passes(const BwdLayout& L, const Scratch& sc, const float* rayin, const float* z,
               const bf16* wm, float* dmats, float* dbias, float* dout, float* demb, int R,
               int KPAD, cudaStream_t stream, bf16* gh = nullptr, int pass = -1) {
  if (pass < 0 || pass == 1) {
    const size_t smem = dgrad_smem(KPAD);
    const cudaError_t e = cudaFuncSetAttribute(dgrad_kernel<CAMERA, POINT, !HEADS_ONLY>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    dgrad_kernel<CAMERA, POINT, !HEADS_ONLY><<<L.nblocks, THREADS, smem, stream>>>(
        rayin, z, wm, sc.acts, sc.hg, sc.gpre, sc.bpart, dout, demb, R, KPAD,
        rays_per_block(KPAD), gh);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (pass < 0 || pass == 2) {
    const int err = launch_wgrad<CAMERA>(sc.acts, sc.gpre, sc.wpart, L.S, L.splits, L.chunk,
                                         HEADS_ONLY ? n_trunk_wgrad_tiles() : 0, stream);
    if (err != 0) return err;
  }
  if (pass < 0 || pass == 3) {
    const long long n_mat = CAMERA ? M_END : M_BOTT;
    const int n_bias = CAMERA ? B_END : B_BOTT;
    reduce_kernel<<<1024, THREADS, 0, stream>>>(sc.wpart, L.splits, n_mat, sc.bpart, L.nblocks,
                                                n_bias, dmats, dbias, HEADS_ONLY ? M_SIG : 0,
                                                HEADS_ONLY ? B_SIG : 0);
  }
  return (int)cudaGetLastError();
}

// saved != nullptr: the saved backward, on the stream the forward wrote
// (fused_fwd_kernel<MODE, false, false, true>) in place of the recompute.
// pass 0..3 (measurement): one of the four launches alone (the first pass,
// dgrad, wgrad, the reduction) on a workspace the passes before it filled;
// < 0 all four.
template <bool CAMERA>
int launch_bwd(const float* rayin, const float* z, const float* deltam, const float* mask,
               const float* gin, const void* wm_, const float* wb, void* ws, float* dmats,
               float* dbias, float* drayin, int R, int KPAD, cudaStream_t stream,
               bf16* saved = nullptr, int pass = -1) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD || pass > 3)
    return (int)cudaErrorInvalidValue;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const BwdLayout L = ray_bwd_layout(CAMERA, R, KPAD, saved == nullptr);
  Scratch sc = carve(L, ws);
  if (saved != nullptr) sc.acts = saved;
  if (pass < 0 || pass == 0) {
    const int err =
        saved != nullptr
            ? launch<CAMERA ? CAM : SHADOW, true, true>(rayin, z, deltam, mask, wm, wb, nullptr, R,
                                                        KPAD, stream, gin, sc.acts, sc.hg)
            : launch<CAMERA ? CAM : SHADOW, true>(rayin, z, deltam, mask, wm, wb, nullptr, R,
                                                  KPAD, stream, gin, sc.acts, sc.hg);
    if (err != 0 || pass == 0) return err;
  }
  return bwd_passes<CAMERA, false>(L, sc, rayin, z, wm, dmats, dbias, drayin, nullptr, R, KPAD,
                                   stream, nullptr, pass);
}

template <bool FIELD>
int launch_point_bwd(const float* pos, const float* emb, const float* gin, const void* wm_,
                     const float* wb, void* ws, float* dmats, float* dbias, float* dpos,
                     float* demb, int N, cudaStream_t stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const BwdLayout L = ray_bwd_layout(FIELD, N, 1);
  const Scratch sc = carve(L, ws);
  int err = launch_point<FIELD, true>(pos, emb, wm, wb, nullptr, N, stream, gin, sc.acts, sc.hg);
  if (err != 0) return err;
  return bwd_passes<FIELD, true>(L, sc, pos, nullptr, wm, dmats, dbias, dpos, demb, N, 1, stream);
}

// ---------------------------------------------------------------------------
// the int8 trunk tier (trunk_quant "int8" and "int8_full")
// ---------------------------------------------------------------------------
//
// Replaces the int8 bodies of the five Pallas ray kernels: `_trunk_fwd_q8`
// and `_trunk_bwd_q8` of the JAX package's ops/pallas/fused_field.py, run
// inside `_camera_fwd_kernel`, `_camera_bwd_kernel`, `_shadow_fwd_kernel`,
// `_shadow_bwd_kernel` and `_coarse_fwd_kernel` (ops/pallas/fused_render.py)
// on the int8 operands of `quantize_trunk_int8`.
//
// What the tier computes: per-column int8 weights (quantized by the caller)
// and per-group int8 activations, one scale per group and quantization
// point, where a group is the rows one TPU grid step holds (rt rays x KPAD
// samples, padded samples and zero rays included; the caller pads the call
// to whole groups). The scale needs the amax of the whole group's previous
// layer, and a group spans up to 16 of this file's 128-row tiles, so the
// trunk runs layer-major: one launch per layer over every row, each tile
// quantizing its inputs on load with its group's scale and folding the
// max |h| of its outputs into its group's amax with atomicMax on the float's
// bits (order-free, so deterministic). The running activation stays f32 in
// device memory between layers (two ping-pong buffers); its bf16 copy goes
// to the activation stream the heads and the backward read. Products are
// mma.sync m16n8k32 s8 x s8 -> s32 (exact), dequantized as
// acc * (s_w * s_act) + b with explicit round-to-nearest operations (no
// contraction into an fma), as the JAX function rounds.
//
// What bounds it on this card: the trunk's int8 products (1,979 TOP/s) and
// the f32 activation traffic, 2 KB per sample and layer (read, written) at
// 3.35 TB/s, which this layer-major design pays and a cluster design keeping
// a group's activations on chip would not (a group is up to 16 tiles, over
// the portable cluster size of 8).
//
// int8_full backward, layer by layer from 7 to 0: q8_gamax_kernel takes the
// group amax of g = g_h * mask * s_w (and the bias gradient's per-tile sums
// of the unquantized g_h * mask), q8_dgrad_kernel quantizes g once per group
// into the int8 cotangent stream and forms (g8 w8^T) s_g rounded to bf16;
// then q8_wgrad_kernel forms each group's exact int32 inp8^T g8, scaled by
// that group's s_in s_g / s_w into per-group f32 partials, which
// q8_reduce_kernel sums in group order (the TPU's sequential grid order).

constexpr int LDQ = CAT + 16;     // int8 tile row stride (bytes): conflict-free fragment loads
constexpr int LDK = 32 + 16;      // int8 transposed k-chunk row stride (bytes)
constexpr int G8S = 8 * W;        // int8 cotangent stream: g8 of layers 0..7 per row
constexpr int QB = 8 * W;         // trunk biases: the per-tile bias sums' row

// The PE of every row (ray r = row / KPAD, sample row % KPAD), rounded to
// bf16, into the stream at A_PE; its group amax into quantization point 0.
__global__ void __launch_bounds__(THREADS)
q8_pe_kernel(const float* __restrict__ rayin, const float* __restrict__ z, bf16* __restrict__ acts,
             long long as, float* __restrict__ amax, long long rows, int KPAD,
             long long group_rows) {
  __shared__ unsigned rowmax[MT];
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, rows - row0);
  if (threadIdx.x < MT) rowmax[threadIdx.x] = 0u;
  __syncthreads();
  for (int e = threadIdx.x; e < nrows * PE; e += THREADS) {
    const int r = e / PE, c = e % PE;
    const long long row = row0 + r;
    float v = 0.f;
    if (c < 63) {
      const float* ri = rayin + (row / KPAD) * RAYIN;
      int j;
      float sc;
      pe_lane(c, j, sc);
      v = pe_value(c, ray_xb(ri, j, sc, z[row]));
    }
    const bf16 pv = __float2bfloat16_rn(v);
    acts[row * as + A_PE + c] = pv;
    atomicMax(&rowmax[r], __float_as_uint(fabsf(bf(pv))));
  }
  fold_group_max(rowmax, row0, nrows, group_rows, amax, 0);
}

constexpr int QNC = 64;   // output columns a pass of q8_layer_kernel: 2 blocks an SM

size_t q8_layer_smem() {
  return (size_t)(MT + QNC) * LDQ + (size_t)MT * (4 * sizeof(float) + 4);
}

// One layer of the int8 trunk, 128 rows a block. Inputs quantized on load:
// layer 0 the PE (bf16, from the stream), layers 1-7 the running f32
// activation `hin`, layer 5 [h4 | PE] with their own scales (two products,
// (A + B) + b). Writes relu(pre) as f32 to `hout` (layers 0-6) and its bf16
// copy to the stream (every layer with write_all, else layer 7 only), and
// folds the output's group amax into quantization point layer + 1.
// QNC output columns a pass keep the accumulators to 64 registers, so two
// blocks share an SM and one's loads overlap the other's products.
__global__ void __launch_bounds__(THREADS, 2)
q8_layer_kernel(int layer, const float* __restrict__ hin, float* __restrict__ hout,
                bf16* __restrict__ acts, long long as, int write_all,
                const int8_t* __restrict__ w8, const float* __restrict__ sw,
                const float* __restrict__ wb, float* __restrict__ amax, long long rows,
                long long group_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qa = reinterpret_cast<int8_t*>(smem);          // MT x LDQ: quantized inputs
  int8_t* qw = qa + MT * LDQ;                              // QNC x LDQ: weight rows (out, in)
  float* s_h = reinterpret_cast<float*>(qw + QNC * LDQ);  // per row: the input's scale and inv,
  float* i_h = s_h + MT;                                   // then the PE's
  float* s_p = i_h + MT;
  float* i_p = s_p + MT;
  unsigned* rowmax = reinterpret_cast<unsigned*>(i_p + MT);
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, rows - row0);
  const int k_h = layer > 0 ? W : 0;
  const int k_dim = k_h + (layer == 0 || layer == 5 ? PE : 0);
  if (tid < MT) {
    rowmax[tid] = 0u;
    const long long g = (row0 + min(tid, nrows - 1)) / group_rows;
    const float ih = q8_inv(amax[g * Q8P + layer]), ip = q8_inv(amax[g * Q8P]);
    i_h[tid] = ih;
    s_h[tid] = __fdiv_rn(1.f, ih);
    i_p[tid] = ip;
    s_p[tid] = __fdiv_rn(1.f, ip);
  }
  __syncthreads();
  const int nq = k_dim / 4;
  for (int v = tid; v < MT * nq; v += THREADS) {
    const int r = v / nq, c = (v % nq) * 4;
    uint32_t packed = 0u;
    if (r < nrows) {
      const long long row = row0 + r;
      if (c < k_h) {
        const float4 f = *reinterpret_cast<const float4*>(hin + row * W + c);
        const float inv = i_h[r];
        packed = q8_byte(f.x, inv) | q8_byte(f.y, inv) << 8 | q8_byte(f.z, inv) << 16 |
                 q8_byte(f.w, inv) << 24;
      } else {
        const bf16* pp = acts + row * as + A_PE + (c - k_h);
        const float inv = i_p[r];
        packed = q8_byte(bf(pp[0]), inv) | q8_byte(bf(pp[1]), inv) << 8 |
                 q8_byte(bf(pp[2]), inv) << 16 | q8_byte(bf(pp[3]), inv) << 24;
      }
    }
    *reinterpret_cast<uint32_t*>(qa + r * LDQ + c) = packed;
  }
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;
  const int8_t* wl = w8 + trunk_offset(layer);   // (out = 256, in = k_dim) row-major
  const float* swl = sw + layer * W;
  const float* bl = wb + B_T + layer * W;
  const bool stream_out = write_all || layer == 7;
  float ma = 0.f, mb = 0.f;
  for (int n0 = 0; n0 < W; n0 += QNC) {
    __syncthreads();
    const int kv16 = k_dim / 16;
    for (int v = tid; v < QNC * kv16; v += THREADS) {
      const int n = v / kv16, kv = (v % kv16) * 16;
      *reinterpret_cast<uint4*>(qw + n * LDQ + kv) =
          __ldg(reinterpret_cast<const uint4*>(wl + (long long)(n0 + n) * k_dim + kv));
    }
    __syncthreads();
    int acc[QNC / 8][4], accp[QNC / 8][4];
#pragma unroll
    for (int j = 0; j < QNC / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = accp[j][q] = 0;
    for (int k0 = 0; k0 < k_dim; k0 += 32) {
      const int8_t* ap = qa + ra * LDQ + k0 + 4 * t;
      const uint32_t a0 = ld_s8x4(ap), a1 = ld_s8x4(ap + 8 * LDQ);
      const uint32_t a2 = ld_s8x4(ap + 16), a3 = ld_s8x4(ap + 8 * LDQ + 16);
      const bool pe_part = layer == 5 && k0 >= W;
#pragma unroll
      for (int j = 0; j < QNC / 8; ++j) {
        const int8_t* bp = qw + (j * 8 + g) * LDQ + k0 + 4 * t;
        if (pe_part) mma_s8(accp[j], a0, a1, a2, a3, ld_s8x4(bp), ld_s8x4(bp + 16));
        else mma_s8(acc[j], a0, a1, a2, a3, ld_s8x4(bp), ld_s8x4(bp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < QNC / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= nrows) continue;
        float h2[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float swc = __ldg(swl + col + q), bc = __ldg(bl + col + q);
          const int a = acc[j][2 * half + q];
          float pre;
          if (layer == 5)
            pre = __fadd_rn(__fadd_rn(deq(a, swc, s_h[r]), deq(accp[j][2 * half + q], swc, s_p[r])),
                            bc);
          else
            pre = __fadd_rn(deq(a, swc, layer == 0 ? s_p[r] : s_h[r]), bc);
          h2[q] = fmaxf(pre, 0.f);
        }
        const long long row = row0 + r;
        if (layer < 7)
          *reinterpret_cast<float2*>(hout + row * W + col) = make_float2(h2[0], h2[1]);
        if (stream_out)
          *reinterpret_cast<__nv_bfloat162*>(acts + row * as + act_h(layer) + col) =
              __floats2bfloat162_rn(h2[0], h2[1]);
        const float m = fmaxf(fabsf(h2[0]), fabsf(h2[1]));
        if (half) mb = fmaxf(mb, m); else ma = fmaxf(ma, m);
      }
    }
  }
  if (layer < 7) {
    if (ra < nrows) atomicMax(&rowmax[ra], __float_as_uint(ma));
    if (rb < nrows) atomicMax(&rowmax[rb], __float_as_uint(mb));
    fold_group_max(rowmax, row0, nrows, group_rows, amax, layer + 1);
  }
}

// int8_full, layer `layer`: the group amax of g = g_h * mask * s_w (mask:
// the layer's activation > 0, from the stream) into gamax, and the tile's
// column sums of the unquantized g_h * mask (the bias gradient) into its row
// of qbpart. One thread per column.
__global__ void __launch_bounds__(THREADS)
q8_gamax_kernel(int layer, const bf16* __restrict__ gh, const bf16* __restrict__ acts,
                long long as, const float* __restrict__ sw, float* __restrict__ gamax,
                float* __restrict__ qbpart, long long rows, long long group_rows) {
  __shared__ unsigned rowmax[MT];
  const int c = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, rows - row0);
  if (c < MT) rowmax[c] = 0u;
  __syncthreads();
  const float swc = sw[layer * W + c];
  float sum = 0.f;
  for (int r = 0; r < nrows; ++r) {
    const long long row = row0 + r;
    const float gv = bf(acts[row * as + act_h(layer) + c]) > 0.f ? bf(gh[row * W + c]) : 0.f;
    sum += gv;
    float m = fabsf(__fmul_rn(gv, swc));
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((c & 31) == 0) atomicMax(&rowmax[r], __float_as_uint(m));
  }
  qbpart[(long long)blockIdx.x * QB + layer * W + c] = sum;
  fold_group_max(rowmax, row0, nrows, group_rows, gamax, layer);
}

constexpr int LDG = W + 16;   // int8 cotangent tile row stride (bytes)

size_t q8_dgrad_smem() { return (size_t)(MT + NC) * LDG + (size_t)MT * 2 * sizeof(float); }

// int8_full, layer `layer`: g8 = round(g_h * mask * s_w * inv_g) per group,
// kept in the int8 cotangent stream (columns layer * 256..) for the wgrad,
// and dgrad g_in = (g8 w8^T) s_g rounded to bf16: into gh_next (the
// cotangent of the layer's input activation), or for the PE into gpe
// (layer 5: its PE part; layer 0: added to it in bf16).
__global__ void __launch_bounds__(THREADS)
q8_dgrad_kernel(int layer, const bf16* __restrict__ gh, bf16* __restrict__ gh_next,
                bf16* __restrict__ gpe, const bf16* __restrict__ acts, long long as,
                const int8_t* __restrict__ w8t, const float* __restrict__ sw,
                const float* __restrict__ gamax, int8_t* __restrict__ g8s, long long rows,
                long long group_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* qa = reinterpret_cast<int8_t*>(smem);   // MT x LDG: g8
  int8_t* qw = qa + MT * LDG;                       // NC x LDG: w8^T rows (in, out)
  float* s_g = reinterpret_cast<float*>(qw + NC * LDG);
  float* i_g = s_g + MT;
  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * MT;
  const int nrows = (int)min((long long)MT, rows - row0);
  if (tid < MT) {
    const float inv = q8_inv(gamax[((row0 + min(tid, nrows - 1)) / group_rows) * Q8P + layer]);
    i_g[tid] = inv;
    s_g[tid] = __fdiv_rn(1.f, inv);
  }
  __syncthreads();
  const float* swl = sw + layer * W;
  for (int v = tid; v < MT * (W / 4); v += THREADS) {
    const int r = v / (W / 4), c = (v % (W / 4)) * 4;
    uint32_t packed = 0u;
    if (r < nrows) {
      const long long row = row0 + r;
      const float inv = i_g[r];
      for (int j = 0; j < 4; ++j) {
        const float gv =
            bf(acts[row * as + act_h(layer) + c + j]) > 0.f ? bf(gh[row * W + c + j]) : 0.f;
        packed |= q8_byte(__fmul_rn(gv, swl[c + j]), inv) << (8 * j);
      }
      *reinterpret_cast<uint32_t*>(g8s + row * G8S + layer * W + c) = packed;
    }
    *reinterpret_cast<uint32_t*>(qa + r * LDG + c) = packed;
  }
  const int n_dim = layer == 0 ? PE : (layer == 5 ? CAT : W);
  const int8_t* wt = w8t + trunk_offset(layer);   // (in = n_dim, out = 256) row-major
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ra = warp * 16 + g, rb = ra + 8;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    __syncthreads();
    for (int v = tid; v < NC * (W / 16); v += THREADS) {
      const int n = v / (W / 16), kv = (v % (W / 16)) * 16;
      uint4 w16 = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + n < n_dim)
        w16 = __ldg(reinterpret_cast<const uint4*>(wt + (long long)(n0 + n) * W + kv));
      *reinterpret_cast<uint4*>(qw + n * LDG + kv) = w16;
    }
    __syncthreads();
    int acc[NC / 8][4];
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int k0 = 0; k0 < W; k0 += 32) {
      const int8_t* ap = qa + ra * LDG + k0 + 4 * t;
      const uint32_t a0 = ld_s8x4(ap), a1 = ld_s8x4(ap + 8 * LDG);
      const uint32_t a2 = ld_s8x4(ap + 16), a3 = ld_s8x4(ap + 8 * LDG + 16);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int8_t* bp = qw + (j * 8 + g) * LDG + k0 + 4 * t;
        mma_s8(acc[j], a0, a1, a2, a3, ld_s8x4(bp), ld_s8x4(bp + 16));
      }
    }
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= n_dim) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= nrows) continue;
        const long long row = row0 + r;
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(__fmul_rn(__int2float_rn(acc[j][2 * half]), s_g[r]),
                                  __fmul_rn(__int2float_rn(acc[j][2 * half + 1]), s_g[r]));
        if (layer == 0) {
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(gpe + row * PE + col);
          const float2 o = __bfloat1622float2(*p), a = __bfloat1622float2(v2);
          *p = __floats2bfloat162_rn(o.x + a.x, o.y + a.y);
        } else if (layer == 5 && col >= W) {
          *reinterpret_cast<__nv_bfloat162*>(gpe + row * PE + col - W) = v2;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(gh_next + row * W + col) = v2;
        }
      }
    }
  }
}

// int8_full weight gradients: blockIdx.x walks the trunk's 128 x 128 tiles
// (layer-major), blockIdx.y the groups. A block forms its group's exact
// int32 inp8^T g8 (inp8: the stream's bf16 activation, or the PE, quantized
// with the group's scale; its amax is the bf16 rounding of the recompute's
// f32 amax), scales it by s_in * (s_g / s_w) per column and writes it to the
// group's own slice of qwpart, in the packed (out, in) layout.
__global__ void __launch_bounds__(THREADS)
q8_wgrad_kernel(const bf16* __restrict__ acts, long long as, const int8_t* __restrict__ g8s,
                const float* __restrict__ sw, const float* __restrict__ amax,
                const float* __restrict__ gamax, float* __restrict__ qwpart, long long rows,
                long long group_rows) {
  __shared__ __align__(16) int8_t sa[WG_TILE * LDK];
  __shared__ __align__(16) int8_t sb[WG_TILE * LDK];
  int t = blockIdx.x, layer = 0, mt = 0, nt = 0;
  for (; layer < 8; ++layer) {
    const int in = layer == 0 ? PE : (layer == 5 ? CAT : W);
    const int tiles = ((in + WG_TILE - 1) / WG_TILE) * (W / WG_TILE);
    if (t < tiles) { mt = t / (W / WG_TILE); nt = t % (W / WG_TILE); break; }
    t -= tiles;
  }
  const int in = layer == 0 ? PE : (layer == 5 ? CAT : W);
  const int m0 = mt * WG_TILE, n0 = nt * WG_TILE;
  const bool pe_src = layer == 0 || m0 >= W;
  const int acol = pe_src ? A_PE + (m0 >= W ? m0 - W : m0) : act_h(layer - 1) + m0;
  const int mvalid = min(WG_TILE, in - m0);
  const long long grp = blockIdx.y;
  const long long rbeg = grp * group_rows, rend = min(rows, rbeg + group_rows);
  const float inv_in = q8_inv(bf_round(amax[grp * Q8P + (pe_src ? 0 : layer)]));
  const float s_in = __fdiv_rn(1.f, inv_in);
  const float s_g = __fdiv_rn(1.f, q8_inv(gamax[grp * Q8P + layer]));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  int acc[WG_TILE / 8][4];
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  for (long long k0 = rbeg; k0 < rend; k0 += 32) {
    __syncthreads();
    // stage the chunk's 32 rows transposed: (feature, row) int8
    for (int v = threadIdx.x; v < 32 * (WG_TILE / 8); v += THREADS) {
      const int kk = v / (WG_TILE / 8), cv = (v % (WG_TILE / 8)) * 8;
      const long long row = k0 + kk;
      uint4 a8 = make_uint4(0u, 0u, 0u, 0u);
      uint2 b8 = make_uint2(0u, 0u);
      if (row < rend) {
        if (cv < mvalid) a8 = *reinterpret_cast<const uint4*>(acts + row * as + acol + cv);
        b8 = *reinterpret_cast<const uint2*>(g8s + row * G8S + layer * W + n0 + cv);
      }
      const bf16* ae = reinterpret_cast<const bf16*>(&a8);
      const int8_t* be = reinterpret_cast<const int8_t*>(&b8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sa[(cv + j) * LDK + kk] = (int8_t)__float2int_rn(__fmul_rn(bf(ae[j]), inv_in));
        sb[(cv + j) * LDK + kk] = be[j];
      }
    }
    __syncthreads();
    const int8_t* ap = sa + (warp * 16 + g) * LDK + 4 * tq;
    const uint32_t a0 = ld_s8x4(ap), a1 = ld_s8x4(ap + 8 * LDK);
    const uint32_t a2 = ld_s8x4(ap + 16), a3 = ld_s8x4(ap + 8 * LDK + 16);
#pragma unroll
    for (int j = 0; j < WG_TILE / 8; ++j) {
      const int8_t* bp = sb + (j * 8 + g) * LDK + 4 * tq;
      mma_s8(acc[j], a0, a1, a2, a3, ld_s8x4(bp), ld_s8x4(bp + 16));
    }
  }
  float* dst = qwpart + grp * M_SIG + trunk_offset(layer);
#pragma unroll
  for (int j = 0; j < WG_TILE / 8; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ml = warp * 16 + g + (q >= 2 ? 8 : 0), n = n0 + j * 8 + 2 * tq + (q & 1);
      if (ml >= mvalid) continue;
      const float scale = __fmul_rn(s_in, __fdiv_rn(s_g, sw[layer * W + n]));
      dst[(long long)n * in + m0 + ml] = __fmul_rn(__int2float_rn(acc[j][q]), scale);
    }
  }
}

// int8_full: the trunk's weight gradients as the sum of the per-group
// partials in group order, and its bias gradients as the sum of the per-tile
// column sums in tile order (fixed orders: the same bits from run to run).
__global__ void q8_reduce_kernel(const float* __restrict__ qwpart, int n_groups,
                                 const float* __restrict__ qbpart, int ntiles,
                                 float* __restrict__ dmats, float* __restrict__ dbias) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < M_SIG + QB;
       e += stride) {
    float s = 0.f;
    if (e < M_SIG) {
      for (int g = 0; g < n_groups; ++g) s += qwpart[(long long)g * M_SIG + e];
      dmats[e] = s;
    } else {
      const long long eb = e - M_SIG;
      for (int t = 0; t < ntiles; ++t) s += qbpart[(long long)t * QB + eb];
      dbias[B_T + eb] = s;
    }
  }
}

// int8_full: per ray, d_o and d_d from the PE cotangent (the dgrad kernel's
// last step, here after the layer-by-layer chain), into d_rayin columns 0..5.
constexpr int RG_THREADS = 64;

__global__ void __launch_bounds__(RG_THREADS)
q8_ray_grads_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                    const bf16* __restrict__ gpe, float* __restrict__ drayin, int KPAD) {
  __shared__ float part[RG_THREADS][6];
  const long long ray = blockIdx.x;
  const float* ri = rayin + ray * RAYIN;
  float a6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < KPAD; k += RG_THREADS) {
    const long long row = ray * KPAD + k;
    const float zs = z[row];
    for (int c = 0; c < 63; ++c) {
      int j;
      float sc;
      pe_lane(c, j, sc);
      const float xb = ray_xb(ri, j, sc, zs);
      const float der = c < 3 ? 1.f
                      : sinf(c < 33 ? __fadd_rn(xb, HALF_PI)
                                    : __fadd_rn(__fadd_rn(xb, HALF_PI), HALF_PI));
      const float dxs = bf(gpe[row * PE + c]) * der * sc;
      a6[j] += dxs;
      a6[3 + j] += dxs * zs;
    }
  }
  for (int j = 0; j < 6; ++j) part[threadIdx.x][j] = a6[j];
  __syncthreads();
  if (threadIdx.x < 6) {
    float s = 0.f;
    for (int u = 0; u < RG_THREADS; ++u) s += part[u][threadIdx.x];
    drayin[ray * RAYIN + threadIdx.x] = s;
  }
}

// The int8 trunk over `rows` rows (R rays x KPAD): the PE, then the eight
// layers, f32 activations ping-ponging through hf (2 x rows x 256).
int q8_trunk(const float* rayin, const float* z, bf16* acts, long long as, bool write_all,
             const int8_t* w8, const float* sw, const float* wb, float* hf, float* amax,
             long long rows, int KPAD, long long group_rows, cudaStream_t stream) {
  const int tiles = (int)((rows + MT - 1) / MT);
  q8_pe_kernel<<<tiles, THREADS, 0, stream>>>(rayin, z, acts, as, amax, rows, KPAD, group_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = q8_layer_smem();
  e = cudaFuncSetAttribute(q8_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int layer = 0; layer < 8; ++layer) {
    q8_layer_kernel<<<tiles, THREADS, smem, stream>>>(
        layer, hf + (long long)((layer + 1) % 2) * rows * W, hf + (long long)(layer % 2) * rows * W,
        acts, as, write_all ? 1 : 0, w8, sw, wb, amax, rows, group_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

bool q8_shape_ok(int R, int KPAD, long long group_rows) {
  return R > 0 && KPAD > 0 && KPAD % 8 == 0 && KPAD <= MAX_KPAD && group_rows > 0 &&
         group_rows % KPAD == 0 && ((long long)R * KPAD) % group_rows == 0;
}

size_t q8_fwd_bytes(bool camera_layout, long long rows) {
  return align256((size_t)rows * (camera_layout ? ACT_CAM : ACT_SH) * sizeof(bf16)) +
         align256((size_t)2 * rows * W * sizeof(float));
}

// Scratch of an int8 backward past the bf16 backward's own (BwdLayout):
// the f32 activations, and for int8_full the bf16 cotangents (ping-pong),
// the PE cotangent, the int8 cotangent stream and the int8 passes' partials.
struct Q8Layout {
  size_t hf, gh, gpe, g8, qbpart, qwpart, total;
};

Q8Layout q8_bwd_layout(bool camera, bool full, int R, int KPAD, long long group_rows) {
  const long long rows = (long long)R * KPAD;
  const long long tiles = (rows + MT - 1) / MT, groups = rows / group_rows;
  Q8Layout Q;
  Q.hf = ray_bwd_layout(camera, R, KPAD).total;
  Q.gh = align256(Q.hf + (size_t)2 * rows * W * sizeof(float));
  Q.gpe = align256(Q.gh + (full ? (size_t)2 * rows * W * sizeof(bf16) : 0));
  Q.g8 = align256(Q.gpe + (full ? (size_t)rows * PE * sizeof(bf16) : 0));
  Q.qbpart = align256(Q.g8 + (full ? (size_t)rows * G8S : 0));
  Q.qwpart = align256(Q.qbpart + (full ? (size_t)tiles * QB * sizeof(float) : 0));
  Q.total = align256(Q.qwpart + (full ? (size_t)groups * M_SIG * sizeof(float) : 0));
  return Q;
}

int q8_fwd(int mode, const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, const void* w8, const float* sw, void* ws,
           float* amax, float* out, int R, int KPAD, long long group_rows,
           cudaStream_t stream) {
  if (!q8_shape_ok(R, KPAD, group_rows) || mode < CAM || mode > COARSE)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)R * KPAD;
  const long long as = mode == CAM ? ACT_CAM : ACT_SH;
  bf16* acts = static_cast<bf16*>(ws);
  float* hf = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) +
                                       align256((size_t)rows * as * sizeof(bf16)));
  int err = q8_trunk(rayin, z, acts, as, false, static_cast<const int8_t*>(w8), sw, wb, hf, amax,
                     rows, KPAD, group_rows, stream);
  if (err != 0) return err;
  if (mode == CAM)
    return launch<CAM, false, true>(rayin, z, deltam, mask, wm, wb, out, R, KPAD, stream, nullptr,
                                    acts);
  if (mode == SHADOW)
    return launch<SHADOW, false, true>(rayin, z, deltam, mask, wm, wb, out, R, KPAD, stream,
                                       nullptr, acts);
  return launch<COARSE, false, true>(rayin, z, deltam, mask, wm, wb, out, R, KPAD, stream, nullptr,
                                     acts);
}

template <bool CAMERA>
int q8_bwd(bool full, const float* rayin, const float* z, const float* deltam, const float* mask,
           const float* gin, const void* wm_, const float* wb, const void* w8_, const void* w8t_,
           const float* sw, void* ws, float* amax, float* gamax, float* dmats, float* dbias,
           float* drayin, int R, int KPAD, long long group_rows, cudaStream_t stream) {
  if (!q8_shape_ok(R, KPAD, group_rows)) return (int)cudaErrorInvalidValue;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const int8_t* w8 = static_cast<const int8_t*>(w8_);
  const int8_t* w8t = static_cast<const int8_t*>(w8t_);
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  const long long rows = (long long)R * KPAD;
  const BwdLayout L = ray_bwd_layout(CAMERA, R, KPAD);
  const Scratch sc = carve(L, ws);
  const Q8Layout Q = q8_bwd_layout(CAMERA, full, R, KPAD, group_rows);
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* hf = reinterpret_cast<float*>(base + Q.hf);
  // the recompute: the int8 trunk in the backward's groups, every activation
  // to the stream, then the heads from the stream and the compositing backward
  int err = q8_trunk(rayin, z, sc.acts, AS, true, w8, sw, wb, hf, amax, rows, KPAD, group_rows,
                     stream);
  if (err != 0) return err;
  err = launch<CAMERA ? CAM : SHADOW, true, true>(rayin, z, deltam, mask, wm, wb, nullptr, R, KPAD,
                                                  stream, gin, sc.acts, sc.hg);
  if (err != 0) return err;
  // int8: straight through, the bf16 dgrad and wgrad against the unquantized
  // weights on the int8 recompute's stream
  if (!full)
    return bwd_passes<CAMERA, false>(L, sc, rayin, z, wm, dmats, dbias, drayin, nullptr, R, KPAD,
                                     stream);
  bf16* gh = reinterpret_cast<bf16*>(base + Q.gh);
  bf16* gpe = reinterpret_cast<bf16*>(base + Q.gpe);
  int8_t* g8s = reinterpret_cast<int8_t*>(base + Q.g8);
  float* qbpart = reinterpret_cast<float*>(base + Q.qbpart);
  float* qwpart = reinterpret_cast<float*>(base + Q.qwpart);
  err = bwd_passes<CAMERA, false, true>(L, sc, rayin, z, wm, dmats, dbias, drayin, nullptr, R, KPAD,
                                        stream, gh);
  if (err != 0) return err;
  const int tiles = (int)((rows + MT - 1) / MT);
  const size_t smem = q8_dgrad_smem();
  cudaError_t e = cudaFuncSetAttribute(q8_dgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int layer = 7; layer >= 0; --layer) {
    const bf16* cur = gh + (long long)((7 - layer) % 2) * rows * W;
    bf16* nxt = gh + (long long)((8 - layer) % 2) * rows * W;
    q8_gamax_kernel<<<tiles, THREADS, 0, stream>>>(layer, cur, sc.acts, AS, sw, gamax, qbpart,
                                                   rows, group_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    q8_dgrad_kernel<<<tiles, THREADS, smem, stream>>>(layer, cur, nxt, gpe, sc.acts, AS, w8t, sw,
                                                      gamax, g8s, rows, group_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int groups = (int)(rows / group_rows);
  q8_wgrad_kernel<<<dim3(n_trunk_wgrad_tiles(), groups), THREADS, 0, stream>>>(
      sc.acts, AS, g8s, sw, amax, gamax, qwpart, rows, group_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q8_reduce_kernel<<<1024, THREADS, 0, stream>>>(qwpart, groups, qbpart, tiles, dmats, dbias);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q8_ray_grads_kernel<<<R, RG_THREADS, 0, stream>>>(rayin, z, gpe, drayin, KPAD);
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
  return launch<CAM, false>(rayin, z, deltam, nullptr, wm, wb, acc, R, KPAD,
                             static_cast<cudaStream_t>(stream));
}

int eonerf_shadow_fwd(const float* rayin, const float* z, const float* deltam, const float* mask,
                      const void* wm, const float* wb, float* geo, int R, int KPAD, void* stream) {
  return launch<SHADOW, false>(rayin, z, deltam, mask, wm, wb, geo, R, KPAD,
                              static_cast<cudaStream_t>(stream));
}

// The coarse (density-only) pass's per-sample compositing weights, written
// as (R, KPAD) into w.
int eonerf_coarse_fwd(const float* rayin, const float* z, const float* deltam, const void* wm,
                      const float* wb, float* w, int R, int KPAD, void* stream) {
  return launch<COARSE, false>(rayin, z, deltam, nullptr, wm, wb, w, R, KPAD,
                               static_cast<cudaStream_t>(stream));
}

// Per-point density: pos (N, 3) -> sigma (N,).
int eonerf_density_fwd(const float* pos, const void* wm, const float* wb, float* sigma, int N,
                       void* stream) {
  return launch_point<false, false>(pos, nullptr, wm, wb, sigma, N,
                                    static_cast<cudaStream_t>(stream));
}

// Per-point field: pos (N, 3), emb (N, 4) -> out (N, 8).
int eonerf_field_fwd(const float* pos, const float* emb, const void* wm, const float* wb,
                     float* out, int N, void* stream) {
  return launch_point<true, false>(pos, emb, wm, wb, out, N, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch one backward call needs (camera != 0: the camera's).
long long eonerf_bwd_workspace_bytes(int camera, int R, int KPAD) {
  return (long long)ray_bwd_layout(camera != 0, R, KPAD).total;
}

// Bytes of scratch one point backward needs (field != 0: the field's, else
// the density's).
long long eonerf_point_bwd_workspace_bytes(int field, int N) {
  return (long long)ray_bwd_layout(field != 0, N, 1).total;
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

// The saved-activations pair. Columns of one activation-stream row (camera
// != 0: the camera's, ACT_CAM; else the shadow's, ACT_SH).
long long eonerf_act_stream_cols(int camera) { return camera ? ACT_CAM : ACT_SH; }

// The camera forward that also writes the PE and h0..h7 of every sample row
// into acts (R * KPAD rows of eonerf_act_stream_cols(1) bf16 columns).
int eonerf_camera_fwd_save(const float* rayin, const float* z, const float* deltam,
                           const void* wm, const float* wb, float* acc, void* acts, int R,
                           int KPAD, void* stream) {
  return launch<CAM, false, false, true>(rayin, z, deltam, nullptr, wm, wb, acc, R, KPAD,
                                         static_cast<cudaStream_t>(stream), nullptr,
                                         static_cast<bf16*>(acts));
}

// The shadow forward that also writes its stream (eonerf_act_stream_cols(0)
// columns a row).
int eonerf_shadow_fwd_save(const float* rayin, const float* z, const float* deltam,
                           const float* mask, const void* wm, const float* wb, float* geo,
                           void* acts, int R, int KPAD, void* stream) {
  return launch<SHADOW, false, false, true>(rayin, z, deltam, mask, wm, wb, geo, R, KPAD,
                                            static_cast<cudaStream_t>(stream), nullptr,
                                            static_cast<bf16*>(acts));
}

// Bytes of scratch of a saved backward: the recompute backward's without its
// activation region.
long long eonerf_saved_bwd_workspace_bytes(int camera, int R, int KPAD) {
  return (long long)ray_bwd_layout(camera != 0, R, KPAD, false).total;
}

// Backward of the camera op from the forward's stream acts (the camera's
// head columns are written into it): outputs as eonerf_camera_bwd's.
int eonerf_camera_bwd_saved(const float* rayin, const float* z, const float* deltam,
                            const float* gacc, const void* wm, const float* wb, void* acts,
                            void* ws, float* dmats, float* dbias, float* drayin, int R, int KPAD,
                            void* stream) {
  return launch_bwd<true>(rayin, z, deltam, nullptr, gacc, wm, wb, ws, dmats, dbias, drayin, R,
                          KPAD, static_cast<cudaStream_t>(stream), static_cast<bf16*>(acts));
}

// Backward of the shadow op from the forward's stream acts: outputs as
// eonerf_shadow_bwd's.
int eonerf_shadow_bwd_saved(const float* rayin, const float* z, const float* deltam,
                            const float* mask, const float* ggeo, const void* wm, const float* wb,
                            void* acts, void* ws, float* dmats, float* dbias, float* drayin, int R,
                            int KPAD, void* stream) {
  return launch_bwd<false>(rayin, z, deltam, mask, ggeo, wm, wb, ws, dmats, dbias, drayin, R,
                           KPAD, static_cast<cudaStream_t>(stream), static_cast<bf16*>(acts));
}

// Measurement: one launch of a camera (camera != 0) or shadow backward
// alone, on a workspace that the launches before it filled: pass 0 the
// first pass (the recompute, or with acts the heads from the saved stream),
// 1 dgrad, 2 wgrad, 3 the fixed-order reduction. Arguments as the four
// backward entries' (mask null for the camera, acts null for the
// recompute).
int eonerf_bwd_pass(int camera, int pass, const float* rayin, const float* z,
                    const float* deltam, const float* mask, const float* gin, const void* wm,
                    const float* wb, void* acts, void* ws, float* dmats, float* dbias,
                    float* drayin, int R, int KPAD, void* stream) {
  if (pass < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* saved = static_cast<bf16*>(acts);
  if (camera)
    return launch_bwd<true>(rayin, z, deltam, nullptr, gin, wm, wb, ws, dmats, dbias, drayin, R,
                            KPAD, st, saved, pass);
  return launch_bwd<false>(rayin, z, deltam, mask, gin, wm, wb, ws, dmats, dbias, drayin, R,
                           KPAD, st, saved, pass);
}

// Where a backward of R rays of KPAD samples (or R points, KPAD 1) keeps
// its streams in its workspace (every backward's workspace, the int8 ones'
// included, starts with this layout): out = [activation stream's byte
// offset (-1 when saved: the caller's), cotangent stream's byte offset,
// activation columns, cotangent columns, sample splits, rows a split, dgrad
// blocks].
void eonerf_bwd_stream_layout(int camera, int R, int KPAD, int saved, long long* out) {
  const BwdLayout L = ray_bwd_layout(camera != 0, R, KPAD, saved == 0);
  out[0] = saved ? -1 : (long long)L.acts;
  out[1] = (long long)L.gpre;
  out[2] = camera ? ACT_CAM : ACT_SH;
  out[3] = camera ? GP_CAM : GP_SH;
  out[4] = L.splits;
  out[5] = L.chunk;
  out[6] = L.nblocks;
}

// Bytes of the per-split partial sums of eonerf_wgrad over S rows.
long long eonerf_wgrad_partial_bytes(int camera, long long S) {
  const BwdLayout L = bwd_layout(camera != 0, S, 1);
  return (long long)L.splits * (camera ? M_END : M_BOTT) * (long long)sizeof(float);
}

// The weight-gradient pass alone on given streams of S rows (acts: S x
// ACT_CAM or ACT_SH bf16, gpre: S x GP_CAM or GP_SH), split as a backward of
// S rows splits them, then the fixed-order reduction of its matrices into
// dmats (the packed layout; heads_only: the matrices past the trunk, as
// int8_full's backward runs it, and dmats' trunk is not written).
int eonerf_wgrad(int camera, int heads_only, const void* acts, const void* gpre, long long S,
                 void* wpart, float* dmats, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdLayout L = bwd_layout(camera != 0, S, 1);
  const bf16* a = static_cast<const bf16*>(acts);
  const bf16* g = static_cast<const bf16*>(gpre);
  float* wp = static_cast<float*>(wpart);
  const int tile0 = heads_only ? n_trunk_wgrad_tiles() : 0;
  const int err = camera ? launch_wgrad<true>(a, g, wp, S, L.splits, L.chunk, tile0, st)
                         : launch_wgrad<false>(a, g, wp, S, L.splits, L.chunk, tile0, st);
  if (err != 0) return err;
  reduce_kernel<<<1024, THREADS, 0, st>>>(wp, L.splits, camera ? M_END : M_BOTT, nullptr, 0, 0,
                                          dmats, nullptr, heads_only ? M_SIG : 0, 0);
  return (int)cudaGetLastError();
}

// Backward of the field op: g (N, 8) -> d_mats, d_biases, d_pos (N, 3) and
// d_emb (N, 4).
int eonerf_field_bwd(const float* pos, const float* emb, const float* g, const void* wm,
                     const float* wb, void* ws, float* dmats, float* dbias, float* dpos,
                     float* demb, int N, void* stream) {
  return launch_point_bwd<true>(pos, emb, g, wm, wb, ws, dmats, dbias, dpos, demb, N,
                                static_cast<cudaStream_t>(stream));
}

// Backward of the density op: g (N,) -> the density prefix of d_mats and
// d_biases, and d_pos (N, 3).
int eonerf_density_bwd(const float* pos, const float* g, const void* wm, const float* wb,
                       void* ws, float* dmats, float* dbias, float* dpos, int N, void* stream) {
  return launch_point_bwd<false>(pos, nullptr, g, wm, wb, ws, dmats, dbias, dpos, nullptr, N,
                                 static_cast<cudaStream_t>(stream));
}

// The int8 trunk tier. Rays are padded by the caller to whole scale groups
// of group_rows rows (rt rays x KPAD samples). w8 (int8) holds the trunk's
// quantized matrices packed as the trunk prefix of the bf16 matrices, w8t the
// same transposed per matrix, sw the 8 x 256 per-column scales; amax (and, for
// int8_full, gamax) is (groups, 8), zeroed by the caller, and returns the
// group amax the kernels quantized with.

// Bytes of scratch of an int8 forward (mode 0 camera, 1 shadow, 2 coarse).
long long eonerf_q8_fwd_workspace_bytes(int mode, int R, int KPAD) {
  return (long long)q8_fwd_bytes(mode == CAM, (long long)R * KPAD);
}

// Forward through the int8 trunk: out as the bf16 op of the same mode
// (camera acc (R, 8), shadow geo (R,), coarse weights (R, KPAD)).
int eonerf_q8_fwd(int mode, const float* rayin, const float* z, const float* deltam,
                  const float* mask, const void* wm, const float* wb, const void* w8,
                  const float* sw, void* ws, float* amax, float* out, int R, int KPAD,
                  long long group_rows, void* stream) {
  return q8_fwd(mode, rayin, z, deltam, mask, wm, wb, w8, sw, ws, amax, out, R, KPAD, group_rows,
                static_cast<cudaStream_t>(stream));
}

// Bytes of scratch of an int8 backward (camera != 0: the camera's; full != 0:
// int8_full).
long long eonerf_q8_bwd_workspace_bytes(int camera, int full, int R, int KPAD,
                                        long long group_rows) {
  return (long long)q8_bwd_layout(camera != 0, full != 0, R, KPAD, group_rows).total;
}

// Backward of the int8 camera (camera != 0; gin = gacc (R, 8)) or shadow op
// (gin = ggeo (R,)): int8 (full = 0) or int8_full. Outputs as the bf16
// backward's.
int eonerf_q8_bwd(int camera, int full, const float* rayin, const float* z, const float* deltam,
                  const float* mask, const float* gin, const void* wm, const float* wb,
                  const void* w8, const void* w8t, const float* sw, void* ws, float* amax,
                  float* gamax, float* dmats, float* dbias, float* drayin, int R, int KPAD,
                  long long group_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (camera)
    return q8_bwd<true>(full != 0, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax,
                        gamax, dmats, dbias, drayin, R, KPAD, group_rows, st);
  return q8_bwd<false>(full != 0, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax,
                       gamax, dmats, dbias, drayin, R, KPAD, group_rows, st);
}

const char* eonerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
