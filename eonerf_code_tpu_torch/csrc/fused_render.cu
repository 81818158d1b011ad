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
//   [sigma, albedo r g b, t_s, t_beta, 0, 0]. Both are point modes of the
//   streamed forward (stream_fwd_kernel<PT_DENSITY>, <PT_FIELD>); its
//   section below holds their design.
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
//      wgmma product, f32 accumulation, bf16 rounding at its output, as the
//      JAX package's _mm_t), ReLU masks read back from the activation
//      stream under the products and applied in their epilogue; it writes
//      every layer's pre-activation cotangent to a cotangent stream, each
//      unit's f32 bias-gradient sums, and d_rayin (a persistent grid; its
//      design is described above the kernel);
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
// forward is the save mode of the streamed forward, stream_fwd_kernel<MODE,
// /*SAVE=*/true> (its section below): the plain forward (its outputs bit
// for bit) that also writes the PE and h0..h7 of every sample row (ray *
// KPAD + k) into an activation stream with the backward's layout and stride
// (ACT_CAM, ACT_SH), which the caller keeps from forward to backward. The
// saved backward then skips the PE and
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>
#include <type_traits>

#include "tile_common.cuh"   // the tile machinery, shared with kernel_variants.cu

namespace cg = cooperative_groups;

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

// What a launch of fused_fwd_kernel computes per ray after the trunk; the
// point modes are stream_fwd_kernel's per-point field and density.
enum Mode { CAM = 0, SHADOW = 1, COARSE = 2, PT_FIELD = 3, PT_DENSITY = 4 };

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
template <int MODE, bool BWD, bool FROM_STREAM = false>
__global__ void __launch_bounds__(THREADS, 1)
fused_fwd_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                 const float* __restrict__ deltam, const float* __restrict__ mask,
                 const bf16* __restrict__ wm, const float* __restrict__ wb,
                 float* __restrict__ out, int R, int KPAD, int rpb,
                 const float* __restrict__ gin, bf16* __restrict__ acts,
                 float* __restrict__ hg) {
  constexpr bool CAMERA = MODE == CAM;
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
      if (BWD) {
        __syncthreads();
        tile_to_stream(bufX, W, PE, acts, AS, g0, nrows, A_PE);
      }
      P = trunk_tile<BWD>(bufX, bufY, wm, wb, wst, acts, AS, g0, nrows);   // P holds h7
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

// The first pass of the per-point density and field backwards: one block
// per 128 points, which fill the tile's rows directly. The forward's
// recompute (PE from xyz into both tiles, the trunk and the sigma head, then
// with FIELD the camera heads, the embedding read per point), which streams
// every activation to `acts` (FIELD: the camera's layout, else the
// shadow's), then each point's head cotangents at the pre-activations, from
// the output cotangent `gin` ((N, 8) in the forward's layout, or (N,)), into
// `hg`. The softplus heads' derivative sigmoid(x) is 1 - exp(-softplus(x)).
// (The forwards themselves are stream_fwd_kernel's point modes.)
template <bool FIELD>
__global__ void __launch_bounds__(THREADS, 1)
point_kernel(const float* __restrict__ pos, const float* __restrict__ emb,
             const bf16* __restrict__ wm, const float* __restrict__ wb, int N,
             const float* __restrict__ gin, bf16* __restrict__ acts, float* __restrict__ hg) {
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* res = reinterpret_cast<float*>(wst + WST);   // MT x RES
  constexpr long long AS = FIELD ? ACT_CAM : ACT_SH;
  constexpr int NO = FIELD ? ACC : 1;                     // cotangents per point
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
  __syncthreads();
  tile_to_stream(bufX, W, PE, acts, AS, p0, nrows, A_PE);
  bf16* P = trunk_tile<true>(bufX, bufY, wm, wb, wst, acts, AS, p0, nrows);   // P holds h7
  for (int r = threadIdx.x; r < nrows; r += THREADS)
    res[r * RES] = softplus(dot_row(P + r * LDA, wm + M_SIG, W) + wb[B_SIG]);
  if constexpr (FIELD) {
    camera_heads<true>(P, P == bufX ? bufY : bufX, wm, wb, wst, res, nrows,
                       [&](int r, int c) { return emb[(p0 + r) * 4 + c]; }, acts, p0);
  }
  __syncthreads();
  // head cotangents, neighbouring threads on neighbouring addresses
  for (int e = threadIdx.x; e < nrows * NO; e += THREADS) {
    const int r = e / NO, c = e % NO;
    const float* rs = res + r * RES;
    const float g = gin[p0 * NO + e];
    float v = 0.f;
    if (c == 0 || c == 5) v = g * -expm1f(-rs[c]);       // sigma, t_beta (softplus)
    else if (c < 5) v = g * rs[c] * (1.f - rs[c]);        // albedo, t_s (sigmoid)
    hg[(p0 + r) * HG + c] = v;
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

template <int MODE, bool BWD, bool FROM_STREAM = false>
int launch(const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, float* out, int R, int KPAD, cudaStream_t stream,
           const float* gin = nullptr, bf16* acts = nullptr, float* hg = nullptr) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD) return (int)cudaErrorInvalidValue;
  const int rpb = rays_per_block(KPAD);
  const int grid = (R + rpb - 1) / rpb;
  const size_t smem = fwd_smem(KPAD);
  cudaError_t err = cudaFuncSetAttribute(fused_fwd_kernel<MODE, BWD, FROM_STREAM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<MODE, BWD, FROM_STREAM><<<grid, THREADS, smem, stream>>>(
      rayin, z, deltam, mask, static_cast<const bf16*>(wm), wb, out, R, KPAD, rpb, gin, acts,
      hg);
  return (int)cudaGetLastError();
}

// point_kernel: the point backwards' first pass
template <bool FIELD>
int launch_point(const float* pos, const float* emb, const bf16* wm, const float* wb, int N,
                 cudaStream_t stream, const float* gin, bf16* acts, float* hg) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(2 * MT * LDA + WST) * sizeof(bf16) + (size_t)MT * RES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(point_kernel<FIELD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  point_kernel<FIELD><<<(N + MT - 1) / MT, THREADS, smem, stream>>>(pos, emb, wm, wb, N, gin,
                                                                    acts, hg);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the streamed forwards: the plain camera, shadow and coarse forwards and
// the per-point field and density forwards
// ---------------------------------------------------------------------------
//
// stream_fwd_kernel<MODE> is the plain (no stream) camera, shadow and
// coarse forward: the counterpart of `_camera_fwd_kernel`,
// `_shadow_fwd_kernel` and `_coarse_fwd_kernel` (the JAX package's
// ops/pallas/fused_render.py) in place of fused_fwd_kernel<MODE, false>,
// which stays for the backwards' first pass and the int8 heads. It gives
// fused_fwd_kernel's bits: each row's products, epilogues and narrow heads
// in the same operations, the per-ray sums in sample order by the same
// statements.
//
// Its save mode, stream_fwd_kernel<CAM or SHADOW, /*SAVE=*/true>, is the
// differentiated camera and shadow forward (`_camera_fwd_kernel` and
// `_shadow_fwd_kernel` with save=True): the plain forward that also writes
// the PE and h0..h7 of every sample row to the activation stream the saved
// backward reads (ACT_CAM or ACT_SH columns a row). What bounds it: the
// products and, nearly as much, the stream (2112 bf16 a row: at 1024 x 128
// rows 553 MB, 0.17 ms at 3.35 TB/s, against 0.18 ms of the camera's
// products). Here:
// - every sample row is a row, padding and deltam = 0 included (the saved
//   backward reads every row of the stream, and an unwritten row of its
//   torch.empty buffer could be NaN), so a block's rows are its rays' R *
//   KPAD consecutive rows: no plan beyond the weight stream; block b of the
//   grid owns rays b R / G .. (b + 1) R / G - 1 (sv_first_ray), and a
//   row's (ray, sample) is (row / KPAD, row % KPAD). The per-ray sums visit
//   every sample, as fused_fwd_kernel's did: the same bits.
// - the stream is written while the products run: after each trunk
//   layer's epilogue a warp reads its 16 rows of that layer's output back
//   from the tile and stores them with streaming 16-byte stores (L2
//   evict-first, so the 553 MB pass leaves the weight stream's L2 lines
//   alone; fs_rows_to_stream), 512 B a row to act_h(i), and after layer 4
//   640 B, [h4 | PE] being tile columns 0..319 and stream columns
//   1024..1343, so the PE is written once. The warp waits for its reads of
//   the tile and for its stores to be taken (all SMs store a layer at once:
//   about a seventh of a tile), not for them to land. The camera's head
//   columns 2112..3071 stay the backward's to write. Measured slower
//   (PERF.md, the save forwards' findings): a bulk copy a row by the TMA,
//   shared -> global (each SM's 128 small copies a layer queued ahead of
//   the weight ring's loads), and the same stores spread over the next
//   product, between a chunk's wgmma and its wait or while the ring's
//   chunks were awaited (the products and the waits grew by more than the
//   stores saved).
//
// Its point modes, PT_FIELD and PT_DENSITY, are the per-point forwards: the
// counterparts of `_field_fwd_kernel` and `_density_fwd_kernel` (the JAX
// package's ops/pallas/fused_field.py). The field runs the camera's trunk
// and heads on points, the density the shadow's trunk and sigma head, so
// the machinery below carries over with no plan: every point is a row (the
// JAX functions evaluate them all), in order; a block of the persistent
// grid takes a contiguous range of whole tiles (pt_first_row); a row's
// inputs are its xyz (and, for the field, its embedding), its PE
// point_kernel's (x * 2^deg, the ray form with d = 0, z = 0, bit for bit);
// its results go straight to `out` ((N, 8) = [sigma, albedo r g b, t_s,
// t_beta, 0, 0], or sigma (N,)); there are no per-ray sums. The weight
// stream is written by fs_count_kernel's stream blocks alone. The products,
// epilogues and narrow heads are point_kernel's in the same operations, so
// the outputs are the bits of the backwards' recompute.
//
// What bounds it: the products of the samples that need them (the camera's
// 0.68 M multiply-adds a sample at 989 TFLOP/s). What held the design
// before it far from that (PERF.md, its phase table): a block owned one
// ray's 128-row tile at a time and re-staged every weight matrix for every
// tile through a 3-stage ring of 32-deep chunks that drained at each of a
// tile's 13 products (a block barrier and two chunks' L2 round trips with
// nothing under them), with a block barrier and a full wgmma wait a chunk;
// the 1- and 3-wide heads ran one thread a row and the composite one thread
// a ray while the SM waited; and every sample ran the trunk, though a
// sample with deltam = 0 (outside the cube, or padding) adds nothing. Here:
// - only the samples with deltam != 0 are rows: fs_count_kernel counts
//   them a ray, fs_scan_kernel turns the counts into each ray's first row
//   and cuts the rows into one contiguous range of whole rays a block,
//   about the same rows each (no host synchronisation). A ray's rows may
//   straddle tiles; its sums run after the block's last tile, from the
//   rows' results in the workspace. Skipping the others is exact: a row's
//   products depend on that row alone, and in the per-ray sums such a
//   sample adds exact zeros (its weight is T (1 - e^0) = 0; the shadow's
//   sum adds sigma * 0).
// - the weights are one continuous stream: fs_count_kernel's other blocks
//   write the tile's whole weight sequence (the trunk, then the camera's
//   heads) once a call into the workspace as the exact image of 16 KB ring
//   stages (each 128-row half of a chunk the 64-byte-swizzled K-major layout
//   of tile_common.cuh's stage_wt), and one producer warp streams it by
//   bulk copies (the TMA, L2 evict-last; four a chunk) into a 7-stage ring with full and
//   empty mbarriers, through a tile's products and on into the next
//   tile's: nothing drains, and no block barrier is left in the products.
// - a persistent grid, one block an SM: two consumer warpgroups, each
//   owning 64 rows of the 128-row tile, multiply as one (wgmma m64n128k16,
//   A from registers by ldmatrix, B from the ring), a chunk at a time:
//   ptxas serializes wgmma whose A registers a later chunk reloads while a
//   group is in flight (C7512), so nothing is left in flight. A warp reads
//   and writes only its own 16 rows, so a layer's output overwrites its
//   input in place (one 128 x 328 tile) and the warpgroups synchronise
//   only through the ring.
// - every bias and the narrow heads' weights sit in shared memory: the
//   epilogues' bias loads (L1 misses beside 218 KB of shared memory) were
//   a tenth of the kernel.
// - the camera's albedo hidden layer and transient layer 0 both read the
//   bottleneck: they run as one 256-wide product over [bottleneck |
//   embedding] (the albedo rows zero past the bottleneck's 256 columns:
//   exact zeros added), so the heads need no second tile.
// - the 1- and 3-wide heads run on a warp's own rows, a lane a row (lanes
//   0-15 the sigma and the three albedo dots, 16-31 t_s and t_beta), each
//   lane's dots interleaved (dot_rows; each the fmaf chain of dot_row).
// Landmarks of its phases (FS_*): empty here; bench/stream_fwd.py builds a
// copy that defines them (the phase order of its PHASES).
#ifndef FS_MARK
#define FS_MARK(next)
#define FS_BEGIN()
#define FS_END()
#endif
enum FsPhase { FSP_OTHER, FSP_META, FSP_PE, FSP_WAIT, FSP_PRODUCTS, FSP_EPILOGUE, FSP_HEADS,
               FSP_RESULTS, FSP_COMPOSITE, FSP_STORES };

constexpr int FS_WARPS = 8;                      // consumer warps: two warpgroups
constexpr int FS_THREADS = FS_WARPS * 32 + 32;   // and the producer warp
constexpr int FS_STAGES = 7;                     // chunks in the weight ring
// bulk copies a chunk: each copy's latency grows with its bytes, and four
// at once land a chunk sooner than one (PERF.md, PR 14)
constexpr int FS_COPIES = 4;
constexpr int FS_CHUNK = 2 * STAGE_BYTES;        // bytes a chunk: two 128-row, 32-deep halves
constexpr int FS_RES = 8;     // a camera row's results: sigma, albedo x3, t_s, t_beta, z, deltam
constexpr int FS_MAX_BLOCKS = 1024;
constexpr int FS_LAYERS_CAM = 13, FS_LAYERS_DENSITY = 8;
constexpr int FS_IN = 12;     // a row's inputs staged by its warp: o(3), d(3), z, deltam, emb(4)
                              // (points: xyz(3), 0 x 5, emb(4))
constexpr int FS_HW = W + 3 * HALF + 2 * HALF;   // the narrow heads' weights: sigma, albedo, t_s, t_beta
// shared memory: the ring, the tile, the barriers, the warps' row inputs,
// the narrow heads' weights, every bias
constexpr size_t FS_OFF_TILE = (size_t)FS_STAGES * FS_CHUNK;
constexpr size_t FS_OFF_BARS = FS_OFF_TILE + (size_t)MT * LDA * sizeof(bf16);
constexpr size_t FS_OFF_IN = FS_OFF_BARS + 2 * FS_STAGES * sizeof(uint64_t);
constexpr size_t FS_OFF_HW = FS_OFF_IN + (size_t)FS_WARPS * 16 * FS_IN * sizeof(float);
constexpr size_t FS_OFF_BIAS = FS_OFF_HW + (size_t)FS_HW * sizeof(bf16);
constexpr size_t FS_SMEM = FS_OFF_BIAS + (size_t)B_END * sizeof(float);
static_assert(FS_SMEM <= 232448, "the ring, the tile and the rest fit an SM");
static_assert(FS_OFF_IN % 16 == 0 && FS_OFF_HW % 16 == 0 && FS_OFF_BIAS % 16 == 0,
              "16-byte aligned parts");

// Layer i of the weight stream: the trunk's eight, then the camera's
// bottleneck, [albedo hidden | transient 0] and transient 1..3. wide: 256
// outputs, a chunk 32 deep over both 128-row halves; else 128 outputs, a
// chunk 64 deep as two 32-deep halves. k_dim: its input columns.
struct FsLayer {
  bool wide;
  int k_dim;
};

__host__ __device__ constexpr FsLayer fs_layer(int i) {
  if (i < 8) return {true, i == 0 ? PE : (i == 5 ? CAT : W)};
  if (i == 8) return {true, W};
  if (i == 9) return {true, CAT};
  return {false, HALF};
}

__host__ __device__ constexpr int fs_chunks(int i) {
  return fs_layer(i).k_dim / (fs_layer(i).wide ? KC : 2 * KC);
}

// chunks of a tile's weight sequence (camera, field: 84; shadow, coarse,
// density: 60)
__host__ __device__ constexpr int fs_stream_chunks(bool camera) {
  int n = 0;
  for (int i = 0; i < (camera ? FS_LAYERS_CAM : FS_LAYERS_DENSITY); ++i) n += fs_chunks(i);
  return n;
}

// Eight weights of layer i, output row n, inputs k..k+7, from the packed
// matrices (the albedo hidden layer's rows zero past its 256 inputs).
__device__ inline uint4 fs_weights8(const bf16* __restrict__ wm, int i, int n, int k) {
  long long off;
  if (i < 8) off = trunk_offset(i) + (long long)n * fs_layer(i).k_dim + k;
  else if (i == 8) off = M_BOTT + (long long)n * W + k;
  else if (i == 9) {
    if (n >= HALF) off = M_TR0 + (long long)(n - HALF) * CAT + k;
    else if (k < W) off = M_ALB0 + (long long)n * W + k;
    else return make_uint4(0u, 0u, 0u, 0u);
  } else {
    off = M_TR1 + (long long)(i - 10) * HALF * HALF + (long long)n * HALF + k;
  }
  return *reinterpret_cast<const uint4*>(wm + off);
}

// The plan's first launch (the point modes': the stream alone, nb_rays =
// 0). Blocks below nb_rays: a warp a ray, counting its samples with deltam
// != 0 into cnt. The others: the weight stream, one
// 16-byte unit a thread, unit u of chunk q at stream[q * 1024 + u] as the
// ring stage's image: half h = u / 512 holds 128 (n, k) rows of 64 bytes,
// unit (u % 4) of row n stored at (u % 4) ^ ((n >> 1) & 3) (stage_wt's
// layout); a wide layer's half h is output rows 128 h.., a narrow one's its
// chunk's k slice 32 h...
__global__ void __launch_bounds__(256)
fs_count_kernel(const float* __restrict__ deltam, int R, int KPAD, int* __restrict__ cnt,
                int nb_rays, const bf16* __restrict__ wm, int nlayers, uint4* __restrict__ stream) {
  if ((int)blockIdx.x < nb_rays) {
    const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
    if (r >= R) return;
    int n = 0;
    for (int k0 = 0; k0 < KPAD; k0 += 32) {
      const int k = k0 + lane;
      n += __popc(__ballot_sync(0xffffffffu, k < KPAD && deltam[(long long)r * KPAD + k] != 0.f));
    }
    if (lane == 0) cnt[r] = n;
    return;
  }
  const int v = (blockIdx.x - nb_rays) * 256 + threadIdx.x;
  int q = v / (FS_CHUNK / 16), i = 0, c0 = 0;
  while (i < nlayers && q >= c0 + fs_chunks(i)) c0 += fs_chunks(i++);
  if (i >= nlayers) return;
  const FsLayer L = fs_layer(i);
  const int u = v % (FS_CHUNK / 16), h = u >> 9, o = (u & 511) * 16, nl = o >> 6;
  const int kk = ((o & 63) >> 4) ^ ((nl >> 1) & 3), kc = q - c0;
  stream[v] = L.wide ? fs_weights8(wm, i, h * HALF + nl, kc * KC + kk * 8)
                     : fs_weights8(wm, i, nl, kc * 2 * KC + h * KC + kk * 8);
}

// The plan's second launch, one block: prefix[r] = the rows (samples with
// deltam != 0) of the rays before r, prefix[R] = all of them; then
// ray_start[b] (b = 0..G) = the first ray whose first row is at or past b
// ceil(rows / G) (at least 1; R if none): block b of the forward owns rays
// ray_start[b] .. ray_start[b + 1] - 1, whole rays and about the same rows
// each, and ray_start[G] = R.
__global__ void __launch_bounds__(1024)
fs_scan_kernel(const int* __restrict__ cnt, int R, int G, int* __restrict__ prefix,
               int* __restrict__ ray_start) {
  __shared__ int wsum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, T = blockDim.x;
  const int m = (R + T - 1) / T, lo = min(R, t * m), hi = min(R, lo + m);
  int s = 0;
  for (int r = lo; r < hi; ++r) s += cnt[r];
  int x = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  for (int b = t; b <= G; b += T) ray_start[b] = R;
  __syncthreads();
  if (warp == 0) {
    int w = lane < T / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    wsum[lane] = w;
  }
  __syncthreads();
  const int total = wsum[T / 32 - 1];
  const int target = max(1, (total + G - 1) / G);
  int run = x - s + (warp > 0 ? wsum[warp - 1] : 0);   // rows before ray lo
  int before = lo > 0 ? run - cnt[lo - 1] : 0;          // rows before ray lo - 1
  for (int r = lo; r < hi; ++r) {
    prefix[r] = run;
    // the blocks b (1 <= b < G) whose first row b * target falls in
    // (rows before r - 1, rows before r]: ray r is their first
    if (r == 0) ray_start[0] = 0;
    else
      for (int b = before / target + 1; b <= min(G - 1, run / target); ++b) ray_start[b] = r;
    before = run;
    run += cnt[r];
  }
  if (t == 0) prefix[R] = total;
}

// The weight ring as a consumer warpgroup sees it: chunk q sits in stage
// q % FS_STAGES, its bytes landed when the full barrier's phase of parity
// (q / FS_STAGES) & 1 completes; each consumer thread arrives on the empty
// barrier once its warpgroup's products have read the stage.
struct FsRing {
  uint32_t ring, full, empty;
  int q;   // chunks acquired

  __device__ uint32_t acquire() {
    const int s = q % FS_STAGES;
    FS_MARK(FSP_WAIT);
    mbar_wait(full + 8 * s, (uint32_t)((q / FS_STAGES) & 1));
    FS_MARK(FSP_PRODUCTS);
    ++q;
    return ring + s * FS_CHUNK;
  }
  __device__ void release(int qq) { mbar_arrive(empty + 8 * (qq % FS_STAGES)); }
};

// One wide layer on this warp's 16 rows (row0..) of the tile: columns 0..255
// become act(A W^T + bias), A the tile's columns acol .. acol + k_dim - 1
// (the output may overwrite them: every A fragment is in registers before
// the epilogue). bias(c): output column c's bias. The products and
// epilogue are gemm's (tile_common.cuh) on each 128-column half.
template <bool RELU, typename Bias>
__device__ __forceinline__ void fs_wide(FsRing& rg, bf16* tile, int row0, int acol, int k_dim,
                                        Bias bias) {
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  // a chunk at a time, its products waited for before the next: ptxas
  // serializes these wgmma whatever is left in flight (C7512), and a
  // second chunk's A fragments in flight only cost registers
  for (int kc = 0; kc < k_dim / KC; ++kc) {
    const uint32_t st = rg.acquire();
    uint32_t a[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) load_a<LDA>(a[s], tile, row0, acol + kc * KC + 16 * s);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma<128, 0>(acc[h], a[s], gmma_desc(st + h * STAGE_BYTES + 32 * s, 16, 512, 2));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    rg.release(rg.q - 1);
  }
  FS_MARK(FSP_EPILOGUE);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* orow = tile + (row0 + g) * LDA + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float b[16][2];   // the half's biases, all loads in flight before the stores
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      b[j][0] = bias(h * NC + j * 8 + 2 * t);
      b[j][1] = bias(h * NC + j * 8 + 2 * t + 1);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float b0 = b[j][0], b1 = b[j][1];
      float v0 = acc[h][4 * j] + b0, v1 = acc[h][4 * j + 1] + b1;
      float v2 = acc[h][4 * j + 2] + b0, v3 = acc[h][4 * j + 3] + b1;
      if (RELU) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      bf16* op = orow + h * NC + j * 8;
      *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(v0, v1);
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * LDA) = __floats2bfloat162_rn(v2, v3);
    }
  }
  __syncwarp();
  FS_MARK(FSP_OTHER);
}

// One narrow layer (a transient layer, 128 -> 128, ReLU) in place on the
// tile's columns 128..255 of this warp's rows; bias(c) as fs_wide's.
template <typename Bias>
__device__ __forceinline__ void fs_narrow(FsRing& rg, bf16* tile, int row0, Bias bias) {
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HALF / (2 * KC); ++kc) {
    const uint32_t st = rg.acquire();
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) load_a<LDA>(a[s], tile, row0, HALF + kc * 2 * KC + 16 * s);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma<128, 0>(acc, a[s], gmma_desc(st + (s >> 1) * STAGE_BYTES + 32 * (s & 1), 16, 512, 2));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    rg.release(rg.q - 1);
  }
  FS_MARK(FSP_EPILOGUE);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* orow = tile + (row0 + g) * LDA + HALF + 2 * t;
  float b[16][2];   // all bias loads in flight before the stores
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    b[j][0] = bias(j * 8 + 2 * t);
    b[j][1] = bias(j * 8 + 2 * t + 1);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float b0 = b[j][0], b1 = b[j][1];
    const float v0 = fmaxf(acc[4 * j] + b0, 0.f), v1 = fmaxf(acc[4 * j + 1] + b1, 0.f);
    const float v2 = fmaxf(acc[4 * j + 2] + b0, 0.f), v3 = fmaxf(acc[4 * j + 3] + b1, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = __floats2bfloat162_rn(v0, v1);
    *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 8 * LDA) = __floats2bfloat162_rn(v2, v3);
  }
  __syncwarp();
  FS_MARK(FSP_OTHER);
}

// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void fs_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(FS_WARPS * 32) : "memory");
}

// The first point of block b's tiles in the point modes: block b of G owns
// the tiles b T / G .. (b + 1) T / G - 1 of the T = ceil(N / 128), whole
// tiles in order (N for b = G).
__host__ __device__ inline long long pt_first_row(int b, int N, int G) {
  const long long tiles = ((long long)N + MT - 1) / MT;
  const long long row = (long long)b * tiles / G * MT;
  return row < N ? row : N;
}

// The save mode's stream write: a warp's 16 tile rows (rows row0.., those
// below nr), columns 0..ncols - 1, to their stream rows (dst: row row0's
// first column; row stride AS), right after the epilogue that wrote them:
// 16 bytes a lane from shared memory, then a streaming 16-byte store (L2
// evict-first), so each warp instruction writes 512 contiguous bytes of a
// row. The warp does not wait for the stores; it waits for its reads of
// the tile (__syncwarp) before the next epilogue overwrites those columns.
template <long long AS>
__device__ __forceinline__ void fs_rows_to_stream(const bf16* tile, int row0, int nr,
                                                  bf16* __restrict__ dst, int ncols) {
  FS_MARK(FSP_STORES);
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    if (row0 + r >= nr) break;
    const bf16* src = tile + (row0 + r) * LDA;
    for (int c = 8 * lane; c < ncols; c += 256)
      __stcs(reinterpret_cast<uint4*>(dst + r * AS + c), *reinterpret_cast<const uint4*>(src + c));
  }
  __syncwarp();
  FS_MARK(FSP_OTHER);
}

// The first ray of block b of G in the save mode: whole rays, b R / G (R
// for b = G), so the blocks' rays differ by at most one and their rows by
// at most KPAD.
__host__ __device__ inline int sv_first_ray(int b, int R, int G) {
  return (int)((long long)b * R / G);
}

// The plain forward over the rows of the samples with deltam != 0 (the
// plan's prefix and ray_start). CAM: acc (R, 8); SHADOW: geo (R,);
// COARSE: the weights (R, KPAD). meta and res: the workspace's rows (ray,
// sample) and results, written and read by this kernel; stream: the
// weight sequence (fs_count_kernel).
// SAVE (CAM, SHADOW): the save mode over every sample row, the rays split
// by sv_first_ray (prefix, ray_start and meta not read), which also writes
// the PE and h0..h7 of every row into the activation stream `acts`
// (ACT_CAM or ACT_SH columns a row).
// The point modes (PT_FIELD: out (R, 8); PT_DENSITY: sigma (R,)) over the
// R points in order: rayin holds their xyz (R, 3), z the field's
// embeddings (R, 4); deltam, mask, prefix, ray_start, meta, res and KPAD
// are not read.
template <int MODE, bool SAVE = false>
__global__ void __launch_bounds__(FS_THREADS, 1)
stream_fwd_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                  const float* __restrict__ deltam, const float* __restrict__ mask,
                  const bf16* __restrict__ wm, const float* __restrict__ wb,
                  const uint4* __restrict__ stream, const int* __restrict__ prefix,
                  const int* __restrict__ ray_start, int2* meta, float* res,
                  float* __restrict__ out, int R, int KPAD, bf16* __restrict__ acts) {
  constexpr bool POINT = MODE == PT_FIELD || MODE == PT_DENSITY;
  constexpr bool CAMERA = MODE == CAM;
  constexpr bool HEADS = CAMERA || MODE == PT_FIELD;   // the camera heads after the trunk
  constexpr int CHUNKS = fs_stream_chunks(HEADS);
  static_assert(!SAVE || MODE == CAM || MODE == SHADOW,
                "the save mode is the camera's or the shadow's");
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;   // the activation stream's row
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem + FS_OFF_TILE);
  float* rin = reinterpret_cast<float*>(smem + FS_OFF_IN) + (threadIdx.x >> 5) * 16 * FS_IN;
  bf16* hw = reinterpret_cast<bf16*>(smem + FS_OFF_HW);
  float* bs = reinterpret_cast<float*>(smem + FS_OFF_BIAS);
  const uint32_t ring = smem_addr(smem);
  const uint32_t full = smem_addr(smem + FS_OFF_BARS);
  const uint32_t empty = full + 8 * FS_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  FS_BEGIN();
  if (tid == 0) {
    for (int s = 0; s < FS_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, FS_WARPS * 32);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the block's rays (point modes: none) and rows; a ray's first row
  auto first_row = [&](int r) { return SAVE ? (long long)r * KPAD : (long long)prefix[r]; };
  const int ray_lo = POINT ? 0 : (SAVE ? sv_first_ray(blockIdx.x, R, gridDim.x)
                                       : ray_start[blockIdx.x]);
  const int ray_hi = POINT ? 0 : (SAVE ? sv_first_ray(blockIdx.x + 1, R, gridDim.x)
                                       : ray_start[blockIdx.x + 1]);
  const long long row_lo = POINT ? pt_first_row(blockIdx.x, R, gridDim.x) : first_row(ray_lo);
  const long long row_hi = POINT ? pt_first_row(blockIdx.x + 1, R, gridDim.x) : first_row(ray_hi);
  const int ntiles = (int)((row_hi - row_lo + MT - 1) / MT);

  if (warp == FS_WARPS) {   // the producer: the weight sequence once a tile, without a break
    if (lane == 0) {
      const uint64_t policy = l2_evict_last();
      const long long total = (long long)ntiles * CHUNKS;
      for (long long q = 0; q < total; ++q) {
        const int s = (int)(q % FS_STAGES);
        if (q >= FS_STAGES) mbar_wait(empty + 8 * s, (uint32_t)((q / FS_STAGES - 1) & 1));
        mbar_expect_tx(full + 8 * s, FS_CHUNK);
        for (int c = 0; c < FS_COPIES; ++c)
          bulk_g2s(ring + s * FS_CHUNK + c * (FS_CHUNK / FS_COPIES),
                   stream + (q % CHUNKS) * (FS_CHUNK / 16) + c * (FS_CHUNK / 16 / FS_COPIES),
                   FS_CHUNK / FS_COPIES, full + 8 * s, policy);
      }
    }
    return;
  }

  // the narrow heads' weights: [sigma | albedo | t_s | t_beta]
  for (int e = tid; e < FS_HW; e += FS_WARPS * 32)
    hw[e] = wm[e < W ? M_SIG + e : (e < W + 3 * HALF ? M_ALB1 + e - W : M_TS + e - W - 3 * HALF)];
  for (int e = tid; e < B_END; e += FS_WARPS * 32) bs[e] = wb[e];
  // each row's (ray, sample): a warp a ray, in sample order (point modes:
  // no rays; the save mode: (row / KPAD, row % KPAD))
  FS_MARK(FSP_META);
  for (int r = ray_lo + warp; !SAVE && r < ray_hi; r += FS_WARPS) {
    long long base = prefix[r];
    for (int k0 = 0; k0 < KPAD; k0 += 32) {
      const int k = k0 + lane;
      const bool nz = k < KPAD && deltam[(long long)r * KPAD + k] != 0.f;
      const unsigned bal = __ballot_sync(0xffffffffu, nz);
      if (nz) meta[base + __popc(bal & ((1u << lane) - 1u))] = make_int2(r, k);
      base += __popc(bal);
    }
  }
  fs_consumers_sync();
  FS_MARK(FSP_OTHER);

  FsRing rg{ring, full, empty, 0};
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;   // this warp's 16 tile rows
  int pj[2];       // the lane's two PE columns (lane, 32 + lane): coordinate, scale
  float psc[2];
  pe_lane(lane, pj[0], psc[0]);
  pe_lane(32 + lane, pj[1], psc[1]);
  const bf16* trow = tile + (row0 + (lane & 15)) * LDA;   // lane's row for the narrow heads
  for (int t = 0; t < ntiles; ++t) {
    const long long g0 = row_lo + (long long)t * MT;   // the tile's first row
    const int nr = (int)min((long long)MT, row_hi - g0);
    const bool own = row0 + (lane & 15) < nr;          // lane's row exists
    // the warp's rows' inputs into its staging (lanes 0..15, a row each)
    if (lane < 16) {
      float v[FS_IN];
#pragma unroll
      for (int c = 0; c < FS_IN; ++c) v[c] = 0.f;
      if (own && POINT) {
        const long long p = g0 + row0 + lane;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = rayin[p * 3 + c];
        if (HEADS) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[8 + c] = z[p * 4 + c];
        }
      } else if (own) {
        const long long g = g0 + row0 + lane;
        const int2 m = SAVE ? make_int2((int)(g / KPAD), (int)(g % KPAD)) : meta[g];
        const float* ri = rayin + (long long)m.x * RAYIN;
#pragma unroll
        for (int c = 0; c < 6; ++c) v[c] = ri[c];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[8 + c] = ri[6 + c];
        v[6] = z[(long long)m.x * KPAD + m.y];
        v[7] = deltam[(long long)m.x * KPAD + m.y];
      }
#pragma unroll
      for (int c = 0; c < FS_IN; ++c) rin[lane * FS_IN + c] = v[c];
    }
    __syncwarp();
    // positional encoding into columns 256..319 of the warp's rows; rows
    // past the tile's get zeros
    FS_MARK(FSP_PE);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = i >> 1, c = (i & 1) * 32 + lane;
      float v = 0.f;
      if (row0 + r < nr && c < 63) {
        const float* ri = rin + r * FS_IN;
        if (POINT) v = pe_value(c, __fmul_rn(ri[pj[i & 1]], psc[i & 1]));
        else v = pe_value(c, ray_xb(ri, pj[i & 1], psc[i & 1], ri[6]));
      }
      tile[(row0 + r) * LDA + W + c] = __float2bfloat16_rn(v);
    }
    __syncwarp();
    FS_MARK(FSP_OTHER);
    for (int i = 0; i < 8; ++i) {
      const float* bi = bs + B_T + i * W;
      fs_wide<true>(rg, tile, row0, i == 0 ? W : 0, fs_layer(i).k_dim,
                    [&](int c) { return bi[c]; });
      if (SAVE)   // the warp's rows of h_i (after h4 with the PE) to the stream
        fs_rows_to_stream<AS>(tile, row0, nr, acts + (g0 + row0) * AS + act_h(i),
                              i == 4 ? W + PE : W);
    }
    FS_MARK(FSP_HEADS);
    float sig = 0.f;
    if (lane < 16) sig = softplus(dot_row(trow, hw, W) + bs[B_SIG]);
    __syncwarp();
    if constexpr (HEADS) {
      FS_MARK(FSP_OTHER);
      fs_wide<false>(rg, tile, row0, 0, W, [&](int c) { return bs[B_BOTT + c]; });
      // the embedding into columns 256..259 (260..319 zero), over the PE
      // (layer 5 was its last reader)
      FS_MARK(FSP_HEADS);
#pragma unroll 4
      for (int i = 0; i < 32; ++i) {
        const int r = i >> 1, c = (i & 1) * 32 + lane;
        const float v = row0 + r < nr && c < 4 ? rin[r * FS_IN + 8 + c] : 0.f;
        tile[(row0 + r) * LDA + W + c] = __float2bfloat16_rn(v);
      }
      __syncwarp();
      FS_MARK(FSP_OTHER);
      // [albedo hidden | transient 0] over [bottleneck | embedding]
      fs_wide<true>(rg, tile, row0, 0, CAT, [&](int c) {
        return bs[c < HALF ? B_ALB0 + c : B_TR + c - HALF];
      });
      for (int i = 1; i < 4; ++i) {
        const float* bi = bs + B_TR + i * HALF;
        fs_narrow(rg, tile, row0, [&](int c) { return bi[c]; });
      }
      FS_MARK(FSP_HEADS);
      float h[3];
      if (lane < 16) {   // albedo
        dot_rows<3>(h, trow, hw + W, HALF, HALF);
#pragma unroll
        for (int c = 0; c < 3; ++c) h[c] = sigmoid(h[c] + bs[B_ALB1 + c]);
      } else {           // t_s and t_beta, then z (deltam beside it)
        float d[2];
        dot_rows<2>(d, trow + HALF, hw + W + 3 * HALF, HALF, HALF);
        h[0] = sigmoid(d[0] + bs[B_TS]);
        h[1] = softplus(d[1] + bs[B_TB]);
        h[2] = rin[(lane & 15) * FS_IN + 6];
      }
      FS_MARK(FSP_RESULTS);
      if (own && POINT) {   // [sigma, albedo | t_s, t_beta, 0, 0]
        float* op = out + (g0 + row0 + (lane & 15)) * ACC;
        *reinterpret_cast<float4*>(op + (lane & 16) / 4) =
            lane < 16 ? make_float4(sig, h[0], h[1], h[2]) : make_float4(h[0], h[1], 0.f, 0.f);
      } else if (own) {
        float* rp = res + (g0 + row0 + (lane & 15)) * FS_RES;
        *reinterpret_cast<float4*>(rp + (lane & 16) / 4) =
            lane < 16 ? make_float4(sig, h[0], h[1], h[2])
                      : make_float4(h[0], h[1], h[2], rin[(lane & 15) * FS_IN + 7]);
      }
    } else {
      FS_MARK(FSP_RESULTS);
      if (own && lane < 16) (POINT ? out : res)[g0 + row0 + lane] = sig;
    }
    __syncwarp();
    FS_MARK(FSP_OTHER);
  }

  if (POINT) {   // no per-ray sums
    FS_END();
    return;
  }
  // the per-ray sums, a thread a ray, in sample order over the ray's rows
  // (the statements of fused_fwd_kernel's, which also visits the samples
  // with deltam = 0, whose terms are exact zeros)
  fs_consumers_sync();
  FS_MARK(FSP_COMPOSITE);
  for (int r = ray_lo + tid; r < ray_hi; r += FS_WARPS * 32) {
    const long long ray = r;
    const float* dr = deltam + ray * KPAD;
    long long row = first_row(r);
    if constexpr (CAMERA) {
      const long long end = first_row(r + 1);
      float excl = 0.f, a[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (; row < end; ++row) {
        const float* rs = res + row * FS_RES;   // [sigma, albedo, t_s, t_beta, z, deltam]
        const float sd = rs[0] * rs[7];
        const float wgt = expf(-excl) * (1.f - expf(-sd));
        a[0] += wgt * rs[6];
        for (int c = 1; c < 6; ++c) a[c] += wgt * rs[c];
        a[6] += wgt;
        excl += sd;
      }
      for (int c = 0; c < 7; ++c) out[ray * ACC + c] = a[c];
      out[ray * ACC + 7] = 0.f;
    } else if (MODE == COARSE) {
      float excl = 0.f;
#pragma unroll 4
      for (int k = 0; k < KPAD; ++k) {
        float w = 0.f;
        if (dr[k] != 0.f) {
          const float sd = res[row++] * dr[k];
          w = expf(-excl) * (1.f - expf(-sd));
          excl += sd;
        }
        out[ray * KPAD + k] = w;
      }
    } else {
      // a sample counts when at least two valid samples remain from it on
      const float* mr = mask + ray * KPAD;
      float remaining = 0.f, ev = 0.f;
      for (int k = 0; k < KPAD; ++k) remaining += mr[k];
#pragma unroll 4
      for (int k = 0; k < KPAD; ++k) {
        if (SAVE || dr[k] != 0.f) {   // the save mode: every sample a row
          if (remaining >= 2.f) ev += res[row] * dr[k];
          ++row;
        }
        remaining -= mr[k];
      }
      out[ray] = expf(-ev);
    }
  }
  FS_END();
}

// The workspace of a streamed forward of R rays of KPAD samples (camera !=
// 0: the camera's), in bytes, and its carve: the weight stream, the rows'
// results and (ray, sample), the counts, the prefix and the blocks' first
// rays, each 256-byte aligned. bench/stream_fwd.py and fused_render.py's
// stream_fwd_workspace_bytes restate it.
struct FsLayout {
  size_t stream, res, meta, cnt, prefix, ray_start, total;
};

FsLayout fs_layout(bool camera, int R, int KPAD) {
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  const size_t rows = (size_t)R * KPAD;
  FsLayout L;
  L.stream = 0;
  L.res = L.stream + up((size_t)fs_stream_chunks(camera) * FS_CHUNK);
  L.meta = L.res + up(rows * (camera ? FS_RES : 1) * sizeof(float));
  L.cnt = L.meta + up(rows * sizeof(int2));
  L.prefix = L.cnt + up((size_t)R * sizeof(int));
  L.ray_start = L.prefix + up((size_t)(R + 1) * sizeof(int));
  L.total = L.ray_start + up((size_t)(FS_MAX_BLOCKS + 1) * sizeof(int));
  return L;
}

// the streamed forward's grid: one block an SM, at most FS_MAX_BLOCKS; 0 on
// a CUDA error (its code in *err)
int fs_grid(cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return *err == cudaSuccess ? std::min(sms, FS_MAX_BLOCKS) : 0;
}

long long fs_launch_count[5] = {0, 0, 0, 0, 0};   // plain and point-mode launches, by mode

// The plan's two launches (fs_count_kernel with the weight stream, then
// fs_scan_kernel) into the workspace `ws` (fs_layout), for the grid of G
// blocks.
int launch_plan(bool camera, const float* deltam, const bf16* wm, int R, int KPAD, int G,
                unsigned char* ws, cudaStream_t stream) {
  const FsLayout L = fs_layout(camera, R, KPAD);
  int* cnt = reinterpret_cast<int*>(ws + L.cnt);
  const int nb_rays = (R + 7) / 8;
  const int nb_stream = fs_stream_chunks(camera) * (FS_CHUNK / 16) / 256;
  fs_count_kernel<<<nb_rays + nb_stream, 256, 0, stream>>>(
      deltam, R, KPAD, cnt, nb_rays, wm, camera ? FS_LAYERS_CAM : FS_LAYERS_DENSITY,
      reinterpret_cast<uint4*>(ws + L.stream));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fs_scan_kernel<<<1, 1024, 0, stream>>>(cnt, R, G, reinterpret_cast<int*>(ws + L.prefix),
                                         reinterpret_cast<int*>(ws + L.ray_start));
  return (int)cudaGetLastError();
}

bool fs_shape_ok(int R, int KPAD) {
  return R > 0 && KPAD > 0 && KPAD % 8 == 0 && KPAD <= MAX_KPAD &&
         (long long)R * KPAD < (1LL << 31);
}

template <int MODE>
int launch_stream(const float* rayin, const float* z, const float* deltam, const float* mask,
                  const void* wm_, const float* wb, float* out, int R, int KPAD, void* ws,
                  cudaStream_t stream) {
  if (!fs_shape_ok(R, KPAD) || ws == nullptr) return (int)cudaErrorInvalidValue;
  constexpr bool CAMERA = MODE == CAM;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const FsLayout L = fs_layout(CAMERA, R, KPAD);
  unsigned char* base = static_cast<unsigned char*>(ws);
  cudaError_t e = cudaSuccess;
  const int G = fs_grid(&e);
  if (e != cudaSuccess) return (int)e;
  const int err = launch_plan(CAMERA, deltam, wm, R, KPAD, G, base, stream);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(stream_fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FS_SMEM);
  if (e != cudaSuccess) return (int)e;
  stream_fwd_kernel<MODE><<<G, FS_THREADS, FS_SMEM, stream>>>(
      rayin, z, deltam, mask, wm, wb, reinterpret_cast<const uint4*>(base + L.stream),
      reinterpret_cast<const int*>(base + L.prefix), reinterpret_cast<const int*>(base + L.ray_start),
      reinterpret_cast<int2*>(base + L.meta), reinterpret_cast<float*>(base + L.res), out, R,
      KPAD, nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++fs_launch_count[MODE];
  return 0;
}

// The weight stream of the camera's heads (camera) or of the density trunk
// alone into `dst` (fs_count_kernel's stream blocks): the one plan launch
// of the point modes and of the save mode.
int launch_weight_stream(bool camera, const bf16* wm, uint4* dst, cudaStream_t stream) {
  const int nb_stream = fs_stream_chunks(camera) * (FS_CHUNK / 16) / 256;
  fs_count_kernel<<<nb_stream, 256, 0, stream>>>(
      nullptr, 0, 0, nullptr, 0, wm, camera ? FS_LAYERS_CAM : FS_LAYERS_DENSITY, dst);
  return (int)cudaGetLastError();
}

// The point modes' workspace: the weight stream alone (the field's is the
// camera's, the density's the shadow's), 256-byte aligned.
size_t pt_workspace_bytes(bool field) {
  return ((size_t)fs_stream_chunks(field) * FS_CHUNK + 255) / 256 * 256;
}

// The point modes' grid for N points: one block an SM (at most
// FS_MAX_BLOCKS), at most a tile each; 0 on a CUDA error (its code in *err).
int pt_grid(int N, cudaError_t* err) {
  return std::min(fs_grid(err), (int)(((long long)N + MT - 1) / MT));
}

// A per-point forward (MODE PT_FIELD or PT_DENSITY): the weight stream
// into the workspace `ws` (fs_count_kernel's stream blocks), then the
// persistent grid over the points.
template <int MODE>
int launch_point_fwd(const float* pos, const float* emb, const void* wm_, const float* wb,
                     float* out, int N, void* ws, cudaStream_t stream) {
  if (N <= 0 || ws == nullptr) return (int)cudaErrorInvalidValue;
  constexpr bool FIELD = MODE == PT_FIELD;
  const bf16* wm = static_cast<const bf16*>(wm_);
  uint4* weights = static_cast<uint4*>(ws);
  cudaError_t e = cudaSuccess;
  const int G = pt_grid(N, &e);
  if (e != cudaSuccess) return (int)e;
  const int err = launch_weight_stream(FIELD, wm, weights, stream);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(stream_fwd_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FS_SMEM);
  if (e != cudaSuccess) return (int)e;
  stream_fwd_kernel<MODE><<<G, FS_THREADS, FS_SMEM, stream>>>(
      pos, emb, nullptr, nullptr, wm, wb, weights, nullptr, nullptr, nullptr, nullptr, out, N, 0,
      nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++fs_launch_count[MODE];
  return 0;
}

// The save mode's workspace of R rays of KPAD samples (camera: the
// camera's), in bytes, and its carve: the weight stream, then every row's
// results (camera: 8 floats, else 1), each 256-byte aligned.
// fused_render.py's save_fwd_layout restates it.
struct SvLayout {
  size_t stream, res, total;
};

SvLayout sv_layout(bool camera, int R, int KPAD) {
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  SvLayout L;
  L.stream = 0;
  L.res = up((size_t)fs_stream_chunks(camera) * FS_CHUNK);
  L.total = L.res + up((size_t)R * KPAD * (camera ? FS_RES : 1) * sizeof(float));
  return L;
}

// The save mode's grid for R rays: one block an SM (at most FS_MAX_BLOCKS),
// at least a ray each; 0 on a CUDA error (its code in *err).
int sv_grid(int R, cudaError_t* err) { return std::min(fs_grid(err), R); }

long long sv_launch_count[2] = {0, 0};   // save-mode launches: camera, shadow

// The save forward (MODE CAM or SHADOW): the weight stream into the
// workspace `ws` (sv_layout), then the persistent grid over every sample
// row, writing the activation stream `acts`.
template <int MODE>
int launch_save(const float* rayin, const float* z, const float* deltam, const float* mask,
                const void* wm_, const float* wb, float* out, bf16* acts, int R, int KPAD,
                void* ws, cudaStream_t stream) {
  if (!fs_shape_ok(R, KPAD) || ws == nullptr || acts == nullptr) return (int)cudaErrorInvalidValue;
  constexpr bool CAMERA = MODE == CAM;
  const bf16* wm = static_cast<const bf16*>(wm_);
  const SvLayout L = sv_layout(CAMERA, R, KPAD);
  unsigned char* base = static_cast<unsigned char*>(ws);
  cudaError_t e = cudaSuccess;
  const int G = sv_grid(R, &e);
  if (e != cudaSuccess) return (int)e;
  const int err = launch_weight_stream(CAMERA, wm, reinterpret_cast<uint4*>(base + L.stream), stream);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(stream_fwd_kernel<MODE, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FS_SMEM);
  if (e != cudaSuccess) return (int)e;
  stream_fwd_kernel<MODE, true><<<G, FS_THREADS, FS_SMEM, stream>>>(
      rayin, z, deltam, mask, wm, wb, reinterpret_cast<const uint4*>(base + L.stream), nullptr,
      nullptr, nullptr, reinterpret_cast<float*>(base + L.res), out, R, KPAD, acts);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++sv_launch_count[CAMERA ? 0 : 1];
  return 0;
}

// ---------------------------------------------------------------------------
// backward: the cotangent chain (dgrad) and the weight gradients (wgrad)
// ---------------------------------------------------------------------------

// The dgrad pass (dgrad_kernel below): what bounds it and what its design
// does about that. Per 128-row tile it reads the ReLU masks of every layer
// from the activation stream (2688 bf16 columns a camera row) and writes
// every layer's pre-activation cotangent to the cotangent stream (2976),
// 11.4 KB a row against 0.68 M multiply-adds: at 60 operations a byte it is
// bound by bytes (the camera's training batch, 1024 x 128 rows: 1.48 GB,
// 0.45 ms at 3.35 TB/s; its products alone 0.18 ms at 989 TFLOP/s). The
// kernel this replaces (one block a unit, on dgemm) spent 38 % of a tile in
// reading the masks synchronously behind a barrier, 29 % in its products
// and the rest in serial steps (PERF.md, its phase table). Here:
// - a layer's mask is staged by cp.async (L2 evict-first) into the columns
//   of the output tile that the product will overwrite, spread over the
//   pass's first chunks, so it lands under the products; the epilogue
//   applies it to the rounded accumulators (a zero stays a zero);
// - a finished cotangent tile goes to the stream (16-byte evict-first
//   stores) after the first barrier of the product that reads it;
// - its bias gradient is formed in the epilogue that makes it, from the
//   registers: each thread's two rows, a three-step exchange over the
//   warp's rows, then the eight warps in order through shared memory (a
//   fixed tree: deterministic, but not the row order of the kernel this
//   replaces, so the bias gradients differ from it in the last bits);
// - the weight ring runs on from one product to the next and from one tile
//   to the next (ChainRing), four stages deep, each warpgroup's products of
//   one chunk still running across the next chunk's barrier;
// - a persistent grid: one block an SM loops over the units of whole rays
//   (the old blocks, each with its own row of bias partial sums, reduced in
//   the same order), the next tile's head cotangents copied in under the
//   current tile's first product; the head layers, the PE backward and the
//   per-ray sums spread over the block's threads.
// Landmarks of its phases (DG_*): empty here; bench/backward_passes.py
// builds a copy that defines them (the phase order of its PHASES).
#ifndef DG_MARK
#define DG_MARK(next)
#define DG_BEGIN()
#define DG_TILE()
#define DG_PRO()
#define DG_MM()
#define DG_NEXT_CALL()
#define DG_END(dst)
#endif
// (PH_MASK names the parent kernel's synchronous mask reads, which the
// bench's copy of that kernel marks; this one has none.)
enum DgPhase { PH_HEADS_IN, PH_HEAD_LOOPS, PH_MASK, PH_STORES, PH_COLSUMS, PH_PE_BWD, PH_RAY_SUMS,
               PH_OTHER, PH_EPILOGUE, PH_BARRIER };

// One product of the cotangent chain: the cotangent at a layer's output
// (k_dim columns of a tile) times Wp, the layer's packed (out, in) matrix at
// element w, gives the one at its input (n_dim columns).
struct DJob {
  long long w;
  int k_dim, n_dim;
};

// A tile's chain, in order: the camera heads' products (transient layers 3,
// 2, 1, 0, the albedo hidden layer's, the bottleneck's), then with TRUNK the
// trunk's layers 7..0; the shadow's chain is the trunk's alone.
template <bool CAMERA, bool TRUNK>
struct DChain {
  static constexpr int HEADS = CAMERA ? 6 : 0;
  static constexpr int JOBS = HEADS + (TRUNK ? 8 : 0);
  __device__ static DJob job(int j) {
    switch (j < HEADS ? j : 6) {
      case 0: return {M_TR1 + 2LL * HALF * HALF, HALF, HALF};
      case 1: return {M_TR1 + (long long)HALF * HALF, HALF, HALF};
      case 2: return {M_TR1, HALF, HALF};
      case 3: return {M_TR0, HALF, CAT};
      case 4: return {M_ALB0, HALF, W};
      case 5: return {M_BOTT, W, W};
      default: {
        const int i = 7 - (j - HEADS);
        return {trunk_offset(i), W, i == 0 ? PE : (i == 5 ? CAT : W)};
      }
    }
  }
  // weight chunks of a product: 128-column passes of KC-deep slices
  __device__ static int chunks(const DJob& jb) { return (jb.n_dim + NC - 1) / NC * (jb.k_dim / KC); }
};

// The chain's weight ring: tile_common.cuh's 32-deep, 128-column chunks
// and one block barrier a chunk, run as one sequence over the block's whole
// chain (after a product's last chunks the ring goes on with the next
// product's first, and after a tile's last product with the next tile's
// first, so no product starts by waiting for its weights). DSTAGES chunks:
// a warpgroup leaves WG_INFLIGHT chunks' products in flight across the
// next barrier (so they run under it), and LOOKAHEAD chunks are copied
// ahead of the products; the stage a barrier frees is the one
// WG_INFLIGHT + 1 chunks back.
constexpr int DSTAGES = 4;
constexpr int WG_INFLIGHT = 1;
constexpr int LOOKAHEAD = DSTAGES - 1 - WG_INFLIGHT;
constexpr int DWST = DSTAGES * NC * KC;   // bf16 elements (32,768 bytes)

template <class Chain>
struct ChainRing {
  uint32_t ring;      // shared address of the DSTAGES stages
  const bf16* wm;
  int q, iq;          // chunks consumed (chunk q sits in stage q % DSTAGES), chunks issued
  long long left;     // chunks the block has still to issue
  // the next chunk to issue: product ij of the chain (its matrix w, its
  // n_dim and k slices nk), pass column n0 and k slice ik
  int ij, n_dim, nk, n0, ik;
  const bf16* w;

  __device__ void start(int j) {
    const DJob jb = Chain::job(j);
    ij = j;
    w = wm + jb.w;
    n_dim = jb.n_dim;
    nk = jb.k_dim / KC;
    n0 = ik = 0;
  }

  __device__ void issue() {
    if (left > 0) {
      stage_wp(ring + (iq % DSTAGES) * STAGE_BYTES, w, n_dim, n0, ik * KC);
      if (++ik == nk) {
        ik = 0;
        n0 += NC;
        if (n0 >= n_dim) start(ij + 1 == Chain::JOBS ? 0 : ij + 1);
      }
      --left;
    }
    cp_async_commit();
    ++iq;
  }

  // The next chunk, landed for every thread (one block barrier); after the
  // barrier `after` runs (its cp.async copies join the new group), then the
  // chunk LOOKAHEAD ahead is issued into the stage the barrier freed.
  template <typename After>
  __device__ uint32_t next(After after) {
    cp_async_wait<LOOKAHEAD - 1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();
    after();
    issue();
    return ring + (q++ % DSTAGES) * STAGE_BYTES;
  }
};

// The tile a chain works on, and what the products' epilogues owe the
// block: the streams, the tile's rows, and the warps' column sums of the
// last 128-column pass of a cotangent (colpart, 8 warps x 128) still to be
// added to the bias sums (fold_dst, fold_n columns).
struct ChainTile {
  const bf16* acts;   // activation stream (as columns)
  long long as;
  bf16* gp;           // cotangent stream (gs columns)
  long long gs;
  long long g0;       // the tile's first stream row
  int nrows;          // its rows
  float* colpart;
  float* fold_dst;
  int fold_n;
  uint64_t policy;    // L2 evict-first: the streams pass through once

  // the pending column sums into the bias sums: warps 0..7 in order (the
  // caller has passed a block barrier since the epilogue that wrote them)
  __device__ void fold() {
    for (int c = threadIdx.x; c < fold_n; c += THREADS) {
      float s = colpart[c];
#pragma unroll
      for (int w = 1; w < THREADS / 32; ++w) s += colpart[w * NC + c];
      fold_dst[c] += s;
    }
    fold_n = 0;
  }
};

// A 128-column pass of a layer's ReLU mask (activation stream columns
// col.. of the tile's rows) into columns n0.. of the tile `dst` that the
// pass's results will overwrite: part `part` of `parts` of eight 16-byte
// cp.async copies a thread, L2 evict-first (the stream passes through
// once; read normally it evicts the weights every tile re-reads), rows
// past nrows zero-filled (a zero mask). The caller commits them (a chain
// product: in the weight ring's groups) and waits for them.
__device__ __forceinline__ void stage_mask(const ChainTile& ct, bf16* dst, int n0, int col,
                                           int part = 0, int parts = 1) {
  constexpr int N = MT * (NC / 8) / THREADS;
  for (int i = part * N / parts; i < (part + 1) * N / parts; ++i) {
    const int v = threadIdx.x + i * THREADS, r = v / (NC / 8), u = v % (NC / 8);
    const bool in = r < ct.nrows;
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 ::"r"(smem_addr(dst + r * LDA + n0 + u * 8)),
                 "l"(ct.acts + (ct.g0 + (in ? r : 0)) * ct.as + col + u * 8), "r"(in ? 16 : 0),
                 "l"(ct.policy)
                 : "memory");
  }
}

// v0, v1 (a bf16 pair's columns) kept where the staged activation pair m
// is > 0
__device__ __forceinline__ void apply_mask(float& v0, float& v1, __nv_bfloat162 m) {
  const float2 a = __bfloat1622float2(m);
  if (!(a.x > 0.f)) v0 = 0.f;
  if (!(a.y > 0.f)) v1 = 0.f;
}

// The column sums of one 128-column pass over the warp's 16 rows into
// colpart[warp][column]: x[k] is this thread's two rows' sum of column
// 64 h + 8 j + 2 t + e, k = 2 (8 h + j) + e; three halving exchanges over
// the eight lanes of a column group (lane bits 4, 3, 2) leave each lane the
// sums of four columns, k = 4 g + 0..3. A fixed tree: deterministic.
__device__ __forceinline__ void warp_colsums(const float (&x)[32], float* colpart) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float y[16], z[8], w[4];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    y[k] = (b4 ? x[k + 16] : x[k]) + __shfl_xor_sync(0xffffffffu, b4 ? x[k] : x[k + 16], 16);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    z[k] = (b3 ? y[k + 8] : y[k]) + __shfl_xor_sync(0xffffffffu, b3 ? y[k] : y[k + 8], 8);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (b2 ? z[k + 4] : z[k]) + __shfl_xor_sync(0xffffffffu, b2 ? z[k] : z[k + 4], 4);
  float* dst = colpart + (threadIdx.x >> 5) * NC + 2 * t;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int idx = 4 * g + k;
    dst[64 * (idx >> 4) + 8 * ((idx >> 1) & 7) + (idx & 1)] = w[k];
  }
}

// What a chain product's epilogue does with its rounded accumulators
// round(acc) (then the mask where mcol >= 0, on the columns below W):
// EP_MASK   the cotangent at a ReLU layer's pre-activation;
// EP_PLAIN  nothing more (the transient input's [g_bott | g_emb]);
// EP_ADD    round(out + round(acc)), rows past nrows zeroed (the bottleneck's
//           cotangent: the albedo head's part added to the transient's);
// EP_SIG    round(round(acc) + round(g_sig w_sig)) (g_h7: the sigma head's
//           part added to the bottleneck's);
// EP_PE     round(out + round(acc)) (layer 0's PE part added to layer 5's).
enum ChainEp { EP_MASK, EP_PLAIN, EP_ADD, EP_SIG, EP_PE };

// One chain product on a 128-row tile (tile_common.cuh dgemm's products:
// Wp's (k, n) chunks MN-major from the ring, each warpgroup 64 rows, one
// m64n64k16 a 64-column half and k step): out[r, oc0 + n] from A's first
// k_dim columns (A and out may be one tile if their columns are disjoint).
// After its first barrier: A's rows (the finished cotangent this product
// reads, k_dim columns, rows below nrows) to the cotangent stream at column
// gcol_a (< 0: none), 16 bytes a thread, evict-first, which drain under the
// products. After each of the product's barriers the pending column
// sums are folded (each pass's after the next pass's first barrier);
// each masked pass's mask is staged into out's pass columns after its
// first barrier and lands under its chunks. After the product's first
// barrier, `first` (a prefetch). bsum_out (null: none): the bias sums of
// the cotangent this product gives, its column sums formed in the epilogue
// from the registers (warp_colsums) and folded after the next barrier.
// wsig and hsv: EP_SIG's w_sig and the tile's head cotangents.
template <int EP, class Ring, typename First>
__device__ void chain_mm(Ring& rg, ChainTile& ct, const DJob jb, const bf16* A, int gcol_a,
                         bf16* out, int oc0, int mcol, float* bsum_out,
                         const bf16* __restrict__ wsig, const float* hsv, First first) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16, ra = row0 + g, rb = ra + 8;
  const int nk = jb.k_dim / KC, nrows = ct.nrows;
  const int upr = jb.k_dim / 8, units = gcol_a >= 0 ? nrows * upr : 0;   // A's 16-byte units
  // mask parts: issued at chunk kk, they land by chunk kk + LOOKAHEAD
  const int parts = min(4, nk - LOOKAHEAD);
  float hsa = 0.f, hsb = 0.f;
  if (EP == EP_SIG) {
    hsa = bf_round(hsv[ra * HG]);
    hsb = bf_round(hsv[rb * HG]);
  }
  DG_PRO();
  bool first_chunk = true;
  for (int n0 = 0; n0 < jb.n_dim; n0 += NC) {
    const int nh = min(NC, jb.n_dim - n0) / 64;   // 64-column halves of this pass
    const bool mpass = mcol >= 0 && n0 < W;
    float acc[2][32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    uint32_t a[2][KC / 16][4];   // A's fragments, two chunks' (one may be in flight)
    int kk = 0;                  // the pass's chunk pair
    // one chunk, kk + P: its barrier and hook, A's fragments into a[P], the products
    auto chunk = [&](auto par) {
      constexpr int P = decltype(par)::value;
      const int kk_ = kk + P;
      const uint32_t st = rg.next([&] {
        ct.fold();
        // out's pass columns are free: the last product that read them is done
        if (mpass && kk_ < parts) stage_mask(ct, out, n0, mcol + n0, kk_, parts);
        if (first_chunk) {   // A's rows to the stream, four loads in flight a round
          DG_MARK(PH_STORES);
          for (int v0 = tid; v0 < units; v0 += 4 * THREADS) {
            uint4 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int v = v0 + i * THREADS, r = v / upr, c = (v - r * upr) * 8;
              if (v < units) x[i] = *reinterpret_cast<const uint4*>(A + r * LDA + c);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int v = v0 + i * THREADS, r = v / upr, c = (v - r * upr) * 8;
              if (v < units)
                __stcs(reinterpret_cast<uint4*>(ct.gp + (ct.g0 + r) * ct.gs + gcol_a + c), x[i]);
            }
          }
          first();
        }
      });
      first_chunk = false;
      if (kk_ == 0) DG_MM();
#pragma unroll
      for (int s = 0; s < KC / 16; ++s) load_a<LDA>(a[P][s], A, row0, kk_ * KC + 16 * s);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
      // MN-major B: (k, n) rows of 128 bytes, 8-row groups 1024 apart, the
      // second 64-column half KC * 128 further. Both halves always: a
      // condition around a wgmma makes ptxas serialize the products
      // (C7520); a half past n_dim reads a stale stage and is not written.
#pragma unroll
      for (int s = 0; s < KC / 16; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma<64, 1>(acc[h], a[P][s], gmma_desc(st + h * (KC * 128) + 2048 * s, KC * 128, 1024, 1));
      wgmma_commit();
      wgmma_wait<WG_INFLIGHT>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
    };
    for (kk = 0; kk < nk; kk += 2) {   // nk is even (4 or 8)
      chunk(std::integral_constant<int, 0>{});
      chunk(std::integral_constant<int, 1>{});
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    DG_MARK(PH_EPILOGUE);
    float xs[32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (h >= nh) continue;
        const int col = n0 + h * 64 + j * 8 + 2 * t;
        float v0 = bf_round(acc[h][4 * j]), v1 = bf_round(acc[h][4 * j + 1]);
        float v2 = bf_round(acc[h][4 * j + 2]), v3 = bf_round(acc[h][4 * j + 3]);
        __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(out + ra * LDA + oc0 + col);
        __nv_bfloat162* pb = reinterpret_cast<__nv_bfloat162*>(out + rb * LDA + oc0 + col);
        if (EP == EP_ADD || EP == EP_PE) {
          const float2 e0 = __bfloat1622float2(*pa), e1 = __bfloat1622float2(*pb);
          v0 = bf_round(v0 + e0.x); v1 = bf_round(v1 + e0.y);
          v2 = bf_round(v2 + e1.x); v3 = bf_round(v3 + e1.y);
        }
        if (EP == EP_SIG) {
          const float s0 = bf(wsig[col]), s1 = bf(wsig[col + 1]);
          v0 = bf_round(v0 + bf_round(hsa * s0));
          v1 = bf_round(v1 + bf_round(hsa * s1));
          v2 = bf_round(v2 + bf_round(hsb * s0));
          v3 = bf_round(v3 + bf_round(hsb * s1));
        }
        if (mpass) {   // the staged mask sits where the result goes
          apply_mask(v0, v1, *pa);
          apply_mask(v2, v3, *pb);
        }
        if (EP == EP_ADD) {   // rows past the tile's: zeros (a mask has them zero-filled)
          if (ra >= nrows) v0 = v1 = 0.f;
          if (rb >= nrows) v2 = v3 = 0.f;
        }
        // every v is a bf16 value now: stored exactly, summed as stored
        *pa = __floats2bfloat162_rn(v0, v1);
        *pb = __floats2bfloat162_rn(v2, v3);
        xs[2 * (8 * h + j)] = v0 + v2;
        xs[2 * (8 * h + j) + 1] = v1 + v3;
      }
    if (bsum_out != nullptr && n0 < W) {   // not layer 5's PE part; folded after the next barrier
      DG_MARK(PH_COLSUMS);
      warp_colsums(xs, ct.colpart);
      ct.fold_dst = bsum_out + n0;
      ct.fold_n = NC;
    }
    DG_MARK(PH_BARRIER);
  }
  DG_NEXT_CALL();
}

// A head layer's cotangent computed per element into a tile (n_dim
// columns), in the products' accumulator layout so that each warp writes
// only its own 16 rows: val(r, c) rounded to bf16, masked where mcol >= 0
// (the mask staged into the tile first, as chain_mm stages it), rows past
// the tile's zero; with bsum_out, its column sums as chain_mm forms them.
// The tile must be free (the caller passed a block barrier since its last
// readers).
template <typename Val>
__device__ void head_tile(ChainTile& ct, bf16* out, int n_dim, int mcol, float* bsum_out,
                          Val val) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = (threadIdx.x >> 5) * 16 + g, rb = ra + 8;
  if (mcol >= 0) {
    for (int n0 = 0; n0 < n_dim; n0 += NC) stage_mask(ct, out, n0, mcol + n0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    if (n0 > 0 && bsum_out != nullptr) {   // the last pass's column sums out of colpart
      __syncthreads();
      ct.fold();
      __syncthreads();
    }
    float xs[32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + h * 64 + j * 8 + 2 * t;
        __nv_bfloat162* pa = reinterpret_cast<__nv_bfloat162*>(out + ra * LDA + col);
        __nv_bfloat162* pb = reinterpret_cast<__nv_bfloat162*>(out + rb * LDA + col);
        float v0 = val(ra, col), v1 = val(ra, col + 1), v2 = val(rb, col), v3 = val(rb, col + 1);
        if (mcol >= 0) {   // rows past the tile's: the zero-filled mask zeroes them
          apply_mask(v0, v1, *pa);
          apply_mask(v2, v3, *pb);
        }
        const __nv_bfloat162 ya = __floats2bfloat162_rn(v0, v1), yb = __floats2bfloat162_rn(v2, v3);
        *pa = ya;
        *pb = yb;
        const float2 fa = __bfloat1622float2(ya), fb = __bfloat1622float2(yb);
        xs[2 * (8 * h + j)] = fa.x + fb.x;
        xs[2 * (8 * h + j) + 1] = fa.y + fb.y;
      }
    if (bsum_out != nullptr) {
      warp_colsums(xs, ct.colpart);
      ct.fold_dst = bsum_out + n0;
      ct.fold_n = NC;
    }
  }
}

// Second pass of the backward: the cotangent chain from the head
// cotangents `hg` down to the PE, per 128-sample tile, in bf16 tiles in
// shared memory, the ReLU masks read back from the activation stream.
// Writes every layer's pre-activation cotangent to `gpre`, each unit's f32
// bias-gradient sums to `bias_part` (one row a unit, reduced in a fixed
// order later) and the per-ray d_rayin = [d_o, d_d, d_emb] into `dout`.
// Units: `rpb` whole rays (the forward's blocks, rays_per_block), walked by
// a persistent grid (unit blockIdx.x, then + gridDim.x, ...). Every output
// but the bias gradients is the bits of the one-block-a-unit kernel this
// replaces (the products, masks and per-ray sums in its order); the bias
// gradients sum each tile's columns in a fixed tree (warp_colsums).
// POINT: rows are points (R = N, KPAD = 1, rpb = MT: 128 points a unit,
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
  using Chain = DChain<CAMERA, TRUNK>;
  constexpr int NB = CAMERA ? B_END : B_BOTT;
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  constexpr long long GS = CAMERA ? GP_CAM : GP_SH;
  constexpr int GSIG = CAMERA ? G_SIG_CAM : G_SIG_SH;
  constexpr int NH = CAMERA ? 6 : 1;        // head cotangents per sample
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* bsum = reinterpret_cast<float*>(wst + DWST);  // B_END floats
  float* hgs = bsum + B_END + 2;       // 2 x MT x HG: this tile's head cotangents, the next's
  float* rowacc = hgs + 2 * MT * HG;   // MT x 10: per-sample [d_o, d_d, d_emb]
  float* colpart = rowacc + MT * 10;   // 8 warps x 128: column sums of a warp's rows
  float* rayacc = colpart + 8 * NC;    // rpb x 10 (rays; points use rowacc)
  const int tid = threadIdx.x;
  const int nunits = (R + rpb - 1) / rpb;
  DG_BEGIN();

  // the block's tiles: its units' rays, 128 sample rows at a time
  auto unit_rows = [&](int u) { return min(rpb, R - u * rpb) * KPAD; };
  long long ntiles = 0;
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) ntiles += (unit_rows(u) + MT - 1) / MT;
  int per_tile = 0;
  for (int j = 0; j < Chain::JOBS; ++j) per_tile += Chain::chunks(Chain::job(j));
  // a tile's head cotangents (rows g0.. of hg, nr of them; zeros past them)
  // into buf: one 16-byte copy a thread
  auto load_hg = [&](float* buf, long long g0n, int nr) {
    const int r = tid >> 1, half = tid & 1;
    cp_async16_zfill(smem_addr(buf + r * HG + 4 * half),
                     hg + (g0n + min(r, nr - 1)) * HG + 4 * half, r < nr ? 16 : 0);
  };

  for (int e = tid; e < NB; e += THREADS) bsum[e] = 0.f;
  for (int e = tid; !POINT && e < rpb * 10; e += THREADS) rayacc[e] = 0.f;
  ChainRing<Chain> rg{smem_addr(wst), wm, 0, 0, ntiles * per_tile};
  if (Chain::JOBS > 0) rg.start(0);
  ChainTile ct{acts, AS, gpre, GS, 0, 0, colpart, nullptr, 0, 0};
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(ct.policy));
  int u = blockIdx.x, s0 = 0;   // the tile: unit u's rows s0..
  if (ntiles > 0) load_hg(hgs, (long long)u * rpb * KPAD, min(MT, unit_rows(u)));
#pragma unroll
  for (int q = 0; q < LOOKAHEAD; ++q) rg.issue();   // the first tile's head cotangents join
  cp_async_wait<0>();

  for (long long ti = 0; ti < ntiles; ++ti) {
    const int ray0 = u * rpb, nray = min(rpb, R - ray0), S = nray * KPAD;
    const int nrows = min(MT, S - s0);
    const long long g0 = (long long)ray0 * KPAD + s0;
    ct.g0 = g0;
    ct.nrows = nrows;
    int nu = u, ns = s0 + MT;   // the next tile
    if (ns >= S) { nu += gridDim.x; ns = 0; }
    float* hgt = hgs + (ti & 1) * MT * HG;
    float* hgn = hgs + ((ti + 1) & 1) * MT * HG;
    // the next tile's head cotangents, under this tile's first product
    auto prefetch = [&] {
      if (ti + 1 < ntiles) load_hg(hgn, (long long)nu * rpb * KPAD + ns, min(MT, unit_rows(nu) - ns));
    };
    if constexpr (Chain::JOBS == 0) {   // no product to hide it under
      load_hg(hgt, g0, nrows);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    DG_TILE();
    if (tid < NH) {   // the head biases' gradients sum the f32 cotangents
      float s = 0.f;
      for (int r = 0; r < nrows; ++r) s += hgt[r * HG + tid];
      const int b = tid == 0 ? B_SIG : (tid < 4 ? B_ALB1 + tid - 1 : (tid == 4 ? B_TS : B_TB));
      bsum[b] += s;
    }
    // the heads' bf16 cotangents into the stream: [sigma | albedo | t_s | t_beta], 8 wide each
    constexpr int ncol = CAMERA ? 32 : 8;
    for (int e = tid; e < nrows * ncol; e += THREADS) {
      const int r = e / ncol, c = e % ncol, grp = c / 8, j = c % 8;
      const float* hs = hgt + r * HG;
      float v = 0.f;
      if (grp == 0) v = j == 0 ? bf_round(hs[0]) : 0.f;
      else if (grp == 1) v = j < 3 ? bf_round(hs[1 + j]) : 0.f;
      else v = j == 0 ? bf_round(hs[2 + grp]) : 0.f;
      gpre[(g0 + r) * GS + GSIG + c] = __float2bfloat16_rn(v);
    }
    // each cotangent tile goes to the stream, a share a chunk, under the
    // product that reads it (chain_mm's gcol_a)
    bf16 *C, *O;   // C: the tile holding the current cotangent
    if (CAMERA) {
      bf16 *X = bufX, *Y = bufY;
      DG_MARK(PH_HEAD_LOOPS);
      // transient output layer: g_t3 = round(round(g_ts w_ts) + round(g_tb w_tb)), masked
      head_tile(ct, X, HALF, A_T0 + 3 * HALF, bsum + B_TR + 3 * HALF, [&](int r, int c) {
        const float a = bf_round(bf_round(hgt[r * HG + 4]) * bf(wm[M_TS + c]));
        const float b = bf_round(bf_round(hgt[r * HG + 5]) * bf(wm[M_TB + c]));
        return a + b;
      });
      for (int i = 3; i >= 1; --i) {   // transient layers 3..1: the cotangents at t2..t0
        chain_mm<EP_MASK>(rg, ct, Chain::job(3 - i), X, G_TR0 + i * HALF, Y, 0,
                          A_T0 + (i - 1) * HALF, bsum + B_TR + (i - 1) * HALF, nullptr, nullptr,
                          [&, i] {
                            if (i == 3) prefetch();
                          });
        bf16* tmp = X; X = Y; Y = tmp;
      }
      // transient layer 0: Y = [g_bott from the transient head | g_emb | 0]
      chain_mm<EP_PLAIN>(rg, ct, Chain::job(3), X, G_TR0, Y, 0, -1, nullptr, nullptr, nullptr,
                         [] {});
      __syncthreads();
      if (tid < MT)
        for (int j = 0; j < 4; ++j)
          rowacc[tid * 10 + 6 + j] = tid < nrows ? bf(Y[tid * LDA + W + j]) : 0.f;
      DG_MARK(PH_HEAD_LOOPS);
      // albedo output layer into the albedo hidden layer's cotangent, masked
      head_tile(ct, X, HALF, A_AH, bsum + B_ALB0, [&](int r, int c) {
        const float* hs = hgt + r * HG;
        const float h1 = bf_round(hs[1]), h2 = bf_round(hs[2]), h3 = bf_round(hs[3]);
        return h1 * bf(wm[M_ALB1 + c]) + h2 * bf(wm[M_ALB1 + HALF + c]) +
               h3 * bf(wm[M_ALB1 + 2 * HALF + c]);
      });
      // g_bott += g_ah W_alb0^T, into Y's first 256 columns
      chain_mm<EP_ADD>(rg, ct, Chain::job(4), X, G_AH, Y, 0, -1, bsum + B_BOTT, nullptr, nullptr,
                       [] {});
      // g_h7 = g_bott W_bott^T + round(g_sig w_sig), masked by h7 when the trunk follows
      chain_mm<EP_SIG>(rg, ct, Chain::job(5), Y, G_BOTT, X, 0, TRUNK ? act_h(7) : -1,
                       TRUNK ? bsum + B_T + 7 * W : nullptr, wm + M_SIG, hgt, [] {});
      C = X; O = Y;
    } else {
      DG_MARK(PH_HEAD_LOOPS);
      // g_h7 = round(g_sig w_sig), masked by h7 when the trunk follows
      head_tile(ct, bufY, W, TRUNK ? act_h(7) : -1, TRUNK ? bsum + B_T + 7 * W : nullptr,
                [&](int r, int c) { return bf_round(hgt[r * HG]) * bf(wm[M_SIG + c]); });
      C = bufY; O = bufX;
    }
    if (!TRUNK) {
      __syncthreads();
      tile_to_stream(C, 0, W, gh, W, g0, nrows, 0);
    }
    // trunk: layer 5's PE part lands in cols 256..319 of the tile that layer
    // 0's cotangent sits in, and layer 0 adds its own PE part to it in bf16
    for (int i = 7; TRUNK && i >= 1; --i) {
      chain_mm<EP_MASK>(rg, ct, Chain::job(Chain::HEADS + 7 - i), C, i * W, O, 0, act_h(i - 1),
                        bsum + B_T + (i - 1) * W, nullptr, nullptr, [&, i] {
                          if (!CAMERA && i == 7) prefetch();
                        });
      bf16* tmp = C; C = O; O = tmp;
    }
    if (TRUNK)
      chain_mm<EP_PE>(rg, ct, Chain::job(Chain::HEADS + 7), C, 0, C, W, -1, nullptr, nullptr,
                      nullptr, [] {});
    __syncthreads();
    DG_MARK(PH_PE_BWD);
    // d_xb = g_pe * pe'(xb), routed through B's transpose to d_o and d_d
    // (d_pos for points): each lane's g_pe pe'(xb) by two threads a row
    // (lanes 0..31, 32..62) into the free tile O (f32, rows DXS apart), then
    // scaled and summed per row in lane order (the one-thread-a-row
    // arithmetic, so the same bits)
    // (the lanes unrolled: each lane's coordinate and scale are constants)
    constexpr int DXS = 65;   // odd: a warp's 32 rows on 32 banks
    float* dx = reinterpret_cast<float*>(O);
    if (TRUNK) {
      const int r = tid & (MT - 1);
      if (r < nrows) {
        const int s = s0 + r;
        const long long ray = ray0 + s / KPAD;
        const float* ri = rayin + ray * (POINT ? 3 : RAYIN);
        const float zs = POINT ? 0.f : z[ray * KPAD + s % KPAD];
        auto lane = [&](int c) {
          int j;
          float sc;
          pe_lane(c, j, sc);
          const float xb =
              POINT ? __fmul_rn(ri[j], sc)
                    : ray_xb(ri, j, sc, zs);
          const float der = c < 3 ? 1.f
                          : sinf(c < 33 ? __fadd_rn(xb, HALF_PI)
                                        : __fadd_rn(__fadd_rn(xb, HALF_PI), HALF_PI));
          dx[r * DXS + c] = bf(C[r * LDA + W + c]) * der;
        };
        if (tid < MT) {
#pragma unroll
          for (int c = 0; c < 32; ++c) lane(c);
        } else {
#pragma unroll
          for (int c = 32; c < 63; ++c) lane(c);
        }
      }
      __syncthreads();
    }
    DG_MARK(PH_OTHER);
    if (tid < MT) {
      float a6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (TRUNK && tid < nrows) {
        const int s = s0 + tid;
        const float zs = POINT ? 0.f : z[(ray0 + s / KPAD) * (long long)KPAD + s % KPAD];
#pragma unroll
        for (int c = 0; c < 63; ++c) {
          int j;
          float sc;
          pe_lane(c, j, sc);
          const float dxs = dx[tid * DXS + c] * sc;
          a6[j] += dxs;
          a6[3 + j] += dxs * zs;
        }
      }
      for (int j = 0; j < 6; ++j) rowacc[tid * 10 + j] = a6[j];
      if (!CAMERA)
        for (int j = 6; j < 10; ++j) rowacc[tid * 10 + j] = 0.f;
    }
    __syncthreads();
    DG_MARK(PH_RAY_SUMS);
    for (int e = tid; !POINT && e < nray * 10; e += THREADS) {   // per-ray sums in sample order
      const int lr = e / 10, c = e % 10;
      const int lo = max(lr * KPAD, s0), hi = min((lr + 1) * KPAD, s0 + nrows);
      float a = rayacc[e];
      for (int s = lo; s < hi; ++s) a += rowacc[(s - s0) * 10 + c];
      rayacc[e] = a;
    }
    if (s0 + MT >= S) {   // the unit's last tile: its rays' d_rayin and its bias partials
      __syncthreads();
      DG_MARK(PH_OTHER);
      for (int e = tid; e < nray * 10; e += THREADS) {
        const int lr = e / 10, c = e % 10;
        const long long row = ray0 + lr;
        if (!POINT) {
          if (CAMERA || c < 6) dout[row * RAYIN + c] = rayacc[e];
        } else if (c < 3) {   // a point is its one sample: 0 + the row's value, as a ray's sum
          dout[row * 3 + c] = 0.f + rowacc[e];
        } else if (CAMERA && c >= 6) {
          demb[row * 4 + c - 6] = 0.f + rowacc[e];
        }
      }
      for (int e = tid; e < NB; e += THREADS) {
        bias_part[(long long)u * NB + e] = bsum[e];
        bsum[e] = 0.f;
      }
      __syncthreads();
      for (int e = tid; !POINT && e < rpb * 10; e += THREADS) rayacc[e] = 0.f;
    }
    u = nu;
    s0 = ns;
  }
  __syncthreads();
  DG_END(bias_part + (long long)blockIdx.x * NB);
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

// S stream rows (samples or points) in nblocks dgrad units (one row of bias
// partial sums each; dgrad_kernel's persistent blocks walk them). Without
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

// dgrad_kernel's shared memory: the two tiles, the ring, then the f32 bias
// sums, head cotangents (two tiles' worth), per-sample d_rayin, the warps'
// column sums and (rays; KPAD 1 is points) the per-ray sums
size_t dgrad_smem(int KPAD) {
  return (size_t)(2 * MT * LDA + DWST) * sizeof(bf16) +
         (size_t)(B_END + 2 + 2 * MT * HG + MT * 10 + 8 * NC +
                  (KPAD == 1 ? 0 : rays_per_block(KPAD) * 10)) * sizeof(float);
}

// dgrad_kernel's persistent grid for `units` units (blocks of whole rays,
// or 128 points): one block an SM (its shared memory fills one), at most
// one a unit. 0 on a CUDA error (its code in *err).
int dgrad_grid(int units, cudaError_t* err) {
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return *err == cudaSuccess ? std::min(units, sms) : 0;
}

long long dgrad_launch_count = 0;   // dgrad_kernel launches made (every instantiation)

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
    cudaError_t e = cudaFuncSetAttribute(dgrad_kernel<CAMERA, POINT, !HEADS_ONLY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const int grid = e == cudaSuccess ? dgrad_grid(L.nblocks, &e) : 0;
    if (e != cudaSuccess) return (int)e;
    dgrad_kernel<CAMERA, POINT, !HEADS_ONLY><<<grid, THREADS, smem, stream>>>(
        rayin, z, wm, sc.acts, sc.hg, sc.gpre, sc.bpart, dout, demb, R, KPAD,
        rays_per_block(KPAD), gh);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++dgrad_launch_count;
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
// (stream_fwd_kernel<MODE, true>) in place of the recompute.
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
  int err = launch_point<FIELD>(pos, emb, wm, wb, N, stream, gin, sc.acts, sc.hg);
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
// layer, and a group spans up to 16 of this file's 128-row tiles. Where it
// spans at most 16 (every call the port makes: group rows <= 2048), the
// trunk is one cluster launch, a cluster a group, the activations on chip
// (q8_trunk_cluster_kernel, below). Past that (KPAD > 256) it runs
// layer-major: one launch per layer over every row, each tile quantizing
// its inputs on load with its group's scale and folding the max |h| of its
// outputs into its group's amax with atomicMax on the float's bits
// (order-free, so deterministic); the running activation stays f32 in
// device memory between layers (two ping-pong buffers). On both paths the
// bf16 copy of the activations goes to the activation stream the heads and
// the backward read, and the products are exact int8 x int8 -> int32
// (layer-major: mma.sync m16n8k32), dequantized as acc * (s_w * s_act) + b
// with explicit round-to-nearest operations (no contraction into an fma),
// as the JAX function rounds: the two paths give the same bits.
//
// What bounds it on this card: the trunk's int8 products (1,979 TOP/s); the
// layer-major path also pays the f32 activation traffic, 2 KB per sample
// and layer (read, written) at 3.35 TB/s.
//
// int8_full backward (`_trunk_bwd_q8`): the cotangent chain from layer 7
// to 0 quantizes g = g_h * mask * s_w once per group and layer into the int8
// cotangent stream and forms (g8 w8^T) s_g rounded to bf16 (the next
// layer's g_h), with the bias gradient's column sums of the unquantized
// g_h * mask; then q8_wgrad_kernel forms each group's exact int32
// inp8^T g8, scales it by that group's s_in s_g / s_w and adds the groups
// in group order (the TPU's sequential grid order). Where the trunk runs
// as one cluster launch, so does the chain (q8_chain_cluster_kernel, in the
// section after the forward's cluster kernel); past that the chain runs
// layer by layer, q8_gamax_kernel (the group amax and the bias sums) then
// q8_dgrad_kernel, 16 launches.
//
// The int8 cotangent stream is K-major for the weight gradient, whose
// contraction runs over rows: for group G, layer L, feature c, the group's
// rows in order, G8R = group rows rounded up to 256 bytes apart,
//   g8t[((G * 8 + L) * 256 + c) * G8R + row in group]
// (bytes past the group's rows are never written; the weight gradient
// multiplies them by zeros).

constexpr int LDQ = CAT + 16;     // int8 tile row stride (bytes): conflict-free fragment loads
constexpr int QB = 8 * W;         // trunk biases: the per-tile bias sums' row

// the int8 cotangent stream's row run: a group's rows rounded up to the
// weight gradient's 256-row chunks
__host__ __device__ __forceinline__ long long q8_g8_rows(long long group_rows) {
  return (group_rows + 255) / 256 * 256;
}

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
// kept in the int8 cotangent stream (K-major, see above) for the wgrad,
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
      const long long grp = row / group_rows, gr8 = q8_g8_rows(group_rows);
      int8_t* g8c = g8s + ((grp * 8 + layer) * W + c) * gr8 + (row - grp * group_rows);
      for (int j = 0; j < 4; ++j) {
        const float gv =
            bf(acts[row * as + act_h(layer) + c + j]) > 0.f ? bf(gh[row * W + c + j]) : 0.f;
        const uint32_t b = q8_byte(__fmul_rn(gv, swl[c + j]), inv);
        packed |= b << (8 * j);
        g8c[j * gr8] = (int8_t)b;   // the K-major stream, a byte a feature
      }
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

// int8_full: the trunk's bias gradients as the sum of the per-tile (or per
// CTA) column sums in tile order (a fixed order: the same bits from run to
// run).
__global__ void q8_reduce_kernel(const float* __restrict__ qbpart, int ntiles,
                                 float* __restrict__ dbias) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < QB; e += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < ntiles; ++t) s += qbpart[(long long)t * QB + e];
    dbias[B_T + e] = s;
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

// ---------------------------------------------------------------------------
// the int8 trunk as one cluster launch
// ---------------------------------------------------------------------------
//
// q8_trunk_cluster_kernel replaces q8_pe_kernel and the eight
// q8_layer_kernel launches (the same `_trunk_fwd_q8`) whenever a scale group
// spans at most Q8_CLUSTER_MAX 128-row CTAs: a thread-block cluster holds one
// group, CTA `rank` its rows 128 rank .. (128, or 64 in a group's last CTA),
// and the activations never leave the chip. Per CTA: the PE of its rows,
// then the eight layers, each an int8 tensor-core product whose weights
// stream through a cp.async ring (the trunk's chunks in one schedule, so
// the next layer's first chunks are in flight during this layer's epilogue
// and exchange), `wgmma.mma_async m64n128k32 .s32.s8.s8` for each of four
// warpgroups' 64 rows x 128 output columns (A, the int8 activations, by
// ldmatrix from the CTA's tile into registers, as gemm's A; B, the K-major
// weight chunk, from the ring through a descriptor), and an epilogue in
// registers: dequantize, bias, ReLU, the row maxima. The f32 activation
// then waits in the accumulator registers while the CTAs of the cluster
// exchange their maxima through distributed shared memory (each writes its
// max into slot `rank` of every CTA's slots, one cluster barrier, its bf16
// rows going to the stream meanwhile by bulk copies from a staging tile):
// every CTA reads the same group amax, quantizes its registers into its
// int8 tile for the next layer, and rank 0 writes the amax to `amax`. A
// max is order-free, so this computes the layer-major kernels' bits: the
// same int32 products (exact), the same dequantization and roundings, the
// same group maxima.
//
// Bound on an H100 SXM: the trunk's int8 operations (491,520 multiply-adds a
// sample at 1,979 TOP/s) against the bytes of rayin, z and the stream
// written; the 2 KB a sample and layer of f32 activations that the
// layer-major path moves through device memory are gone. One CTA an SM (512
// threads, 64 accumulator registers each); a cluster's CTAs must be
// resident together, so how many clusters fit the card
// (cudaOccupancyMaxActiveClusters, eonerf_q8_trunk_active_clusters) sets how
// many SMs work. No one cost dominates a CTA's time: taking out the
// products, the weight copies, the exchange or the quantization each saves
// 5-10 % of it (bench/q8_trunk.py attribution; PERF.md).

constexpr int Q8_CLUSTER_MAX = 16;   // CTAs a cluster: the H100's non-portable limit
constexpr int Q8_LAYER_MAJOR = 0, Q8_CLUSTER = 1;   // the trunk's two paths
constexpr int Q8_THREADS = 512;   // four warpgroups, each 64 rows x 128 output columns
constexpr int QKC = 64;      // int8 depth (bytes) of a staged weight chunk: a 64-byte swizzle atom
constexpr int QSTAGES = 4;   // chunks in the ring
constexpr int QSTAGE_BYTES = W * QKC;      // all 256 output rows
constexpr int QRING_BYTES = QSTAGES * QSTAGE_BYTES;
constexpr int NKH = W / QKC;               // chunks of a 256-deep layer
// The trunk's chunks: layer 0's 64-deep PE, four 256-deep layers, layer 5
// (256 of h4, then 64 of PE), two more 256-deep layers.
constexpr int Q8_CHUNKS = 2 + 7 * NKH;
constexpr int LDH = W + 16;    // int8 activation tile row stride (bytes): conflict-free ldmatrix
constexpr int LDP = PE + 16;   // int8 PE tile row stride
constexpr int LDS = 2 * W + 16;   // bf16 staging row stride (bytes): conflict-free pair stores
static_assert(QKC == PE && QSTAGES >= 2, "a chunk is one 64-byte swizzle atom, the PE's depth");
static_assert(QSTAGE_BYTES % 1024 == 0, "every chunk starts on a swizzle atom");

// Shared memory: the ring, the int8 tiles, the bf16 staging tile of the
// stream's rows, the per-column epilogue constants (s_w s of the layer's
// input, b, and layer 5's s_w s_PE), the CTAs' maxima (a slot per
// quantization point and rank) and the warps'.
constexpr size_t Q8_CLUSTER_SMEM = QRING_BYTES + (size_t)MT * (LDH + LDP + LDS) +
                                   3 * W * sizeof(float) +
                                   (Q8P * Q8_CLUSTER_MAX + Q8_THREADS / 32) * sizeof(unsigned);
static_assert(Q8_CLUSTER_SMEM <= 232448, "fits an H100 block's shared memory");

size_t q8_cluster_smem() { return Q8_CLUSTER_SMEM; }

// int32 <-> float by the 1.5 * 2^23 bias, exact for |x| < 2^22 (every
// accumulator: |a| <= 127 * 127 * 256; every quantized value): the
// accumulators start at Q8_BIAS_BITS, so float(acc) = bits - Q8_BIAS, and
// round(y) half to even is the low byte of the bits of y + Q8_BIAS (the
// sum's ulp is 1). Full-rate adds in place of the conversion instructions.
constexpr float Q8_BIAS = 12582912.f;
constexpr int Q8_BIAS_BITS = 0x4B400000;

__device__ __forceinline__ float q8_acc(int acc) { return __fsub_rn(__int_as_float(acc), Q8_BIAS); }

// q8_byte's byte (in the low 8 bits; the rest is not zero)
__device__ __forceinline__ uint32_t q8_rbits(float v, float inv) {
  return __float_as_uint(__fadd_rn(__fmul_rn(v, inv), Q8_BIAS));
}

// cp.async.bulk: `bytes` (a multiple of 16) of shared memory to global,
// asynchronous, in the issuing thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// chunk q of the trunk's schedule: its layer and its slice kc (layer 5's
// slice NKH is its PE part)
__device__ __forceinline__ void q8_chunk(int q, int& layer, int& kc) {
  if (q == 0) { layer = 0; kc = 0; }
  else if (q < 1 + 4 * NKH) { layer = 1 + (q - 1) / NKH; kc = (q - 1) % NKH; }
  else if (q < 2 + 5 * NKH) { layer = 5; kc = q - (1 + 4 * NKH); }
  else { layer = 6 + (q - 2 - 5 * NKH) / NKH; kc = (q - 2 - 5 * NKH) % NKH; }
}

// byte offset in a ring stage of output row n's 16-byte unit u: rows of 64
// bytes, the units swizzled as wgmma's K-major layout (64-byte swizzle)
__device__ __forceinline__ uint32_t qunit(int n, int u) {
  return n * QKC + ((u ^ ((n >> 1) & 3)) << 4);
}

// B's descriptor at a stage's byte address `addr` (plus a row offset, and
// 32 a k step): K-major, 8-row groups one swizzle atom apart
__device__ __forceinline__ uint64_t qdesc(uint32_t addr) { return gmma_desc(addr, 16, 512, 2); }

__device__ __forceinline__ void wgmma_s8_m64n32(int (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int N>
__device__ __forceinline__ void fence_iregs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The A fragments of a warp's 16 rows for one 32-deep k step of an int8 tile
// (row stride LD bytes) at byte column col: ldmatrix's 8x8 b16 matrices are
// the 8x16 int8 blocks of mma m16n8k32's (and wgmma k32's) A layout.
template <int LD>
__device__ __forceinline__ void load_a8(uint32_t (&a)[4], const int8_t* tile, int row0, int col) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_addr(tile + (row0 + (lane & 15)) * LD + col + (lane >> 4) * 16));
}

// The group amax of one quantization point, in two halves so that work
// can run between them: cluster_max_post folds the CTA's max (float bits of
// values >= 0) into slot `rank` of every CTA of the cluster and arrives at
// the cluster barrier (release); cluster_max_get waits on it (acquire) and
// returns the max of the slots, the same in every CTA.
__device__ __forceinline__ void cluster_max_post(unsigned m, unsigned* wmax, unsigned* slots,
                                                 cg::cluster_group& cl, unsigned rank,
                                                 unsigned C) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  if (tid < (int)C) {
    unsigned cm = 0u;
#pragma unroll
    for (int w = 0; w < Q8_THREADS / 32; ++w) cm = max(cm, wmax[w]);
    cl.map_shared_rank(slots, tid)[rank] = cm;
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float cluster_max_get(const unsigned* slots, unsigned C) {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  unsigned gm = 0u;
  for (unsigned r = 0; r < C; ++r) gm = max(gm, slots[r]);
  return __uint_as_float(gm);
}

__global__ void __launch_bounds__(Q8_THREADS, 1)
q8_trunk_cluster_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                        bf16* __restrict__ acts, long long as, int write_all,
                        const int8_t* __restrict__ w8, const float* __restrict__ sw,
                        const float* __restrict__ wb, float* __restrict__ amax, int KPAD,
                        long long group_rows) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  int8_t* h8 = reinterpret_cast<int8_t*>(smem + QRING_BYTES);   // MT x LDH: the next layer's input
  int8_t* pe8 = h8 + MT * LDH;                                   // MT x LDP: the quantized PE
  unsigned char* stg = reinterpret_cast<unsigned char*>(pe8 + MT * LDP);   // MT x LDS bf16 rows
  float* ssh = reinterpret_cast<float*>(stg + MT * LDS);        // a column's s_w s_in
  float* bias = ssh + W;                                         // its b
  float* ssp = bias + W;                                         // layer 5's s_w s_PE
  unsigned* slots = reinterpret_cast<unsigned*>(ssp + W);       // Q8P x 16: the CTAs' maxima
  unsigned* wmax = slots + Q8P * Q8_CLUSTER_MAX;                  // a warp's max
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  const long long grp = blockIdx.x / C;
  const long long row0 = grp * group_rows + (long long)rank * MT;
  const int nrows = (int)min((long long)MT, group_rows - (long long)rank * MT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // warpgroup wg: rows 64 (wg & 1) .., output columns c0 ..
  const int wg = warp >> 2, c0 = (wg >> 1) * (W / 2);
  const int wrow = (wg & 1) * 64 + (warp & 3) * 16;   // the warp's first tile row
  const bool active = (wg & 1) * 64 < nrows;        // a 64-row CTA: the second row half idles
  float* gamax = amax + grp * Q8P;

  auto stage = [&](int s, int q) {
    int layer, kc;
    q8_chunk(q, layer, kc);
    const int k_dim = layer == 0 ? PE : (layer == 5 ? CAT : W);
    const int8_t* src = w8 + trunk_offset(layer) + kc * QKC;
    const uint32_t dst = ring + s * QSTAGE_BYTES;
#pragma unroll
    for (int i = 0; i < W * QKC / 16 / Q8_THREADS; ++i) {
      const int v = tid + i * Q8_THREADS, n = v / (QKC / 16), u = v % (QKC / 16);
      cp_async16(dst + qunit(n, u), src + (long long)n * k_dim + u * 16);
    }
  };
  // every CTA of the cluster must be running before any writes into its
  // shared memory: arrive now, wait before the first exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  ring_prologue<QSTAGES>(Q8_CHUNKS, stage);   // the first weights fly while the PE is computed

  // the PE: lane c of rows r = tid / 64 + 8 i, rounded to bf16 into the stream
  constexpr int PER = MT * PE / Q8_THREADS;   // PE values a thread
  float pe[PER];
  unsigned m = 0u;
  {
    const int c = tid & 63;
    int j = 0;
    float sc = 0.f;
    if (c < 63) pe_lane(c, j, sc);
    // a group is whole rays: its rays from grp * rays-a-group, 32-bit offsets
    // within. Every load first (rows past the CTA's read its last row), so
    // they are in flight together.
    const float* ri0 = rayin + grp * (group_rows / KPAD) * RAYIN;
    float zs[PER], os[PER], ds[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = min((tid >> 6) + (Q8_THREADS / PE) * i, nrows - 1);
      const float* ri = ri0 + ((int)rank * MT + r) / KPAD * RAYIN;
      zs[i] = z[row0 + r];
      os[i] = ri[j];
      ds[i] = ri[3 + j];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int r = (tid >> 6) + (Q8_THREADS / PE) * i;
      pe[i] = 0.f;
      if (r < nrows) {
        const long long row = row0 + r;
        float v = 0.f;
        if (c < 63)   // ray_xb's arithmetic on the loaded o, d and z
          v = pe_value(c, __fadd_rn(__fmul_rn(os[i], sc), __fmul_rn(__fmul_rn(ds[i], sc), zs[i])));
        const bf16 pv = __float2bfloat16_rn(v);
        acts[row * as + A_PE + c] = pv;
        pe[i] = bf(pv);
        m = max(m, __float_as_uint(fabsf(pe[i])));
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cluster_max_post(m, wmax, slots, cl, rank, C);
  const float gm0 = cluster_max_get(slots, C);
  if (rank == 0 && tid == 0) gamax[0] = gm0;
  const float inv_p = q8_inv(gm0), s_p = __fdiv_rn(1.f, inv_p);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    pe8[((tid >> 6) + (Q8_THREADS / PE) * i) * LDP + (tid & 63)] =
        (int8_t)q8_rbits(pe[i], inv_p);

  // the warp's 16 rows x 128 columns: acc[4 j + i] is row g + 8 (i / 2),
  // column c0 + 8 j + 2 t + i % 2
  int acc[W / 4];
  float s_in = s_p;   // the scale of the current layer's input
  int q = 0;
  for (int layer = 0; layer < 8; ++layer) {
    // the layer's per-column constants (read after the ring's next barrier;
    // the previous layer's readers are past the exchange)
    if (tid < W) {
      ssh[tid] = __fmul_rn(__ldg(sw + layer * W + tid), s_in);
      bias[tid] = __ldg(wb + B_T + layer * W + tid);
      if (layer == 5) ssp[tid] = __fmul_rn(__ldg(sw + layer * W + tid), s_p);
    }
    const int nk = layer == 0 ? 1 : (layer == 5 ? NKH + 1 : NKH);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) acc[i] = Q8_BIAS_BITS;
    for (int kc = 0; kc < nk; ++kc) {
      const uint32_t st = ring_next<QSTAGES, QSTAGE_BYTES>(q++, Q8_CHUNKS, ring, stage);
      if (!active) continue;
      uint32_t a[QKC / 32][4];
      if (layer == 5 && kc == NKH) {
        // the skip layer's PE part at the PE's own scale: four 32-column
        // products, each added at once to its columns of the f32 h4 part
        // (acc, dequantized in place): pre = (A + B) + b
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const float2 ss = *reinterpret_cast<const float2*>(ssh + c0 + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[4 * j + i] =
                __float_as_int(__fmul_rn(q8_acc(acc[4 * j + i]), i & 1 ? ss.y : ss.x));
        }
        load_a8<LDP>(a[0], pe8, wrow, 0);
        load_a8<LDP>(a[1], pe8, wrow, 32);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          int accp[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) accp[i] = Q8_BIAS_BITS;
          fence_iregs(accp);
          wgmma_fence();
          wgmma_s8_m64n32(accp, a[0], qdesc(st + (c0 + 32 * qq) * QKC));
          wgmma_s8_m64n32(accp, a[1], qdesc(st + (c0 + 32 * qq) * QKC + 32));
          wgmma_commit();
          wgmma_wait<0>();
          fence_iregs(accp);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = c0 + 32 * qq + 8 * jj + 2 * t;
            const float2 ss = *reinterpret_cast<const float2*>(ssp + col);
            const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int e = 4 * (4 * qq + jj) + i;
              const float pre = __fadd_rn(__fadd_rn(__int_as_float(acc[e]),
                                                    __fmul_rn(q8_acc(accp[4 * jj + i]),
                                                              i & 1 ? ss.y : ss.x)),
                                          i & 1 ? bb.y : bb.x);
              acc[e] = __float_as_int(fmaxf(pre, 0.f));
            }
          }
        }
        continue;
      }
      // layer 0 reads the PE (one chunk deep), the others the activation tile
#pragma unroll
      for (int s = 0; s < QKC / 32; ++s) {
        if (layer == 0) load_a8<LDP>(a[s], pe8, wrow, 32 * s);
        else load_a8<LDH>(a[s], h8, wrow, kc * QKC + 32 * s);
      }
      fence_iregs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < QKC / 32; ++s)
        wgmma_s8_m64n128(acc, a[s], qdesc(st + c0 * QKC + 32 * s));
      wgmma_commit();
      wgmma_wait<0>();   // the next barrier hands this stage to a copy
      fence_iregs(acc);
    }
    // the epilogue: pre = acc (s_w s) + b, ReLU (layer 5: done above), the
    // maxima
    m = 0u;
    if (active) {
      if (layer != 5) {
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const float2 ss = *reinterpret_cast<const float2*>(ssh + c0 + 8 * j + 2 * t);
          const float2 bb = *reinterpret_cast<const float2*>(bias + c0 + 8 * j + 2 * t);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pre = __fadd_rn(__fmul_rn(q8_acc(acc[4 * j + i]), i & 1 ? ss.y : ss.x),
                                        i & 1 ? bb.y : bb.x);
            acc[4 * j + i] = __float_as_int(fmaxf(pre, 0.f));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < W / 4; ++i) m = max(m, __float_as_uint(fabsf(__int_as_float(acc[i]))));
    }
    // the group amax of this layer's output, the next layer's input scale:
    // posted, then the stream's rows while the other CTAs post theirs
    unsigned* pslots = slots + (layer + 1) * Q8_CLUSTER_MAX;
    if (layer < 7) cluster_max_post(m, wmax, pslots, cl, rank, C);
    if (write_all || layer == 7) {
      // the bf16 rows to the stream: into the staging tile (its previous
      // rows' copies have read it), then one bulk copy a row
      if (tid < nrows) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncthreads();
      if (active) {
        unsigned char* s0 = stg + (wrow + g) * LDS + 2 * (c0 + 2 * t);
#pragma unroll
        for (int j = 0; j < W / 16; ++j) {
          const __nv_bfloat162 v01 = __floats2bfloat162_rn(__int_as_float(acc[4 * j]),
                                                           __int_as_float(acc[4 * j + 1]));
          const __nv_bfloat162 v23 = __floats2bfloat162_rn(__int_as_float(acc[4 * j + 2]),
                                                           __int_as_float(acc[4 * j + 3]));
          *reinterpret_cast<__nv_bfloat162*>(s0 + 16 * j) = v01;
          *reinterpret_cast<__nv_bfloat162*>(s0 + 8 * LDS + 16 * j) = v23;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to the copies
      __syncthreads();
      if (tid < nrows)
        bulk_store(acts + (row0 + tid) * as + act_h(layer), smem_addr(stg + tid * LDS), 2 * W);
    }
    if (layer == 7) break;
    const float gm = cluster_max_get(pslots, C);
    if (rank == 0 && tid == 0) gamax[layer + 1] = gm;
    const float inv = q8_inv(gm);
    s_in = __fdiv_rn(1.f, inv);
    if (active) {
      int8_t* q0 = h8 + (wrow + g) * LDH + c0 + 2 * t;
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        *reinterpret_cast<uint16_t*>(q0 + 8 * j) = (uint16_t)__byte_perm(
            q8_rbits(__int_as_float(acc[4 * j]), inv),
            q8_rbits(__int_as_float(acc[4 * j + 1]), inv), 0x40);
        *reinterpret_cast<uint16_t*>(q0 + 8 * LDH + 8 * j) = (uint16_t)__byte_perm(
            q8_rbits(__int_as_float(acc[4 * j + 2]), inv),
            q8_rbits(__int_as_float(acc[4 * j + 3]), inv), 0x40);
      }
    }
  }
  // the stream's last copies are done before the CTA's shared memory goes
  if (tid < nrows) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

bool q8_shape_ok(int R, int KPAD, long long group_rows) {
  return R > 0 && KPAD > 0 && KPAD % 8 == 0 && KPAD <= MAX_KPAD && group_rows > 0 &&
         group_rows % KPAD == 0 && ((long long)R * KPAD) % group_rows == 0;
}

// The trunk's path, from the shape alone: one cluster launch when a scale
// group is whole 64-row warpgroup slabs over at most Q8_CLUSTER_MAX CTAs of
// 128 rows, else the layer-major kernels. `forced` (Q8_LAYER_MAJOR or
// Q8_CLUSTER, for tests and measurements) overrides it; -1 keeps it.
int q8_path(long long group_rows, int forced) {
  if (forced == Q8_LAYER_MAJOR || forced == Q8_CLUSTER) return forced;
  return group_rows % 64 == 0 && group_rows <= (long long)Q8_CLUSTER_MAX * MT ? Q8_CLUSTER
                                                                               : Q8_LAYER_MAJOR;
}

int q8_cluster_size(long long group_rows) { return (int)((group_rows + MT - 1) / MT); }

// f32 scratch of the layer-major path (two ping-pong activations); the
// cluster path keeps them on chip
size_t q8_hf_bytes(int path, long long rows) {
  return path == Q8_CLUSTER ? 0 : align256((size_t)2 * rows * W * sizeof(float));
}

cudaError_t q8_cluster_attributes() {
  cudaError_t e = cudaFuncSetAttribute(q8_trunk_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)q8_cluster_smem());
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(q8_trunk_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

cudaLaunchConfig_t q8_cluster_config(long long groups, int C, cudaStream_t stream,
                                     cudaLaunchAttribute* attr, size_t smem = q8_cluster_smem()) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * C));
  cfg.blockDim = dim3(Q8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches of the int8 trunk's kernels that q8_trunk has made, by kernel:
// q8_trunk_cluster_kernel, q8_pe_kernel, q8_layer_kernel (read by
// eonerf_q8_trunk_launches).
long long q8_trunk_launch_counts[3];

// The int8 trunk over `rows` rows (R rays x KPAD) on `path`: one cluster
// launch (q8_trunk_cluster_kernel, a cluster a scale group), or the
// layer-major kernels (the PE, then the eight layers, f32 activations
// ping-ponging through hf, 2 x rows x 256). There is no retry on the other
// path: a refused launch returns its error.
int q8_trunk(int path, const float* rayin, const float* z, bf16* acts, long long as,
             bool write_all, const int8_t* w8, const float* sw, const float* wb, float* hf,
             float* amax, long long rows, int KPAD, long long group_rows, cudaStream_t stream) {
  if (path == Q8_CLUSTER) {
    if (group_rows % 64 != 0) return (int)cudaErrorInvalidValue;
    const int C = q8_cluster_size(group_rows);
    if (C > Q8_CLUSTER_MAX) return (int)cudaErrorInvalidClusterSize;
    cudaError_t e = q8_cluster_attributes();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = q8_cluster_config(rows / group_rows, C, stream, attr);
    e = cudaLaunchKernelEx(&cfg, q8_trunk_cluster_kernel, rayin, z, acts, as, write_all ? 1 : 0,
                           w8, sw, wb, amax, KPAD, group_rows);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e == cudaSuccess) ++q8_trunk_launch_counts[0];
    return (int)e;
  }
  const int tiles = (int)((rows + MT - 1) / MT);
  q8_pe_kernel<<<tiles, THREADS, 0, stream>>>(rayin, z, acts, as, amax, rows, KPAD, group_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++q8_trunk_launch_counts[1];
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
    ++q8_trunk_launch_counts[2];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// int8_full's trunk backward: the cotangent chain as one cluster launch, and
// the weight gradient on an int8 wgmma ring
// ---------------------------------------------------------------------------
//
// q8_chain_cluster_kernel replaces the chain's 16 launches (q8_gamax_kernel
// then q8_dgrad_kernel, a layer each) wherever the trunk itself is one
// cluster launch (q8_path): a cluster a scale group, CTA `rank` its rows
// 128 rank .., the forward's geometry. A CTA walks layers 7 to 0 in one
// launch, and the cotangent g_h never leaves the chip: it waits in the
// products' accumulator registers (a warpgroup's 64 rows x 128 columns)
// from one layer to the next. A layer:
//   1. g = g_h where the layer's activation (staged, see 4) is > 0; the
//      bias gradient's column sums of g from the registers (a fixed tree:
//      the warp's rows by halving exchanges, then the CTA's warps of a
//      column in order) into the CTA's row of bias partial sums; the max of
//      |g s_w|;
//   2. the group amax across the cluster through distributed shared memory
//      (cluster_max_post / cluster_max_get, a slot array per layer, one
//      cluster barrier);
//   3. g8 = round(g s_w / s_g) into the CTA's int8 tile, once;
//   4. (g8 w8^T) s_g: wgmma m64n128k32 .s32.s8.s8 (and m64n32k32 for the PE
//      columns of layers 5 and 0), A (g8, K = the layer's 256 outputs,
//      contiguous) by ldmatrix from the tile, B (w8^T's rows, K contiguous
//      as they lie) from a 4-stage cp.async ring of 64-deep chunks (the
//      chain's 32 chunks in one schedule, so a layer's first weights fly
//      during the previous layer's exchange and quantization). Under the
//      products the tile goes to the int8 cotangent stream K-major (a
//      16-byte store a feature's 16 rows, from the tile transposed in shared
//      memory as it was quantized). The next layer's activation (its mask)
//      is staged by cp.async with an L2 evict-first hint (the stream passes
//      through once; read normally it evicts the weights every CTA
//      re-reads) as soon as 2.'s barrier has ended this layer's mask reads,
//      so that it flies under the exchange, the quantization and the
//      products (the masks are the chain's largest single cost, by
//      bench/q8_backward.py attribution);
//   5. the epilogue rounds acc s_g to bf16 in the registers: the next
//      layer's g_h (layer 5's PE columns wait as bf16 pairs until layer 0
//      adds its own to them, the layer-major order, into gpe).
// The quantities, roundings and maxima are the layer-major kernels', so the
// outputs are their bits, except the bias sums (another fixed order).
//
// Bound on an H100 SXM: bytes. A row reads g_h7 (512 B) and 8 layers'
// activations as masks (4 KB) and writes 2 KB of g8 and 128 B of gpe; the
// int8 products (0.49 M multiply-adds a row at 1,979 TOP/s) take about a
// quarter of that time.

constexpr int QC_STAGES = 4;                  // 64-deep chunks of w8^T in the chain's ring
constexpr int QC_STAGE_BYTES = CAT * QKC;     // a chunk: up to 320 input rows x 64 bytes
constexpr int QC_CHUNKS = 8 * NKH;            // layers 7..0, NKH chunks each
constexpr int LDM = 2 * W + 16;               // staged activation row stride (bytes)
constexpr int LDT = MT + 16;                  // transposed g8 tile row stride (bytes)
static_assert(QC_STAGES >= 2 && QC_STAGES <= NKH,
              "the next layer's mask is waited for with a chunk of the same layer");
static_assert(QC_STAGE_BYTES % 1024 == 0, "every chunk starts on a swizzle atom");

// Shared memory: the ring, the int8 tile, the staged activations, the int8
// tile transposed (a feature's rows, for the stream), the warps' column
// sums, the layer's s_w, the CTAs' maxima (a slot array a layer) and the
// warps'.
constexpr size_t Q8_CHAIN_SMEM = (size_t)QC_STAGES * QC_STAGE_BYTES + (size_t)MT * (LDH + LDM) +
                                 (size_t)W * LDT +
                                 (size_t)(Q8_THREADS / 32) * NC * sizeof(float) +
                                 W * sizeof(float) +
                                 (Q8P * Q8_CLUSTER_MAX + Q8_THREADS / 32) * sizeof(unsigned);
static_assert(Q8_CHAIN_SMEM <= 232448, "fits an H100 block's shared memory");

// Landmarks of the chain's and the weight gradient's phases (QC_*, QW_*):
// empty here; bench/q8_backward.py builds a copy that defines them (the
// phase orders of its CHAIN_PHASES and WGRAD_PHASES).
#ifndef QC_MARK
#define QC_MARK(next)
#define QC_BEGIN()
#define QC_END(dst)
#define QW_MARK(next)
#define QW_BEGIN()
#define QW_END(dst)
#endif

// The column sums of 64 columns over the warp's 16 rows: x[k] is this
// thread's two rows' sum of column 8 j + 2 t + e, k = 2 j + e; three
// halving exchanges over the eight lanes of a column group (lane bits 4,
// 3, 2) leave lane g the sums of columns 8 g + 2 t + e, into dst. A fixed
// tree: deterministic.
__device__ __forceinline__ void warp_colsums64(const float (&x)[16], float* dst) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float y[8], z[4], w[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    y[k] = (b4 ? x[k + 8] : x[k]) + __shfl_xor_sync(0xffffffffu, b4 ? x[k] : x[k + 8], 16);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    z[k] = (b3 ? y[k + 4] : y[k]) + __shfl_xor_sync(0xffffffffu, b3 ? y[k] : y[k + 4], 8);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    w[k] = (b2 ? z[k + 2] : z[k]) + __shfl_xor_sync(0xffffffffu, b2 ? z[k] : z[k + 2], 4);
  *reinterpret_cast<float2*>(dst + 8 * g + 2 * t) = make_float2(w[0], w[1]);
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 bits_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

__global__ void __launch_bounds__(Q8_THREADS, 1)
q8_chain_cluster_kernel(const bf16* __restrict__ gh7, bf16* __restrict__ gpe,
                        const bf16* __restrict__ acts, long long as,
                        const int8_t* __restrict__ w8t, const float* __restrict__ sw,
                        float* __restrict__ gamax, int8_t* __restrict__ g8t,
                        float* __restrict__ qbpart, long long group_rows) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  int8_t* g8 = reinterpret_cast<int8_t*>(smem + QC_STAGES * QC_STAGE_BYTES);   // MT x LDH
  unsigned char* mk = reinterpret_cast<unsigned char*>(g8 + MT * LDH);         // MT x LDM bf16 rows
  int8_t* g8tr = reinterpret_cast<int8_t*>(mk + MT * LDM);                     // W x LDT: g8 transposed
  float* colpart = reinterpret_cast<float*>(g8tr + W * LDT);  // a warp's column sums (16 x 128)
  float* ssw = colpart + (Q8_THREADS / 32) * NC;               // the layer's s_w
  unsigned* slots = reinterpret_cast<unsigned*>(ssw + W);      // Q8P x 16: the CTAs' maxima
  unsigned* wmax = slots + Q8P * Q8_CLUSTER_MAX;               // a warp's max
  cg::cluster_group cl = cg::this_cluster();
  const unsigned C = cl.num_blocks(), rank = cl.block_rank();
  const long long grp = blockIdx.x / C;
  const long long row0 = grp * group_rows + (long long)rank * MT;
  const int nrows = (int)min((long long)MT, group_rows - (long long)rank * MT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  // warpgroup wg: rows 64 (wg & 1) .., columns c0 .. (column half ch)
  const int wg = warp >> 2, ch = wg >> 1, c0 = ch * (W / 2);
  const int wrow = (wg & 1) * 64 + (warp & 3) * 16;   // the warp's first tile row
  const bool active = (wg & 1) * 64 < nrows;        // a 64-row CTA: the second row half idles
  const long long gr8 = q8_g8_rows(group_rows);
  int8_t* g8c = g8t + grp * 8 * W * gr8 + (long long)rank * MT;   // the CTA's rows of the run
  float* bsum = qbpart + (grp * C + rank) * QB;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  QC_BEGIN();

  // layer `layer`'s activation rows into the staging tile (rows past nrows
  // zero-filled: a zero mask)
  auto stage_mask = [&](int layer) {
#pragma unroll
    for (int i = 0; i < MT * (2 * W / 16) / Q8_THREADS; ++i) {
      const int v = tid + i * Q8_THREADS, r = v >> 5, u = v & 31;
      const bool in = r < nrows;
      asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                   ::"r"(smem_addr(mk + r * LDM + u * 16)),
                   "l"(acts + (row0 + (in ? r : 0)) * as + act_h(layer) + u * 8),
                   "r"(in ? 16 : 0), "l"(policy)
                   : "memory");
    }
  };
  // chunk q: layer 7 - q / NKH, its w8^T rows (n_dim inputs) at output depth
  // 64 (q % NKH) ..
  auto stage = [&](int s, int q) {
    const int layer = 7 - q / NKH, kc = q % NKH;
    const int n_dim = layer == 0 ? PE : (layer == 5 ? CAT : W);
    const int8_t* src = w8t + trunk_offset(layer) + kc * QKC;
    const uint32_t dst = ring + s * QC_STAGE_BYTES;
    for (int v = tid; v < n_dim * (QKC / 16); v += Q8_THREADS) {
      const int n = v >> 2, u = v & 3;
      cp_async16(dst + qunit(n, u), src + (long long)n * W + u * 16);
    }
  };
  // every CTA of the cluster must be running before any writes into its
  // shared memory: arrive now, wait before the first exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid < W) ssw[tid] = __ldg(sw + 7 * W + tid);
  stage_mask(7);
  cp_async_commit();
  ring_prologue<QC_STAGES>(QC_CHUNKS, stage);

  // g_h7, the heads' cotangent at the trunk's output: acc[4 j + i] is row
  // wrow + g + 8 (i / 2), column c0 + 8 j + 2 t + i % 2 (f32 bits), the
  // accumulator layout the products leave
  int acc[W / 4];
  if (active) {
#pragma unroll
    for (int j = 0; j < W / 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            gh7 + (row0 + wrow + g + 8 * hh) * W + c0 + 8 * j + 2 * t));
        acc[4 * j + 2 * hh] = __float_as_int(v.x);
        acc[4 * j + 2 * hh + 1] = __float_as_int(v.y);
      }
  }
  int accp[16];      // the PE columns' products: 32 columns, 32 ch ..
  uint32_t pek[8];   // layer 5's PE cotangent, bf16 pairs: rows g + 8 hh, columns 8 jj + 2 t
  cp_async_wait<QC_STAGES - 1>();   // h7's rows have landed
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  int q = 0;
  for (int layer = 7; layer >= 0; --layer) {
    QC_MARK(1);
    // 1. the mask, the column sums, the max
    unsigned m = 0u;
    if (active) {
      const unsigned char* mrow = mk + (wrow + g) * LDM + 2 * (c0 + 2 * t);
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(ssw + c0 + 8 * j + 2 * t);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v0 = __int_as_float(acc[4 * j + 2 * hh]);
          float v1 = __int_as_float(acc[4 * j + 2 * hh + 1]);
          apply_mask(v0, v1,
                     *reinterpret_cast<const __nv_bfloat162*>(mrow + 8 * hh * LDM + 16 * j));
          acc[4 * j + 2 * hh] = __float_as_int(v0);
          acc[4 * j + 2 * hh + 1] = __float_as_int(v1);
          m = max(m, max(__float_as_uint(fabsf(__fmul_rn(v0, s.x))),
                         __float_as_uint(fabsf(__fmul_rn(v1, s.y)))));
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float x[16];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            x[2 * jj + e] = __int_as_float(acc[4 * (8 * hf + jj) + e]) +
                            __int_as_float(acc[4 * (8 * hf + jj) + 2 + e]);
        warp_colsums64(x, colpart + warp * NC + 64 * hf);
      }
    }
    QC_MARK(2);
    // 2. the group amax: posted, the CTA's column sums folded meanwhile (a
    // column's eight warps in order; a 64-row CTA's first four)
    unsigned* lslots = slots + layer * Q8_CLUSTER_MAX;
    cluster_max_post(m, wmax, lslots, cl, rank, C);
    // past the post's barrier every thread has read this layer's mask: the
    // next layer's is staged now, in flight under the exchange, the
    // quantization and the products, in the ring's copy group of this
    // layer's last chunk (whose wait it shares)
    if (layer > 0) stage_mask(layer - 1);
    if (tid < W) {
      const float* p = colpart + 8 * (tid >> 7) * NC + (tid & (NC - 1));
      float s = p[0];
      for (int w = 1; w < (nrows > 64 ? 8 : 4); ++w) s += p[w * NC];
      bsum[layer * W + tid] = s;
    }
    const float gm = cluster_max_get(lslots, C);
    if (rank == 0 && tid == 0) gamax[grp * Q8P + layer] = gm;
    const float inv = q8_inv(gm), s_g = __fdiv_rn(1.f, inv);
    QC_MARK(3);
    // 3. g8 into the tile, and transposed (a byte a store: a warp's lanes
    // write four bytes of eight words, no two in one bank) into g8tr
    if (active) {
      int8_t* q0 = g8 + (wrow + g) * LDH + c0 + 2 * t;
      int8_t* t0 = g8tr + (c0 + 2 * t) * LDT + wrow + g;
#pragma unroll
      for (int j = 0; j < W / 16; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(ssw + c0 + 8 * j + 2 * t);
        const uint32_t b0 = q8_rbits(__fmul_rn(__int_as_float(acc[4 * j]), s.x), inv);
        const uint32_t b1 = q8_rbits(__fmul_rn(__int_as_float(acc[4 * j + 1]), s.y), inv);
        const uint32_t b2 = q8_rbits(__fmul_rn(__int_as_float(acc[4 * j + 2]), s.x), inv);
        const uint32_t b3 = q8_rbits(__fmul_rn(__int_as_float(acc[4 * j + 3]), s.y), inv);
        *reinterpret_cast<uint16_t*>(q0 + 8 * j) = (uint16_t)__byte_perm(b0, b1, 0x40);
        *reinterpret_cast<uint16_t*>(q0 + 8 * LDH + 8 * j) = (uint16_t)__byte_perm(b2, b3, 0x40);
        int8_t* tj = t0 + 8 * j * LDT;
        tj[0] = (int8_t)b0;
        tj[LDT] = (int8_t)b1;
        tj[8] = (int8_t)b2;
        tj[LDT + 8] = (int8_t)b3;
      }
    }
    // 4. the products (H: the 256 h columns; P: the 64 PE ones), the tile
    // to the stream and the next mask under them
    auto products = [&](auto h_part, auto p_part) {
      constexpr bool H = decltype(h_part)::value, P = decltype(p_part)::value;
      if constexpr (H) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i) acc[i] = Q8_BIAS_BITS;
      }
      if constexpr (P) {
#pragma unroll
        for (int i = 0; i < 16; ++i) accp[i] = Q8_BIAS_BITS;
      }
      for (int kc = 0; kc < NKH; ++kc) {
        QC_MARK(4);
        const uint32_t st = ring_next<QC_STAGES, QC_STAGE_BYTES>(q++, QC_CHUNKS, ring, stage);
        QC_MARK(5);
        // the next layer's s_w (this layer's readers are past the barrier)
        if (kc == 0 && layer > 0 && tid < W) ssw[tid] = __ldg(sw + (layer - 1) * W + tid);
        if (active) {
          uint32_t a[2][4];
          load_a8<LDH>(a[0], g8, wrow, kc * QKC);
          load_a8<LDH>(a[1], g8, wrow, kc * QKC + 32);
          if constexpr (H) fence_iregs(acc);
          if constexpr (P) fence_iregs(accp);
          wgmma_fence();
          if constexpr (H) {
            wgmma_s8_m64n128(acc, a[0], qdesc(st + c0 * QKC));
            wgmma_s8_m64n128(acc, a[1], qdesc(st + c0 * QKC + 32));
          }
          if constexpr (P) {
            const uint32_t pb = st + ((H ? W : 0) + 32 * ch) * QKC;
            wgmma_s8_m64n32(accp, a[0], qdesc(pb));
            wgmma_s8_m64n32(accp, a[1], qdesc(pb + 32));
          }
          wgmma_commit();
        }
        {   // a quarter of the transposed tile to the K-major stream: 16 bytes
            // a thread, a warp four features' 128 rows
          QC_MARK(6);
          const int e = tid + Q8_THREADS * kc, c = e >> 3, k = e & 7;
          if (16 * k < nrows)
            *reinterpret_cast<uint4*>(g8c + ((long long)layer * W + c) * gr8 + 16 * k) =
                *reinterpret_cast<const uint4*>(g8tr + c * LDT + 16 * k);
          QC_MARK(5);
        }
        if (active) {
          wgmma_wait<0>();   // the next barrier hands this stage to a copy
          if constexpr (H) fence_iregs(acc);
          if constexpr (P) fence_iregs(accp);
        }
      }
    };
    if (layer == 0) products(std::false_type(), std::true_type());
    else if (layer == 5) products(std::true_type(), std::true_type());
    else products(std::true_type(), std::false_type());
    QC_MARK(7);
    // 5. the epilogue: round(acc s_g), the input's cotangent
    if (active) {
      if (layer > 0) {
#pragma unroll
        for (int i = 0; i < W / 4; ++i)
          acc[i] = __float_as_int(bf_round(__fmul_rn(q8_acc(acc[i]), s_g)));
      }
      if (layer == 5 || layer == 0) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 v =
                __floats2bfloat162_rn(__fmul_rn(q8_acc(accp[4 * jj + 2 * hh]), s_g),
                                      __fmul_rn(q8_acc(accp[4 * jj + 2 * hh + 1]), s_g));
            if (layer == 5) {
              pek[2 * jj + hh] = bf162_bits(v);
            } else {   // layer 0's PE part added to layer 5's, rounded
              const float2 o = __bfloat1622float2(bits_bf162(pek[2 * jj + hh]));
              const float2 a = __bfloat1622float2(v);
              *reinterpret_cast<__nv_bfloat162*>(gpe + (row0 + wrow + g + 8 * hh) * PE +
                                                 32 * ch + 8 * jj + 2 * t) =
                  __floats2bfloat162_rn(o.x + a.x, o.y + a.y);
            }
          }
      }
    }
  }
  QC_END(bsum);
}

// q8_wgrad_kernel: the trunk's weight gradients. A block owns a 64 x 64
// tile (input features x output features) of one layer's matrix and walks
// every group in group order. A group's rows run through a cp.async ring
// in chunks (QwGeom: 256 rows): the activations' rows as they lie
// in the stream (bf16) and the group's g8 (K-major, as the chain writes
// it). Every thread quantizes 4 x 4 blocks of the rows with the group's
// input scale (that of the bf16 rounding of the recompute's amax) and
// transposes them by prmt into a swizzled K-major int8 tile (two,
// alternating); warpgroup 0 runs
// wgmma m64n64k32 .s32.s8.s8 with both operands from shared memory (int8
// operands must be K-major: wgmma's transpose bits are for 16-bit types
// only), each chunk's product running on while the next is quantized. At a
// group's end the exact int32 sum is scaled, __fmul_rn(acc, s_in (s_g /
// s_w)), and added to the running f32 sum with __fadd_rn (0 + x is exact):
// the per-group partials' sum in group order, bit for bit, with no
// partials written or read back.
//
// Bound on an H100 SXM: bytes. A row's inputs (the PE and h0..h6, 1,856 B
// in bf16) and its 2 KB of g8 read once; 120 tiles re-read them from L2
// (each input column by 4 tiles, each g8 column by 4 or 5).

constexpr int QW_T = 64;       // a tile's input and output features

// The chunk geometry: 256 rows a chunk, two 4 x 4 blocks a thread of 512,
// a 4-stage ring. K-major operands (a 64-row tile, KR bytes a row) lie in
// blocks of 128-byte rows in wgmma's 128-byte swizzle.
struct QwGeom {
  static constexpr int KR = 256;
  static constexpr int THREADS = 512;
  static constexpr int BPT = KR * 4 / THREADS;   // 4 x 4 blocks a thread a chunk
  static constexpr int STAGES = 4;
  static constexpr int AHEAD = STAGES - 1;       // chunks issued ahead of the one whose product runs
  static constexpr int ROWB = 128;
  static constexpr int A_BYTES = KR * QW_T * 2;            // the chunk's activations, bf16
  static constexpr int STAGE_BYTES = A_BYTES + QW_T * KR;  // and its g8
  static constexpr int A8_BYTES = QW_T * KR;               // a quantized chunk
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * A8_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "every stage starts on a swizzle atom");
  static_assert(SMEM <= 232448, "fits an H100 SM's shared memory");
  // byte of a K-major tile's row n (of 64), at byte k (a 16-byte unit's
  // swizzled place, then k % 16)
  __device__ static uint32_t at(int n, int k) {
    const int u = (k % ROWB) >> 4;
    return (k / ROWB) * (QW_T * ROWB) + (k & 15) + n * 128 + ((u ^ (n & 7)) << 4);
  }
  // the descriptor of a K-major tile at `base` for the 32-deep step at
  // byte k: 8-row groups one swizzle atom apart
  __device__ static uint64_t desc(uint32_t base, int k) {
    return gmma_desc(base + (k / ROWB) * (QW_T * ROWB) + k % ROWB, 16, 1024, 1);
  }
};
constexpr size_t Q8_WGRAD_SMEM = QwGeom::SMEM;

__host__ __device__ __forceinline__ int q8_in_of(int layer) {
  return layer == 0 ? PE : (layer == 5 ? CAT : W);
}

// Tile t of q8_wgrad_kernel: layers in order, then input blocks, then
// output blocks (64 x 64 each).
__host__ __device__ __forceinline__ void q8_wgrad_tile(int t, int& layer, int& m0, int& n0) {
  for (layer = 0; layer < 8; ++layer) {
    const int tiles = q8_in_of(layer) / QW_T * (W / QW_T);
    if (t < tiles) {
      m0 = t / (W / QW_T) * QW_T;
      n0 = t % (W / QW_T) * QW_T;
      return;
    }
    t -= tiles;
  }
  m0 = n0 = 0;
}

int q8_wgrad_tiles() {
  int n = 0;
  for (int layer = 0; layer < 8; ++layer) n += q8_in_of(layer) / QW_T * (W / QW_T);
  return n;
}

__device__ __forceinline__ void wgmma_s8_ss_m64n64(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(QwGeom::THREADS, 1)
q8_wgrad_kernel(const bf16* __restrict__ acts, long long as, const int8_t* __restrict__ g8t,
                const float* __restrict__ sw, const float* __restrict__ amax,
                const float* __restrict__ gamax, float* __restrict__ out, long long group_rows,
                int n_groups) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ring = smem_addr(smem);
  using G = QwGeom;
  unsigned char* a8s = smem + G::STAGES * G::STAGE_BYTES;   // two quantized chunks, K-major
  int layer, m0, n0;
  q8_wgrad_tile(blockIdx.x, layer, m0, n0);
  const int in = q8_in_of(layer);
  const bool pe_src = layer == 0 || m0 >= W;
  const int acol = pe_src ? A_PE + (m0 >= W ? m0 - W : m0) : act_h(layer - 1) + m0;
  const int qpt = pe_src ? 0 : layer;   // the input's quantization point
  const long long gr8 = q8_g8_rows(group_rows);
  const int nch = (int)(gr8 / G::KR);
  const int total = n_groups * nch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  QW_BEGIN();

  // chunk qi: group qi / nch, its rows KR (qi % nch) ..: the
  // activations' KR rows x 128 bytes (a row's 16-byte units XOR-swizzled
  // by row / 4, so the quantizing reads below are conflict-free; rows past
  // the group zero-filled), then g8's 64 features x KR bytes (wgmma's
  // K-major swizzle)
  auto stage = [&](int s, int qi) {
    const long long grp = qi / nch;
    const int k0 = (qi % nch) * G::KR;
    const uint32_t dst = ring + s * G::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < G::KR * (QW_T * 2 / 16) / G::THREADS; ++i) {
      const int v = tid + i * G::THREADS, r = v >> 3, u = v & 7;
      const bool inr = k0 + r < group_rows;
      cp_async16_zfill(dst + r * (QW_T * 2) + ((u ^ ((r >> 2) & 7)) << 4),
                       acts + (grp * group_rows + k0 + (inr ? r : 0)) * as + acol + u * 8,
                       inr ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < QW_T * (G::KR / 16) / G::THREADS; ++i) {
      const int v = tid + i * G::THREADS, n = v / (G::KR / 16), u = v % (G::KR / 16);
      cp_async16(dst + G::A_BYTES + G::at(n, 16 * u),
                 g8t + ((grp * 8 + layer) * W + n0 + n) * gr8 + k0 + u * 16);
    }
  };
  __syncthreads();
#pragma unroll
  for (int q = 0; q < G::AHEAD; ++q) {
    if (q < total) stage(q, q);
    cp_async_commit();
  }

  // warpgroup 0's 64 x 64 tile: acc[4 j + i] is input feature m0 + 16 warp +
  // g + 8 (i / 2), output feature n0 + 8 j + 2 t + i % 2
  int acc[32];
  float tot[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0;
    tot[i] = 0.f;
  }
  float inv_in = 0.f;
  // chunk qi's rows, quantized, into the tile qi & 1 (read by its product)
  auto quantize = [&](int qi) {
    const long long grp = qi / nch;
    if (qi % nch == 0) inv_in = q8_inv(bf_round(__ldg(amax + grp * Q8P + qpt)));
    const unsigned char* raw = smem + (qi % G::STAGES) * G::STAGE_BYTES;
    unsigned char* a8 = a8s + (qi & 1) * G::A8_BYTES;
    // the thread's blocks b: rows 4 sb .., features 4 fb .. (a warp: 16 row
    // blocks, two feature blocks); its stores rotate by fb's parity so that
    // a warp's hit every bank once
#pragma unroll
    for (int bi = 0; bi < G::BPT; ++bi) {
      const int b = tid + G::THREADS * bi;
      const int sb = (b & 15) | (b >> 8) << 4, fb = (b >> 4) & 15, p = fb & 1;
      uint32_t y[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            raw + (4 * sb + r) * (QW_T * 2) + (((fb >> 1) ^ (sb & 7)) << 4) + 8 * p);
        y[r][0] = q8_rbits(__uint_as_float(v.x << 16), inv_in);
        y[r][1] = q8_rbits(__uint_as_float(v.x & 0xffff0000u), inv_in);
        y[r][2] = q8_rbits(__uint_as_float(v.y << 16), inv_in);
        y[r][3] = q8_rbits(__uint_as_float(v.y & 0xffff0000u), inv_in);
      }
      uint32_t tr[4];   // feature 4 fb + i: rows 4 sb .. 4 sb + 3
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tr[i] = __byte_perm(__byte_perm(y[0][i], y[1][i], 0x40),
                            __byte_perm(y[2][i], y[3][i], 0x40), 0x5410);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(a8 + G::at(4 * fb + (j ^ p), 4 * sb)) = p ? tr[j ^ 1] : tr[j];
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
  };
  cp_async_wait<G::AHEAD - 1>();   // chunk 0
  __syncthreads();
  quantize(0);
  // One barrier a chunk: after it chunk qi is quantized, chunk qi + 1 has
  // landed, and warpgroup 0 is done with chunk qi - 1's product, whose
  // stage takes chunk qi + AHEAD and whose tile chunk qi + 1's
  // quantizing; chunk qi's product then runs under that quantizing.
  for (int qi = 0; qi < total; ++qi) {
    QW_MARK(0);
    cp_async_wait<G::AHEAD - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();
    if (qi + G::AHEAD < total) stage((qi + G::AHEAD) % G::STAGES, qi + G::AHEAD);
    cp_async_commit();
    QW_MARK(2);
    const long long grp = qi / nch;
    if (warp < 4) {
      const uint32_t st = ring + (qi % G::STAGES) * G::STAGE_BYTES;
      const uint32_t sa = smem_addr(a8s + (qi & 1) * G::A8_BYTES);
      fence_iregs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < G::KR; k += 32)
        wgmma_s8_ss_m64n64(acc, G::desc(sa, k), G::desc(st + G::A_BYTES, k));
      wgmma_commit();
    }
    QW_MARK(1);
    const float inv_q = inv_in;   // chunk qi's group's (the next chunk may start a group)
    if (qi + 1 < total) quantize(qi + 1);
    if (warp < 4) {
      QW_MARK(2);
      wgmma_wait<0>();
      fence_iregs(acc);
      if (qi % nch == nch - 1) {   // the group's end: scale, add in group order
        QW_MARK(3);
        const float s_in = __fdiv_rn(1.f, inv_q);
        const float s_g = __fdiv_rn(1.f, q8_inv(__ldg(gamax + grp * Q8P + layer)));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + 2 * t + e;
            const float sc = __fmul_rn(s_in, __fdiv_rn(s_g, __ldg(sw + layer * W + n)));
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int i = 4 * j + 2 * hh + e;
              tot[i] = __fadd_rn(tot[i], __fmul_rn(__int2float_rn(acc[i]), sc));
              acc[i] = 0;
            }
          }
      }
    }
  }
  if (warp < 4) {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[trunk_offset(layer) + (long long)(n0 + 8 * (i >> 2) + 2 * t + (i & 1)) * in + m0 +
          16 * warp + g + 8 * ((i >> 1) & 1)] = tot[i];
  }
  QW_END(out + trunk_offset(layer) + (long long)n0 * in + m0);
}

size_t q8_fwd_bytes(bool camera_layout, long long rows, int path) {
  return align256((size_t)rows * (camera_layout ? ACT_CAM : ACT_SH) * sizeof(bf16)) +
         q8_hf_bytes(path, rows);
}

// Scratch of an int8 backward past the bf16 backward's own (BwdLayout):
// the f32 activations (layer-major path only), and for int8_full the bf16
// cotangents (g_h7; the layer-major chain ping-pongs two), the PE
// cotangent, the int8 cotangent stream (K-major, a run of q8_g8_rows rows
// a group, feature and layer) and the bias partial sums (a row a CTA of
// the cluster chain, a row a 128-row tile of the layer-major one).
struct Q8Layout {
  size_t hf, gh, gpe, g8, qbpart, total;
};

long long q8_bias_rows(int path, long long rows, long long group_rows) {
  return path == Q8_CLUSTER ? rows / group_rows * q8_cluster_size(group_rows)
                            : (rows + MT - 1) / MT;
}

Q8Layout q8_bwd_layout(bool camera, bool full, int R, int KPAD, long long group_rows, int path) {
  const long long rows = (long long)R * KPAD, groups = rows / group_rows;
  Q8Layout Q;
  Q.hf = ray_bwd_layout(camera, R, KPAD).total;
  Q.gh = align256(Q.hf + q8_hf_bytes(path, rows));
  Q.gpe = align256(Q.gh + (full ? (size_t)(path == Q8_CLUSTER ? 1 : 2) * rows * W * sizeof(bf16)
                                : 0));
  Q.g8 = align256(Q.gpe + (full ? (size_t)rows * PE * sizeof(bf16) : 0));
  Q.qbpart = align256(Q.g8 + (full ? (size_t)groups * 8 * W * q8_g8_rows(group_rows) : 0));
  Q.total = align256(Q.qbpart + (full ? (size_t)q8_bias_rows(path, rows, group_rows) * QB *
                                            sizeof(float)
                                      : 0));
  return Q;
}

// Launches of int8_full's trunk-backward kernels made so far, by kernel:
// q8_chain_cluster_kernel, q8_wgrad_kernel, q8_gamax_kernel,
// q8_dgrad_kernel, q8_reduce_kernel (read by eonerf_q8_bwd_launches).
long long q8_bwd_launch_counts[5];

cudaError_t q8_chain_attributes() {
  cudaError_t e = cudaFuncSetAttribute(q8_chain_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Q8_CHAIN_SMEM);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(q8_chain_cluster_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The cotangent chain from g_h7 (gh) down to the PE (gpe) on `path`: one
// cluster launch, or 8 x (q8_gamax_kernel, q8_dgrad_kernel) ping-ponging
// the bf16 cotangent through gh (2 x rows x 256). No retry on the other
// path: a refused launch returns its error.
int q8_chain(int path, bf16* gh, bf16* gpe, const bf16* acts, long long as, const int8_t* w8t,
             const float* sw, float* gamax, int8_t* g8s, float* qbpart, long long rows,
             long long group_rows, cudaStream_t stream) {
  if (path == Q8_CLUSTER) {
    if (group_rows % 64 != 0) return (int)cudaErrorInvalidValue;
    const int C = q8_cluster_size(group_rows);
    if (C > Q8_CLUSTER_MAX) return (int)cudaErrorInvalidClusterSize;
    cudaError_t e = q8_chain_attributes();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        q8_cluster_config(rows / group_rows, C, stream, attr, Q8_CHAIN_SMEM);
    e = cudaLaunchKernelEx(&cfg, q8_chain_cluster_kernel, (const bf16*)gh, gpe, acts, as, w8t, sw,
                           gamax, g8s, qbpart, group_rows);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e == cudaSuccess) ++q8_bwd_launch_counts[0];
    return (int)e;
  }
  const int tiles = (int)((rows + MT - 1) / MT);
  const size_t smem = q8_dgrad_smem();
  cudaError_t e = cudaFuncSetAttribute(q8_dgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  for (int layer = 7; layer >= 0; --layer) {
    const bf16* cur = gh + (long long)((7 - layer) % 2) * rows * W;
    bf16* nxt = gh + (long long)((8 - layer) % 2) * rows * W;
    q8_gamax_kernel<<<tiles, THREADS, 0, stream>>>(layer, cur, acts, as, sw, gamax, qbpart, rows,
                                                   group_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++q8_bwd_launch_counts[2];
    q8_dgrad_kernel<<<tiles, THREADS, smem, stream>>>(layer, cur, nxt, gpe, acts, as, w8t, sw,
                                                      gamax, g8s, rows, group_rows);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++q8_bwd_launch_counts[3];
  }
  return 0;
}

// The trunk's weight gradients into dmats: every group, in group order, in
// one launch.
int q8_wgrad(const bf16* acts, long long as, const int8_t* g8s, const float* sw,
             const float* amax, const float* gamax, float* dmats, long long group_rows, int groups,
             cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(q8_wgrad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)Q8_WGRAD_SMEM);
  if (e != cudaSuccess) return (int)e;
  q8_wgrad_kernel<<<q8_wgrad_tiles(), QwGeom::THREADS, Q8_WGRAD_SMEM, stream>>>(
      acts, as, g8s, sw, amax, gamax, dmats, group_rows, groups);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++q8_bwd_launch_counts[1];
  return (int)e;
}

int q8_fwd(int mode, const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, const void* w8, const float* sw, void* ws,
           float* amax, float* out, int R, int KPAD, long long group_rows,
           cudaStream_t stream, int path) {
  if (!q8_shape_ok(R, KPAD, group_rows) || mode < CAM || mode > COARSE)
    return (int)cudaErrorInvalidValue;
  path = q8_path(group_rows, path);
  const long long rows = (long long)R * KPAD;
  const long long as = mode == CAM ? ACT_CAM : ACT_SH;
  bf16* acts = static_cast<bf16*>(ws);
  float* hf = reinterpret_cast<float*>(static_cast<unsigned char*>(ws) +
                                       align256((size_t)rows * as * sizeof(bf16)));
  int err = q8_trunk(path, rayin, z, acts, as, false, static_cast<const int8_t*>(w8), sw, wb, hf,
                     amax, rows, KPAD, group_rows, stream);
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

// pass (measurement; int8_full only): < 0 every launch; 0 the recompute and
// the heads' passes; 1 the cotangent chain; 2 the weight gradient; 3 the
// bias reduction; 4 the per-ray PE gradients. Each alone on a workspace
// that the passes before it filled.
template <bool CAMERA>
int q8_bwd(bool full, const float* rayin, const float* z, const float* deltam, const float* mask,
           const float* gin, const void* wm_, const float* wb, const void* w8_, const void* w8t_,
           const float* sw, void* ws, float* amax, float* gamax, float* dmats, float* dbias,
           float* drayin, int R, int KPAD, long long group_rows, cudaStream_t stream, int path,
           int pass = -1) {
  if (!q8_shape_ok(R, KPAD, group_rows) || pass > 4 || (pass >= 0 && !full))
    return (int)cudaErrorInvalidValue;
  path = q8_path(group_rows, path);
  const bf16* wm = static_cast<const bf16*>(wm_);
  const int8_t* w8 = static_cast<const int8_t*>(w8_);
  const int8_t* w8t = static_cast<const int8_t*>(w8t_);
  constexpr long long AS = CAMERA ? ACT_CAM : ACT_SH;
  const long long rows = (long long)R * KPAD;
  const BwdLayout L = ray_bwd_layout(CAMERA, R, KPAD);
  const Scratch sc = carve(L, ws);
  const Q8Layout Q = q8_bwd_layout(CAMERA, full, R, KPAD, group_rows, path);
  unsigned char* base = static_cast<unsigned char*>(ws);
  float* hf = reinterpret_cast<float*>(base + Q.hf);
  bf16* gh = reinterpret_cast<bf16*>(base + Q.gh);
  int err = 0;
  if (pass < 0 || pass == 0) {
    // the recompute: the int8 trunk in the backward's groups, every
    // activation to the stream, then the heads from the stream and the
    // compositing backward
    err = q8_trunk(path, rayin, z, sc.acts, AS, true, w8, sw, wb, hf, amax, rows, KPAD, group_rows,
                   stream);
    if (err != 0) return err;
    err = launch<CAMERA ? CAM : SHADOW, true, true>(rayin, z, deltam, mask, wm, wb, nullptr, R,
                                                    KPAD, stream, gin, sc.acts, sc.hg);
    if (err != 0) return err;
    // int8: straight through, the bf16 dgrad and wgrad against the
    // unquantized weights on the int8 recompute's stream
    if (!full)
      return bwd_passes<CAMERA, false>(L, sc, rayin, z, wm, dmats, dbias, drayin, nullptr, R,
                                       KPAD, stream);
    err = bwd_passes<CAMERA, false, true>(L, sc, rayin, z, wm, dmats, dbias, drayin, nullptr, R,
                                          KPAD, stream, gh);
    if (err != 0 || pass == 0) return err;
  }
  bf16* gpe = reinterpret_cast<bf16*>(base + Q.gpe);
  int8_t* g8s = reinterpret_cast<int8_t*>(base + Q.g8);
  float* qbpart = reinterpret_cast<float*>(base + Q.qbpart);
  const int groups = (int)(rows / group_rows);
  if (pass < 0 || pass == 1) {
    err = q8_chain(path, gh, gpe, sc.acts, AS, w8t, sw, gamax, g8s, qbpart, rows, group_rows,
                   stream);
    if (err != 0) return err;
  }
  if (pass < 0 || pass == 2) {
    err = q8_wgrad(sc.acts, AS, g8s, sw, amax, gamax, dmats, group_rows, groups, stream);
    if (err != 0) return err;
  }
  if (pass < 0 || pass == 3) {
    q8_reduce_kernel<<<QB / THREADS, THREADS, 0, stream>>>(
        qbpart, (int)q8_bias_rows(path, rows, group_rows), dbias);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    ++q8_bwd_launch_counts[4];
  }
  if (pass < 0 || pass == 4)
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

// The plain forwards (stream_fwd_kernel and its plan's two launches). ws:
// eonerf_stream_fwd_workspace_bytes of scratch, after the stream (a build
// of an older tree, whose forwards take none, ignores it).
int eonerf_camera_fwd(const float* rayin, const float* z, const float* deltam, const void* wm,
                      const float* wb, float* acc, int R, int KPAD, void* stream, void* ws) {
  return launch_stream<CAM>(rayin, z, deltam, nullptr, wm, wb, acc, R, KPAD, ws,
                            static_cast<cudaStream_t>(stream));
}

int eonerf_shadow_fwd(const float* rayin, const float* z, const float* deltam, const float* mask,
                      const void* wm, const float* wb, float* geo, int R, int KPAD, void* stream,
                      void* ws) {
  return launch_stream<SHADOW>(rayin, z, deltam, mask, wm, wb, geo, R, KPAD, ws,
                               static_cast<cudaStream_t>(stream));
}

// The coarse (density-only) pass's per-sample compositing weights, written
// as (R, KPAD) into w.
int eonerf_coarse_fwd(const float* rayin, const float* z, const float* deltam, const void* wm,
                      const float* wb, float* w, int R, int KPAD, void* stream, void* ws) {
  return launch_stream<COARSE>(rayin, z, deltam, nullptr, wm, wb, w, R, KPAD, ws,
                               static_cast<cudaStream_t>(stream));
}

// Bytes of scratch of a plain forward (camera != 0: the camera's), and its
// carve (fs_layout): offsets of the weight stream, the rows' results, their
// (ray, sample), the counts, the prefix, the blocks' first rays, then the
// total.
long long eonerf_stream_fwd_workspace_bytes(int camera, int R, int KPAD) {
  return (long long)fs_layout(camera != 0, R, KPAD).total;
}

void eonerf_stream_fwd_layout(int camera, int R, int KPAD, long long* out) {
  const FsLayout L = fs_layout(camera != 0, R, KPAD);
  const size_t v[7] = {L.stream, L.res, L.meta, L.cnt, L.prefix, L.ray_start, L.total};
  for (int i = 0; i < 7; ++i) out[i] = (long long)v[i];
}

// The plain forwards' grid on the current card (blocks), or minus a CUDA
// error code.
int eonerf_stream_fwd_grid() {
  cudaError_t e;
  const int G = fs_grid(&e);
  return e == cudaSuccess ? G : -(int)e;
}

// Measurement and tests: the plan alone (the counts, the prefix, the
// blocks' first rays and the weight stream into ws), for the grid of the
// current card.
int eonerf_stream_fwd_plan(int camera, const float* deltam, const void* wm, int R, int KPAD,
                           void* ws, void* stream) {
  if (!fs_shape_ok(R, KPAD) || ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  const int G = fs_grid(&e);
  if (e != cudaSuccess) return (int)e;
  return launch_plan(camera != 0, deltam, static_cast<const bf16*>(wm), R, KPAD, G,
                     static_cast<unsigned char*>(ws), static_cast<cudaStream_t>(stream));
}

// stream_fwd_kernel launches made so far: camera, shadow, coarse.
void eonerf_stream_fwd_launches(long long* out) {
  for (int m = 0; m < 3; ++m) out[m] = fs_launch_count[m];
}

// The per-point forwards (stream_fwd_kernel's point modes, after the
// weight stream's launch). ws: eonerf_point_fwd_workspace_bytes of scratch,
// after the stream (a build of an older tree, whose point forwards take
// none, ignores it).
// Per-point density: pos (N, 3) -> sigma (N,).
int eonerf_density_fwd(const float* pos, const void* wm, const float* wb, float* sigma, int N,
                       void* stream, void* ws) {
  return launch_point_fwd<PT_DENSITY>(pos, nullptr, wm, wb, sigma, N, ws,
                                      static_cast<cudaStream_t>(stream));
}

// Per-point field: pos (N, 3), emb (N, 4) -> out (N, 8).
int eonerf_field_fwd(const float* pos, const float* emb, const void* wm, const float* wb,
                     float* out, int N, void* stream, void* ws) {
  return launch_point_fwd<PT_FIELD>(pos, emb, wm, wb, out, N, ws,
                                    static_cast<cudaStream_t>(stream));
}

// Bytes of scratch of a per-point forward (field != 0: the field's) of N
// points: the weight stream.
long long eonerf_point_fwd_workspace_bytes(int field, int N) {
  (void)N;
  return (long long)pt_workspace_bytes(field != 0);
}

// The per-point forwards' grid for N points on the current card (blocks),
// or minus a CUDA error code.
int eonerf_point_fwd_blocks(int N) {
  cudaError_t e;
  const int G = pt_grid(N, &e);
  return e == cudaSuccess ? G : -(int)e;
}

// The per-point forwards' launches made so far: field, density.
void eonerf_point_fwd_launches(long long* out) {
  out[0] = fs_launch_count[PT_FIELD];
  out[1] = fs_launch_count[PT_DENSITY];
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
// into acts (R * KPAD rows of eonerf_act_stream_cols(1) bf16 columns): the
// save mode of the streamed forward after its weight stream's launch. ws:
// eonerf_save_fwd_workspace_bytes of scratch, after the stream (a build of
// an older tree, whose save forwards take none, ignores it).
int eonerf_camera_fwd_save(const float* rayin, const float* z, const float* deltam,
                           const void* wm, const float* wb, float* acc, void* acts, int R,
                           int KPAD, void* stream, void* ws) {
  return launch_save<CAM>(rayin, z, deltam, nullptr, wm, wb, acc, static_cast<bf16*>(acts), R,
                          KPAD, ws, static_cast<cudaStream_t>(stream));
}

// The shadow forward that also writes its stream (eonerf_act_stream_cols(0)
// columns a row); ws as eonerf_camera_fwd_save's.
int eonerf_shadow_fwd_save(const float* rayin, const float* z, const float* deltam,
                           const float* mask, const void* wm, const float* wb, float* geo,
                           void* acts, int R, int KPAD, void* stream, void* ws) {
  return launch_save<SHADOW>(rayin, z, deltam, mask, wm, wb, geo, static_cast<bf16*>(acts), R,
                             KPAD, ws, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch of a save forward (camera != 0: the camera's) of R rays
// of KPAD samples: the weight stream and every row's results (sv_layout).
long long eonerf_save_fwd_workspace_bytes(int camera, int R, int KPAD) {
  return (long long)sv_layout(camera != 0, R, KPAD).total;
}

// The save forwards' grid for R rays on the current card (blocks), or
// minus a CUDA error code.
int eonerf_save_fwd_blocks(int R) {
  cudaError_t e;
  const int G = sv_grid(R, &e);
  return e == cudaSuccess ? G : -(int)e;
}

// The save-mode launches made so far: camera, shadow.
void eonerf_save_fwd_launches(long long* out) {
  out[0] = sv_launch_count[0];
  out[1] = sv_launch_count[1];
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

// dgrad_kernel launches made so far (every instantiation, whichever entry
// launched it), into out[0].
void eonerf_dgrad_launches(long long* out) { out[0] = dgrad_launch_count; }

// dgrad_kernel's plan for R rays of KPAD samples (or R points, KPAD 1):
// out = [rays a unit, units (rows of bias partial sums), blocks of the
// persistent grid (0 on a CUDA error), dynamic shared memory bytes].
void eonerf_dgrad_plan(int R, int KPAD, long long* out) {
  const int rpb = rays_per_block(KPAD), units = (R + rpb - 1) / rpb;
  cudaError_t e;
  out[0] = rpb;
  out[1] = units;
  out[2] = dgrad_grid(units, &e);
  out[3] = (long long)dgrad_smem(KPAD);
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

// The int8 trunk's path for scale groups of group_rows rows of KPAD samples:
// 1 one cluster launch (q8_trunk_cluster_kernel), 0 the layer-major kernels
// (q8_pe_kernel, q8_layer_kernel x 8), -1 a shape no int8 call takes.
int eonerf_q8_trunk_path(int KPAD, long long group_rows) {
  if (!q8_shape_ok(1, KPAD, KPAD) || group_rows <= 0 || group_rows % KPAD != 0) return -1;
  return q8_path(group_rows, -1);
}

// Clusters of C CTAs of q8_trunk_cluster_kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int eonerf_q8_trunk_active_clusters(int C) {
  cudaError_t e = q8_cluster_attributes();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q8_cluster_config(1, C, nullptr, attr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, q8_trunk_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Launches of the int8 trunk's kernels made so far, into out[3]:
// q8_trunk_cluster_kernel, q8_pe_kernel, q8_layer_kernel.
void eonerf_q8_trunk_launches(long long* out) {
  for (int i = 0; i < 3; ++i) out[i] = q8_trunk_launch_counts[i];
}

// Bytes of scratch of the int8 trunk alone (the layer-major path's f32
// activations; 0 on the cluster path). path: -1 the shape's, 0 or 1 forced.
long long eonerf_q8_trunk_workspace_bytes(int R, int KPAD, long long group_rows, int path) {
  return (long long)q8_hf_bytes(q8_path(group_rows, path), (long long)R * KPAD);
}

// The int8 trunk alone, as the int8 forwards (write_all = 0: the PE and h7)
// and backwards (write_all = 1: the PE and every h) run it, into the stream
// acts (R * KPAD rows of `as` columns) and amax (groups, 8), zeroed by the
// caller; ws: eonerf_q8_trunk_workspace_bytes. path as there.
int eonerf_q8_trunk(int path, const float* rayin, const float* z, void* acts, long long as,
                    int write_all, const void* w8, const float* sw, const float* wb, void* ws,
                    float* amax, int R, int KPAD, long long group_rows, void* stream) {
  if (!q8_shape_ok(R, KPAD, group_rows) || (as != ACT_CAM && as != ACT_SH))
    return (int)cudaErrorInvalidValue;
  return q8_trunk(q8_path(group_rows, path), rayin, z, static_cast<bf16*>(acts), as,
                  write_all != 0, static_cast<const int8_t*>(w8), sw, wb, static_cast<float*>(ws),
                  amax, (long long)R * KPAD, KPAD, group_rows, static_cast<cudaStream_t>(stream));
}

// Bytes of scratch of an int8 forward (mode 0 camera, 1 shadow, 2 coarse);
// path as eonerf_q8_trunk's.
long long eonerf_q8_fwd_workspace_bytes(int mode, int R, int KPAD, long long group_rows,
                                        int path) {
  return (long long)q8_fwd_bytes(mode == CAM, (long long)R * KPAD, q8_path(group_rows, path));
}

// Forward through the int8 trunk: out as the bf16 op of the same mode
// (camera acc (R, 8), shadow geo (R,), coarse weights (R, KPAD)). The
// stream (the first R * KPAD x 3072 (camera) or 2112 bf16 of ws) holds the
// PE and h7.
int eonerf_q8_fwd(int mode, const float* rayin, const float* z, const float* deltam,
                  const float* mask, const void* wm, const float* wb, const void* w8,
                  const float* sw, void* ws, float* amax, float* out, int R, int KPAD,
                  long long group_rows, void* stream, int path) {
  return q8_fwd(mode, rayin, z, deltam, mask, wm, wb, w8, sw, ws, amax, out, R, KPAD, group_rows,
                static_cast<cudaStream_t>(stream), path);
}

// Bytes of scratch of an int8 backward (camera != 0: the camera's; full != 0:
// int8_full).
long long eonerf_q8_bwd_workspace_bytes(int camera, int full, int R, int KPAD,
                                        long long group_rows, int path) {
  return (long long)q8_bwd_layout(camera != 0, full != 0, R, KPAD, group_rows,
                                  q8_path(group_rows, path)).total;
}

// Backward of the int8 camera (camera != 0; gin = gacc (R, 8)) or shadow op
// (gin = ggeo (R,)): int8 (full = 0) or int8_full. Outputs as the bf16
// backward's.
int eonerf_q8_bwd(int camera, int full, const float* rayin, const float* z, const float* deltam,
                  const float* mask, const float* gin, const void* wm, const float* wb,
                  const void* w8, const void* w8t, const float* sw, void* ws, float* amax,
                  float* gamax, float* dmats, float* dbias, float* drayin, int R, int KPAD,
                  long long group_rows, void* stream, int path) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (camera)
    return q8_bwd<true>(full != 0, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax,
                        gamax, dmats, dbias, drayin, R, KPAD, group_rows, st, path);
  return q8_bwd<false>(full != 0, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax,
                       gamax, dmats, dbias, drayin, R, KPAD, group_rows, st, path);
}

// Measurement: one pass of an int8_full backward alone (pass as q8_bwd's:
// 0 the recompute and heads, 1 the chain, 2 the weight gradient, 3 the
// bias reduction, 4 the per-ray gradients), on a workspace the passes
// before it filled; arguments as eonerf_q8_bwd's.
int eonerf_q8_bwd_pass(int camera, int pass, const float* rayin, const float* z,
                       const float* deltam, const float* mask, const float* gin, const void* wm,
                       const float* wb, const void* w8, const void* w8t, const float* sw,
                       void* ws, float* amax, float* gamax, float* dmats, float* dbias,
                       float* drayin, int R, int KPAD, long long group_rows,
                       void* stream, int path) {
  if (pass < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (camera)
    return q8_bwd<true>(true, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax, gamax,
                        dmats, dbias, drayin, R, KPAD, group_rows, st, path, pass);
  return q8_bwd<false>(true, rayin, z, deltam, mask, gin, wm, wb, w8, w8t, sw, ws, amax, gamax,
                       dmats, dbias, drayin, R, KPAD, group_rows, st, path, pass);
}

// Where an int8_full backward keeps its int8 scratch in its workspace:
// out = [g_h7's byte offset (rows x 256 bf16), the PE cotangent's (rows x
// 64 bf16), the int8 cotangent stream's, the bias partials' (rows of 2048
// f32), their row count, the stream's run of rows (q8_g8_rows), total].
void eonerf_q8_bwd_layout(int camera, int R, int KPAD, long long group_rows, int path,
                          long long* out) {
  const int p = q8_path(group_rows, path);
  const Q8Layout Q = q8_bwd_layout(camera != 0, true, R, KPAD, group_rows, p);
  out[0] = (long long)Q.gh;
  out[1] = (long long)Q.gpe;
  out[2] = (long long)Q.g8;
  out[3] = (long long)Q.qbpart;
  out[4] = q8_bias_rows(p, (long long)R * KPAD, group_rows);
  out[5] = q8_g8_rows(group_rows);
  out[6] = (long long)Q.total;
}

// The int8_full backward's plan for groups of group_rows rows of KPAD
// samples: out = [the chain's path (1 the cluster kernel, 0 the
// layer-major pair, -1 a shape no call takes), CTAs a group, the cluster
// kernel's dynamic shared memory bytes, q8_wgrad_kernel's tiles, its
// dynamic shared memory bytes, the int8 stream's run of rows].
void eonerf_q8_bwd_plan(int KPAD, long long group_rows, long long* out) {
  out[0] = eonerf_q8_trunk_path(KPAD, group_rows);
  out[1] = q8_cluster_size(group_rows);
  out[2] = (long long)Q8_CHAIN_SMEM;
  out[3] = q8_wgrad_tiles();
  out[4] = (long long)Q8_WGRAD_SMEM;
  out[5] = q8_g8_rows(group_rows);
}

// Clusters of C CTAs of q8_chain_cluster_kernel that the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int eonerf_q8_chain_active_clusters(int C) {
  cudaError_t e = q8_chain_attributes();
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = q8_cluster_config(1, C, nullptr, attr, Q8_CHAIN_SMEM);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, q8_chain_cluster_kernel, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

// Launches of int8_full's trunk-backward kernels made so far, into out[5]:
// q8_chain_cluster_kernel, q8_wgrad_kernel, q8_gamax_kernel,
// q8_dgrad_kernel, q8_reduce_kernel.
void eonerf_q8_bwd_launches(long long* out) {
  for (int i = 0; i < 5; ++i) out[i] = q8_bwd_launch_counts[i];
}

const char* eonerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
