// Fused EO-NeRF render forward kernels for NVIDIA Hopper (sm_90a).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int RES = 6;        // per-sample results: sigma, albedo x3, t_s, t_beta
constexpr float HALF_PI = 1.57079632679489661923f;

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

// One block per group of `rpb` whole rays; KPAD samples per ray (a multiple
// of 8, <= MAX_KPAD); rows s = ray * KPAD + k of the block's sample axis are
// processed 128 at a time.
template <bool CAMERA>
__global__ void __launch_bounds__(THREADS, 1)
fused_fwd_kernel(const float* __restrict__ rayin, const float* __restrict__ z,
                 const float* __restrict__ deltam, const float* __restrict__ mask,
                 const bf16* __restrict__ wm, const float* __restrict__ wb,
                 float* __restrict__ out, int R, int KPAD, int rpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufX = reinterpret_cast<bf16*>(smem);
  bf16* bufY = bufX + MT * LDA;
  bf16* wst = bufY + MT * LDA;
  float* res = reinterpret_cast<float*>(wst + NC * LDW);
  const int ray0 = blockIdx.x * rpb;
  const int nray = min(rpb, R - ray0);
  const int S = nray * KPAD;

  for (int s0 = 0; s0 < S; s0 += MT) {
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
    // trunk: layer i reads src, writes dst; h4 lands in bufY, next to its PE
    // copy, so layer 5 reads [h4, pe] as one 320-wide operand
    bf16 *src = bufX, *dst = bufY;
    for (int i = 0; i < 8; ++i) {
      const int k_dim = i == 0 ? PE : (i == 5 ? CAT : W);
      gemm<true>(src, i == 0 ? W : 0, k_dim, wm + trunk_offset(i), wb + B_T + i * W, W, dst, wst);
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
      gemm<true>(Q, 0, W, wm + M_ALB0, wb + B_ALB0, HALF, P, wst);  // albedo hidden -> P
      __syncthreads();
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
      gemm<true>(P, 0, HALF, wm + M_TR1, wb + B_TR + HALF, HALF, Q, wst);
      gemm<true>(Q, 0, HALF, wm + M_TR1 + HALF * HALF, wb + B_TR + 2 * HALF, HALF, P, wst);
      gemm<true>(P, 0, HALF, wm + M_TR1 + 2 * HALF * HALF, wb + B_TR + 3 * HALF, HALF, Q, wst);
      __syncthreads();
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

  // compositing, one thread per ray, in f32
  for (int lr = threadIdx.x; lr < nray; lr += THREADS) {
    const long long ray = ray0 + lr;
    const float* zr = z + ray * KPAD;
    const float* dr = deltam + ray * KPAD;
    const float* rs = res + lr * KPAD * RES;
    if (CAMERA) {
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
    } else {
      // a sample counts when at least two valid samples remain from it on,
      // i.e. it lies strictly before the ray's last valid sample
      const float* mr = mask + ray * KPAD;
      float remaining = 0.f, ev = 0.f;
      for (int k = 0; k < KPAD; ++k) remaining += mr[k];
      for (int k = 0; k < KPAD; ++k) {
        if (remaining >= 2.f) ev += rs[k * RES] * dr[k];
        remaining -= mr[k];
      }
      out[ray] = expf(-ev);
    }
  }
}

template <bool CAMERA>
int launch(const float* rayin, const float* z, const float* deltam, const float* mask,
           const void* wm, const float* wb, float* out, int R, int KPAD, void* stream) {
  if (R <= 0 || KPAD <= 0 || KPAD % 8 != 0 || KPAD > MAX_KPAD) return (int)cudaErrorInvalidValue;
  const int rpb = KPAD >= MT ? 1 : MT / KPAD;
  const int grid = (R + rpb - 1) / rpb;
  const size_t smem = (size_t)(2 * MT * LDA + NC * LDW) * sizeof(bf16) +
                      (size_t)rpb * KPAD * RES * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_fwd_kernel<CAMERA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_fwd_kernel<CAMERA><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      rayin, z, deltam, mask, static_cast<const bf16*>(wm), wb, out, R, KPAD, rpb);
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
  return launch<true>(rayin, z, deltam, nullptr, wm, wb, acc, R, KPAD, stream);
}

int eonerf_shadow_fwd(const float* rayin, const float* z, const float* deltam, const float* mask,
                      const void* wm, const float* wb, float* geo, int R, int KPAD, void* stream) {
  return launch<false>(rayin, z, deltam, mask, wm, wb, geo, R, KPAD, stream);
}

const char* eonerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
