// Device code shared by the port's two CUDA sources: fused_render.cu (the
// production kernels) and kernel_variants.cu (the kernel-variant bench, which
// measures that design's costs one by one). The tile machinery: the 128-row
// bf16 activation tiles and their stride, the two tensor-core products with
// their weights staged through an asynchronous ring (gemm, dgemm), the
// weight-gradient product with both operands staged through one (wgemm),
// the trunk over a tile, the PE lanes, the packed weight layout, the
// fixed-order reduction of per-block partial sums, and the int8 pieces
// (mma, quantization, the group amax fold).
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
constexpr int LDA = CAT + 8;  // activation row stride; +8 keeps ldmatrix conflict-free
constexpr int KC = 32;        // depth of one staged weight chunk; weight-gradient splits are multiples
constexpr int NC = 128;       // output columns per pass
constexpr int STAGES = 3;     // stages of the products' weight ring
constexpr int WST = STAGES * NC * KC;   // the ring, bf16 elements (24,576 bytes)
static_assert(2 * MT * LDA * 2 % 1024 == 0, "a ring after two tiles stays 1024-byte aligned");
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous, cached in L2 only
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp_async16 with a source size of 0 or 16 bytes: the rest of the 16 are
// zero-filled (0: nothing is read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}

// this thread's copies of all but the newest N groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory, lane l giving the row address
// of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// The A fragment of a 16 x 16 step (rows row0..row0 + 15, columns col..col +
// 15 of a bf16 tile with row stride LD) in one ldmatrix: a0..a3 as the PTX
// fragment layout of mma m16n8k16 and of wgmma's A in registers orders them.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int col) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_addr(tile + (row0 + (lane & 15)) * LD + col + (lane >> 4) * 8));
}

// wgmma.mma_async m64nNk16, bf16 -> f32, A from registers (each warp of the
// warpgroup holds its 16 rows in mma m16n8k16's A layout), B from shared
// memory through a matrix descriptor; TRANS_B = 1 reads B MN-major. The
// accumulator d holds the warp's 16 rows as mma m16n8k16's C layout, one
// n8 tile after the other: d[4 j + i] is (row g + 8 (i / 2), column 8 j +
// 2 t + i % 2).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}


template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (N == 32) wgmma_m64n32<TRANS_B>(d, a, desc);
  else if constexpr (N == 64) wgmma_m64n64<TRANS_B>(d, a, desc);
  else wgmma_m64n128<TRANS_B>(d, a, desc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// close the warpgroup's wgmmas since the fence into one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of the warpgroup's groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving an accumulator's reads or writes across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled operand: start address,
// leading and stride byte offsets, layout (1: 128-byte swizzle, 2: 64-byte).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
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

// The weight ring, STAGES chunks of NC x KC bf16 (8 KB each) at `wst`,
// 1024-byte aligned. gemm's chunk holds 128 of Wt's (n, k) rows, 32 deep:
// 64 bytes a row, its four 16-byte units u stored at u ^ ((n >> 1) & 3), the
// 64-byte swizzle of wgmma's K-major operand layout. dgemm's holds 32 of
// Wp's (k, n) rows, 128 columns wide, as two 64-column halves: 128 bytes a
// row, its eight units u stored at u ^ (k & 7), the 128-byte swizzle of the
// MN-major layout. No row padding: the swizzle keeps the copies' stores
// and the tensor cores' reads free of bank conflicts.
constexpr int STAGE_BYTES = NC * KC * 2;

__device__ __forceinline__ void stage_wt(uint32_t st, const bf16* __restrict__ Wt, int k_dim,
                                         int n0, int k0) {
#pragma unroll
  for (int i = 0; i < NC * KC / 8 / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS, n = v >> 2, u = v & 3;
    cp_async16(st + n * 64 + ((u ^ ((n >> 1) & 3)) << 4),
               Wt + (long long)(n0 + n) * k_dim + k0 + u * 8);
  }
}

// columns past n_dim are not copied (their products are skipped)
__device__ __forceinline__ void stage_wp(uint32_t st, const bf16* __restrict__ Wp, int n_dim,
                                         int n0, int k0) {
#pragma unroll
  for (int i = 0; i < NC * KC / 8 / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS, k = v >> 4, nu = v & 15;
    if (n0 + nu * 8 < n_dim)
      cp_async16(st + (nu >> 3) * (KC * 128) + k * 128 + (((nu & 7) ^ (k & 7)) << 4),
                 Wp + (long long)(k0 + k) * n_dim + n0 + nu * 8);
  }
}

// The ring's schedule, shared by both products: chunk q of the call
// (passes of NC output columns outer, KC-deep slices inner) is copied
// STAGES - 1 chunks ahead of its products, so its L2 round trip runs under
// the products of the chunks before it, and the passes run on without a
// drain. One block barrier a chunk: after it, chunk q has landed for every
// thread and every warpgroup is done with chunk q - 1, whose stage the
// copy of chunk q + ST - 1 then takes. stage(s, q) issues chunk q's
// copies into stage s (stores it makes itself with st.shared are ordered
// before the tensor cores' reads as the copies are). ST stages of SB bytes:
// the products' ring by default, wgemm's its own.
template <int ST = STAGES, typename Stage>
__device__ __forceinline__ void ring_prologue(int total, Stage stage) {
  __syncthreads();   // the caller's writes are visible; the ring's last readers are done
#pragma unroll
  for (int q = 0; q < ST - 1; ++q) {
    if (q < total) stage(q, q);
    cp_async_commit();
  }
}

template <int ST = STAGES, int SB = STAGE_BYTES, typename Stage>
__device__ __forceinline__ uint32_t ring_next(int q, int total, uint32_t ring, Stage stage) {
  cp_async_wait<ST - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
  __syncthreads();
  const int qn = q + ST - 1;
  if (qn < total) stage(qn % ST, qn);
  cp_async_commit();
  return ring + (q % ST) * SB;
}

// One chunk's products for a warpgroup: its warp's A fragments for the
// chunk's KC columns (ldmatrix, into the registers wgmma reads), then one
// wgmma a k step and chain c < nch, and the wait for them (the next
// barrier hands their stage to a copy). desc(s, c): B's descriptor for k
// step s and chain c.
template <int LD, int N, int CH, int TRANS_B, typename Desc>
__device__ __forceinline__ void chunk_products(float (&acc)[CH][N / 2], const bf16* A, int row0,
                                               int acol, int nch, Desc desc) {
  uint32_t a[KC / 16][4];
#pragma unroll
  for (int s = 0; s < KC / 16; ++s) load_a<LD>(a[s], A, row0, acol + 16 * s);
#pragma unroll
  for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < KC / 16; ++s)
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (c < nch) wgmma<N, TRANS_B>(acc[c], a[s], desc(s, c));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < CH; ++c) fence_regs(acc[c]);
}

// The TPU kernels' layer product: the JAX package's ops/pallas/fused_field.py
// `_mm` (:199), the product of every Pallas body's trunk and head layers.
// out[r, n] = act(sum_k A[r, a_col0 + k] * Wt[n, k] + bias[n]) for the
// ROWS rows of the tile, n < n_dim (a multiple of 128), rounded to bf16; LD
// is the tiles' row stride. Wt (n_dim x k_dim, row-major) streams through
// the weight ring, 128 x 32 a chunk. The two warpgroups split the tile
// into 64-row halves (ROWS = 128) or a pass's 128 columns into 64-column
// halves (ROWS = 64); each warp loads its 16 rows of A with ldmatrix into
// the registers wgmma reads, and each warpgroup issues its share of the
// chunk as CH wgmma chains of 128 / CH (ROWS = 64: 64) columns back to back
// on each 16-deep k step (independent accumulators; the production kernels
// use CH = 1, one m64n128k16 a step). A and out must be different tiles.
// Starts with a block barrier, so writes made before the call by any
// thread are visible.
//
// Bound on an H100 SXM: operations, 2 ROWS n_dim k_dim a call at 989
// TFLOP/s, 7.5 an SM (a 256 x 256 layer on a 128-row tile: 2.2 us on its
// SM); the weights are L2-resident and the tile never leaves shared memory.
// Fits: the ring is 24,576 bytes beside two 128 x 328 tiles (167,936),
// which leaves the camera forward 36,864 bytes of per-ray results at K = 143
// under the 232,448-byte limit (a deeper ring of two 64-deep stages, 32,768
// bytes, does not fit there). What the design does about the costs of the
// staging it replaced (32-deep synchronous __ldg copies into one padded
// buffer, two block barriers a chunk, 32 mma.sync a warp a chunk on
// fragments read as 32-bit shared loads): cp.async copies two chunks ahead
// (the L2 round trip runs under the products), one barrier a chunk, A's
// fragments one ldmatrix.x4 a k step, and B read by the tensor cores
// straight from the swizzled ring, two wgmma a warpgroup a chunk.
template <bool RELU, int LD = LDA, int ROWS = MT, int CH = 1>
__device__ void gemm(const bf16* A, int a_col0, int k_dim, const bf16* __restrict__ Wt,
                     const float* __restrict__ bias, int n_dim, bf16* out, bf16* wst) {
  constexpr int WGR = ROWS / 64, WGC = 2 / WGR, NW = NC / WGC, N = NW / CH;
  static_assert(ROWS % 64 == 0 && WGR * WGC == 2 && (N == 32 || N == 64 || N == 128),
                "two warpgroups of 64 rows cover the tile; a chain is 32, 64 or 128 wide");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, row0 = wg % WGR * 64 + (warp & 3) * 16, col0 = wg / WGR * NW;
  bf16* orow = out + (row0 + g) * LD + col0 + 2 * t;
  const uint32_t ring = smem_addr(wst);
  const int nk = k_dim / KC, total = n_dim / NC * nk;
  auto stage = [&](int s, int q) {
    stage_wt(ring + s * STAGE_BYTES, Wt, k_dim, q / nk * NC, q % nk * KC);
  };
  ring_prologue(total, stage);
  int q = 0;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    float acc[CH][N / 2];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[c][i] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += KC) {
      const uint32_t st = ring_next(q++, total, ring, stage);
      // K-major B: (n, k) rows of 64 bytes, 8-row groups 512 apart
      chunk_products<LD, N, CH, 0>(acc, A, row0, a_col0 + k0, CH, [&](int s, int c) {
        return gmma_desc(st + (col0 + c * N) * 64 + 32 * s, 16, 512, 2);
      });
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = n0 + col0 + c * N + j * 8 + 2 * t;
        const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
        float v0 = acc[c][4 * j] + b0, v1 = acc[c][4 * j + 1] + b1;
        float v2 = acc[c][4 * j + 2] + b0, v3 = acc[c][4 * j + 3] + b1;
        if (RELU) {
          v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
        }
        bf16* op = orow + n0 + c * N + j * 8;
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

// The TPU kernels' cotangent product: the JAX package's ops/pallas/
// fused_field.py `_mm_t` (:207), g @ W^T, every trunk and head dgrad product.
// out[r, oc0 + n] = round(sum_k A[r, a_col0 + k] * Wp[k, n]) for n < n_dim,
// Wp a packed (out, in) matrix read as (k = out) x (n = in): f32
// accumulation, bf16 rounding at the output. ADD: out = round(out +
// round(product)). A and out may be one tile if their column ranges are
// disjoint (each warp reads and writes only its own 16 rows). Wp's (k, n)
// rows stream through the weight ring as they lie in memory, 32 x 128 a
// chunk, and wgmma reads them MN-major (its transpose bit): each warpgroup
// owns 64 rows of the 128-row tile and issues one m64n64k16 a 64-column
// half and k step, skipping the halves past n_dim (n_dim 64 and 320 leave
// one half in their last pass). Starts with a block barrier; the caller
// syncs before reading out.
//
// Bound, shared memory and the ring as gemm's. What it replaces: gemm's
// staging, plus a transpose while staging, 8 scalar 2-byte stores a
// 16-byte load, 16-way bank conflicts each (the 16 lanes with one k wrote
// rows 8 apart, 640 bytes: one bank); the tensor cores now read the
// untransposed chunk.
template <bool ADD>
__device__ void dgemm(const bf16* A, int a_col0, int k_dim, const bf16* __restrict__ Wp,
                      int n_dim, bf16* out, int oc0, bf16* wst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (warp >> 2) * 64 + (warp & 3) * 16;
  bf16* orow = out + (row0 + g) * LDA + oc0 + 2 * t;
  const uint32_t ring = smem_addr(wst);
  const int nk = k_dim / KC, total = (n_dim + NC - 1) / NC * nk;
  auto stage = [&](int s, int q) {
    stage_wp(ring + s * STAGE_BYTES, Wp, n_dim, q / nk * NC, q % nk * KC);
  };
  ring_prologue(total, stage);
  int q = 0;
  for (int n0 = 0; n0 < n_dim; n0 += NC) {
    const int nh = min(NC, n_dim - n0) / 64;   // 64-column halves of this pass
    float acc[2][32];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    for (int k0 = 0; k0 < k_dim; k0 += KC) {
      const uint32_t st = ring_next(q++, total, ring, stage);
      // MN-major B: (k, n) rows of 128 bytes, 8-row groups 1024 apart, the
      // second 64-column half KC * 128 further
      chunk_products<LDA, 64, 2, 1>(acc, A, row0, a_col0 + k0, nh, [&](int s, int h) {
        return gmma_desc(st + h * (KC * 128) + 2048 * s, KC * 128, 1024, 1);
      });
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + h * 64 + j * 8;
        if (col >= n_dim) continue;
        float v0 = bf_round(acc[h][4 * j]), v1 = bf_round(acc[h][4 * j + 1]);
        float v2 = bf_round(acc[h][4 * j + 2]), v3 = bf_round(acc[h][4 * j + 3]);
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

// The weight-gradient product: the JAX package's weight-gradient sums, the
// `outer` contributions (a^T g over a tile's rows, accumulated across the
// sequential grid) of _camera_bwd_kernel and _shadow_bwd_kernel (its
// ops/pallas/fused_render.py:312, :511), of the per-point _field_bwd_kernel
// and _density_bwd_kernel (ops/pallas/fused_field.py:462, :571), and of
// scripts/bench_kernel_variants.py's _bwd_core (:374).
// acc = A^T G over the chunks of a sample range: A (samples x 128 input
// features) and G (samples x 128 output features), both (sample, feature)
// rows as they lie in the backward's streams. Each block owns one 128 x 128
// output tile; warpgroup wg its input rows 64 wg .. 64 wg + 63 (`active`
// false: none of them exists, and it issues no products). acc holds the
// warpgroup's 64 x 128 result in wgmma's accumulator layout (as gemm's, one
// warp's 16 rows: acc[4 j + i] is (row g + 8 (i / 2), column 8 j + 2 t + i %
// 2)).
//
// Staging: stage(s, q) fills stage s (wring + s * WSTAGE_BYTES: A's chunk,
// then G's at + WOP_BYTES) with chunk q, WKC samples of both operands, by
// stage_rows (16-byte cp.async of the rows as they lie, zero-filled past the
// range's end) or its own st.shared; the ring is gemm's schedule, WSTAGES
// deep: copies WSTAGES - 1 chunks ahead, one block barrier a chunk. Both
// chunks are MN-major (feature fastest) with the 128-byte swizzle that
// dgemm's weight chunks have: two 64-feature halves, each sample row 128
// bytes, its unit u at u ^ (sample & 7). The transposes are the tensor
// cores': one wgmma m64n128k16 a warpgroup and 16-sample step, A and B both
// read from the ring through descriptors with their transpose bits set
// (bf16 allows it for A as well as B). Each output element sums its
// range's samples in ascending 16-sample steps, as the mma.sync staging
// this replaces did.
//
// Bound on an H100 SXM: bytes. A tile reads 512 bytes a sample and does
// 2 x 128 x 128 flops on them, 64 flops a byte, under the 295 at which the
// tensor cores (989 TFLOP/s) rather than memory (3.35 TB/s) would bound it;
// so a pass is bounded by reading each stream byte it needs once (the
// camera backward's at 1024 x 128 samples: the 3072 + 2950 bf16 columns its
// products read, 1.58 GB, and its partial sums, 0.48 ms). Shared memory:
// the ring only, WRING_BYTES (3 stages of 2 x 64 x 128 bf16: 98,304
// bytes), dynamic and 1024-byte aligned; nothing else, so two blocks fit
// an SM (the configurations measured are in PERF.md, from
// bench/wgrad_rings.py). What the design does about the old staging's
// costs: it stored both chunks transposed, 8 scalar 2-byte stores a 16-byte
// load with 16-way bank conflicts (the 16 lanes that shared a sample wrote
// rows 640 bytes apart), loaded synchronously between two barriers with
// nothing in flight, and read fragments as 32-bit shared loads for 16
// mma.sync a warp a step. Now 16-byte copies land conflict-free under the
// swizzle with WSTAGES - 1 chunks (64 KB a block) in flight, and the tensor
// cores take both transposes from the ring. The re-reads: the two output
// tiles of a matrix's 128 input features, and the tiles of its 128 output
// features, are neighbours in the grid and read one split's rows at about
// the same time, so the second read of a row finds it in L2.
constexpr int WKC = 64;                             // samples a chunk
constexpr int WSTAGES = 3;                          // chunks in the ring
constexpr int WOP_BYTES = WKC * WG_TILE * 2;        // one operand's chunk
constexpr int WSTAGE_BYTES = 2 * WOP_BYTES;         // A's chunk, then G's
constexpr int WRING_BYTES = WSTAGES * WSTAGE_BYTES;
static_assert(WKC % 16 == 0 && WKC * 16 % THREADS == 0 && WSTAGES >= 2,
              "a chunk is whole 16-sample steps, copied in whole rounds of the block");
static_assert(WOP_BYTES % 1024 == 0, "every chunk starts on a swizzle atom");

// wgmma.mma_async m64n128k16, bf16 -> f32, A and B both from shared memory
// through descriptors; TRANS_A / TRANS_B = 1 reads them MN-major.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

// Byte offset in an operand's chunk of sample row k's 16-byte unit nu (8
// features): half nu / 8, unit nu % 8 swizzled by the row.
__device__ __forceinline__ uint32_t wunit(int k, int nu) {
  return (nu >> 3) * (WKC * 128) + k * 128 + (((nu & 7) ^ (k & 7)) << 4);
}

// One operand's chunk into the ring at dst: rows r0 .. r0 + WKC - 1 of a
// row-major bf16 stream (`src` at the chunk's first column, `stride`
// elements a row), its first ncols (a multiple of 8) of 128 columns. Rows at
// or past rend are zero-filled without a read; the units past ncols are not
// copied (their products land in output rows or columns that are never
// written), so no copy reads past a stream row or past its end.
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* __restrict__ src,
                                           long long stride, long long r0, long long rend,
                                           int ncols) {
#pragma unroll
  for (int i = 0; i < WKC * 16 / THREADS; ++i) {
    const int v = threadIdx.x + i * THREADS, k = v >> 4, nu = v & 15;
    if (nu * 8 < ncols) {
      const bool in = r0 + k < rend;
      cp_async16_zfill(dst + wunit(k, nu), src + (in ? (r0 + k) * stride : 0) + nu * 8,
                       in ? 16 : 0);
    }
  }
}

template <typename Stage>
__device__ void wgemm(float (&acc)[64], int nchunks, bool active, unsigned char* wring,
                      Stage stage) {
  const uint32_t ring = smem_addr(wring);
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  ring_prologue<WSTAGES>(nchunks, stage);
  for (int q = 0; q < nchunks; ++q) {
    const uint32_t st = ring_next<WSTAGES, WSTAGE_BYTES>(q, nchunks, ring, stage);
    if (!active) continue;
    fence_regs(acc);
    wgmma_fence();
    // MN-major A and B: 8-sample groups of 128-byte rows 1024 apart, a
    // 16-sample step 2048; A's 64 rows are one half, B's second 64 columns
    // the half WKC * 128 further
#pragma unroll
    for (int s = 0; s < WKC / 16; ++s)
      wgmma_ss_m64n128<1, 1>(acc, gmma_desc(st + wg * (WKC * 128) + 2048 * s, WKC * 128, 1024, 1),
                             gmma_desc(st + WOP_BYTES + 2048 * s, WKC * 128, 1024, 1));
    wgmma_commit();
    wgmma_wait<0>();   // the next barrier hands this stage to a copy
    fence_regs(acc);
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
