// The int8_full trunk's weight gradient as per-group partials, the design
// that q8_wgrad_kernel's in-kernel sum was measured against. Not part of
// the port: bench/q8_backward.py appends this file to a copy of
// csrc/fused_render.cu (it uses that file's helpers) and times it beside
// the production pass.
//
// A block owns a 64 x 64 tile (input features x output features) of one
// layer's matrix for one group (grid: tiles x groups, two blocks an SM).
// The group's rows run through an 8-stage cp.async ring in 64-row chunks,
// quantized and transposed as q8_wgrad_kernel does into a 64-byte-swizzled
// K-major tile; warpgroup 0 runs wgmma m64n64k32 .s32.s8.s8. The group's
// exact int32 sum, scaled, goes to its M_SIG slice of the partials, which
// q8_wgrad_partials_reduce_kernel sums in group order: the production
// pass's bits.

struct QpGeom {
  static constexpr int KR = 64;
  static constexpr int THREADS = 256;
  static constexpr int STAGES = 8;
  static constexpr int AHEAD = STAGES - 1;
  static constexpr int A_BYTES = KR * QW_T * 2;
  static constexpr int STAGE_BYTES = A_BYTES + QW_T * KR;
  static constexpr int A8_BYTES = QW_T * KR;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * A8_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "every stage starts on a swizzle atom");
  static_assert(SMEM <= 232448 / 2, "two blocks fit an H100 SM's shared memory");
  // byte k of a K-major tile's row n (64-byte rows, wgmma's 64-byte swizzle)
  __device__ static uint32_t at(int n, int k) {
    return (k & 15) + n * 64 + (((k >> 4) ^ ((n >> 1) & 3)) << 4);
  }
  __device__ static uint64_t desc(uint32_t base, int k) { return gmma_desc(base + k, 16, 512, 2); }
};

__global__ void __launch_bounds__(QpGeom::THREADS, 2)
q8_wgrad_partials_kernel(const bf16* __restrict__ acts, long long as,
                         const int8_t* __restrict__ g8t, const float* __restrict__ sw,
                         const float* __restrict__ amax, const float* __restrict__ gamax,
                         float* __restrict__ qwpart, long long group_rows) {
  extern __shared__ __align__(1024) unsigned char smem[];
  using G = QpGeom;
  const uint32_t ring = smem_addr(smem);
  unsigned char* a8s = smem + G::STAGES * G::STAGE_BYTES;
  int layer, m0, n0;
  q8_wgrad_tile(blockIdx.x, layer, m0, n0);
  const int in = q8_in_of(layer);
  const bool pe_src = layer == 0 || m0 >= W;
  const int acol = pe_src ? A_PE + (m0 >= W ? m0 - W : m0) : act_h(layer - 1) + m0;
  const int qpt = pe_src ? 0 : layer;
  const long long gr8 = q8_g8_rows(group_rows), grp = blockIdx.y;
  const int total = (int)(gr8 / G::KR);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  auto stage = [&](int s, int qi) {
    const int k0 = qi * G::KR;
    const uint32_t dst = ring + s * G::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < G::KR * (QW_T * 2 / 16) / G::THREADS; ++i) {
      const int v = tid + i * G::THREADS, r = v >> 3, u = v & 7;
      const bool inr = k0 + r < group_rows;
      cp_async16_zfill(dst + r * (QW_T * 2) + ((u ^ ((r >> 2) & 7)) << 4),
                       acts + (grp * group_rows + k0 + (inr ? r : 0)) * as + acol + u * 8,
                       inr ? 16 : 0);
    }
    const int n = tid / (G::KR / 16), u = tid % (G::KR / 16);
    cp_async16(dst + G::A_BYTES + G::at(n, 16 * u),
               g8t + ((grp * 8 + layer) * W + n0 + n) * gr8 + k0 + u * 16);
  };
  __syncthreads();
#pragma unroll
  for (int q = 0; q < G::AHEAD; ++q) {
    if (q < total) stage(q, q);
    cp_async_commit();
  }
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  const float inv_in = q8_inv(bf_round(__ldg(amax + grp * Q8P + qpt)));
  auto quantize = [&](int qi) {
    const unsigned char* raw = smem + (qi % G::STAGES) * G::STAGE_BYTES;
    unsigned char* a8 = a8s + (qi & 1) * G::A8_BYTES;
    const int sb = tid & 15, fb = tid >> 4, p = fb & 1;   // one 4 x 4 block a thread
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
    uint32_t tr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      tr[i] = __byte_perm(__byte_perm(y[0][i], y[1][i], 0x40),
                          __byte_perm(y[2][i], y[3][i], 0x40), 0x5410);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(a8 + G::at(4 * fb + (j ^ p), 4 * sb)) = p ? tr[j ^ 1] : tr[j];
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  cp_async_wait<G::AHEAD - 1>();
  __syncthreads();
  quantize(0);
  for (int qi = 0; qi < total; ++qi) {
    cp_async_wait<G::AHEAD - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (qi + G::AHEAD < total) stage((qi + G::AHEAD) % G::STAGES, qi + G::AHEAD);
    cp_async_commit();
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
    if (qi + 1 < total) quantize(qi + 1);
    if (warp < 4) {
      wgmma_wait<0>();
      fence_iregs(acc);
    }
  }
  if (warp < 4) {
    const float s_in = __fdiv_rn(1.f, inv_in);
    const float s_g = __fdiv_rn(1.f, q8_inv(__ldg(gamax + grp * Q8P + layer)));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + 2 * t + e;
        const float sc = __fmul_rn(s_in, __fdiv_rn(s_g, __ldg(sw + layer * W + n)));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          qwpart[grp * M_SIG + trunk_offset(layer) + (long long)n * in + m0 + 16 * warp + g +
                 8 * hh] = __fmul_rn(__int2float_rn(acc[4 * j + 2 * hh + e]), sc);
      }
  }
}

// The weight gradients as the partials' sum in group order.
__global__ void q8_wgrad_partials_reduce_kernel(const float* __restrict__ qwpart, int n_groups,
                                                float* __restrict__ dmats) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < M_SIG; e += stride) {
    float s = 0.f;
    for (int g = 0; g < n_groups; ++g) s += qwpart[(long long)g * M_SIG + e];
    dmats[e] = s;
  }
}

extern "C" {

// The weight gradient by per-group partials (qwpart: groups x M_SIG f32)
// on the workspace of an int8_full backward whose recompute and chain ran
// (eonerf_q8_bwd_pass's passes 0 and 1), into dmats; arguments as
// eonerf_q8_bwd_pass's.
int eonerf_q8_wgrad_partials(int camera, void* ws, const float* sw, const float* amax,
                             const float* gamax, float* dmats, float* qwpart, int R, int KPAD,
                             long long group_rows, void* stream, int path) {
  if (!q8_shape_ok(R, KPAD, group_rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  path = q8_path(group_rows, path);
  const long long rows = (long long)R * KPAD;
  const int groups = (int)(rows / group_rows);
  const Scratch sc = carve(ray_bwd_layout(camera != 0, R, KPAD), ws);
  const Q8Layout Q = q8_bwd_layout(camera != 0, true, R, KPAD, group_rows, path);
  const int8_t* g8s = reinterpret_cast<const int8_t*>(static_cast<unsigned char*>(ws) + Q.g8);
  cudaError_t e = cudaFuncSetAttribute(q8_wgrad_partials_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)QpGeom::SMEM);
  if (e != cudaSuccess) return (int)e;
  q8_wgrad_partials_kernel<<<dim3(q8_wgrad_tiles(), groups), QpGeom::THREADS, QpGeom::SMEM, st>>>(
      sc.acts, camera ? ACT_CAM : ACT_SH, g8s, sw, amax, gamax, qwpart, group_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  q8_wgrad_partials_reduce_kernel<<<1024, THREADS, 0, st>>>(qwpart, groups, dmats);
  return (int)cudaGetLastError();
}

}  // extern "C"
