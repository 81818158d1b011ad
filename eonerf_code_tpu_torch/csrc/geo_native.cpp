// Native geo kernels for the port's host-side pipeline.
//
// The reference's performance-critical host code lives in external native
// dependencies: rpcm's per-pixel iterative RPC localization (pure python,
// minutes per scene: reference datasets/satellite.py:65-121 cold path) and
// numba-JIT'd NCC registration loops (dsmr.py). This translation unit
// provides the equivalents as a small C++/OpenMP library with a C ABI,
// loaded through ctypes by eonerf_code_tpu_torch/native/__init__.py. The
// numpy paths (geo/rpc.py::localize, eval/registration.py) stay as the
// reference, and these give their bits (see poly20 and ncc_score).
//
// Build (eonerf_code_tpu_torch/ops/_build.py, GXX_FLAGS):
//   g++ -O3 -fopenmp -shared -fPIC -o <hashed name>.so geo_native.cpp
// No -march=native: with FMA on, g++ contracts the polynomial sums and the
// results leave the numpy path's bits.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 20-term cubic RPC polynomial (term order per sat_utils.py:437-450;
// x = lat_n, y = lon_n, z = alt_n)
// ---------------------------------------------------------------------------

// The sum in geo/rpc.py::apply_poly's association, line by line (each
// line's terms summed first, then added to the total): the numpy path's bits.
// One left-to-right chain of all 20 terms rounds differently and lands up to
// one ulp of the longitude away after the Newton solve (1.4e-14 deg on the
// production scene's pixel grids).
static inline double poly20(const double* p, double x, double y, double z) {
  double out = 0.0;
  out += p[0];
  out += p[1] * y + p[2] * x + p[3] * z;
  out += p[4] * y * x + p[5] * y * z + p[6] * x * z;
  out += p[7] * y * y + p[8] * x * x + p[9] * z * z;
  out += p[10] * x * y * z;
  out += p[11] * y * y * y;
  out += p[12] * y * x * x + p[13] * y * z * z + p[14] * y * y * x;
  out += p[15] * x * x * x;
  out += p[16] * x * z * z + p[17] * y * y * z + p[18] * x * x * z;
  out += p[19] * z * z * z;
  return out;
}

static inline void poly20_grad(const double* p, double x, double y, double z,
                               double* dx, double* dy) {
  *dx = p[2] + p[4] * y + p[6] * z + 2 * p[8] * x + p[10] * y * z +
        2 * p[12] * y * x + p[14] * y * y + 3 * p[15] * x * x + p[16] * z * z +
        2 * p[18] * x * z;
  *dy = p[1] + p[4] * x + p[5] * z + 2 * p[7] * y + p[10] * x * z +
        3 * p[11] * y * y + p[12] * x * x + p[13] * z * z + 2 * p[14] * y * x +
        2 * p[17] * y * z;
}

struct RpcCoeffs {
  double row_offset, col_offset, lat_offset, lon_offset, alt_offset;
  double row_scale, col_scale, lat_scale, lon_scale, alt_scale;
  double row_num[20], row_den[20], col_num[20], col_den[20];
};

// Batch Newton inverse localization: (col, row, alt) -> (lon, lat).
// Mirrors geo/rpc.py::localize (fixed iteration count).
void rpc_localize_batch(const RpcCoeffs* c, const double* cols,
                        const double* rows, const double* alts, int64_t n,
                        int iters, double* lons, double* lats) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double ncol = (cols[i] - c->col_offset) / c->col_scale;
    const double nrow = (rows[i] - c->row_offset) / c->row_scale;
    const double nalt = (alts[i] - c->alt_offset) / c->alt_scale;
    double x = 0.0, y = 0.0;  // lat_n, lon_n
    for (int it = 0; it < iters; ++it) {
      const double cn = poly20(c->col_num, x, y, nalt);
      const double cd = poly20(c->col_den, x, y, nalt);
      const double rn = poly20(c->row_num, x, y, nalt);
      const double rd = poly20(c->row_den, x, y, nalt);
      const double fc = cn / cd - ncol;
      const double fr = rn / rd - nrow;
      double cnx, cny, cdx, cdy, rnx, rny, rdx, rdy;
      poly20_grad(c->col_num, x, y, nalt, &cnx, &cny);
      poly20_grad(c->col_den, x, y, nalt, &cdx, &cdy);
      poly20_grad(c->row_num, x, y, nalt, &rnx, &rny);
      poly20_grad(c->row_den, x, y, nalt, &rdx, &rdy);
      const double inv_cd2 = 1.0 / (cd * cd);
      const double inv_rd2 = 1.0 / (rd * rd);
      const double jcx = (cnx * cd - cn * cdx) * inv_cd2;
      const double jcy = (cny * cd - cn * cdy) * inv_cd2;
      const double jrx = (rnx * rd - rn * rdx) * inv_rd2;
      const double jry = (rny * rd - rn * rdy) * inv_rd2;
      const double inv_det = 1.0 / (jcx * jry - jcy * jrx);
      x -= inv_det * (jry * fc - jcy * fr);
      y -= inv_det * (-jrx * fc + jcx * fr);
    }
    lats[i] = x * c->lat_scale + c->lat_offset;
    lons[i] = y * c->lon_scale + c->lon_offset;
  }
}

// Batch forward projection: (lon, lat, alt) -> (col, row).
void rpc_project_batch(const RpcCoeffs* c, const double* lons,
                       const double* lats, const double* alts, int64_t n,
                       double* cols, double* rows) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const double y = (lons[i] - c->lon_offset) / c->lon_scale;
    const double x = (lats[i] - c->lat_offset) / c->lat_scale;
    const double z = (alts[i] - c->alt_offset) / c->alt_scale;
    const double col =
        poly20(c->col_num, x, y, z) / poly20(c->col_den, x, y, z);
    const double row =
        poly20(c->row_num, x, y, z) / poly20(c->row_den, x, y, z);
    cols[i] = col * c->col_scale + c->col_offset;
    rows[i] = row * c->row_scale + c->row_offset;
  }
}

// ---------------------------------------------------------------------------
// NaN-aware NCC shift search (dsmr.py:50-117 semantics): for each candidate
// (dx, dy) in [initdx-irange, initdx+irange] x [initdy-...], compute masked
// NCC of u[j, i] vs v[j+dy, i+dx]; return the first maximum scanning y-major
// (the reference tie-break order).
//
// Each score is eval/registration.py::ncc's float64 arithmetic step for
// step (the jointly finite pixels gathered row-major, numpy's means, the
// deviations, the products), so near-tied candidates order as they do on
// the numpy path and the search returns its shift. A one-pass sum of the
// raw moments rounds differently and can pick another of two tied shifts.
// ---------------------------------------------------------------------------

// numpy's float64 add.reduce of a contiguous array, within one buffer: the
// pairwise sum (8 accumulators up to 128 elements, halves above).
static double np_pairwise(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.;
    for (int64_t i = 0; i < n; ++i) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int64_t i = 8;
    for (; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; ++i) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return np_pairwise(a, n2) + np_pairwise(a + n2, n - n2);
}

// numpy's mean of a contiguous float64 array: the pairwise sums of its
// 8192-element buffers added in order, over the count.
static double np_mean(const double* a, int64_t n) {
  double s = 0.;
  for (int64_t i = 0; i < n; i += 8192) s += np_pairwise(a + i, n - i < 8192 ? n - i : 8192);
  return s / static_cast<double>(n);
}

// ncc(u, v, dx, dy): -inf where the overlap is empty, has no jointly finite
// pixel, or a flat side. `buf` holds 3 * h * w doubles.
static double ncc_score(const double* u, const double* v, int64_t h, int64_t w, int dx,
                        int dy, double* buf) {
  const double none = -std::numeric_limits<double>::infinity();
  const int64_t j0 = dy < 0 ? -dy : 0, j1 = h - dy < h ? h - dy : h;
  const int64_t i0 = dx < 0 ? -dx : 0, i1 = w - dx < w ? w - dx : w;
  if (j1 <= j0 || i1 <= i0) return none;
  double* a = buf;
  double* b = buf + h * w;
  double* t = buf + 2 * h * w;
  int64_t n = 0;
  for (int64_t j = j0; j < j1; ++j) {
    const double* urow = u + j * w;
    const double* vrow = v + (j + dy) * w + dx;
    for (int64_t i = i0; i < i1; ++i) {
      if (std::isfinite(urow[i]) && std::isfinite(vrow[i])) {
        a[n] = urow[i];
        b[n] = vrow[i];
        ++n;
      }
    }
  }
  if (n == 0) return none;
  const double mu = np_mean(a, n), mv = np_mean(b, n);
  for (int64_t k = 0; k < n; ++k) {
    a[k] -= mu;
    b[k] -= mv;
  }
  for (int64_t k = 0; k < n; ++k) t[k] = a[k] * a[k];
  const double sigu = std::sqrt(np_mean(t, n));
  for (int64_t k = 0; k < n; ++k) t[k] = b[k] * b[k];
  const double sigv = std::sqrt(np_mean(t, n));
  for (int64_t k = 0; k < n; ++k) t[k] = a[k] * b[k];
  const double xc = np_mean(t, n);
  const double denom = sigu * sigv;
  return denom > 0 ? xc / denom : none;
}

void ncc_search(const double* u, const double* v, int64_t h, int64_t w,
                int irange, int initdx, int initdy, int* best_dx,
                int* best_dy) {
  const int span = 2 * irange + 1;
  double best = -std::numeric_limits<double>::infinity();
  int bx = initdx, by = initdy;
  // parallelize over candidate shifts; reduce with the y-major-first rule
  std::vector<double> scores(static_cast<size_t>(span) * span);
#pragma omp parallel
  {
    std::vector<double> buf(static_cast<size_t>(3 * h * w));
#pragma omp for collapse(2) schedule(static)
    for (int yy = 0; yy < span; ++yy)
      for (int xx = 0; xx < span; ++xx)
        scores[yy * span + xx] = ncc_score(u, v, h, w, initdx - irange + xx,
                                           initdy - irange + yy, buf.data());
  }
  for (int yy = 0; yy < span; ++yy)
    for (int xx = 0; xx < span; ++xx)
      if (scores[yy * span + xx] > best) {
        best = scores[yy * span + xx];
        by = initdy - irange + yy;
        bx = initdx - irange + xx;
      }
  *best_dx = bx;
  *best_dy = by;
}

// NaN-aware 2x block-mean downsample (dsmr.py:16-46), single channel.
void downsample2x(const double* u, int64_t h, int64_t w, double* out) {
  const int64_t oh = (h + 1) / 2, ow = (w + 1) / 2;
#pragma omp parallel for schedule(static)
  for (int64_t j = 0; j < oh; ++j) {
    for (int64_t i = 0; i < ow; ++i) {
      double s = 0;
      int c = 0;
      for (int dj = 0; dj < 2; ++dj)
        for (int di = 0; di < 2; ++di) {
          const int64_t jj = 2 * j + dj, ii = 2 * i + di;
          if (jj < h && ii < w) {
            const double t = u[jj * w + ii];
            if (std::isfinite(t)) { s += t; ++c; }
          }
        }
      out[j * ow + i] = c > 0 ? s / c : std::numeric_limits<double>::quiet_NaN();
    }
  }
}

}  // extern "C"
