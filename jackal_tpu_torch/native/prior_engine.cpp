// ELAS host prior engine (native).
//
// The per-frame host work between the two TPU stages — sequential support
// pruning (order-dependent, elas.cpp:153-235 semantics), plane fitting
// (3x3 Gauss-Jordan per triangle, elas.cpp:507-577), exact scanline
// rasterization (elas.cpp:813-904 incl. the corner-sort and uint32-cast
// quirks), candidate-grid OR-diffusion (elas.cpp:579-659 incl. flat-array
// wrap) and the float32 plane evaluation — is irregular pointer work that
// python/numpy does in ~0.5 s/frame. This C++ engine does it in
// milliseconds. Triangulation stays in scipy/Qhull (the triangle lists are
// inputs here).
//
// Exposed via a C ABI for ctypes; no pybind11 dependency.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// sequential support pruning (exact scan-order semantics)
// ---------------------------------------------------------------------------

void prune_support(int16_t* D, int ncv, int ncu,
                   int incon_window, int incon_threshold, int incon_min_sup,
                   int redun_max_dist, int redun_threshold) {
  // removeInconsistentSupportPoints: u outer, v inner, in-place.
  // Neighbor iteration order is free (pure count): clamp the window
  // bounds outside the loops, walk rows contiguously, stop counting at
  // the threshold — ~5x faster than the naive bounds-checked scan on
  // this host, identical result.
  for (int u = 0; u < ncu; ++u) {
    int u0 = std::max(u - incon_window, 0);
    int u1 = std::min(u + incon_window, ncu - 1);
    for (int v = 0; v < ncv; ++v) {
      int16_t d = D[v * ncu + u];
      if (d < 0) continue;
      int v0 = std::max(v - incon_window, 0);
      int v1 = std::min(v + incon_window, ncv - 1);
      int support = 0;
      for (int v2 = v0; v2 <= v1 && support < incon_min_sup; ++v2) {
        const int16_t* row = D + v2 * ncu;
        for (int u2 = u0; u2 <= u1; ++u2) {
          int16_t d2 = row[u2];
          if (d2 >= 0 && std::abs(d - d2) <= incon_threshold) ++support;
        }
      }
      if (support < incon_min_sup) D[v * ncu + u] = -1;
    }
  }
  // removeRedundantSupportPoints: vertical then horizontal
  for (int pass = 0; pass < 2; ++pass) {
    int du[2] = {0, 0}, dv[2] = {0, 0};
    if (pass == 0) { dv[0] = -1; dv[1] = 1; }
    else           { du[0] = -1; du[1] = 1; }
    for (int u = 0; u < ncu; ++u) {
      for (int v = 0; v < ncv; ++v) {
        int16_t d = D[v * ncu + u];
        if (d < 0) continue;
        bool redundant = true;
        for (int i = 0; i < 2; ++i) {
          bool support = false;
          int u2 = u, v2 = v;
          for (int j = 0; j < redun_max_dist; ++j) {
            u2 += du[i]; v2 += dv[i];
            if (u2 < 0 || v2 < 0 || u2 >= ncu || v2 >= ncv) break;
            int16_t d2 = D[v2 * ncu + u2];
            if (d2 >= 0 && std::abs(d - d2) <= redun_threshold) {
              support = true;
              break;
            }
          }
          if (!support) { redundant = false; break; }
        }
        if (redundant) D[v * ncu + u] = -1;
      }
    }
  }
}

// collect (u, v, d) triples in reference order (u_can outer, from index 1)
int collect_support(const int16_t* D, int ncv, int ncu, int step,
                    int32_t* out /* [max*3] */, int max_out) {
  int n = 0;
  for (int u = 1; u < ncu; ++u) {
    for (int v = 1; v < ncv; ++v) {
      int16_t d = D[v * ncu + u];
      if (d >= 0 && n < max_out) {
        out[n * 3 + 0] = u * step;
        out[n * 3 + 1] = v * step;
        out[n * 3 + 2] = d;
        ++n;
      }
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// plane fitting: 3x3 Gauss-Jordan with full pivoting (matrix.cpp:414-502)
// ---------------------------------------------------------------------------

static bool solve3(double A[3][3], double b[3]) {
  int idx[3] = {0, 1, 2};
  for (int k = 0; k < 3; ++k) {
    // full pivot
    int pr = k, pc = k;
    double best = 0.0;
    for (int i = k; i < 3; ++i)
      for (int j = k; j < 3; ++j)
        if (std::fabs(A[i][j]) > best) { best = std::fabs(A[i][j]); pr = i; pc = j; }
    if (best < 1e-20) return false;
    if (pr != k) {
      for (int j = 0; j < 3; ++j) std::swap(A[pr][j], A[k][j]);
      std::swap(b[pr], b[k]);
    }
    if (pc != k) {
      for (int i = 0; i < 3; ++i) std::swap(A[i][pc], A[i][k]);
      std::swap(idx[pc], idx[k]);
    }
    double piv = A[k][k];
    for (int j = 0; j < 3; ++j) A[k][j] /= piv;
    b[k] /= piv;
    for (int i = 0; i < 3; ++i) {
      if (i == k) continue;
      double f = A[i][k];
      for (int j = 0; j < 3; ++j) A[i][j] -= f * A[k][j];
      b[i] -= f * b[k];
    }
  }
  double out[3];
  for (int k = 0; k < 3; ++k) out[idx[k]] = b[k];
  for (int k = 0; k < 3; ++k) b[k] = out[k];
  return true;
}

void fit_planes(const int32_t* support /* [n*3] */, int n,
                const int32_t* tri /* [t*3] */, int t,
                float* planes /* [t*6] */) {
  for (int i = 0; i < t; ++i) {
    int c[3] = {tri[i * 3], tri[i * 3 + 1], tri[i * 3 + 2]};
    for (int right = 0; right < 2; ++right) {
      double A[3][3], b[3];
      for (int k = 0; k < 3; ++k) {
        double u = support[c[k] * 3 + 0];
        double d = support[c[k] * 3 + 2];
        A[k][0] = right ? u - d : u;
        A[k][1] = support[c[k] * 3 + 1];
        A[k][2] = 1.0;
        b[k] = d;
      }
      float* out = planes + i * 6 + right * 3;
      if (solve3(A, b)) {
        out[0] = (float)b[0]; out[1] = (float)b[1]; out[2] = (float)b[2];
      } else {
        out[0] = out[1] = out[2] = 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// exact scanline rasterization (computeDisparity loop semantics)
// ---------------------------------------------------------------------------

static inline int64_t u32trunc(float x) {
  // (int32_t)(uint32_t)(float) on x86: cvttss2si to int64, wrap to uint32
  int64_t t = (int64_t)x;  // trunc toward zero
  return (int64_t)(uint32_t)t;
}

void rasterize(const int32_t* support, int n,
               const int32_t* tri, int t,
               int width, int height, int right_image,
               int32_t* tri_id /* [h*w], init by callee */) {
  for (int64_t i = 0; i < (int64_t)width * height; ++i) tri_id[i] = -1;
  for (int i = 0; i < t; ++i) {
    int c[3] = {tri[i * 3], tri[i * 3 + 1], tri[i * 3 + 2]};
    float tu[3], tv[3];
    for (int k = 0; k < 3; ++k) {
      float u = (float)support[c[k] * 3 + 0];
      float d = (float)support[c[k] * 3 + 2];
      tu[k] = right_image ? u - d : u;
      tv[k] = (float)support[c[k] * 3 + 1];
    }
    // literal corner sort (elas.cpp:847-854)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < j; ++k)
        if (tu[k] > tu[j]) { std::swap(tu[j], tu[k]); std::swap(tv[j], tv[k]); }
    float A_u = tu[0], A_v = tv[0], B_u = tu[1], B_v = tv[1],
          C_u = tu[2], C_v = tv[2];
    float AB_a = 0, AC_a = 0, BC_a = 0;
    if ((int)A_u != (int)B_u) AB_a = (A_v - B_v) / (A_u - B_u);
    if ((int)A_u != (int)C_u) AC_a = (A_v - C_v) / (A_u - C_u);
    if ((int)B_u != (int)C_u) BC_a = (B_v - C_v) / (B_u - C_u);
    float AB_b = A_v - AB_a * A_u;
    float AC_b = A_v - AC_a * A_u;
    float BC_b = B_v - BC_a * B_u;

    struct Part { int u0, u1; float a, b; } parts[2] = {
        {(int)A_u, (int)B_u, AB_a, AB_b},
        {(int)B_u, (int)C_u, BC_a, BC_b}};
    for (auto& p : parts) {
      if (p.u0 == p.u1) continue;
      int lo = std::max(p.u0, 0), hi = std::min(p.u1, width);
      for (int u = lo; u < hi; ++u) {
        int64_t v1 = u32trunc(AC_a * (float)u + AC_b);
        int64_t v2 = u32trunc(p.a * (float)u + p.b);
        int64_t vlo = std::min(v1, v2), vhi = std::max(v1, v2);
        vlo = std::max<int64_t>(vlo, 0);
        vhi = std::min<int64_t>(vhi, height);
        for (int64_t v = vlo; v < vhi; ++v) tri_id[v * width + u] = i;
      }
    }
  }
}

// dense per-pixel prior outputs from tri_id + planes
void plane_maps(const int32_t* tri_id, const float* planes, int t,
                int width, int height, int right_image,
                int32_t* d_plane, uint8_t* plane_valid, uint8_t* covered) {
  for (int v = 0; v < height; ++v) {
    for (int u = 0; u < width; ++u) {
      int64_t idx = (int64_t)v * width + u;
      int id = tri_id[idx];
      if (id < 0) {
        d_plane[idx] = 0; plane_valid[idx] = 0; covered[idx] = 0;
        continue;
      }
      const float* p = planes + id * 6;
      float a = right_image ? p[3] : p[0];
      float b = right_image ? p[4] : p[1];
      float c = right_image ? p[5] : p[2];
      float a_other = right_image ? p[0] : p[3];
      d_plane[idx] = (int32_t)(a * (float)u + b * (float)v + c);
      plane_valid[idx] = (std::fabs(a) < 0.7f && std::fabs(a_other) < 0.7f);
      covered[idx] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// candidate grid build + flat 3x3 OR diffusion (createGrid semantics)
// ---------------------------------------------------------------------------

void build_grid(const int32_t* support, int n,
                int width, int height, int right_image,
                int grid_size, int disp_max,
                uint8_t* mask /* [gh*gw*(disp_max+1)] */) {
  int gw = (width + grid_size - 1) / grid_size;
  int gh = (height + grid_size - 1) / grid_size;
  int D = disp_max + 1;
  std::vector<uint8_t> temp1((size_t)gh * gw * D, 0);
  for (int i = 0; i < n; ++i) {
    int u = support[i * 3 + 0];
    int v = support[i * 3 + 1];
    int d = support[i * 3 + 2];
    int dmin = std::max(d - 1, 0), dmax = std::min(d + 1, disp_max);
    int x = right_image
        ? (int)std::floor((float)(u - d) / (float)grid_size)
        : (int)std::floor((float)(u / grid_size));
    int y = (int)std::floor((float)v / (float)grid_size);
    if (x < 0 || x >= gw || y < 0 || y >= gh) continue;
    for (int dd = dmin; dd <= dmax; ++dd)
      temp1[((size_t)y * gw + x) * D + dd] = 1;
  }
  // flat 3x3 OR diffusion with row wrap (elas.cpp:617-632)
  std::memset(mask, 0, (size_t)gh * gw * D);
  size_t ncells = (size_t)gh * gw;
  for (size_t cell = gw + 1; cell + gw + 1 < ncells; ++cell) {
    uint8_t* out = mask + cell * D;
    static const int offs[9] = {0, 1, 2, 0, 1, 2, 0, 1, 2};
    for (int oy = 0; oy < 3; ++oy) {
      for (int ox = 0; ox < 3; ++ox) {
        const uint8_t* in = temp1.data() + (cell - gw - 1 + (size_t)oy * gw + ox) * D;
        for (int dd = 0; dd < D; ++dd) out[dd] |= in[dd];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// speckle removal: exact BFS port of removeSmallSegments (elas.cpp:981-1099)
// ---------------------------------------------------------------------------

void remove_small_segments_native(float* D, int width, int height,
                                  float sim_threshold, int speckle_size) {
  std::vector<int32_t> done((size_t)width * height, 0);
  std::vector<int32_t> seg_u((size_t)width * height);
  std::vector<int32_t> seg_v((size_t)width * height);
  for (int u = 0; u < width; ++u) {
    for (int v = 0; v < height; ++v) {
      int64_t start = (int64_t)v * width + u;
      if (done[start]) continue;
      int count = 1, curr = 0;
      seg_u[0] = u; seg_v[0] = v;
      while (curr < count) {
        int uc = seg_u[curr], vc = seg_v[curr];
        int64_t ac = (int64_t)vc * width + uc;
        const int un[4] = {uc - 1, uc + 1, uc, uc};
        const int vn[4] = {vc, vc, vc - 1, vc + 1};
        for (int i = 0; i < 4; ++i) {
          if (un[i] < 0 || vn[i] < 0 || un[i] >= width || vn[i] >= height)
            continue;
          int64_t an = (int64_t)vn[i] * width + un[i];
          if (!done[an] && D[an] >= 0 &&
              std::fabs(D[ac] - D[an]) <= sim_threshold) {
            seg_u[count] = un[i];
            seg_v[count] = vn[i];
            ++count;
            done[an] = 1;
          }
        }
        ++curr;
        done[ac] = 1;
      }
      if (count < speckle_size) {
        for (int i = 0; i < count; ++i)
          D[(int64_t)seg_v[i] * width + seg_u[i]] = -10.0f;
      }
    }
  }
}

}  // extern "C"
