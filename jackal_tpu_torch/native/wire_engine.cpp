// Host wire prep for the ELAS device raster: triangle top-row ordering
// (tri_wire) + slab/column-tile binning (slab_select), fused in one pass.
//
// Semantics twin of jackal_tpu/matching/elas/device_prior.py::tri_wire +
// slab_select (see there for the raster contract; reference anchor:
// computeDisparity's triangle rasterization, elas.cpp:813-904). The numpy
// forms cost ~2.4 ms/frame on this 1-core host — the largest host-prior
// stage after Delaunay — and are plain integer bookkeeping; here they are
// two linear passes (~0.05 ms/frame).
//
// Contract notes (matched to the numpy twin, asserted equal in
// tests/test_device_prior.py):
//   - ordering: stable sort of triangles by vmin = min corner image row;
//     paint_out[i] = ORIGINAL index of sorted row i (the raster's
//     winner-takes-last key), exactly np.argsort(vmin, kind="stable").
//   - bin rows: s0 = clip(floordiv(vmin - 1, slab), 0, S-1) (one row of
//     margin below vmin absorbs f32 slope rounding in the device raster),
//     s1 = clip(floordiv(vmax, slab), 0, S-1). Python floor division —
//     NOT C truncation — for negative values.
//   - bin cols: u = support u (right image: u - d) per corner;
//     c0 = clip(floordiv(umin, ctile), 0, C-1),
//     c1 = clip(floordiv(max(umax, 1) - 1, ctile), 0, C-1).
//   - fill order within a tile: ascending sorted-triangle index (the
//     numpy twin's stable argsort over band keys preserves generation
//     order, which is k-major per triangle).
//   - sel entries index the SORTED wire order; empty slots are -1.
//
// Returns the max per-tile count. If it exceeds ts_cap the sel buffer is
// only partially filled and the caller must retry with a larger cap.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {
inline int floordiv(int a, int b) {  // b > 0
  int q = a / b, r = a % b;
  return (r != 0 && r < 0) ? q - 1 : q;
}
inline int clipi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
}  // namespace

extern "C" int tri_wire_and_bin(
    const int16_t* support, int n_support,  // [N, 3] (u, v, d)
    const int32_t* tri, int T,              // [T, 3] vertex indices
    int W, int H, int slab, int ctile, int right, int ts_cap,
    int16_t* tri_out,    // [T, 3] sorted by vmin (stable)
    int16_t* paint_out,  // [T] original index of sorted row
    int16_t* sel_out     // [S*C, ts_cap], -1 padded
) {
  (void)n_support;
  const int S = (H + slab - 1) / slab;
  const int C = (W + ctile - 1) / ctile;
  const int n_tiles = S * C;

  // --- stable counting sort by vmin (vmin in [0, H) for valid support)
  std::vector<int> vmin(T), order(T);
  std::vector<int> hist(H + 2, 0);
  for (int t = 0; t < T; ++t) {
    int v0 = support[3 * tri[3 * t + 0] + 1];
    int v1 = support[3 * tri[3 * t + 1] + 1];
    int v2 = support[3 * tri[3 * t + 2] + 1];
    int m = v0 < v1 ? v0 : v1;
    m = m < v2 ? m : v2;
    m = clipi(m, 0, H);  // support rows are in-image; clamp defensively
    vmin[t] = m;
    hist[m + 1]++;
  }
  for (int i = 0; i < H + 1; ++i) hist[i + 1] += hist[i];
  for (int t = 0; t < T; ++t) order[hist[vmin[t]]++] = t;

  // --- emit sorted wire + per-triangle tile ranges
  std::vector<int> ts0(T), ts1(T), tc0(T), tc1(T);
  std::vector<int> counts(n_tiles, 0);
  for (int i = 0; i < T; ++i) {
    int t = order[i];
    paint_out[i] = (int16_t)t;
    int vmn = 1 << 30, vmx = -(1 << 30);
    int umn = 1 << 30, umx = -(1 << 30);
    for (int k = 0; k < 3; ++k) {
      int idx = tri[3 * t + k];
      tri_out[3 * i + k] = (int16_t)idx;
      int v = support[3 * idx + 1];
      int u = support[3 * idx + 0];
      if (right) u -= support[3 * idx + 2];
      if (v < vmn) vmn = v;
      if (v > vmx) vmx = v;
      if (u < umn) umn = u;
      if (u > umx) umx = u;
    }
    int s0 = clipi(floordiv(vmn - 1, slab), 0, S - 1);
    int s1 = clipi(floordiv(vmx, slab), 0, S - 1);
    int c0 = clipi(floordiv(umn, ctile), 0, C - 1);
    int c1 = clipi(floordiv((umx > 1 ? umx : 1) - 1, ctile), 0, C - 1);
    ts0[i] = s0; ts1[i] = s1; tc0[i] = c0; tc1[i] = c1;
    for (int s = s0; s <= s1; ++s)
      for (int c = c0; c <= c1; ++c) counts[s * C + c]++;
  }
  int max_count = 0;
  for (int b = 0; b < n_tiles; ++b)
    if (counts[b] > max_count) max_count = counts[b];
  if (max_count > ts_cap) return max_count;

  memset(sel_out, 0xff, (size_t)n_tiles * ts_cap * sizeof(int16_t));
  std::vector<int> fill(n_tiles, 0);
  for (int i = 0; i < T; ++i) {
    for (int s = ts0[i]; s <= ts1[i]; ++s)
      for (int c = tc0[i]; c <= tc1[i]; ++c) {
        int b = s * C + c;
        sel_out[(size_t)b * ts_cap + fill[b]++] = (int16_t)i;
      }
  }
  return max_count;
}

// One chunk's flat device wire in a single pass (twin of
// pipeline._flatten_chunk_wire's numpy form, which costs ~0.6 ms/frame in
// small-array overhead on this 1-core host). Layout (all int16, viewed as
// int32 by the caller; every section length is even):
//   [CH, Np, 3]  support triples, padded rows (0, 0, -1)
//   per side:  [CH, Tp, 3] triangles (pad rows 0 0 0 -> support[0] x3),
//              [CH, Tp]    paint (pad -1)
//   per side:  [CH, SC, Ts] slab selections (negatives and pads -> Tp-1)
// Pointer arrays are passed as int64 (ctypes); side-major frame order for
// tri/paint/sel: side0 frame0..CH-1, then side1.
extern "C" void flatten_chunk_wire(
    const int64_t* sp_ptrs, const int32_t* sp_lens,      // [CH]
    const int64_t* tri_ptrs, const int64_t* paint_ptrs,  // [2*CH]
    const int32_t* tri_lens,                             // [2*CH]
    const int64_t* sel_ptrs, const int32_t* sel_ts,      // [2*CH]
    int CH, int Np, int Tp, int Ts, int SC, int16_t* out) {
  int16_t* p = out;
  for (int i = 0; i < CH; ++i) {
    const int16_t* sp = (const int16_t*)(intptr_t)sp_ptrs[i];
    int n = sp_lens[i];
    memcpy(p, sp, (size_t)n * 3 * sizeof(int16_t));
    int16_t* pad = p + (size_t)n * 3;
    for (int r = n; r < Np; ++r) {
      *pad++ = 0;
      *pad++ = 0;
      *pad++ = -1;
    }
    p += (size_t)Np * 3;
  }
  for (int side = 0; side < 2; ++side) {
    const int64_t* tp = tri_ptrs + side * CH;
    const int64_t* pp = paint_ptrs + side * CH;
    const int32_t* tl = tri_lens + side * CH;
    int16_t* tri_base = p;
    int16_t* paint_base = p + (size_t)CH * Tp * 3;
    for (int i = 0; i < CH; ++i) {
      int t = tl[i];
      int16_t* td = tri_base + (size_t)i * Tp * 3;
      memcpy(td, (const int16_t*)(intptr_t)tp[i],
             (size_t)t * 3 * sizeof(int16_t));
      memset(td + (size_t)t * 3, 0, (size_t)(Tp - t) * 3 * sizeof(int16_t));
      int16_t* pd = paint_base + (size_t)i * Tp;
      memcpy(pd, (const int16_t*)(intptr_t)pp[i], (size_t)t * sizeof(int16_t));
      for (int r = t; r < Tp; ++r) pd[r] = -1;
    }
    p = paint_base + (size_t)CH * Tp;
  }
  const int16_t fillv = (int16_t)(Tp - 1);
  for (int side = 0; side < 2; ++side) {
    for (int i = 0; i < CH; ++i) {
      const int16_t* s = (const int16_t*)(intptr_t)sel_ptrs[side * CH + i];
      int ts = sel_ts[side * CH + i];
      for (int r = 0; r < SC; ++r) {
        int16_t* row = p + ((size_t)i * SC + r) * Ts;
        const int16_t* srow = s + (size_t)r * ts;
        for (int c = 0; c < ts; ++c) row[c] = srow[c] < 0 ? fillv : srow[c];
        for (int c = ts; c < Ts; ++c) row[c] = fillv;
      }
    }
    p += (size_t)CH * SC * Ts;
  }
}
