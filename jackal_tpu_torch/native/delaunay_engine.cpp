// First-party Delaunay triangulator for the ELAS prior stage.
//
// Replaces the round-1 scipy/Qhull delegation (the last third-party
// dependency on the prior path). Reference behavior being reproduced:
// computeDelaunayTriangulation (elas.cpp:445-505) calls Shewchuk's
// "triangle" with switches "zQB" — divide-and-conquer Delaunay with
// alternating cuts (Dwyer's algorithm) and exact arithmetic predicates.
//
// This is a fresh implementation of the published Guibas–Stolfi
// divide-and-conquer algorithm (Guibas & Stolfi 1985) with Dwyer's
// alternating-cuts refinement (Dwyer 1987) — the same algorithms Shewchuk's
// code implements — on the quad-edge data structure. ELAS support-point
// coordinates are always small integers (u, v and u-d of grid-aligned
// support candidates), so the orient2d / incircle predicates are computed
// EXACTLY in 64/128-bit integer arithmetic: no epsilons, no adaptive
// floating point needed. Co-circular ties resolve by the same strict
// (`> 0`) tests as the reference; agreement with the reference triangulator
// on its degenerate support lattices is validated against golden fixtures
// generated from a standalone build of it (tests/test_delaunay.py).
//
// Quad-edge primer: a quad-edge q owns 4 directed edge slots q*4+r; r=0 is
// the primal edge, r=2 its reverse; r=1,3 are the duals, kept only because
// splice() routes through them. onext[] is the single connectivity array.
//
// Handle conventions (Guibas–Stolfi):
//   le: hull edge POINTING CCW around the hull, org = lexicographic MIN
//   re: hull edge POINTING CW  around the hull, org = lexicographic MAX
// CCW-pointing hull edges all have the outer face on their right, so
// rprev() cycles exactly the ccw hull ring — which makes re-homing handles
// after an alternate-axis child recursion a simple full-ring walk.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

typedef __int128 int128;

struct Ctx {
  std::vector<int64_t> px, py;   // deduped working coords
  std::vector<int32_t> orig;     // working index -> original input index
  std::vector<int32_t> nxt;      // onext, per directed edge slot
  std::vector<int32_t> org_;     // origin vertex per slot (-1 for duals)
  std::vector<int32_t> freeq;    // recycled quad ids
  // packed per-axis comparison keys (see make_keys): one int64 load per
  // compare instead of two coordinate loads + a tie branch
  std::vector<int64_t> kless[2], kmin[2], kmax[2];
  bool small = false;            // |coords| <= kSmall: int64 incircle fits

  static constexpr int64_t kSmall = 8192;  // 192*S^4 < 2^63 headroom

  // key = (A + 2^24) << 26 | encode(B): strictly order-preserving for
  // (A asc, then B asc/desc) — coords are bounded by +-2^24 at parse,
  // so A+2^24 < 2^25 and both B encodings stay inside 26 bits.
  void make_keys(int cfg) {
    int n = (int)px.size();
    for (int axis = 0; axis < 2; ++axis) {
      const int64_t* A = axis ? py.data() : px.data();
      const int64_t* B = axis ? px.data() : py.data();
      kless[axis].resize(n);
      kmin[axis].resize(n);
      kmax[axis].resize(n);
      const int64_t OFF = (int64_t)1 << 25;
      bool asc_less = !(cfg & 1);
      bool desc_min = (cfg & 2) != 0;   // min_better tie: B desc
      bool asc_max = (cfg & 4) != 0;    // max_better tie: B asc
      for (int i = 0; i < n; ++i) {
        int64_t hi = (A[i] + ((int64_t)1 << 24)) << 26;
        int64_t basc = hi | (B[i] + OFF);
        int64_t bdesc = hi | (OFF - B[i]);
        kless[axis][i] = asc_less ? basc : bdesc;
        kmin[axis][i] = desc_min ? bdesc : basc;
        // max_better(a,b) <=> kmax[a] > kmax[b]: A desc primary, so the
        // encoding keeps A asc and the caller compares with >
        kmax[axis][i] = asc_max ? bdesc : basc;
      }
    }
  }

  static int32_t rot(int32_t e) { return (e & ~3) | ((e + 1) & 3); }
  static int32_t rotinv(int32_t e) { return (e & ~3) | ((e + 3) & 3); }
  static int32_t sym(int32_t e) { return e ^ 2; }
  int32_t onext(int32_t e) const { return nxt[e]; }
  int32_t oprev(int32_t e) const { return rot(nxt[rot(e)]); }
  int32_t lnext(int32_t e) const { return rot(nxt[rotinv(e)]); }
  int32_t rprev(int32_t e) const { return nxt[sym(e)]; }
  int32_t org(int32_t e) const { return org_[e]; }
  int32_t dest(int32_t e) const { return org_[sym(e)]; }

  int32_t make_edge() {
    int32_t q;
    if (!freeq.empty()) {
      q = freeq.back();
      freeq.pop_back();
    } else {
      q = (int32_t)(nxt.size() / 4);
      nxt.resize(nxt.size() + 4);
      org_.resize(org_.size() + 4);
    }
    int32_t e = q * 4;
    nxt[e] = e;
    nxt[e + 1] = e + 3;
    nxt[e + 2] = e + 2;
    nxt[e + 3] = e + 1;
    org_[e] = org_[e + 1] = org_[e + 2] = org_[e + 3] = -1;
    return e;
  }

  void splice(int32_t a, int32_t b) {
    int32_t alpha = rot(nxt[a]), beta = rot(nxt[b]);
    std::swap(nxt[a], nxt[b]);
    std::swap(nxt[alpha], nxt[beta]);
  }

  int32_t connect(int32_t a, int32_t b) {
    int32_t e = make_edge();
    org_[e] = dest(a);
    org_[sym(e)] = org(b);
    splice(e, lnext(a));
    splice(sym(e), b);
    return e;
  }

  void delete_edge(int32_t e) {
    splice(e, oprev(e));
    splice(sym(e), oprev(sym(e)));
    freeq.push_back(e >> 2);
  }

  // ---- exact predicates (coords are small integers) -------------------
  int64_t orient(int32_t a, int32_t b, int32_t c) const {
    return (px[b] - px[a]) * (py[c] - py[a]) -
           (py[b] - py[a]) * (px[c] - px[a]);
  }
  bool ccw(int32_t a, int32_t b, int32_t c) const {
    return orient(a, b, c) > 0;
  }
  bool right_of(int32_t p, int32_t e) const { return ccw(p, dest(e), org(e)); }
  bool left_of(int32_t p, int32_t e) const { return ccw(p, org(e), dest(e)); }
  // d strictly inside the circumcircle of ccw triangle (a, b, c)
  bool in_circle(int32_t a, int32_t b, int32_t c, int32_t d) const {
    int64_t adx = px[a] - px[d], ady = py[a] - py[d];
    int64_t bdx = px[b] - px[d], bdy = py[b] - py[d];
    int64_t cdx = px[c] - px[d], cdy = py[c] - py[d];
    if (small) {
      // |coords| <= kSmall = 2^13: lifts <= 2^27, crosses <= 2^27,
      // 3-term sum <= 192*2^52 < 2^63 — exact in plain int64 (the common
      // case: ELAS support coordinates are image-sized)
      int64_t alift = adx * adx + ady * ady;
      int64_t blift = bdx * bdx + bdy * bdy;
      int64_t clift = cdx * cdx + cdy * cdy;
      int64_t det = alift * (bdx * cdy - bdy * cdx) +
                    blift * (cdx * ady - cdy * adx) +
                    clift * (adx * bdy - ady * bdx);
      return det > 0;
    }
    int128 alift = (int128)adx * adx + (int128)ady * ady;
    int128 blift = (int128)bdx * bdx + (int128)bdy * bdy;
    int128 clift = (int128)cdx * cdx + (int128)cdy * cdy;
    int128 det = alift * (bdx * cdy - bdy * cdx) +
                 blift * (cdx * ady - cdy * adx) +
                 clift * (adx * bdy - ady * bdx);
    return det > 0;
  }
};

// Comparators for alternating cuts. The reference's vertexmedian partitions
// by coords[axis] with ties broken by coords[1-axis], both ascending; all
// geometry (ccw / in_circle / tangent walks) runs in the PLAIN frame for
// both cut directions — only the partition order and the hull-handle
// extremes change with the axis.
struct Frame {
  const Ctx* c;
  int axis;
  int cfg;  // tie-convention bits, see delaunay_exact_cfg
  // all three orders compare ONE precomputed packed key (Ctx::make_keys);
  // the orders themselves are unchanged from the coordinate forms:
  //   less:       coords[axis] asc, tie coords[1-axis] asc/desc (cfg&1)
  //   min_better: coords[axis] asc, tie per cfg&2
  //   max_better: coords[axis] desc, tie per cfg&4
  bool less(int32_t a, int32_t b) const {
    return c->kless[axis][a] < c->kless[axis][b];
  }
  bool min_better(int32_t a, int32_t b) const {
    return c->kmin[axis][a] < c->kmin[axis][b];
  }
  bool max_better(int32_t a, int32_t b) const {
    return c->kmax[axis][a] > c->kmax[axis][b];
  }
};

struct DC {
  Ctx& c;
  bool alternate;  // Dwyer alternating cuts (the reference default)
  int cfg;         // tie conventions (see delaunay_exact_cfg)

  // Walk the full ccw hull ring from any ccw-pointing hull edge and return
  // the frame-f handles: le (org = f-min, ccw) and re (org = f-max, cw).
  void rehome(int32_t e, const Frame& f, int32_t* le, int32_t* re) const {
    int32_t best_min = e;       // ccw edge with extreme-min org
    int32_t best_into_max = e;  // ccw edge with extreme-max dest
    int32_t cur = c.rprev(e);
    for (; cur != e; cur = c.rprev(cur)) {
      if (f.min_better(c.org(cur), c.org(best_min))) best_min = cur;
      if (f.max_better(c.dest(cur), c.dest(best_into_max)))
        best_into_max = cur;
    }
    *le = best_min;
    *re = Ctx::sym(best_into_max);
  }

  void triangulate(int32_t* idx, int n, int axis, int32_t* le, int32_t* re) {
    Frame f{&c, axis, cfg};
    if (n <= 3 && !(cfg & 8)) {
      // base-case subsets are always sorted by x (the reference's
      // alternateaxes forces axis 0 for arraysize <= 3)
      Frame f0{&c, 0, cfg};
      std::sort(idx, idx + n,
                [&](int32_t a, int32_t b) { return f0.less(a, b); });
    } else if (n <= 3) {
      std::sort(idx, idx + n,
                [&](int32_t a, int32_t b) { return f.less(a, b); });
    } else {
      // Internal nodes only need the PARTITION, not the full order: the
      // comparator is a total order on the deduped points, so
      // nth_element's halves are exactly the sorted halves (children
      // re-order their own subsets). Replaces the per-level full sort —
      // O(n) per level instead of O(n log n), the dominant cost at
      // support-set sizes.
      std::nth_element(idx, idx + n / 2, idx + n,
                       [&](int32_t a, int32_t b) { return f.less(a, b); });
    }
    if (n == 2) {
      int32_t a = c.make_edge();
      c.org_[a] = idx[0];
      c.org_[Ctx::sym(a)] = idx[1];
      *le = a;
      *re = Ctx::sym(a);
      return;
    }
    if (n == 3) {
      int32_t a = c.make_edge(), b = c.make_edge();
      c.splice(Ctx::sym(a), b);
      c.org_[a] = idx[0];
      c.org_[Ctx::sym(a)] = idx[1];
      c.org_[b] = idx[1];
      c.org_[Ctx::sym(b)] = idx[2];
      int64_t o = c.orient(idx[0], idx[1], idx[2]);
      if (o > 0) {
        c.connect(b, a);
        *le = a;
        *re = Ctx::sym(b);
      } else if (o < 0) {
        int32_t cc = c.connect(b, a);
        *le = Ctx::sym(cc);
        *re = cc;
      } else {  // collinear: a chain, no triangle
        *le = a;
        *re = Ctx::sym(b);
      }
      return;
    }
    int half = n / 2;
    int child_axis = alternate ? 1 - axis : axis;
    int32_t ldo, ldi, rdi, rdo;
    triangulate(idx, half, child_axis, &ldo, &ldi);
    triangulate(idx + half, n - half, child_axis, &rdi, &rdo);

    // Re-home the four handles into THIS frame. Children used a different
    // frame under alternating cuts; even same-frame handles are cheap to
    // re-derive, and the ring walk is O(hull).
    int32_t tmp;
    rehome(ldo, f, &ldo, &ldi);          // ldo stays ccw@min; ldi = cw@max
    rehome(Ctx::sym(rdo), f, &rdi, &tmp);  // any ccw hull edge of the right
    rdo = tmp;                             // half seeds the same walk

    // lower common tangent (Guibas & Stolfi, Lemma 9.2 walk)
    for (;;) {
      if (c.left_of(c.org(rdi), ldi)) {
        ldi = c.lnext(ldi);
      } else if (c.right_of(c.org(ldi), rdi)) {
        rdi = c.rprev(rdi);
      } else {
        break;
      }
    }
    int32_t basel = c.connect(Ctx::sym(rdi), ldi);
    if (c.org(ldi) == c.org(ldo)) ldo = Ctx::sym(basel);
    if (c.org(rdi) == c.org(rdo)) rdo = basel;

    // rising-bubble merge; all incircle/ccw tests STRICT, so co-circular
    // ties keep the earlier candidate — the reference's tie behavior
    for (;;) {
      int32_t lcand = c.onext(Ctx::sym(basel));
      if (c.right_of(c.dest(lcand), basel)) {
        while (c.in_circle(c.dest(basel), c.org(basel), c.dest(lcand),
                           c.dest(c.onext(lcand)))) {
          int32_t t = c.onext(lcand);
          c.delete_edge(lcand);
          lcand = t;
        }
      }
      int32_t rcand = c.oprev(basel);
      if (c.right_of(c.dest(rcand), basel)) {
        while (c.in_circle(c.dest(basel), c.org(basel), c.dest(rcand),
                           c.dest(c.oprev(rcand)))) {
          int32_t t = c.oprev(rcand);
          c.delete_edge(rcand);
          rcand = t;
        }
      }
      bool lvalid = c.right_of(c.dest(lcand), basel);
      bool rvalid = c.right_of(c.dest(rcand), basel);
      if (!lvalid && !rvalid) break;
      if (!lvalid ||
          (rvalid && c.in_circle(c.dest(lcand), c.org(lcand), c.org(rcand),
                                 c.dest(rcand)))) {
        basel = c.connect(rcand, Ctx::sym(basel));
      } else {
        basel = c.connect(Ctx::sym(basel), Ctx::sym(lcand));
      }
    }
    *le = ldo;
    *re = rdo;
  }
};

}  // namespace

extern "C" {

// points: n pairs of float32 (x, y) — must be exactly integral (ELAS
// support coordinates always are; non-integral input returns -1 and the
// caller falls back to its floating-point path). tri_out: caller-allocated
// [max_tri*3] int32 triangle corner indices into the ORIGINAL point array
// (duplicate points are merged onto the lowest original index, matching
// "z"-numbered reference output which never references the duplicate).
// alternate: 1 = alternating cuts (the reference default), 0 = vertical
// cuts only (reference "-l"). Returns the triangle count or -1 on error.
int delaunay_exact_cfg(const float* points, int n, int32_t* tri_out,
                       int max_tri, int alternate, int cfg) {
  if (n < 3) return 0;
  // arena reuse across calls: the triangulator runs per frame per side,
  // so the working vectors are hot — clear() keeps their capacity
  static thread_local Ctx w;
  w.px.clear(); w.py.clear(); w.orig.clear();
  w.nxt.clear(); w.org_.clear(); w.freeq.clear();
  // dedup pre-sort on one packed key per point: (x asc, y asc, idx asc)
  // — ((x+2^24)<<26 | y+2^25) is order-preserving for the coord pair and
  // equal exactly for duplicates, which the idx payload then orders
  static thread_local std::vector<std::pair<int64_t, int32_t>> order;
  order.clear();
  order.reserve(n);
  int64_t amax = 0;
  for (int i = 0; i < n; i++) {
    float x = points[2 * i], y = points[2 * i + 1];
    int64_t xi = (int64_t)x, yi = (int64_t)y;
    if ((float)xi != x || (float)yi != y) return -1;
    if (xi < -(1 << 24) || xi > (1 << 24) || yi < -(1 << 24) ||
        yi > (1 << 24))
      return -1;
    amax = std::max(amax, std::max(std::abs(xi), std::abs(yi)));
    order.emplace_back(((xi + ((int64_t)1 << 24)) << 26) |
                           (yi + ((int64_t)1 << 25)),
                       i);
  }
  std::sort(order.begin(), order.end());
  for (int i = 0; i < n; i++) {
    if (i > 0 && order[i].first == order[i - 1].first)
      continue;  // duplicate coords: keep the lowest original index
    int32_t o = order[i].second;
    int64_t key = order[i].first;
    w.px.push_back((key >> 26) - ((int64_t)1 << 24));
    w.py.push_back((key & (((int64_t)1 << 26) - 1)) - ((int64_t)1 << 25));
    w.orig.push_back(o);
  }
  int m = (int)w.px.size();
  if (m < 3) return 0;
  w.small = amax <= Ctx::kSmall;
  w.make_keys(cfg);
  w.nxt.reserve((size_t)m * 12);
  w.org_.reserve((size_t)m * 12);
  static thread_local std::vector<int32_t> idx;
  idx.resize(m);
  for (int i = 0; i < m; i++) idx[i] = i;

  DC dc{w, alternate != 0, cfg};
  int32_t le, re;
  dc.triangulate(idx.data(), m, 0, &le, &re);

  // enumerate interior (ccw) left faces of live primal edge slots
  int nt = 0;
  int total_slots = (int)w.nxt.size();
  std::vector<uint8_t> seen(total_slots, 0);
  std::vector<uint8_t> dead(total_slots / 4, 0);
  for (int32_t q : w.freeq) dead[q] = 1;
  for (int32_t e = 0; e < total_slots; e++) {
    if ((e & 1) || dead[e >> 2] || seen[e]) continue;
    int32_t a = e, b = w.lnext(a), cc = w.lnext(b);
    if (w.lnext(cc) != a) continue;
    if (!w.ccw(w.org(a), w.org(b), w.org(cc))) continue;
    seen[a] = seen[b] = seen[cc] = 1;
    if (nt >= max_tri) return -1;
    tri_out[3 * nt + 0] = w.orig[w.org(a)];
    tri_out[3 * nt + 1] = w.orig[w.org(b)];
    tri_out[3 * nt + 2] = w.orig[w.org(cc)];
    nt++;
  }
  return nt;
}

// Stable entry: the tie conventions that reproduce the reference
// triangulator on the golden fixtures (tests/test_delaunay.py).
int delaunay_exact(const float* points, int n, int32_t* tri_out,
                   int max_tri, int alternate) {
  return delaunay_exact_cfg(points, n, tri_out, max_tri, alternate, 0);
}

}  // extern "C"
