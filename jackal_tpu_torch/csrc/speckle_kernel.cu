// Kernel L: the ELAS speckle filter (removeSmallSegments, elas.cpp:981-1099)
// on [B, H, W] float32 disparity maps.
//
// Replaces the jitted jnp functions of jackal_tpu/matching/elas/post.py
// (no Pallas kernel): remove_small_segments_batch (l.356),
// remove_small_segments (l.242) and _connected_component_labels (l.129).
// Its plain PyTorch versions are matching/elas/post.py
// remove_small_segments_plain / remove_small_segments_batch_plain and
// _connected_component_labels; this kernel computes the same function,
// bit for bit:
//
//   valid  D >= 0 (NaN invalid, -0.0 valid)
//   edge   4-neighbours p, q both valid with fabsf(D[p] - D[q]) <= t, t the
//          threshold rounded to float32 (as torch compares a Python float
//          with a float32 tensor)
//   label  a pixel's component's least flat index in its frame; an
//          invalid pixel's own index
//   out    -10.0 at a valid pixel whose component holds fewer than
//          speckle_size valid pixels; every other pixel keeps its bits
//
// What bounds it on an H100: bytes. It must read each map once and write
// it once (2.46 MB a 640x480 view). The reference and the plain version
// reach the labels by alternating row and column min-scans until nothing
// changes, with a host read of that flag each round.
//
// Design: ONE cooperative launch of persistent blocks (as many as are
// resident, cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs, at
// most one a 32 x 32 tile; block b takes tiles b, b + grid, ...), whose
// four phases are split by three grid barriers
// (cooperative_groups::this_grid().sync()):
//   (a) tile parts, union-find in shared memory. A pixel's parent is
//       the first pixel of its run along the row (one ballot a warp
//       row). The column joins go as a merge tree of the rows: level v
//       joins blocks of 2^v rows across their boundary rows, a warp a
//       boundary, so no two warps touch one tree; a run pair joins only
//       at the first column of each stretch where the runs touch (a pair
//       whose left neighbours are joined to each other and each to it is
//       skipped). A warp's lanes unite in lockstep, one find step an
//       iteration (lanes that each loop on their own diverge and run one
//       after another). Each run start then finds its root, and each run
//       adds its valid length to the root's count, one shared atomic a
//       run. A part is a border part where a pixel of it lies on a tile
//       edge that has a neighbouring tile. Each pixel's tile label (its
//       root, an invalid flag and, at a root, the border flag and the
//       count) stays in shared memory for the block's first kKeep tiles
//       and spills to a global buffer past them (a batch of more tiles
//       than kKeep x the grid). Only border parts reach the global parent
//       map: the root gets parent = itself and its count, each border
//       pixel parent = its root.
//   (b) border unites: a warp takes a right or lower edge of one of its
//       block's tiles, a lane an edge pixel pair (the near side's root
//       from the tile label, the far side's from the parent map), and
//       unites the two trees in the global parent map, walking both
//       finds together, only where the pair before it along the edge
//       does not already join both sides (shuffles). A unite hangs the
//       larger root under the smaller with atomicMin and retries if
//       another thread moved it first.
//   (c) counts: each border part's root finds its tree's root (halving
//       the path as it goes), stores it as its parent and adds its count
//       (from its tile label) to the root's: one atomicAdd a part.
//   (d) kill: each border part's root finds its root again (a hop or
//       two: other walkers' halving may have stored an ancestor over it)
//       and reads its count into shared memory; every other part's root
//       and count are its tile label's. Each pixel then writes out and
//       its label.
// A parent is never larger than its child, so each component's root is
// its least index, and with integer atomics only the result does not
// depend on the order in which threads run. B * H * W must stay below
// 2^31 (the wrapper checks). The launch is refused, and the call fails,
// where the card cannot hold the grid at once
// (cudaErrorCooperativeLaunchTooLarge); there is no other path.
//
// What the designs before it lost time on. The four-launch design (a
// tile kernel, a thread an edge across a tile border, a full-frame
// flatten, the kill): four dependent launches; the tile kernel united
// every vertically joined pixel pair, all rows at once, so chains grew a
// row deep and the lanes of a row retried on one shared address; a
// full-frame parent and count map was written and flattened where only
// the tile roots needed it. Forms of this one launch measured on the card
// (tools/time_support_kernel.py --kernel speckle; PERF.md, Findings): row
// and column min-passes to a fixed point in shared memory took as many
// passes as a part has turns, each a full pass over the tile; the tile's
// union-find with every row at once kept the row-deep chains; flattening
// every run start after each level cost more than it saved; 16-row tiles
// shortened (a) at B = 1 and lengthened (b) and (c) more at B = 8.
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileW = 32;                    // a row of a tile is a warp
constexpr int kTileH = 32;
constexpr int kLevels = 5;                    // log2(kTileH)
constexpr int kTilePix = kTileW * kTileH;
constexpr int kThreads = 256;                 // 8 warps, 4 rows each
constexpr int kWarps = kThreads / 32;
constexpr int kLines = kTileH / kWarps;
constexpr int kPerThread = kTilePix / kThreads;
constexpr int kKeep = 4;                      // tiles a block keeps on chip
constexpr unsigned kFull = 0xffffffffu;
// a tile label: the pixel's root (its tile part's least local index), an
// invalid flag, and at a root the border flag and its valid count
constexpr uint32_t kRootMask = 0x3ffu;
constexpr uint32_t kInvalid = 1u << 10;
constexpr uint32_t kBorder = 1u << 11;
constexpr int kCountShift = 12;               // 11 bits: at most kTilePix

struct Args {
  const float* D;
  float* out;
  int* labels;      // may be null
  int* parent;      // B * H * W; only border parts' pixels used
  int* count;       // B * H * W; only border parts' roots used
  uint32_t* spill;  // tile labels past a block's kKeep tiles; may be null
  long long* stamps;  // may be null: block 0's clock64 (elas_speckle)
  int B, H, W, tx, ty, tiles;
  float t;
  int size;
};

struct Smem {
  float d[kTilePix];        // the tile's disparities (NaN outside the frame)
  int L[kTilePix];          // (a) parents; (d) border parts' global roots
  int R[kTilePix];          // (a) each run start's root
  int cnt[kTilePix];        // (a) the parts' counts; (d) border roots' counts
  unsigned char border[kTilePix];  // (a) the part touches a tile border
  unsigned rj[kTileH];      // bit j of row y: (y, j) joins (y, j + 1)
  uint32_t keep[kKeep][kTilePix];
};

__device__ __forceinline__ bool valid_of(float d) { return d >= 0.f; }

__device__ __forceinline__ bool joined(float a, float b, float t) {
  return valid_of(a) && valid_of(b) && fabsf(__fsub_rn(a, b)) <= t;
}

// root of x in the tile's forest in shared memory, halving the path: each
// node on the way skips to its grandparent, an ancestor in its tree
__device__ __forceinline__ int find_local(volatile int* parent, int x) {
  while (true) {
    const int p = parent[x];
    if (p == x) return x;
    const int g = parent[p];
    if (g != p) parent[x] = g;
    x = g;
  }
}

// the first lane of lane's run, the runs' breaks given (bit i: lane i
// does not join lane i + 1)
__device__ __forceinline__ int first_of_run(unsigned breaks, int lane) {
  const unsigned below = breaks & ((1u << lane) - 1u);
  return below ? 32 - __clz(static_cast<int>(below)) : 0;
}

// whether tile label w at l is a valid border part's root
__device__ __forceinline__ bool is_border_root(uint32_t w, int l) {
  return (w & (kRootMask | kInvalid)) == static_cast<uint32_t>(l) &&
         (w & kBorder);
}

// the global parent map's loads and stores in the walks: relaxed at the
// card's scope (a volatile access compiles to a system-scope one)
__device__ __forceinline__ int load_gpu(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_gpu(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// the parent map's accesses: shared memory through volatile ones, the
// global map relaxed at the card's scope
struct SharedMap {
  static __device__ __forceinline__ int load(int* p) {
    return *reinterpret_cast<volatile int*>(p);
  }
  static __device__ __forceinline__ void store(int* p, int v) {
    *reinterpret_cast<volatile int*>(p) = v;
  }
};

struct GlobalMap {
  static __device__ __forceinline__ int load(int* p) { return load_gpu(p); }
  static __device__ __forceinline__ void store(int* p, int v) {
    store_gpu(p, v);
  }
};

// every lane of the warp calls it; where active, the lane joins the trees
// of a and b, linking the larger root under the smaller. All lanes step
// together, one step an iteration: both finds move at once (their loads
// in flight together), halving their paths; at two roots the lane links
// with atomicMin and retries if another thread moved the larger root
// first. (Lanes that each loop on their own diverge, and the warp then
// runs them one after another.) Halving sets a node's parent to its
// grandparent, an ancestor in its tree: it keeps every tree whole while
// other threads link, since a link it may overwrite hangs a root whose
// linking thread then unites that root's old tree.
template <class Map>
__device__ __forceinline__ void unite_warp(int* parent, int a, int b,
                                           bool active) {
  while (__any_sync(kFull, active)) {
    if (!active) continue;
    const int pa = Map::load(parent + a), pb = Map::load(parent + b);
    if (pa != a || pb != b) {
      const int ga = Map::load(parent + pa), gb = Map::load(parent + pb);
      if (ga != pa) Map::store(parent + a, ga);
      if (gb != pb) Map::store(parent + b, gb);
      a = ga;
      b = gb;
      continue;
    }
    if (a == b) {
      active = false;
      continue;
    }
    const int lo = min(a, b), hi = max(a, b);
    const int old = atomicMin(parent + hi, lo);
    if (old == hi) {
      active = false;
    } else {
      a = lo;
      b = old;
    }
  }
}

// the roots of x[i] >= 0 (others stay), the walks' loads in flight
// together; with halve, each node on the way skips to its grandparent
template <bool halve>
__device__ __forceinline__ void find_each(int* parent, int (&x)[kPerThread]) {
  while (true) {
    int p[kPerThread];
    bool more = false;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      p[i] = x[i] >= 0 ? load_gpu(parent + x[i]) : x[i];
      more |= p[i] != x[i];
    }
    if (!more) return;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (!halve || p[i] == x[i]) {
        x[i] = p[i];
        continue;
      }
      const int g = load_gpu(parent + p[i]);
      if (g != p[i]) store_gpu(parent + x[i], g);
      x[i] = g;
    }
  }
}

struct Tile {
  int base, y0, x0;   // the frame's first flat index, the tile's origin
  int col, row;       // the tile's place among the frame's tiles
};

__device__ __forceinline__ Tile tile_of(const Args& a, int t) {
  const int per = a.tx * a.ty;
  const int b = t / per, r = t - b * per;
  return Tile{b * a.H * a.W, (r / a.tx) * kTileH, (r % a.tx) * kTileW,
              r % a.tx, r / a.tx};
}

__device__ __forceinline__ int global_of(const Args& a, const Tile& c,
                                         int l) {
  return c.base + (c.y0 + l / kTileW) * a.W + c.x0 + l % kTileW;
}

// the k-th tile of this block keeps its labels in shared memory, later
// ones in the spill buffer
__device__ __forceinline__ uint32_t* labels_of(const Args& a, Smem& s, int k,
                                               int t) {
  return k < kKeep ? s.keep[k]
                   : a.spill + static_cast<int64_t>(
                                   t - kKeep * static_cast<int>(gridDim.x)) *
                                   kTilePix;
}

// (a) one tile: its parts in shared memory, its border parts to global
// memory
__device__ void label_tile(const Args& a, Smem& s, int t, uint32_t* lab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Tile c = tile_of(a, t);
#pragma unroll
  for (int k = 0; k < kLines; ++k) {
    const int ly = warp + k * kWarps, l = ly * kTileW + lane;
    const int y = c.y0 + ly, x = c.x0 + lane;
    // a pixel outside the frame is invalid: it joins nothing
    s.d[l] = (y < a.H && x < a.W) ? a.D[c.base + y * a.W + x]
                                  : __int_as_float(0x7fc00000);
    s.cnt[l] = 0;
    s.border[l] = 0;
  }
  __syncthreads();
  // rows: a pixel's parent is the first pixel of its run along the row
#pragma unroll
  for (int k = 0; k < kLines; ++k) {
    const int ly = warp + k * kWarps, l = ly * kTileW + lane;
    const unsigned rj = __ballot_sync(
        kFull, lane + 1 < kTileW && joined(s.d[l], s.d[l + 1], a.t));
    if (lane == 0) s.rj[ly] = rj;
    s.L[l] = ly * kTileW + first_of_run(~rj, lane);
  }
  __syncthreads();
  // columns, as a merge tree of the rows: level v joins the blocks of 2^v
  // rows pairwise across the row boundaries y = 2^v - 1 + m 2^(v+1), a
  // warp a boundary, so no two warps touch one tree and a tree grows one
  // link a level and by the links of one boundary's unites. A pixel pair
  // joins the runs above and below, skipped where the pair to its left is
  // joined and each of it joined to its pixel of the pair (their unite,
  // or the one it skipped to, already joins both runs).
#pragma unroll 1
  for (int v = 0; v < kLevels; ++v) {
    for (int m = warp; m < (kTileH / 2 >> v); m += kWarps) {
      const int ly = (2 * m + 1) * (1 << v) - 1, l = ly * kTileW + lane;
      const bool j = joined(s.d[l], s.d[l + kTileW], a.t);
      const unsigned left =
          __ballot_sync(kFull, j) & s.rj[ly] & s.rj[ly + 1];
      unite_warp<SharedMap>(s.L, l, l + kTileW,
                            j && !(lane > 0 && ((left >> (lane - 1)) & 1u)));
    }
    __syncthreads();
  }
  // each run start's root (finds that halve may still move other starts'
  // parents, so the roots go to their own array)
#pragma unroll 1
  for (int k = 0; k < kLines; ++k) {
    const int ly = warp + k * kWarps, l = ly * kTileW + lane;
    if (lane == 0 || ((~s.rj[ly] >> (lane - 1)) & 1u))
      s.R[l] = find_local(s.L, l);
  }
  __syncthreads();
  // each run adds its valid length to its root (a run of two or more is
  // valid throughout, one of one may not be); a part is a border part
  // where it touches an edge with a neighbouring tile
#pragma unroll
  for (int k = 0; k < kLines; ++k) {
    const int ly = warp + k * kWarps, l = ly * kTileW + lane;
    if (!valid_of(s.d[l])) continue;
    const unsigned breaks = ~s.rj[ly];              // bit 31 always set
    const int r = s.R[ly * kTileW + first_of_run(breaks, lane)];
    if (lane == 0 || ((breaks >> (lane - 1)) & 1u))
      atomicAdd(&s.cnt[r], __ffs(breaks >> lane));
    if ((ly == 0 && c.row > 0) || (ly == kTileH - 1 && c.row + 1 < a.ty) ||
        (lane == 0 && c.col > 0) || (lane == kTileW - 1 && c.col + 1 < a.tx))
      s.border[r] = 1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kLines; ++k) {
    const int ly = warp + k * kWarps, l = ly * kTileW + lane;
    if (!valid_of(s.d[l])) {                      // and outside the frame
      lab[l] = static_cast<uint32_t>(l) | kInvalid;
      continue;
    }
    const int r = s.R[ly * kTileW + first_of_run(~s.rj[ly], lane)];
    const bool border = s.border[r];
    lab[l] = static_cast<uint32_t>(r) |
             (r == l ? (static_cast<uint32_t>(s.cnt[l]) << kCountShift) |
                           (border ? kBorder : 0u)
                     : 0u);
    if (!border) continue;
    // the tile's order of (row, column) is the frame's flat order, so the
    // tile's least index is the least global index of its part
    const int g = global_of(a, c, l);
    if (r == l) {
      a.parent[g] = g;
      a.count[g] = s.cnt[l];
    } else if (ly == 0 || ly == kTileH - 1 || lane == 0 ||
               lane == kTileW - 1) {
      a.parent[g] = global_of(a, c, r);
    }
  }
  __syncthreads();
}

// (b) the right and lower edges of the block's tiles: warp w takes edge
// w, w + kWarps, ... of 2 a tile (right, then lower), lane i its i-th
// pixel pair (a right edge's kTileH)
__device__ void unite_borders(const Args& a, Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (a.tiles - static_cast<int>(blockIdx.x) +
                     static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x);
  for (int e = warp; e < 2 * tiles; e += kWarps) {
    const int k = e >> 1, t = blockIdx.x + k * gridDim.x;
    const bool right = (e & 1) == 0;
    const Tile c = tile_of(a, t);
    if (right ? c.col + 1 >= a.tx : c.row + 1 >= a.ty) continue;  // uniform
    const uint32_t* lab = labels_of(a, s, k, t);
    // p on this tile's edge, q across it; a right edge has kTileH pairs
    const bool on = !right || lane < kTileH;
    const int l = !on    ? 0
                  : right ? lane * kTileW + kTileW - 1
                          : (kTileH - 1) * kTileW + lane;
    const int y = c.y0 + l / kTileW, x = c.x0 + l % kTileW;
    const bool in = on && y < a.H && x < a.W;
    const int p = c.base + y * a.W + x, q = p + (right ? 1 : a.W);
    const float nan = __int_as_float(0x7fc00000);
    const float dp = in ? a.D[p] : nan, dq = in ? a.D[q] : nan;
    // q's root, where q is valid (its tile wrote it in (a)); p's from the
    // tile label
    const int rq = in ? __ldcg(a.parent + q) : 0;
    const bool j = joined(dp, dq, a.t);
    // the pair before along the edge: joined, and p and q each joined to
    // the pixel before them on their side
    const float dp1 = __shfl_up_sync(kFull, dp, 1);
    const float dq1 = __shfl_up_sync(kFull, dq, 1);
    const bool j1 = __shfl_up_sync(kFull, j, 1);
    const bool skip =
        lane > 0 && j1 && joined(dp1, dp, a.t) && joined(dq1, dq, a.t);
    unite_warp<GlobalMap>(
        a.parent, global_of(a, c, static_cast<int>(lab[l] & kRootMask)), rq,
        j && !skip);
  }
}

__global__ void __launch_bounds__(kThreads)
speckle_kernel(Args a) {
  __shared__ Smem s;
  const cg::grid_group grid = cg::this_grid();
  // block 0's clock at its start, at the end of its work in each phase
  // and at the end of each barrier
  long long* stamps =
      blockIdx.x == 0 && threadIdx.x == 0 ? a.stamps : nullptr;
  if (stamps) stamps[0] = clock64();
  int k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k)
    label_tile(a, s, t, labels_of(a, s, k, t));
  if (stamps) stamps[1] = clock64();
  grid.sync();
  if (stamps) stamps[2] = clock64();
  unite_borders(a, s);
  __syncthreads();
  if (stamps) stamps[3] = clock64();
  grid.sync();
  if (stamps) stamps[4] = clock64();
  // (c) every border part's root: a thread's pixels of a tile at once
  k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const uint32_t* lab = labels_of(a, s, k, t);
    const Tile c = tile_of(a, t);
    int g[kPerThread], root[kPerThread];
    uint32_t w[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int l = threadIdx.x + i * kThreads;
      w[i] = lab[l];
      g[i] = global_of(a, c, l);
      root[i] = is_border_root(w[i], l) ? g[i] : -1;
    }
    find_each<true>(a.parent, root);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (root[i] < 0 || root[i] == g[i]) continue;
      store_gpu(a.parent + g[i], root[i]);
      atomicAdd(&a.count[root[i]], static_cast<int>(w[i] >> kCountShift));
    }
  }
  __syncthreads();
  if (stamps) stamps[5] = clock64();
  grid.sync();
  if (stamps) stamps[6] = clock64();
  // (d) each border part's root and count, then each pixel
  k = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++k) {
    const uint32_t* lab = labels_of(a, s, k, t);
    const Tile c = tile_of(a, t);
    int root[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int l = threadIdx.x + i * kThreads;
      root[i] = is_border_root(lab[l], l) ? global_of(a, c, l) : -1;
    }
    find_each<false>(a.parent, root);
    int n[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      n[i] = root[i] >= 0 ? __ldcg(a.count + root[i]) : 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      if (root[i] < 0) continue;
      s.L[threadIdx.x + i * kThreads] = root[i];
      s.cnt[threadIdx.x + i * kThreads] = n[i];
    }
    __syncthreads();
    float v[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int l = threadIdx.x + i * kThreads;
      const int y = c.y0 + l / kTileW, x = c.x0 + l % kTileW;
      v[i] = y < a.H && x < a.W ? __ldg(a.D + c.base + y * a.W + x) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int l = threadIdx.x + i * kThreads;
      const int y = c.y0 + l / kTileW, x = c.x0 + l % kTileW;
      if (y >= a.H || x >= a.W) continue;
      const int f = y * a.W + x, g = c.base + f;
      const uint32_t w = lab[l];
      int label = f, bits = __float_as_int(v[i]);
      if (!(w & kInvalid)) {
        const int r = static_cast<int>(w & kRootMask);
        const uint32_t wr = lab[r];
        const bool border = wr & kBorder;
        label = (border ? s.L[r] : global_of(a, c, r)) - c.base;
        const int n = border ? s.cnt[r] : static_cast<int>(wr >> kCountShift);
        // the bits move as they are: a NaN keeps its payload, -0.0 its sign
        if (n < a.size) bits = __float_as_int(-10.f);
      }
      reinterpret_cast<int*>(a.out)[g] = bits;
      if (a.labels != nullptr) a.labels[g] = label;
    }
    __syncthreads();
  }
  if (stamps) stamps[7] = clock64();
}

}  // namespace

// The grid kernel L's launch takes for B frames of H x W on the current
// card (*grid blocks, every one resident) and the tile labels that spill
// to global memory (*spill_labels uint32, those of the tiles past kKeep a
// block).
extern "C" int elas_speckle_plan(int B, int H, int W, int* grid,
                                 int* spill_labels) {
  *grid = 0;
  *spill_labels = 0;
  if (B < 1 || H < 1 || W < 1 ||
      static_cast<int64_t>(B) * H * W >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, speckle_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop || per_sm < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int64_t tiles = static_cast<int64_t>(B) *
                        ((W + kTileW - 1) / kTileW) *
                        ((H + kTileH - 1) / kTileH);
  const int64_t cap = static_cast<int64_t>(per_sm) * sms;
  *grid = static_cast<int>(tiles < cap ? tiles : cap);
  const int64_t spill = tiles - static_cast<int64_t>(kKeep) * *grid;
  *spill_labels = static_cast<int>(spill > 0 ? spill * kTilePix : 0);
  return static_cast<int>(cudaSuccess);
}

// D -> out for B frames of H x W; labels (may be null) gets each pixel's
// component label; parent and count are B * H * W int32 scratch, spill
// the plan's spill_labels uint32 (null where that is 0), stamps
// null or 8 int64 (block 0's clock64: its start; the end of its (a) work,
// of barrier 1, of its (b) work, of barrier 2, of its (c) work, of
// barrier 3; its end). grid is elas_speckle_plan's. t is the similarity
// threshold, size speckle_size (after subsampling's rescale). One
// cooperative launch, whatever the shape; *launched counts those queued.
extern "C" int elas_speckle(const float* D, float* out, int* labels,
                            int* parent, int* count, uint32_t* spill,
                            long long* stamps, int B, int H, int W, int grid,
                            float t, int size, int* launched, void* stream) {
  *launched = 0;
  const int64_t n = static_cast<int64_t>(B) * H * W;
  if (B < 1 || H < 1 || W < 1 || n >= INT_MAX || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{D, out, labels, parent, count, spill, stamps, B, H, W,
         (W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, 0, t, size};
  const int64_t tiles = static_cast<int64_t>(B) * a.tx * a.ty;
  a.tiles = static_cast<int>(tiles);
  if (grid > tiles || (tiles > static_cast<int64_t>(kKeep) * grid &&
                       spill == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(speckle_kernel), dim3(grid),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  return static_cast<int>(cudaGetLastError());
}
