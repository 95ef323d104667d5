// Kernel L: the ELAS speckle filter (removeSmallSegments, elas.cpp:981-1099)
// on [B, H, W] float32 disparity maps.
//
// Replaces the jitted jnp functions of jackal_tpu/matching/elas/post.py
// (no Pallas kernel): _connected_component_labels (l.129),
// remove_small_segments (l.242) and remove_small_segments_batch (l.356).
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
// it once (2.46 MB a 640x480 view); the union-find's scratch, an int32
// parent map and an int32 count map, stays mostly in the 50 MB L2. The
// reference and the plain version reach the labels by alternating row and
// column min-scans until nothing changes, with a host read of that flag
// each round and another of the largest run count (post.py), and the
// sizes by sorts; per frame the port ran the C++ BFS behind a host round
// trip. Design: union-find with a fixed number of launches, four, and no
// host read:
//   (a) tile_union_kernel: a block a 32 x 32 tile of a frame, a warp a
//       row at a time. Each pixel's parent is the start of its run along
//       the row (one ballot), so a row is one hop deep; then each pixel
//       unites with the one below in shared memory, always linking the
//       larger root under the smaller; then each valid pixel adds 1 to
//       its tile root's count in shared memory. It writes each pixel's
//       tile root (as a global index) into the parent map, and the tile
//       part's count at its tile root (0 elsewhere) into the count map;
//   (b) edge_union_kernel: a thread an edge across a tile border unites
//       the two global roots the same way (find both roots; atomicMin the
//       larger root's parent to the smaller; retry until it holds);
//   (c) flatten_count_kernel: each pixel finds its root (halving the path
//       as it goes) and stores it as its parent; each tile root that is
//       not its component's root adds its count to the root's (one
//       atomicAdd a tile part, not a pixel: a component over the frame
//       takes ~300, not 307,200 on one address);
//   (d) kill_kernel: finds each pixel's root again (a step or two) and
//       writes -10 where valid and the root's count < speckle_size.
// A parent is never larger than its child, so each component's root is
// its least index, and with integer atomics only the result does not
// depend on the order in which threads run. B * H * W must stay below
// 2^31 (the wrapper checks). The first design (a pixel at a time in the
// tile, an atomicAdd a valid pixel) walked chains as long as a tile row
// and serialised a frame-wide component's adds on one address.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kTileThreads = 256;             // 32 x 8, 4 rows a thread
constexpr int kRowsPerThread = kTile * kTile / kTileThreads;
constexpr int kThreads = 256;

__device__ __forceinline__ bool valid_of(float d) { return d >= 0.f; }

__device__ __forceinline__ bool joined(float a, float b, float t) {
  return valid_of(a) && valid_of(b) && fabsf(__fsub_rn(a, b)) <= t;
}

// root of x; parents only ever decrease, so the walk ends
__device__ __forceinline__ int find(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// root of x in a forest no thread links any more, halving the path: each
// node on the way skips to its grandparent, an ancestor, so concurrent
// walks stay right
__device__ __forceinline__ int find_halving(int* parent, int x) {
  volatile int* vp = parent;
  while (true) {
    const int p = vp[x];
    if (p == x) return x;
    const int gp = vp[p];
    if (gp != p) vp[x] = gp;
    x = gp;
  }
}

// join the trees of a and b, linking the larger root under the smaller
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  const volatile int* vp = parent;
  while (true) {
    a = find(vp, a);
    b = find(vp, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // b is the larger root: hang it under a, unless someone moved it first
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kTileThreads)
tile_union_kernel(const float* __restrict__ D, int* __restrict__ parent,
                  int* __restrict__ count, int H, int W, int tiles_x,
                  int tiles_y, float t) {
  __shared__ float d[kTile * kTile];
  __shared__ int sp[kTile * kTile];
  __shared__ int scount[kTile * kTile];
  const int tile = blockIdx.x;
  const int b = tile / (tiles_x * tiles_y);
  const int r = tile - b * tiles_x * tiles_y;
  const int y0 = (r / tiles_x) * kTile, x0 = (r % tiles_x) * kTile;
  const int64_t base = static_cast<int64_t>(b) * H * W;
  // a warp takes rows ly0, ly0 + 8, ...; its lane is the column
  const int lx = threadIdx.x % kTile, ly0 = threadIdx.x / kTile;
  constexpr int kStep = kTileThreads / kTile;
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ly0 + k * kStep;
    const int l = ly * kTile + lx;
    const int y = y0 + ly, x = x0 + lx;
    // a pixel outside the frame is invalid: it joins nothing
    d[l] = (y < H && x < W) ? D[base + static_cast<int64_t>(y) * W + x]
                            : __int_as_float(0x7fc00000);
    scount[l] = 0;
  }
  __syncthreads();
  // rows: a pixel's parent is the first pixel of its run along the row
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ly0 + k * kStep;
    const int l = ly * kTile + lx;
    const bool right = lx + 1 < kTile && joined(d[l], d[l + 1], t);
    // bit j: pixel j does not join pixel j + 1, so j + 1 starts a run
    const unsigned breaks = ~__ballot_sync(0xffffffffu, right);
    const unsigned before = breaks & ((1u << lx) - 1u);
    sp[l] = ly * kTile + (before ? 32 - __clz(static_cast<int>(before)) : 0);
  }
  __syncthreads();
  // columns: each pixel with the one below
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ly0 + k * kStep;
    const int l = ly * kTile + lx;
    if (ly + 1 < kTile && joined(d[l], d[l + kTile], t))
      unite(sp, l, l + kTile);
  }
  __syncthreads();
  int root[kRowsPerThread];
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int l = (ly0 + k * kStep) * kTile + lx;
    root[k] = find_halving(sp, l);
    if (valid_of(d[l])) atomicAdd(&scount[root[k]], 1);
  }
  __syncthreads();
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = ly0 + k * kStep;
    const int y = y0 + ly, x = x0 + lx;
    if (y >= H || x >= W) continue;
    // the tile's order of (row, column) is the frame's flat order, so the
    // tile's least index is the least global index of its part
    const int l = ly * kTile + lx;
    const int64_t g = base + static_cast<int64_t>(y) * W + x;
    parent[g] = static_cast<int>(
        base + static_cast<int64_t>(y0 + root[k] / kTile) * W + x0 +
        root[k] % kTile);
    count[g] = root[k] == l ? scount[l] : 0;
  }
}

// A thread an edge across a tile border: the right edges of the tiles'
// last columns (H * (tiles_x - 1) a frame), then the lower edges of their
// last rows (W * (tiles_y - 1) a frame).
__global__ void __launch_bounds__(kThreads)
edge_union_kernel(const float* __restrict__ D, int* parent, int B, int H,
                  int W, int tiles_x, int tiles_y, float t) {
  const int64_t nv = static_cast<int64_t>(H) * (tiles_x - 1);
  const int64_t nh = static_cast<int64_t>(W) * (tiles_y - 1);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * (nv + nh)) return;
  const int b = static_cast<int>(i / (nv + nh));
  i -= b * (nv + nh);
  int y, x, dy, dx;
  if (i < nv) {
    y = static_cast<int>(i / (tiles_x - 1));
    x = static_cast<int>(i % (tiles_x - 1)) * kTile + kTile - 1;
    dy = 0;
    dx = 1;
  } else {
    i -= nv;
    y = static_cast<int>(i / W) * kTile + kTile - 1;
    x = static_cast<int>(i % W);
    dy = 1;
    dx = 0;
  }
  if (y + dy >= H || x + dx >= W) return;
  const int64_t base = static_cast<int64_t>(b) * H * W;
  const int p = static_cast<int>(base + static_cast<int64_t>(y) * W + x);
  const int q = static_cast<int>(base + static_cast<int64_t>(y + dy) * W +
                                 x + dx);
  if (joined(D[p], D[q], t)) unite(parent, p, q);
}

// count[g] holds a tile part's count at its tile root and 0 elsewhere.
// Only a component's root gains, and no thread reads a root's count
// here, so the reads race with no add.
__global__ void __launch_bounds__(kThreads)
flatten_count_kernel(int* parent, int* count, int n) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  const int root = find_halving(parent, g);
  parent[g] = root;
  if (root != g) {
    const int c = count[g];
    if (c != 0) atomicAdd(&count[root], c);
  }
}

__global__ void __launch_bounds__(kThreads)
kill_kernel(const float* __restrict__ D, const int* parent,
            const int* __restrict__ count, float* __restrict__ out,
            int* __restrict__ labels, int n, int frame, int size) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  // another pixel's halving may have stored an ancestor over the root the
  // flatten left here: walk the (short) rest of the way
  const int root = find(parent, g);
  const float v = D[g];
  // the bits move as they are: a NaN keeps its payload, -0.0 its sign
  reinterpret_cast<int*>(out)[g] = (valid_of(v) && count[root] < size)
                                       ? __float_as_int(-10.f)
                                       : __float_as_int(v);
  if (labels != nullptr) labels[g] = root - (g / frame) * frame;
}

unsigned blocks_for(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

// D -> out for B frames of H x W; labels (may be null) gets each pixel's
// component label; parent and count are B * H * W int32 scratch. t is the
// similarity threshold, size speckle_size (after subsampling's rescale).
// Four launches, whatever the shape; *launched counts those queued.
extern "C" int elas_speckle(const float* D, float* out, int* labels,
                            int* parent, int* count, int B, int H, int W,
                            float t, int size, int* launched, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launched = 0;
  const int64_t n = static_cast<int64_t>(B) * H * W;
  if (B < 1 || H < 1 || W < 1 || n >= INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tx = (W + kTile - 1) / kTile, ty = (H + kTile - 1) / kTile;
  const int64_t tiles = static_cast<int64_t>(B) * tx * ty;
  tile_union_kernel<<<static_cast<unsigned>(tiles), kTileThreads, 0, st>>>(
      D, parent, count, H, W, tx, ty, t);
  cudaError_t err = cudaGetLastError();
  *launched = 1;
  if (err != cudaSuccess) return static_cast<int>(err);
  // a frame of one tile has no border edge: one block that returns, so
  // that every call is four launches
  const int64_t edges = static_cast<int64_t>(B) *
                        (static_cast<int64_t>(H) * (tx - 1) +
                         static_cast<int64_t>(W) * (ty - 1));
  edge_union_kernel<<<blocks_for(edges > 0 ? edges : 1, kThreads), kThreads,
                      0, st>>>(D, parent, B, H, W, tx, ty, t);
  err = cudaGetLastError();
  *launched = 2;
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten_count_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
      parent, count, static_cast<int>(n));
  err = cudaGetLastError();
  *launched = 3;
  if (err != cudaSuccess) return static_cast<int>(err);
  kill_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
      D, parent, count, out, labels, static_cast<int>(n), H * W, size);
  *launched = 4;
  return static_cast<int>(cudaGetLastError());
}
