// Event -> voxel-grid voxelizers for Hopper (sm_90a): K1 and K2, one design
// and one entry point, refid_voxelize.
//
// K1 (events/voxel_cuda.py::voxelize_cuda) replaces the TPU kernel
// refid_tpu/events/voxel_pallas.py::_voxel_kernel_masked (entry
// voxelize_device, pallas_call at :311), with the contract of
// refid_tpu/events/voxel.py::_voxelize_padded: a time-sorted (CAP, 4) f32
// buffer of [t, x, y, p] rows, the first n_valid of them events, voted into a
// (bins, height, width) f32 grid.
//
// K2 (voxel_cuda.py::events_to_voxel_grid_cuda) replaces the TPU kernel
// refid_tpu/events/voxel_pallas.py::_voxel_kernel (via _voxelize_bucketed,
// entry events_to_voxel_grid_pallas, pallas_call at :129), the host-array
// voxelizer the training datasets call: N >= 1 unpadded time-sorted rows,
// voted into a (bins, height, width) grid or, for HWC, (height, width, bins).
//
// Both: timestamps are rescaled to [0, bins-1] from the first and last
// events (a zero span counts as 1), p == 0 votes as -1, and each event adds
// p*(1-dt) to bin floor(t) and p*dt to bin floor(t)+1 at (y, x).  Votes
// into a bin outside [0, bins), and events whose truncated x or y lies
// outside the frame, are dropped (a stamp a bin or more before the first,
// on an unsorted stream, keeps only its right vote, in bin 0).
//
// Bound on an H100 SXM (3.35 TB/s) at the main paths' shape: read 2^20 x 16 B
// of events (16.8 MB) once and write the 24 x 720 x 1280 f32 grid (88.5 MB)
// once: 105.3 MB, 0.0314 ms.  The grid is larger than the 50 MB L2, so a
// zeroing pass plus one global atomic per vote (this file's first design)
// moves each grid byte about three times: 3.7x the bound.
//
// Design.  The TPU kernels sort events by row band and build each band's
// slab of the grid on chip (their one-hot matmuls stand in for the scatter
// the TPU lacks).  Here the slab is a tile of the grid in shared memory:
//   1. Tile plan (make_plan, mirrored by events/voxel.py::voxel_tile_plan):
//      tile_rows x tile_cols pixels x bins floats within a slab budget the
//      caller passes (60 KB from the wrappers: half a 1280-px row at 24
//      bins, three blocks an SM, 1440 tiles).  Whole rows when a row fits,
//      else the row is split into equal column tiles.
//   2. Sort (voxel_sort_kernel), one block per chunk of 4096 events: a
//      counting sort of the chunk's kept events by tile in shared memory
//      (histogram by shared atomics, exclusive scan, scatter), written back
//      as one contiguous run of 16-byte rows, with the chunk's per-tile
//      offsets.  The drop rules are applied here.  A sort of all events at
//      once (a histogram pass, a scan, a global scatter) cost twice as much
//      on the H100: its scatter wrote 2^20 scattered 16-byte rows.
//   3. Tile pass (voxel_tile_kernel), one block per tile: gather the tile's
//      run from every chunk (a scan of the runs' lengths, then a binary
//      search per event), zero the slab, add the votes with shared-memory
//      atomics (the vote's arithmetic in round-to-nearest intrinsics, as
//      the plain version rounds, so no FMA contraction changes a vote),
//      then write the slab once, zeros included, as 16-byte stores of the
//      destination's aligned groups (scalar stores at a run's ragged ends).
//      An HWC full-width tile is one contiguous run, a CHW one a run per
//      bin; column tiles are a run per row (and bin).
// Every grid byte is written exactly once, by the tile pass; the wrappers
// allocate the grid uninitialised.  The sort reads and writes 16.8 MB more,
// mostly in L2.  Shared atomics add in a varying order, as global ones did:
// results agree with the plain version to about 1e-7, not bit for bit.  A
// tile crowded with events serialises on its one block: on sm_90 a shared
// f32 atomicAdd is a compare-and-swap loop.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

// shared memory a block may use on sm_90, less room for static arrays
constexpr int kMaxDynamic = 232448 - 1024;
constexpr int kSortThreads = 1024;
constexpr int kSortPerThread = 4;
constexpr int kSortChunk = kSortThreads * kSortPerThread;   // events a sort block orders
constexpr int kTileThreads = 512;
constexpr int kTileUnroll = 4;       // events per thread per step of the tile pass

struct Geom {
  int bins, width, height;
  int tile_rows, tile_cols, tiles_x, num_tiles;
  int last;          // row whose stamp ends the span
};

// Tile plan: the largest whole-row tile within `slab_bytes`, else one row
// split into the fewest equal column tiles that fit.
int make_plan(int bins, int width, int height, int slab_bytes, int plan[4]) {
  if (bins < 1 || width < 1 || height < 1 || slab_bytes > kMaxDynamic) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long max_px = slab_bytes / (4LL * bins);
  if (max_px < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long rows = 1, cols = width;
  if (width <= max_px) {
    rows = max_px / width < height ? max_px / width : height;
  } else {
    const long long parts = (width + max_px - 1) / max_px;
    cols = (width + parts - 1) / parts;
  }
  const long long tiles_x = (width + cols - 1) / cols;
  const long long tiles_y = (height + rows - 1) / rows;
  // a sort block holds its chunk and a counter per tile, and one more, in
  // shared memory
  if ((tiles_x * tiles_y + 1) * 4 + kSortChunk * 16LL > kMaxDynamic) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  plan[0] = static_cast<int>(rows);
  plan[1] = static_cast<int>(cols);
  plan[2] = static_cast<int>(tiles_x);
  plan[3] = static_cast<int>(tiles_y);
  return 0;
}

struct Stamps {
  float first, delta, scale;
};

__device__ __forceinline__ Stamps stamps(const float4* __restrict__ events, const Geom& g) {
  const float first = events[0].x;
  float delta = __fsub_rn(events[g.last].x, first);
  if (delta == 0.0f) delta = 1.0f;
  return {first, delta, static_cast<float>(g.bins - 1)};
}

struct Split {
  int ti, x, y;
  float dt;
};

// bin and pixel of one event: (bins - 1) * (t - first) / delta, each step
// rounded like the plain version
__device__ __forceinline__ Split split(const float4 e, const Stamps& s) {
  const float ts = __fdiv_rn(__fmul_rn(s.scale, __fsub_rn(e.x, s.first)), s.delta);
  const int ti = __float2int_rz(ts);
  return {ti, __float2int_rz(e.y), __float2int_rz(e.z), __fsub_rn(ts, static_cast<float>(ti))};
}

// the tile of a kept event, -1 for a dropped one: out of frame, or no vote
// in [0, bins) (ti < -1; at ti = -1 only the right vote lands, in bin 0)
__device__ __forceinline__ int tile_of(const float4 e, const Stamps& s, const Geom& g) {
  const Split v = split(e, s);
  if (v.x < 0 || v.x >= g.width || v.y < 0 || v.y >= g.height || v.ti < -1) return -1;
  return (v.y / g.tile_rows) * g.tiles_x + v.x / g.tile_cols;
}

// a[0 .. len) <- its exclusive prefix sums, a[len] <- the total, in shared
// memory, by all kThreads threads of the block (each sums a contiguous run)
template <int kThreads>
__device__ void block_exclusive_scan(int* a, int len) {
  __shared__ int s_warp[kThreads / 32];
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, len);
  const int hi = min(lo + per, len);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += a[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += up;
    }
    if (lane < kThreads / 32) s_warp[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int c = a[j];
    a[j] = run;
    run += c;
  }
  if (threadIdx.x == kThreads - 1) a[len] = run;
  __syncthreads();
}

// Pass 1, one block per chunk of kSortChunk events: a counting sort of the
// chunk's kept events by tile in shared memory, written back contiguous at
// sorted[chunk * kSortChunk ...], and the chunk's tile offsets (num_tiles +
// 1 of them, the last the kept count) at offsets[chunk * (num_tiles + 1)].
__global__ void __launch_bounds__(kSortThreads)
voxel_sort_kernel(const float4* __restrict__ events, int n, Geom g,
                  float4* __restrict__ sorted, int* __restrict__ offsets) {
  extern __shared__ float4 s_rows[];                       // kSortChunk rows, then
  int* s_off = reinterpret_cast<int*>(s_rows + kSortChunk);   // num_tiles + 1 counters
  for (int j = threadIdx.x; j <= g.num_tiles; j += kSortThreads) s_off[j] = 0;
  __syncthreads();

  const Stamps s = stamps(events, g);
  const long long base = static_cast<long long>(blockIdx.x) * kSortChunk;
  float4 e[kSortPerThread];
  int t[kSortPerThread], rank[kSortPerThread];
#pragma unroll
  for (int k = 0; k < kSortPerThread; ++k) {
    const long long i = base + k * kSortThreads + threadIdx.x;
    e[k] = i < n ? events[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
#pragma unroll
  for (int k = 0; k < kSortPerThread; ++k) {
    t[k] = base + k * kSortThreads + threadIdx.x < n ? tile_of(e[k], s, g) : -1;
    rank[k] = t[k] >= 0 ? atomicAdd(s_off + t[k], 1) : 0;
  }
  __syncthreads();
  block_exclusive_scan<kSortThreads>(s_off, g.num_tiles);
#pragma unroll
  for (int k = 0; k < kSortPerThread; ++k) {
    if (t[k] >= 0) s_rows[s_off[t[k]] + rank[k]] = e[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_off[g.num_tiles]; i += kSortThreads) {
    sorted[base + i] = s_rows[i];
  }
  int* out = offsets + static_cast<long long>(blockIdx.x) * (g.num_tiles + 1);
  for (int j = threadIdx.x; j <= g.num_tiles; j += kSortThreads) out[j] = s_off[j];
}

// A slab float's place in shared memory: bits 2-4 of the index XOR bits
// 5-7, which permutes the 16-byte groups of each 128-byte row.  An HWC
// slab's votes of one bin lie `bins` floats apart (24: four banks of 32);
// the swizzle spreads them over all banks, and a group stays whole for the
// 16-byte reads of the write-out.
__device__ __forceinline__ int swz(int i) { return i ^ (((i >> 5) & 7) << 2); }

// Pass 2, one block per tile: gather the tile's run from every chunk, add
// its votes into the slab, write the slab once.
template <bool kHWC>
__global__ void __launch_bounds__(kTileThreads)
voxel_tile_kernel(const float4* __restrict__ events, const float4* __restrict__ sorted,
                  const int* __restrict__ offsets, int chunks, Geom g,
                  float* __restrict__ grid) {
  extern __shared__ float4 s_slab4[];
  float* slab = reinterpret_cast<float*>(s_slab4);
  const int tile = blockIdx.x;
  const int ty = tile / g.tiles_x, tx = tile - ty * g.tiles_x;
  const int y0 = ty * g.tile_rows, x0 = tx * g.tile_cols;
  const int rows = min(g.tile_rows, g.height - y0);
  const int cols = min(g.tile_cols, g.width - x0);
  const int plane = rows * cols;
  const int cells = plane * g.bins;
  // after the slab (whole swizzle rows of the largest tile): where this
  // tile's run starts in each chunk, and the runs' prefix sums
  const int slab_floats = (g.tile_rows * g.tile_cols * g.bins + 31) & ~31;
  int* s_start = reinterpret_cast<int*>(slab + slab_floats);
  int* s_pre = s_start + chunks;

  for (int i = threadIdx.x; i < (cells + 31) / 32 * 8; i += kTileThreads) {
    s_slab4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int c = threadIdx.x; c < chunks; c += kTileThreads) {
    const int* row = offsets + static_cast<long long>(c) * (g.num_tiles + 1) + tile;
    s_start[c] = row[0];
    s_pre[c] = row[1] - row[0];
  }
  __syncthreads();
  block_exclusive_scan<kTileThreads>(s_pre, chunks);

  // slab layout = the destination's: (rows, cols, bins) or (bins, rows, cols)
  const Stamps s = stamps(events, g);
  const int bin_stride = kHWC ? 1 : plane;
  const int px_stride = kHWC ? g.bins : 1;
  const int total = s_pre[chunks];
  for (int k0 = threadIdx.x; k0 < total; k0 += kTileThreads * kTileUnroll) {
    // kTileUnroll loads in flight together: a crowded tile's loop waits on
    // memory once per kTileUnroll events a thread
    float4 e[kTileUnroll];
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      const int k = k0 + u * kTileThreads;
      if (k >= total) break;
      int lo = 0, hi = chunks;         // the chunk c with s_pre[c] <= k < s_pre[c + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_pre[mid] <= k) lo = mid; else hi = mid;
      }
      e[u] = sorted[static_cast<long long>(lo) * kSortChunk + s_start[lo] + (k - s_pre[lo])];
    }
#pragma unroll
    for (int u = 0; u < kTileUnroll; ++u) {
      if (k0 + u * kTileThreads >= total) break;
      const Split v = split(e[u], s);   // in frame, in this tile, ti >= -1: sorted so
      const float p = e[u].w == 0.0f ? -1.0f : e[u].w;
      const int cell = ((v.y - y0) * cols + (v.x - x0)) * px_stride + v.ti * bin_stride;
      if (v.ti >= 0 && v.ti < g.bins) atomicAdd(slab + swz(cell), __fmul_rn(p, __fsub_rn(1.0f, v.dt)));
      if (v.ti + 1 < g.bins) atomicAdd(slab + swz(cell + bin_stride), __fmul_rn(p, v.dt));
    }
  }
  __syncthreads();

  // The slab goes out as runs, each contiguous in the slab's index order
  // (run r at r * run_len) and in the grid.  Full-width tiles merge a bin's
  // rows (CHW) or the whole tile (HWC) into one run.
  const bool full = cols == g.width;
  const int runs_per_bin = kHWC ? 1 : (full ? 1 : rows);
  const int n_runs = kHWC ? (full ? 1 : rows) : g.bins * runs_per_bin;
  const int run_len = cells / n_runs;
  // each run's float range covers at most run_len / 4 + 2 aligned 16-byte groups
  const int slots = (run_len + 3) / 4 + 1;
  for (int k = threadIdx.x; k < n_runs * slots; k += kTileThreads) {
    const int r = k / slots;
    long long dst;                       // the run's first float in the grid
    if (kHWC) {
      dst = (static_cast<long long>(y0 + r) * g.width + x0) * g.bins;
    } else {
      const int b = r / runs_per_bin, row = r - b * runs_per_bin;
      dst = (static_cast<long long>(b) * g.height + y0 + row) * g.width + x0;
    }
    const long long group = (dst >> 2) + (k - r * slots);
    const int lo = static_cast<int>(group * 4 - dst);   // run offset of the group's first float
    if (lo >= run_len) continue;
    const int src = r * run_len + lo;                    // slab index of that float
    if (lo >= 0 && lo + 4 <= run_len) {
      float4 v;
      if ((src & 3) == 0) {
        v = *reinterpret_cast<const float4*>(slab + swz(src));
      } else {
        v = make_float4(slab[swz(src)], slab[swz(src + 1)], slab[swz(src + 2)],
                        slab[swz(src + 3)]);
      }
      reinterpret_cast<float4*>(grid)[group] = v;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (lo + q >= 0 && lo + q < run_len) grid[group * 4 + q] = slab[swz(src + q)];
      }
    }
  }
}

#define RETURN_IF_ERROR(call)                               \
  do {                                                      \
    const cudaError_t err_ = (call);                        \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace

// The tile plan for a (bins, height, width) grid and a slab budget in bytes:
// plan = {tile_rows, tile_cols, tiles_x, tiles_y}.  Returns 0, or
// cudaErrorInvalidValue if no tile fits.
extern "C" int refid_voxel_plan(int bins, int width, int height, int slab_bytes, int* plan) {
  return make_plan(bins, width, height, slab_bytes, plan);
}

// Events a sort block orders: the caller sizes `offsets` and `sorted` by it.
extern "C" int refid_voxel_sort_chunk() { return kSortChunk; }

// One voxelization of the first n rows of `events` (K1: n = n_valid, CHW;
// K2: all n >= 1 rows, CHW or HWC), two launches on `stream`; returns the
// first CUDA error (0 on success).  `events` must be 16-byte aligned and
// hold at least one row; `grid` is a (bins, height, width) or, for `hwc`
// != 0, (height, width, bins) f32 buffer of any contents (every float is
// written); `offsets` holds chunks * (num_tiles + 1) ints and `sorted`
// chunks * kSortChunk rows, chunks = ceil(n / kSortChunk).  The caller
// checks shapes.
extern "C" int refid_voxelize(const float* events, int n, int bins, int width, int height,
                              int hwc, int slab_bytes, int* offsets, float* sorted,
                              float* grid, void* stream) {
  int plan[4];
  const int err = make_plan(bins, width, height, slab_bytes, plan);
  if (err != 0) return err;
  const Geom g{bins, width, height, plan[0], plan[1], plan[2], plan[2] * plan[3],
               n > 0 ? n - 1 : 0};
  const int chunks = static_cast<int>((static_cast<long long>(n) + kSortChunk - 1) / kSortChunk);
  const size_t slab_floats = (static_cast<size_t>(g.tile_rows) * g.tile_cols * bins + 31) & ~size_t(31);
  const size_t tile_smem = sizeof(float) * slab_floats + sizeof(int) * (2 * static_cast<size_t>(chunks) + 1);
  if (tile_smem > kMaxDynamic) return static_cast<int>(cudaErrorInvalidValue);
  const float4* ev = reinterpret_cast<const float4*>(events);
  float4* rows = reinterpret_cast<float4*>(sorted);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  // The shared-memory limits are set to the most a block may use, once a
  // kernel and device (launch.cuh), so that concurrent calls (the loader's
  // threads) never lower them under each other's launches.
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (chunks > 0) {
    RETURN_IF_ERROR(allow_dynamic_smem(reinterpret_cast<const void*>(voxel_sort_kernel),
                                       device, kMaxDynamic));
    const size_t sort_smem = sizeof(float4) * kSortChunk + sizeof(int) * (g.num_tiles + 1);
    voxel_sort_kernel<<<chunks, kSortThreads, sort_smem, s>>>(ev, n, g, rows, offsets);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  const auto kernel = hwc ? voxel_tile_kernel<true> : voxel_tile_kernel<false>;
  RETURN_IF_ERROR(allow_dynamic_smem(reinterpret_cast<const void*>(kernel), device, kMaxDynamic));
  kernel<<<g.num_tiles, kTileThreads, tile_smem, s>>>(ev, rows, offsets, chunks, g, grid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
