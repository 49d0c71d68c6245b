// Band-resident width-folded 3x3 conv for Hopper (sm_90a): P3 and P4 of the
// band-conv rate probe (refid_tpu_torch/probes/band_conv.py).
//
// P3 (mode 0) replaces the TPU kernel scripts/probe_band_conv.py::band_conv:
// x (H, WP, 128) bf16 HWC, w (3, 3, 128, 128) bf16 HWIO, out (H, WP, 128)
// bf16.  Each band of `band` rows is flattened to (band * WP, 128); its
// m2 = (band - 2) * WP interior rows r get
//   leaky_0.1( sum_{dy, dx} x2[a(r, dx) + dy * WP] @ w[dy, dx] )
// with f32 accumulation, written to band row r + WP, and the band's first
// and last rows are zero.  The TPU kernel sums per dx and rolls the f32 sum
// by (1 - dx) mod m2 rows (pltpu.roll, which shifts like jnp.roll); this
// kernel computes the row that roll produces instead:
//   a(r, dx) = (r + dx - 1) mod m2  with rolls,   r  without.
//
// P4 (modes 1 and 2) replaces scripts/probe_band_conv.py::band_conv_int8:
// the same with int8 taps and int32 accumulation.  Mode 1 quantizes bf16 x
// in the kernel, clamp(rint(x * 20), -127, 127) (20 = 1 / float32(0.05) in
// float32); mode 2 takes int8 x.  Epilogue: float(acc) * (0.05f * 0.01f),
// leaky, bf16.  Integer sums are exact and every float step is an explicit
// round-to-nearest intrinsic, so P4 is bit-exact against its plain version.
//
// Bound on an H100 SXM at the probe's (720, 648, 128), band 8: 90 bands x
// 3888 rows x 9 taps x 128^2 x 2 = 103.2 GFLOP, 0.104 ms at 989 TFLOP/s
// (bf16 dense); x read and out written once (238.9 MB) take 0.071 ms at
// 3.35 TB/s, which bounds P4 (0.054 ms with int8 x).  Moving the operands
// from L2 into shared memory takes longer than either, so the design cuts
// that traffic and overlaps it with the products.
//
// Design: TMA ring, wgmma, persistent grid.
// * Tiles.  A tile is kWindow - 8 interior rows of one band (248; 120 in
//   mode 1) by all 128 output channels.  A persistent grid of one CTA per SM
//   walks the tiles band by band (CTA b takes b, b + grid, ...).  Each CTA
//   has 288 threads: one producer warp and two consumer warpgroups, each on
//   half of the window's rows.
// * A windows.  Output row i of a tile (band row m0 + i) reads row
//   m0 + i + dx - 1 (+ dy WP) for tap (dy, dx) with rolls, m0 + i without.
//   So for each dy and 128-byte K-chunk one TMA box of kWindow rows from
//   band row m0 - 1 + dy WP serves all three dx.  x is viewed as (H WP, 128)
//   with CU_TENSOR_MAP_SWIZZLE_128B, and rows outside x come back zero.  The
//   wgmma A descriptor starts dx rows (or 1) into the window: a 128-byte row
//   inside a 1024-byte swizzle atom, with the descriptor's base offset 0,
//   since the swizzle follows the address bits (measured on the card; a base
//   offset of (address >> 7) & 7 gives wrong products).  This cuts A's L2
//   traffic 3x against a box per tap.
// * The roll's wraps.  Row 0 at dx = 0 reads interior row m2 - 1, and row
//   m2 - 1 at dx = 2 reads row 0, each + dy WP.  So window row 0 (first tile
//   of a band) and window row m2 + 1 - m0 (last tile) must hold those rows.
//   Every other tap that reads them writes rows past m2, which are never
//   stored.  In modes 0 and 2 the warpgroup that needs the row writes it
//   into the landed window at its swizzled address, fences
//   (fence.proxy.async.shared::cta) and syncs before its wgmma.  Mode 1
//   reads it from device memory while it quantizes.
// * B.  The wrapper packs w as (tap, out, in), 9 * 128 rows of 128 input
//   channels, so B is K-major as wgmma needs for 8-bit types (one layout for
//   bf16 too).  Each tap's 128 x 128-byte box streams from L2 into a ring
//   of its own.  The nine bf16 taps (288 KB) do not fit in shared memory, and
//   the int8 ones (144 KB) leave no room for the A ring.  (Sharing each B
//   box between two CTAs of a cluster by TMA multicast was tried: the pair
//   then waits on each other's slots, and it ran slower.)
// * Pipeline.  An A ring of 3 windows (32 KB: 256 rows x 64 bf16 channels
//   in mode 0; 128 rows x 128 bf16 channels as two boxes in mode 1; 256
//   rows x 128 int8 channels in mode 2) and a B ring of 4 taps (16 KB), each
//   slot with full/empty mbarriers.  The producer thread issues
//   cp.async.bulk.tensor.  The consumers issue wgmma.mma_async (m64n128k16
//   bf16 -> f32; m64n128k32 s8 -> s32) with one group in flight, and release
//   a slot when the group that read it has completed.  A tile is 6 windows
//   and 18 taps in mode 0, 3 and 9 in modes 1 and 2.
// * Mode 1 quantizes each landed bf16 window into one of two int8 windows
//   in shared memory, then fences.  The quantization is the plain version's
//   clamp(rint(x * 20)), exactly, but without conversion instructions (see
//   quantize()).  With the two int8 windows, quantizing one window overlaps
//   the previous window's products.
// * Epilogue.  Scale (int8), leaky 0.1 and bf16 come from the accumulator
//   registers into a staged tile in shared memory (128-byte swizzle).  One
//   thread stores it with TMA through a 3-D map of the bands' interior rows
//   (bands, m2, 128), which clips at row m2.  The store runs while the next
//   tile's products do.  The consumers also write the tile's share of the
//   band's zero edge rows.
// * Shared memory: 224 KB of rings, windows and staging.  Registers
//   (ptxas, sm_90a): 168 / 154 / 168 in modes 0 / 1 / 2.
// * L2 traffic per probe call (TMA loads, probes/band_conv.py::work): mode 0
//   1440 tiles x 6 x (32 + 3 x 16) KB = 0.71 GB; mode 1 2970 x 3 x 80 KB =
//   0.73 GB; mode 2 1440 x 3 x 80 KB = 0.35 GB.  The earlier wmma kernel moved
//   1.65 GB in every mode.
// * The PTX wrappers (mbarriers, TMA, wgmma, descriptors) and the tensor-map
//   encoder lookup live in hopper.cuh, shared with conv_int8.cu.

#include "hopper.cuh"
#include "launch.cuh"

namespace {

constexpr int kC = 128;               // channels in and out
constexpr int kAStages = 3;           // A windows in flight
constexpr int kBStages = 4;           // B taps in flight
constexpr int kABytes = 32768;        // an A window: kWindow rows x 128 bytes x kABoxes
constexpr int kBBytes = 16384;        // a tap: 128 outputs x 128 bytes of inputs
constexpr int kQBytes = 16384;        // mode 1: an int8 window, 128 rows x 128 bytes
constexpr int kConsumerWarps = 8;     // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + one producer warp

template <int kMode>
struct Cfg;
template <>
struct Cfg<0> {                       // P3: bf16 x, bf16 taps
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr int kWindow = 256, kChunks = 2, kABoxes = 1;
};
template <>
struct Cfg<1> {                       // P4: bf16 x quantized here, int8 taps
  using In = __nv_bfloat16;
  using Acc = int;
  static constexpr int kWindow = 128, kChunks = 1, kABoxes = 2;
};
template <>
struct Cfg<2> {                       // P4: int8 x, int8 taps
  using In = signed char;
  using Acc = int;
  static constexpr int kWindow = 256, kChunks = 1, kABoxes = 1;
};

// quantize(x) = clamp(rint(x * 20), -127, 127) of the plain version, as a
// float whose low byte is the int8 value.  Clamping first gives the same
// value (the bounds are integers and rint is monotonic), and adding
// 1.5 * 2^23 rounds to the nearest integer, ties to even, as rintf does,
// leaving it in the low mantissa bits: no conversion instructions, which
// issue at 16 a cycle on an SM against 128 for float multiply, min and add.
__device__ __forceinline__ uint32_t quantize(float x) {
  const float f = fminf(fmaxf(__fmul_rn(x, 20.0f), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(f, 12582912.0f));
}

// 16 bf16 values (two 16-byte vectors) -> 16 int8 values (one vector).
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t a = w[2 * k], b = w[2 * k + 1];    // bf16 pairs, low half first
    const uint32_t q01 = __byte_perm(quantize(__uint_as_float(a << 16)),
                                     quantize(__uint_as_float(a & 0xFFFF0000u)), 0x0040);
    const uint32_t q23 = __byte_perm(quantize(__uint_as_float(b << 16)),
                                     quantize(__uint_as_float(b & 0xFFFF0000u)), 0x0040);
    q[k] = __byte_perm(q01, q23, 0x5410);
  }
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// Byte offset of 16-byte chunk j of row i in a 128-byte-row tile that TMA
// wrote with CU_TENSOR_MAP_SWIZZLE_128B (tile 1024-byte aligned).
__device__ __forceinline__ int swizzled(int i, int j) { return i * 128 + ((j ^ (i & 7)) << 4); }

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
band_conv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap to, const unsigned char* __restrict__ x,
                 int wp, int band, int bands, int rolls,
                 __nv_bfloat16* __restrict__ out) {
  using C = Cfg<kMode>;
  using Acc = typename C::Acc;
  constexpr int kWin = C::kWindow;            // A rows staged per (dy, K-chunk)
  constexpr int kBM = kWin - 8;               // output rows per tile
  constexpr int kWgRows = kWin / 2;           // rows per consumer warpgroup
  constexpr int kMB = kWgRows / 64;           // m64 blocks per warpgroup
  constexpr int kXRowBytes = kC * static_cast<int>(sizeof(typename C::In));
  constexpr int kBoxCols = 128 / static_cast<int>(sizeof(typename C::In));
  constexpr int kTapCols = kMode == 0 ? 64 : 128;   // B box columns
  constexpr int kOutVec = kC / 8;             // bf16 16-byte vectors per row

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* b_ring = smem + kAStages * kABytes;
  unsigned char* q = b_ring + kBStages * kBBytes;             // mode 1: 2 x int8 window
  unsigned char* staged = q + (kMode == 1 ? 2 * kQBytes : 0);  // the tile's bf16 output
  uint64_t* full_a = reinterpret_cast<uint64_t*>(staged + kWin * 2 * kC);
  uint64_t* empty_a = full_a + kAStages;
  uint64_t* full_b = empty_a + kAStages;
  uint64_t* empty_b = full_b + kBStages;

  const int m2 = (band - 2) * wp;
  const int per_band = (m2 + kBM - 1) / kBM;
  const int tiles = bands * per_band;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAStages; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], kConsumerWarps);
    }
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(&full_b[s], 1);
      mbar_init(&empty_b[s], kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every TMA load ----
    if (lane != 0) return;
    int sa = 0, sb = 0;
    uint32_t pa = 0, pb = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = (tile / per_band) * band * wp + (tile % per_band) * kBM - 1;
      for (int dy = 0; dy < 3; ++dy) {
        for (int kc = 0; kc < C::kChunks; ++kc) {
          mbar_wait(&empty_a[sa], pa ^ 1);
          mbar_expect_tx(&full_a[sa], kABytes);
#pragma unroll
          for (int bx = 0; bx < C::kABoxes; ++bx) {
            tma_load(smem + sa * kABytes + bx * kWin * 128, &tx, &full_a[sa],
                     (kc + bx) * kBoxCols, row0 + dy * wp);
          }
          if (++sa == kAStages) {
            sa = 0;
            pa ^= 1;
          }
          for (int dx = 0; dx < 3; ++dx) {
            mbar_wait(&empty_b[sb], pb ^ 1);
            mbar_expect_tx(&full_b[sb], kBBytes);
            tma_load(b_ring + sb * kBBytes, &tw, &full_b[sb], kc * kTapCols, (3 * dy + dx) * kC);
            if (++sb == kBStages) {
              sb = 0;
              pb ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, kWgRows window rows each ----
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  int sa = 0, sb = 0, nq = 0;
  uint32_t pa = 0, pb = 0;
  Acc acc[kMB][64];
  const float scale = __fmul_rn(0.05f, 0.01f);
  uint4* out4 = reinterpret_cast<uint4*>(out);

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int bnd = tile / per_band;
    const int mt = tile % per_band;
    const int m0 = mt * kBM;
    const long long band_row0 = static_cast<long long>(bnd) * band * wp;
    // window row j holds band row m0 - 1 + j (+ dy wp); output row i reads
    // window row i + dx (rolls) or i + 1.  The roll's wraps: window row 0
    // (output row 0 at dx = 0) must hold interior row m2 - 1, and window row
    // m2 + 1 - m0 (output row m2 - 1 at dx = 2) interior row 0.  Rows they
    // also feed at other dx are past m2 and never stored.
    const int wrap_lo = rolls && m0 == 0 ? 0 : -1;
    const int wrap_hi = rolls && m2 - 1 - m0 < kBM ? m2 + 1 - m0 : -1;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[mb][v] = 0;
    }
    int prev_b = -1, prev_a = -1;   // stages of the wgmma group that may be in flight
    for (int dy = 0; dy < 3; ++dy) {
      for (int kc = 0; kc < C::kChunks; ++kc) {
        const long long dy_row0 = band_row0 + static_cast<long long>(dy) * wp;
        mbar_wait(&full_a[sa], pa);
        unsigned char* st = smem + sa * kABytes;
        const unsigned char* a_win = st;
        if constexpr (kMode == 1) {
          // quantize the bf16 window into one of two int8 windows; the wgmma
          // groups that read this one (two windows back) have completed
          unsigned char* qb = q + (nq++ & 1) * kQBytes;
          named_sync(3, 256);
          const int j = threadIdx.x >> 1;
          const int half = threadIdx.x & 1;
          const int src = j == wrap_lo ? m2 - 1 : j == wrap_hi ? 0 : -1;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint4 lo, hi;
            if (src >= 0) {
              const uint4* g = reinterpret_cast<const uint4*>(
                  x + (dy_row0 + src) * kXRowBytes + half * 128) + 2 * c;
              lo = g[0];
              hi = g[1];
            } else {
              const unsigned char* box = st + half * kWin * 128;
              lo = *reinterpret_cast<const uint4*>(box + swizzled(j, 2 * c));
              hi = *reinterpret_cast<const uint4*>(box + swizzled(j, 2 * c + 1));
            }
            *reinterpret_cast<uint4*>(qb + swizzled(j, 4 * half + c)) = quantize16(lo, hi);
          }
          fence_proxy_async();
          named_sync(3, 256);
          release(&empty_a[sa]);      // the bf16 window is read; wgmma reads qb
          a_win = qb;
        } else {
          // the warpgroup whose rows need a wrap row writes it into the window
          const int rows[2] = {wrap_lo, wrap_hi};
          const int srcs[2] = {m2 - 1, 0};
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int j = rows[k];
            const int i = j - 2 * k;           // the output row that needs it
            if (j >= 0 && i / kWgRows == wg) {
              if (t < 8) {
                *reinterpret_cast<uint4*>(st + swizzled(j, t)) = *reinterpret_cast<const uint4*>(
                    x + (dy_row0 + srcs[k]) * kXRowBytes + kc * 128 + t * 16);
                fence_proxy_async();
              }
              named_sync(1 + wg, 128);
            }
          }
        }
        for (int dx = 0; dx < 3; ++dx) {
          mbar_wait(&full_b[sb], pb);
          const int off = rolls ? dx : 1;
          fence_operands(acc[0]);
          if constexpr (kMB > 1) fence_operands(acc[kMB - 1]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t db = smem_desc(b_ring + sb * kBBytes + ks * 32);
#pragma unroll
            for (int mb = 0; mb < kMB; ++mb) {
              wgmma_tile(acc[mb],
                         smem_desc(a_win + (wg * kWgRows + mb * 64 + off) * 128 + ks * 32), db);
            }
          }
          wgmma_commit();
          fence_operands(acc[0]);
          if constexpr (kMB > 1) fence_operands(acc[kMB - 1]);
          wgmma_wait<1>();            // the previous group has completed
          if (prev_b >= 0) release(&empty_b[prev_b]);
          if (prev_a >= 0) release(&empty_a[prev_a]);
          prev_b = sb;
          prev_a = kMode != 1 && dx == 2 ? sa : -1;
          if (++sb == kBStages) {
            sb = 0;
            pb ^= 1;
          }
        }
        if (++sa == kAStages) {
          sa = 0;
          pa ^= 1;
        }
      }
    }
    wgmma_wait<0>();
    release(&empty_b[prev_b]);
    if (prev_a >= 0) release(&empty_a[prev_a]);

    // epilogue: scale (int8), leaky 0.1, bf16 into the staged tile (two
    // 64-channel halves, 128-byte swizzle), then one thread stores it with
    // TMA; the output map clips at row m2 of the band
    if (threadIdx.x == 0) bulk_wait_read();     // the last tile's store has read it
    named_sync(3, 256);
    const int wi = (t / 32) % 4;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int v = 0; v < 64; v += 2) {
        const int i = wg * kWgRows + mb * 64 + wi * 16 + (lane >> 2) + 8 * ((v >> 1) & 1);
        if (i < kBM) {
          float f0, f1;
          if constexpr (kMode == 0) {
            f0 = acc[mb][v];
            f1 = acc[mb][v + 1];
          } else {
            f0 = __fmul_rn(__int2float_rn(acc[mb][v]), scale);
            f1 = __fmul_rn(__int2float_rn(acc[mb][v + 1]), scale);
          }
          const __nv_bfloat162 h = __floats2bfloat162_rn(fmaxf(f0, __fmul_rn(0.1f, f0)),
                                                         fmaxf(f1, __fmul_rn(0.1f, f1)));
          // columns (v / 4) 8 + (lane % 4) 2 + {0, 1}: half v / 32, chunk (v / 4) % 8
          *reinterpret_cast<__nv_bfloat162*>(staged + (v >> 5) * kWin * 128 +
                                             swizzled(i, (v >> 2) & 7) + (lane & 3) * 4) = h;
        }
      }
    }
    fence_proxy_async();
    named_sync(3, 256);
    if (threadIdx.x == 0) {
      tma_store(&to, staged, 0, m0, bnd);
      tma_store(&to, staged + kWin * 128, 64, m0, bnd);
      bulk_commit();
    }
    // this tile's share of the band's zero first and last rows
    const int units = 2 * wp * kOutVec;
    const int chunk = (units + per_band - 1) / per_band;
    const int end = min(units, (mt + 1) * chunk);
    for (int u = mt * chunk + static_cast<int>(threadIdx.x); u < end;
         u += 32 * kConsumerWarps) {
      const int e = u / kOutVec;
      const long long row = band_row0 + (e < wp ? e : (band - 2) * wp + e);
      out4[row * kOutVec + u % kOutVec] = make_uint4(0, 0, 0, 0);
    }
  }
  if (threadIdx.x == 0) bulk_wait();
}

// A (rows, 128) matrix of 2-byte (bf16) or 1-byte elements, boxes of
// box_rows rows x 128 bytes, 128-byte swizzle, zero fill outside.
bool tensor_map(CUtensorMap* map, const void* base, bool two_bytes, unsigned long long rows,
                unsigned box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kC), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kC * (two_bytes ? 2 : 1))};
  const cuuint32_t box[2] = {two_bytes ? 64u : 128u, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, two_bytes ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The interior rows of out, (bands, m2, 128) bf16 from row wp of band 0
// with a band stride of band wp rows; boxes of box_rows rows x 64 channels.
bool output_map(CUtensorMap* map, void* out, int wp, int band, int bands, unsigned box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kC),
                              static_cast<cuuint64_t>(band - 2) * wp,
                              static_cast<cuuint64_t>(bands)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kC * 2),
                                 static_cast<cuuint64_t>(kC * 2) * band * wp};
  const cuuint32_t box[3] = {64u, box_rows, 1u};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(wp) * kC, dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode>
int launch(const void* x, const void* wk, int h, int wp, int band, int rolls, void* out,
           cudaStream_t stream) {
  using C = Cfg<kMode>;
  CUtensorMap tx, tw, to;
  if (!tensor_map(&tx, x, kMode != 2, static_cast<unsigned long long>(h) * wp, C::kWindow) ||
      !tensor_map(&tw, wk, kMode == 0, 9ull * kC, kC) ||
      !output_map(&to, out, wp, band, h / band, C::kWindow - 8)) {
    return kTensorMapError;
  }
  const int m2 = (band - 2) * wp;
  const int tiles = (h / band) * ((m2 + C::kWindow - 9) / (C::kWindow - 8));
  int device = 0, sms = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rings, int8 windows, barriers, slack to align the base to 1024 bytes, and
  // 256 bytes for the two rows past the last window that wgmma reads for
  // rows it never stores
  const int smem = kAStages * kABytes + kBStages * kBBytes + (kMode == 1 ? 2 * kQBytes : 0) +
                   C::kWindow * 2 * kC + 2 * (kAStages + kBStages) * 8 + 1024 + 256;
  auto kernel = band_conv_kernel<kMode>;
  err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), device, smem);   // one size a mode
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(
      tx, tw, to, static_cast<const unsigned char*>(x), wp, band, h / band, rolls,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: P3 (bf16 x and taps); 1: P4 with bf16 x quantized in the kernel;
// 2: P4 with int8 x.  x (h, wp, 128) and out dense, 16-byte aligned; wk the
// taps packed as (tap, out, in) = (9 * 128, 128), 16-byte aligned; h % band
// == 0, band >= 3 (the wrapper checks).  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or a code of its own if a tensor map
// could not be encoded.
extern "C" int refid_band_conv(const void* x, const void* wk, int h, int wp, int band,
                               int rolls, int mode, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(x, wk, h, wp, band, rolls, out, s);
    case 1: return launch<1>(x, wk, h, wp, band, rolls, out, s);
    case 2: return launch<2>(x, wk, h, wp, band, rolls, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* refid_cuda_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled failed or was not found";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
