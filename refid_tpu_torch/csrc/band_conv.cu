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
// That reproduces the TPU kernel's two wraps: column 0 of a row reads the
// previous row's last column, and r = 0, dx = 0 reads row m2 - 1.
//
// P4 (modes 1 and 2) replaces scripts/probe_band_conv.py::band_conv_int8:
// the same with int8 taps and int32 accumulation.  Mode 1 quantizes bf16 x
// in the kernel, clamp(rint(x * 20), -127, 127) (20 = 1 / float32(0.05) in
// float32); mode 2 takes int8 x.  Epilogue: float(acc) * (0.05f * 0.01f),
// leaky, bf16.  Integer sums are exact and every float step is an explicit
// round-to-nearest intrinsic, so P4 is bit-exact against its plain version.
//
// Design.  One CTA of 8 warps owns a tile of 128 interior rows of one band
// by all 128 output channels (warp tile 32 x 64, nvcuda::wmma 16x16x16
// fragments: bf16 with f32 accumulators, or signed char with int32).  For
// each of the 9 taps it gathers its 128 A rows (a(r, dx) + dy * WP) and the
// tap's 128 x 128 weight slice into shared memory, then runs the 8 k-steps.
// Shared memory holds each operand in 16-column blocks ([col / 16][row][16]),
// so every fragment starts on a 32-byte boundary, which int8 fragments need.
// Nothing is pipelined: loads and products of a tap alternate, and the
// accumulators go through shared memory for the epilogue.  wgmma, TMA and a
// ring of stages are later work.
//
// Bound on an H100 SXM at the probe's (720, 648, 128), band 8: 90 bands x
// 3888 rows x 9 taps x 128^2 x 2 = 103.2 GFLOP, 0.104 ms at 989 TFLOP/s
// (bf16 dense); the bytes (x read, out written: 238.9 MB) take 0.071 ms at
// 3.35 TB/s.  In int8 (1979 TOP/s) the bytes bound it: 0.071 ms, or 0.054 ms
// with int8 x.  Expect a small share of either: wmma compiles to the older
// mma.sync path and every tap waits for its own loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kC = 128;          // channels in and out
constexpr int kTileM = 128;      // interior rows per CTA
constexpr int kThreads = 256;    // 8 warps: 4 along M x 2 along N
constexpr int kStageLd = kC + 4; // row stride of the staged accumulators
constexpr int kSmemBytes = kTileM * kStageLd * 4;   // >= A + B tiles (64 KB)

template <int kMode>
struct Types;
template <>
struct Types<0> {
  using In = __nv_bfloat16;
  using Tap = __nv_bfloat16;
  using Acc = float;
};
template <>
struct Types<1> {
  using In = __nv_bfloat16;
  using Tap = signed char;
  using Acc = int;
};
template <>
struct Types<2> {
  using In = signed char;
  using Tap = signed char;
  using Acc = int;
};

// Offset of (row, col) in a [col / 16][rows][16] shared-memory operand.
__device__ __forceinline__ int blocked(int row, int col, int rows) {
  return (col >> 4) * rows * 16 + row * 16 + (col & 15);
}

__device__ __forceinline__ signed char quantize(__nv_bfloat16 h) {
  float q = rintf(__fmul_rn(__bfloat162float(h), 20.0f));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(q));
}

// 16 bf16 values (two 16-byte vectors) -> 16 int8 values (one vector).
__device__ __forceinline__ uint4 quantize16(uint4 lo, uint4 hi) {
  uint4 out;
  signed char* q = reinterpret_cast<signed char*>(&out);
  const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&lo);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&hi);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    q[i] = quantize(a[i]);
    q[8 + i] = quantize(b[i]);
  }
  return out;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
band_conv_kernel(const typename Types<kMode>::In* __restrict__ x,
                 const typename Types<kMode>::Tap* __restrict__ w, int wp,
                 int band, bool rolls, __nv_bfloat16* __restrict__ out) {
  using Tap = typename Types<kMode>::Tap;
  using Acc = typename Types<kMode>::Acc;
  constexpr int kEl = 16 / sizeof(Tap);   // tap elements per 16-byte vector
  constexpr int kVec = kC / kEl;          // vectors per operand row
  constexpr int kOutVec = kC / 8;         // bf16 output vectors per row

  extern __shared__ __align__(128) unsigned char smem[];
  Tap* s_a = reinterpret_cast<Tap*>(smem);
  Tap* s_b = s_a + kTileM * kC;

  const int m2 = (band - 2) * wp;
  const int m0 = blockIdx.x * kTileM;
  const long long band_row0 = static_cast<long long>(blockIdx.y) * band * wp;
  uint4* out4 = reinterpret_cast<uint4*>(out);

  // The band's first and last rows are zero; the band's CTAs share them out.
  {
    const int tiles = gridDim.x;
    const int tile = blockIdx.x;
    const int units = 2 * wp * kOutVec;
    const int chunk = (units + tiles - 1) / tiles;
    const int end = min(units, (tile + 1) * chunk);
    for (int u = tile * chunk + static_cast<int>(threadIdx.x); u < end; u += kThreads) {
      const int e = u / kOutVec;
      const long long row = band_row0 + (e < wp ? e : (band - 2) * wp + e);
      out4[row * kOutVec + u % kOutVec] = make_uint4(0, 0, 0, 0);
    }
  }

  const int warp = threadIdx.x / 32;
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 64;
  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0);
  }

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3;
    const int dx = tap % 3;
    // A: the tile's rows as the TPU kernel's slice + roll would read them
    for (int u = threadIdx.x; u < kTileM * kVec; u += kThreads) {
      const int i = u / kVec;
      const int c = u % kVec;
      const int r = m0 + i;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < m2) {
        const int src = (rolls ? (r + dx - 1 + m2) % m2 : r) + dy * wp;
        const long long row = band_row0 + src;
        if constexpr (kMode == 1) {
          const uint4* xr = reinterpret_cast<const uint4*>(x) + row * (kC / 8) + 2 * c;
          v = quantize16(xr[0], xr[1]);
        } else {
          v = reinterpret_cast<const uint4*>(x)[row * kVec + c];
        }
      }
      *reinterpret_cast<uint4*>(s_a + blocked(i, c * kEl, kTileM)) = v;
    }
    // B: w[dy, dx], 128 (in) x 128 (out), row-major
    const uint4* w4 = reinterpret_cast<const uint4*>(w + tap * kC * kC);
    for (int u = threadIdx.x; u < kC * kVec; u += kThreads) {
      const int k = u / kVec;
      const int c = u % kVec;
      *reinterpret_cast<uint4*>(s_b + blocked(k, c * kEl, kC)) = w4[u];
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, Tap, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, Tap, wmma::row_major> b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], s_a + blocked(wm + i * 16, k, kTileM), 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(b[j], s_b + blocked(k, wn + j * 16, kC), 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // Epilogue through shared memory: scale (int8), leaky 0.1, bf16.
  Acc* stage = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage + (wm + i * 16) * kStageLd + wn + j * 16,
                              acc[i][j], kStageLd, wmma::mem_row_major);
    }
  }
  __syncthreads();
  const float scale = __fmul_rn(0.05f, 0.01f);
  for (int u = threadIdx.x; u < kTileM * kOutVec; u += kThreads) {
    const int i = u / kOutVec;
    const int c = u % kOutVec;
    const int r = m0 + i;
    if (r >= m2) continue;
    uint4 v;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const Acc a = stage[i * kStageLd + c * 8 + e];
      float f;
      if constexpr (kMode == 0) {
        f = a;
      } else {
        f = __fmul_rn(__int2float_rn(a), scale);
      }
      h[e] = __float2bfloat16_rn(fmaxf(f, __fmul_rn(0.1f, f)));
    }
    out4[(band_row0 + wp + r) * kOutVec + c] = v;
  }
}

template <int kMode>
int launch(const void* x, const void* w, int h, int wp, int band, int rolls,
           void* out, cudaStream_t stream) {
  const int m2 = (band - 2) * wp;
  const dim3 grid((m2 + kTileM - 1) / kTileM, h / band);
  auto kernel = band_conv_kernel<kMode>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const typename Types<kMode>::In*>(x),
      static_cast<const typename Types<kMode>::Tap*>(w), wp, band, rolls != 0,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0: P3 (bf16 x and w); 1: P4 with bf16 x quantized in the kernel;
// 2: P4 with int8 x.  x, w and out are dense and 16-byte aligned, C = 128,
// h % band == 0, band >= 3 (the wrapper checks).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int refid_band_conv(const void* x, const void* w, int h, int wp,
                               int band, int rolls, int mode, void* out,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(x, w, h, wp, band, rolls, out, s);
    case 1: return launch<1>(x, w, h, wp, band, rolls, out, s);
    case 2: return launch<2>(x, w, h, wp, band, rolls, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
