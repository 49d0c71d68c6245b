// int8 convolution for Hopper (sm_90a): the int8 serving path of
// refid_tpu_torch/serve/quant.py, three kernels.
//
// They replace no TPU kernel: the JAX package's int8 conv
// (refid_tpu/serve/quant.py::conv_int8, :147) is XLA's conv_general_dilated
// with int8 operands and int32 sums, and no PyTorch call computes an int8
// convolution on CUDA.
//
// quantize_int8: NCHW float32 or bf16 x -> NHWC int8 with the channels padded
// with zeros to a multiple of 32 (the MMA depth), q = clamp(rint(x / scale),
// -127, 127), x / scale correctly rounded as the plain version's division,
// computed without a divide (quantize_byte).  Bound: bytes, x read once
// (twice in dynamic mode) and xq written once.
// * amax_kernel (dynamic mode): |x| as the float's bits (non-negative floats
//   order as their bits; bf16 pairs as two halfwords, __vmaxu2), 16-byte
//   loads four in flight, a grid of 8 blocks an SM, warp reductions and one
//   atomicMax a block into a two-word state {amax bits, blocks done}.  The
//   amax pass alone (refid_amax_int8, a row shard's share of a group amax)
//   runs it with kFinish: the last block moves the max into the caller's
//   new (1,) buffer and zeroes the state, so that call is one launch (a
//   zeroed result buffer would be a second, a fill, before it).
// * quantize_kernel: a block transposes 32 channels x 256 pixels.  Each
//   thread loads 16-byte vectors along a channel's pixels, quantizes them
//   and writes their bytes into a [channel][pixel] byte tile in shared
//   memory; then each thread gathers 16 channels of one pixel and stores
//   them as one 16-byte vector, so a warp writes 16 whole 32-byte channel
//   runs.  In dynamic mode every block derives scale = max(amax, 1e-12) /
//   127 from the state, and the last block to do so resets the state to
//   zero for the next call: no memset on the host.  In device-amax mode
//   (a row shard of a frame, whose amax is the group's max of every shard's
//   amax_kernel result) the blocks derive the scale the same way from an
//   amax that the caller keeps in device memory, and leave it as it is.
//   Block 0 writes the scale
//   to device memory, where the conv kernel reads it, so no value goes back
//   to the host.  The NCHW read sits in load_tile() alone: a channels_last
//   network changes that function and nothing else.
//
// conv_int8: implicit GEMM, M = output pixels, N = Cout, K = kh kw Cin_padded,
// s8 x s8 -> s32 with wgmma.mma_async.m64nNk32, N fit to Cout (16, 32, 64,
// 128; wider Cout in 128-wide tiles, the last one padded).  At N 64 the
// operands swap: M = the 64 channels, N = the tile's 128 pixels, one
// m64n128k32 where two m64n64k32 would be (a wgmma costs about as much issue
// time at N 64 as at 128: 0.167 -> 0.137 ms at 64 -> 64, 720x1280, on the
// H100 in chip_smoke.py's evhinet_kernel_check).  Weights are packed
// once by the wrapper as (Cout, kh, kw, Cin_padded): K-major rows, as wgmma
// needs both 8-bit operands.  Bound: operations (2 M N K at 1979 TOP/s) at
// the wide sites, bytes at Cout 32 and 64 and at the 1x1s.
// * Tiles.  A tile is kTile = 128 output pixels, bh rows of bw (bw bh = 128,
//   bw a power of two), by N channels; the wrapper (ops/int8_cuda.py::
//   conv_plan) picks bw, N, the K chunk, the ring depth and the store path.
//   A persistent grid of one CTA per SM walks the tiles, N tile outermost.
//   Each CTA has 288 threads: one producer warp and two consumer
//   warpgroups, which take every other tile of the CTA's walk, each from a
//   ring of stages of its own, so one's epilogue overlaps the other's
//   products.
// * A by TMA from the NHWC int8 tensor, a 4-D map (cp, W, H, n); out-of-image
//   coordinates read zeros, which is the conv's padding, with no bounds
//   checks.  Rows and columns take their own padding (pad_h, pad_w): a row
//   shard whose halo rows sit in the tensor runs with pad_h 0.  A stride-1
//   conv wider than 1x1 loads, for each kernel row ky and K chunk, one box
//   of bw + kw - 1 pixels for each of the tile's bh
//   output rows, at (c0, ox0 - pad_w, oy0 + r - pad_h + ky, img), and the wgmma
//   descriptors of tap kx start kx rows into it (a row inside a swizzle
//   atom, base offset 0: the swizzle follows the address bits, for the 32-,
//   64- and 128-byte swizzles alike): kw times fewer A bytes through TMA and
//   the mainloop alone 2.4x faster at 64 -> 64 than with a box a tap.  Other
//   convs (1x1, 4x4/2) load a box of bw x bh pixels a tap at (c0, ox0 s -
//   pad_w + kx, oy0 s - pad_h + ky, img), element strides (1, s, s, 1), so a
//   stride-2 conv reads every other pixel.  K chunks of 128 bytes take the
//   128-byte swizzle; cp 32 and 64 take chunks of 32 and 64 bytes with the
//   32- and 64-byte swizzle, and the wgmma descriptors follow.
// * B by TMA from a 2-D map (kh kw cp, Cout): every N tile's weights
//   resident in shared memory, loaded once, when they fit beside a ring of 3
//   or more stages; else streamed in the ring's stages beside A (a box for
//   each tap the stage serves).  Rows past Cout read zeros.
// * Pipeline: full/empty mbarriers a stage; the producer thread issues
//   cp.async.bulk.tensor for the two warpgroups' tiles step by step, each
//   into its ring; a warpgroup issues one wgmma group a tap (unrolled at
//   compile time: a loop inside a group lets ptxas split it into batches
//   that the wait then serialises), keeps the last step's groups in flight,
//   and releases a stage when the groups that read it have completed.
// * Epilogue, in the plain version's order and rounding: acc -> out dtype;
//   x (wscale[co] xscale -> out dtype); + bias in the out dtype; relu or
//   max(y, y slope).  The N tile's factors sit in a table in shared memory,
//   and bf16 values round two at a time (finish_bf16).  Each group of 32
//   channels goes from the accumulator registers into a [channel][pixel]
//   tile in shared memory (bf16 by stmatrix .trans, 8 x 8 fragments at a
//   time), then store_group() writes each channel's runs of pixels, with
//   16-byte stores where the row width allows (wo a multiple of 16 bytes)
//   and element by element otherwise.  The NCHW layout of the output lives
//   in store_group() alone.  Swapped (N 64), a thread's pairs are two
//   neighbouring pixels of one channel, and all 64 channels go through the
//   staged tile at once (stmatrix without .trans; swap_epilogue()).

#include <cstddef>

#include "hopper.cuh"
#include "launch.cuh"

namespace {

// ---- quantize ----

constexpr int kQPix = 256;            // pixels a quantize block transposes
constexpr int kQCh = 32;              // channels a quantize block transposes
constexpr int kQRow = kQPix + 16;     // bytes a channel row of its tile takes

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// clamp(rint(x / s), -127, 127) as a byte, x / s correctly rounded as the
// plain version's division, without a division: with r = RN(1 / s), q = x r
// is within 1.5 ulp of x / s; one residual step (fma) brings it within 1 ulp
// and a second gives RN(x / s) (Markstein's theorem).  They run where the
// quotient decides the byte, 0.25 <= |q| < 256, and only for scales in
// [2^-100, 2^100] (`fast`), where no step underflows or overflows; outside
// that band q already gives 0 or the clamp, and other scales divide.  Then
// rint and the clamp as float arithmetic: clamping first gives the same
// value, and adding 1.5 * 2^23 rounds to the nearest integer, ties to even,
// leaving it in the low byte.  A division and two conversions issue at a
// quarter of the float rate or less; this is all float-rate arithmetic.
__device__ __forceinline__ uint32_t quantize_byte(float x, float s, float r, bool fast) {
  float q;
  if (fast) {
    q = __fmul_rn(x, r);
    if (fabsf(q) >= 0.25f && fabsf(q) < 256.0f) {
      q = __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
      q = __fmaf_rn(__fmaf_rn(-q, s, x), r, q);
    }
  } else {
    q = __fdiv_rn(x, s);
  }
  const float f = fminf(fmaxf(q, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(f, 12582912.0f)) & 0xFFu;
}

// |x| bits of a 16-byte vector folded into m: float32 as words, bf16 as
// halfword pairs (the caller widens them at the end)
__device__ __forceinline__ uint32_t fold(uint32_t m, uint32_t w, float) {
  return max(m, w & 0x7FFFFFFFu);
}
__device__ __forceinline__ uint32_t fold(uint32_t m, uint32_t w, __nv_bfloat16) {
  return __vmaxu2(m, w & 0x7FFF7FFFu);
}
template <typename T>
__device__ __forceinline__ uint32_t fold4(uint32_t m, uint4 v, T t) {
  return fold(fold(fold(fold(m, v.x, t), v.y, t), v.z, t), v.w, t);
}
__device__ __forceinline__ uint32_t float_bits(uint32_t m, float) { return m; }
__device__ __forceinline__ uint32_t float_bits(uint32_t m, __nv_bfloat16) {
  return max(m & 0xFFFFu, m >> 16) << 16;
}
__device__ __forceinline__ uint32_t scalar_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t scalar_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

// state[0] |= max |x| as float bits (state is {amax bits, blocks done}).
// kFinish (the amax pass alone): the last block to add its max also moves
// the total to *out and leaves the state zero for the next call, so the
// pass is one launch; without it the quantize kernel reads and resets it.
template <typename T, bool kFinish>
__global__ void __launch_bounds__(256) amax_kernel(const T* __restrict__ x, long long total,
                                                   int vec_ok, unsigned int* __restrict__ state,
                                                   float* __restrict__ out) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const T tag{};
  uint32_t m = 0;
  const long long nth = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vec_ok) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const long long nvec = total / kV;
    long long i = tid;
    for (; i + 3 * nth < nvec; i += 4 * nth) {
      const uint4 a = __ldg(xv + i), b = __ldg(xv + i + nth), c = __ldg(xv + i + 2 * nth),
                  d = __ldg(xv + i + 3 * nth);
      m = fold4(fold4(fold4(fold4(m, a, tag), b, tag), c, tag), d, tag);
    }
    for (; i < nvec; i += nth) m = fold4(m, __ldg(xv + i), tag);
    done = nvec * kV;
  }
  m = float_bits(m, tag);
  for (long long i = done + tid; i < total; i += nth) {
    m = max(m, float_bits(scalar_bits(x[i]) & (sizeof(T) == 4 ? 0x7FFFFFFFu : 0x7FFFu), tag));
  }
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ uint32_t part[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = __reduce_max_sync(0xffffffffu, lane < 8 ? part[lane] : 0u);
    if (lane == 0) {
      atomicMax(state, m);
      if constexpr (kFinish) {
        __threadfence();      // this block's max is in before it counts itself
        if (atomicAdd(state + 1, 1u) == gridDim.x - 1) {   // every block's is in
          *out = __uint_as_float(atomicExch(state, 0u));
          state[1] = 0u;
        }
      }
    }
  }
}

// The NCHW read: channels c0.. c0 + 31 x pixels p0.. p0 + 255 of image img,
// quantized, into tile[channel][pixel] (bytes); zeros past c and hw.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, unsigned char* tile, int img,
                                          int c, int hw, int c0, int p0, bool vec_ok,
                                          float scale) {
  const float recip = __frcp_rn(scale);
  const bool fast = scale >= 0x1p-100f && scale <= 0x1p100f;
  constexpr int kV = 16 / static_cast<int>(sizeof(T));   // pixels a 16-byte vector holds
  constexpr int kIters = kQPix / kV / 8;                  // vectors a thread loads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = 4 * warp + (lane >> 3);                  // 4 channels a warp
  const int chan = c0 + ch;
  const T* row = x + (static_cast<long long>(img) * c + chan) * hw;
#pragma unroll
  for (int k = 0; k < kIters; ++k) {
    const int j = (lane & 7) + 8 * k;
    const int p = p0 + j * kV;
    uint32_t q[kV];
    if (chan < c && vec_ok && p + kV <= hw) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + p));
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < kV; ++i) q[i] = quantize_byte(to_float(e[i]), scale, recip, fast);
    } else {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        q[i] = chan < c && p + i < hw ? quantize_byte(to_float(row[p + i]), scale, recip, fast)
                                       : 0u;
      }
    }
    unsigned char* dst = tile + ch * kQRow + j * kV;
    if constexpr (kV == 8) {
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24),
                     q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24));
    } else {
      *reinterpret_cast<uint32_t*>(dst) = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x,
                                                       signed char* __restrict__ xq, int c,
                                                       int hw, int cp, int vec_ok,
                                                       unsigned int* __restrict__ state,
                                                       int reset, float static_scale,
                                                       float* __restrict__ scale_out) {
  __shared__ __align__(16) unsigned char tile[kQCh * kQRow];
  __shared__ float block_scale;
  if (threadIdx.x == 0) {
    float scale = static_scale;
    if (state != nullptr) {
      const unsigned int bits = *reinterpret_cast<volatile unsigned int*>(state);
      scale = __fdiv_rn(fmaxf(__uint_as_float(bits), 1e-12f), 127.0f);
      if (reset) {
        __threadfence();      // the read is done before this block counts itself
        const unsigned int blocks = gridDim.x * gridDim.y * gridDim.z;
        if (atomicAdd(state + 1, 1u) == blocks - 1) {   // every block has read it
          state[0] = 0u;
          state[1] = 0u;
        }
      }
    }
    if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) *scale_out = scale;
    block_scale = scale;
  }
  __syncthreads();
  // channel groups of one pixel range run side by side (blockIdx.x): each
  // pixel's run of cp bytes is written whole while it sits in L2
  const int img = blockIdx.z, c0 = blockIdx.x * kQCh;
  const int half = threadIdx.x & 1;
  for (int p0 = blockIdx.y * kQPix; p0 < hw; p0 += gridDim.y * kQPix) {
    load_tile(x, tile, img, c, hw, c0, p0, vec_ok != 0, block_scale);
    __syncthreads();
    // thread t: half t % 2 (16 channels) of pixel t / 2 (+ 128)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int pl = (threadIdx.x >> 1) + 128 * k;
      const int p = p0 + pl;
      if (p >= hw) continue;
      const unsigned char* src = tile + half * 16 * kQRow + pl;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = static_cast<uint32_t>(src[(4 * i) * kQRow]) |
               (static_cast<uint32_t>(src[(4 * i + 1) * kQRow]) << 8) |
               (static_cast<uint32_t>(src[(4 * i + 2) * kQRow]) << 16) |
               (static_cast<uint32_t>(src[(4 * i + 3) * kQRow]) << 24);
      }
      *reinterpret_cast<uint4*>(xq + (static_cast<long long>(img) * hw + p) * cp + c0 +
                                16 * half) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();            // the tile is read before the next range loads
  }
}

// max |x| over `total` elements into *state (as float bits; the state zero
// before); with `out` (the amax pass alone) into *out, the state left zero
template <typename T>
int launch_amax(const T* xt, long long total, unsigned int* state, float* out,
                cudaStream_t stream) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(xt) % 16 == 0;
  int device = 0, sms = 0;
  const cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (total / kV + 255) / 256;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  if (blocks < 1) blocks = 1;
  if (out != nullptr) {
    amax_kernel<T, true><<<static_cast<int>(blocks), 256, 0, stream>>>(xt, total, aligned,
                                                                        state, out);
  } else {
    amax_kernel<T, false><<<static_cast<int>(blocks), 256, 0, stream>>>(xt, total, aligned,
                                                                         state, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// mode 0: the static `scale`; 1: dynamic, the amax reduced into the
// two-word `amax_state`, reset by the quantize blocks; 2: the scale from
// the amax that `amax_state` holds in device memory, left as it is
template <typename T>
int launch_quantize(const void* x, int n, int c, int hw, int cp, int mode, float scale,
                    void* amax_state, void* scale_out, void* xq, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  unsigned int* state = mode ? static_cast<unsigned int*>(amax_state) : nullptr;
  if (mode == 1) {
    const int err = launch_amax(xt, static_cast<long long>(n) * c * hw, state, nullptr, stream);
    if (err != 0) return err;
  }
  const int ranges = (hw + kQPix - 1) / kQPix;
  const dim3 grid(cp / kQCh, ranges < 65535 ? ranges : 65535, n);
  quantize_kernel<T><<<grid, 256, 0, stream>>>(xt, static_cast<signed char*>(xq), c, hw, cp,
                                                aligned && hw % kV == 0, state, mode == 1,
                                                scale, static_cast<float*>(scale_out));
  return static_cast<int>(cudaGetLastError());
}

// ---- conv ----

constexpr int kTile = 128;            // output pixels a tile: one warpgroup's, 2 m64 blocks
constexpr int kConsumerWarps = 8;     // two warpgroups, each on tiles of its own
constexpr int kThreads = 32 * kConsumerWarps + 32;   // + one producer warp
constexpr int kGroup = 32;            // output channels the epilogue stages at a time
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use (227 KB)
constexpr int kMaxStages = 12;        // two rings of 2 to 6 stages

// The conv's shape and its tile plan (ops/int8_cuda.py::conv_plan), by value.
struct ConvGeom {
  int co, cp, kw, stride, pad_h, pad_w, ho, wo;
  int bw, bh, bw_shift, chunk, stages, resident, vector_store;   // bw = 1 << bw_shift
  int shared;                         // one A box a tile row serves every kx
  int tiles_x, tiles_y, m_tiles, tiles, steps, chunks_per_tap, taps, b_boxes, n_tiles;
  int a_box, a_area, a_tx;            // A: a box slot, a stage's A bytes, bytes landed
  int stage_bytes, b_box, b_tx;       // a stage (A + streamed B); a B slot and its bytes
  int b_offset, staging_offset, table_offset, bar_offset, staging_row;
  int act;
  float slope;
};

template <int kOut>
struct Out;
template <>
struct Out<0> {
  using T = float;
};
template <>
struct Out<1> {
  using T = __nv_bfloat16;
};

// Two floats rounded to bf16 (one packed conversion) and back to float.
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The plain version's epilogue for the sums of two neighbouring channels, in
// its order and rounding: acc -> out dtype; x scale; + bias; relu or
// max(y, y slope).  `scale` and `bias` are the channels' factors already in
// the out dtype's values (the factor table).  float32 out:
__device__ __forceinline__ float2 finish_f32(int a0, int a1, float2 scale, float2 bias,
                                             bool has_bias, int act, float slope) {
  float y0 = __fmul_rn(__int2float_rn(a0), scale.x);
  float y1 = __fmul_rn(__int2float_rn(a1), scale.y);
  if (has_bias) {
    y0 = __fadd_rn(y0, bias.x);
    y1 = __fadd_rn(y1, bias.y);
  }
  if (act == 1) {
    y0 = fmaxf(y0, 0.0f);
    y1 = fmaxf(y1, 0.0f);
  } else if (act == 2) {
    y0 = fmaxf(y0, __fmul_rn(y0, slope));
    y1 = fmaxf(y1, __fmul_rn(y1, slope));
  }
  return make_float2(y0, y1);
}

// bf16 out, as a bf16 pair (a0 in the low half).  Conversions issue at a
// quarter of the float rate, so values round two at a time, and the pair
// comes from the floats' high halves (each is a bf16 value by then).
__device__ __forceinline__ uint32_t finish_bf16(int a0, int a1, float2 scale, float2 bias,
                                                bool has_bias, int act, float slope) {
  float2 y = bf16_round2(__int2float_rn(a0), __int2float_rn(a1));
  y = bf16_round2(__fmul_rn(y.x, scale.x), __fmul_rn(y.y, scale.y));
  if (has_bias) y = bf16_round2(__fadd_rn(y.x, bias.x), __fadd_rn(y.y, bias.y));
  if (act == 1) {
    y.x = fmaxf(y.x, 0.0f);
    y.y = fmaxf(y.y, 0.0f);
  } else if (act == 2) {
    const float2 t = bf16_round2(__fmul_rn(y.x, slope), __fmul_rn(y.y, slope));
    y.x = fmaxf(y.x, t.x);
    y.y = fmaxf(y.y, t.y);
  }
  return __byte_perm(__float_as_uint(y.x), __float_as_uint(y.y), 0x7632);
}

// The NCHW store of one staged group: `chans` channels from ch0 x the tile's
// kTile pixels (bh rows of bw from (oy0, ox0)), staged as [channel][pixel]
// with rows of g.staging_row bytes.  The warpgroup's 128 threads share it.
template <int kOut>
__device__ __forceinline__ void store_group(const unsigned char* staging, const ConvGeom& g,
                                            void* out, int img, int ch0, int chans, int oy0,
                                            int ox0, int tid) {
  using T = typename Out<kOut>::T;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (g.vector_store) {       // wo and bw multiples of kVec: a vector is all in or all out
    constexpr int kPerCh = kTile / kVec;
    for (int u = tid; u < chans * kPerCh; u += 128) {
      const int c = u / kPerCh, r0 = (u - c * kPerCh) * kVec;
      const int ch = ch0 + c, ry = r0 >> g.bw_shift, oy = oy0 + ry;
      const int ox = ox0 + r0 - (ry << g.bw_shift);
      if (ch >= g.co || oy >= g.ho || ox >= g.wo) continue;
      const long long o = ((static_cast<long long>(img) * g.co + ch) * g.ho + oy) * g.wo + ox;
      *reinterpret_cast<uint4*>(static_cast<T*>(out) + o) =
          *reinterpret_cast<const uint4*>(staging + c * g.staging_row + r0 * sizeof(T));
    }
  } else {
    for (int u = tid; u < chans * kTile; u += 128) {
      const int c = u / kTile, r = u - c * kTile;
      const int ch = ch0 + c, ry = r >> g.bw_shift, oy = oy0 + ry;
      const int ox = ox0 + r - (ry << g.bw_shift);
      if (ch >= g.co || oy >= g.ho || ox >= g.wo) continue;
      const long long o = ((static_cast<long long>(img) * g.co + ch) * g.ho + oy) * g.wo + ox;
      static_cast<T*>(out)[o] =
          *reinterpret_cast<const T*>(staging + c * g.staging_row + r * sizeof(T));
    }
  }
}

// Tile `tile` of the CTA's walk -> its N tile and first output pixel.
__device__ __forceinline__ void tile_origin(const ConvGeom& g, int tile, int& nt, int& img,
                                            int& oy0, int& ox0) {
  nt = tile / g.m_tiles;
  const int mt = tile - nt * g.m_tiles;
  const int per_img = g.tiles_x * g.tiles_y;
  img = mt / per_img;
  const int r = mt - img * per_img;
  const int ty = r / g.tiles_x;
  oy0 = ty * g.bh;
  ox0 = (r - ty * g.tiles_x) * g.bw;
}

// The epilogue with swapped operands (N 64): sum v of this thread holds
// channel 16 wi + lane / 4 + 8 ((v / 2) % 2) and pixel 8 (v / 4) + 2 (lane %
// 4) + v % 2, so each pair (v, v + 1) is two neighbouring pixels of one
// channel.  All 64 channels go through the warpgroup's staged tile at once
// (bf16 by stmatrix: 8 x 8 fragments of 8 channels x 8 pixels, stored as
// they are), then store_group().
template <int kOut>
__device__ __forceinline__ void swap_epilogue(const int (&acc)[kTile / 2], const float* table,
                                              unsigned char* staging, const ConvGeom& g,
                                              bool has_bias, void* out, int img, int oy0,
                                              int ox0, int wi, int lane, int tid, int wg) {
  constexpr int kBN = 64;
  named_sync(1 + wg, 128);          // the last tile's stores have read it; the table is in
  const int c0 = 16 * wi + (lane >> 2);             // this thread's channels: c0, c0 + 8
  const float2 sc[2] = {make_float2(table[c0], table[c0]),
                        make_float2(table[c0 + 8], table[c0 + 8])};
  const float2 bi[2] = {make_float2(table[kBN + c0], table[kBN + c0]),
                        make_float2(table[kBN + c0 + 8], table[kBN + c0 + 8])};
  if constexpr (kOut == 1) {
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2) {       // 8-pixel chunks j and j + 1
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // fragment i: chunk j + i / 2, channels c0 + 8 (i % 2)
        const int v = 4 * (j + i / 2) + 2 * (i & 1);
        r[i] = finish_bf16(acc[v], acc[v + 1], sc[i & 1], bi[i & 1], has_bias, g.act, g.slope);
      }
      const int i = lane >> 3;       // the fragment whose row this lane addresses
      stmatrix(staging + (16 * wi + 8 * (i & 1) + (lane & 7)) * g.staging_row +
                   8 * (j + i / 2) * 2,
               r);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 4 * j + 2 * h;
        *reinterpret_cast<float2*>(staging + (c0 + 8 * h) * g.staging_row +
                                   (8 * j + 2 * (lane & 3)) * 4) =
            finish_f32(acc[v], acc[v + 1], sc[h], bi[h], has_bias, g.act, g.slope);
      }
    }
  }
  named_sync(1 + wg, 128);
  store_group<kOut>(staging, g, out, img, 0, kBN, oy0, ox0, tid);
}

template <int kBN, int kOut, int kChunk>
__global__ void __launch_bounds__(kThreads, 1)
conv_int8_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                 const float* __restrict__ wscale, const float* __restrict__ xscale,
                 const float* __restrict__ bias, const ConvGeom g, void* __restrict__ out) {
  // N 64: the operands swap, M = the 64 channels and N = the tile's 128
  // pixels, one m64n128k32 where two m64n64k32 would be (a wgmma takes about
  // as long to issue at N 64 as at 128)
  constexpr bool kSwap = kBN == 64;
  constexpr int kMB = kSwap ? 1 : 2;                // m64 blocks a warpgroup
  constexpr int kR = kSwap ? kTile / 2 : kBN / 2;   // s32 sums a thread holds a block
  constexpr int kGroups = (kBN + kGroup - 1) / kGroup;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* b_mem = smem + g.b_offset;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_offset);
  uint64_t* empty = full + g.stages;
  uint64_t* b_full = empty + g.stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);              // the warps of the warpgroup that read it
    }
    mbar_init(b_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every TMA load, the CTA's tiles in order ----
    if (lane != 0) return;
    if (g.resident) {                       // every N tile's weights, once
      mbar_expect_tx(b_full, static_cast<uint32_t>(g.n_tiles * g.b_boxes) * g.b_tx);
      for (int nt = 0; nt < g.n_tiles; ++nt) {
        for (int j = 0; j < g.b_boxes; ++j) {   // box j: tap j / chunks, chunk j % chunks
          const int tap = j / g.chunks_per_tap;
          tma_load(b_mem + (nt * g.b_boxes + j) * g.b_box, &tw, b_full,
                   tap * g.cp + (j - tap * g.chunks_per_tap) * g.chunk, nt * kBN);
        }
      }
    }
    // tiles in pairs, warpgroup r's tile into ring r, step by step
    const int per_ring = g.stages / 2;
    int slot[2] = {0, 0};
    uint32_t ph[2] = {0, 0};
    for (int pair = blockIdx.x; pair < g.tiles; pair += 2 * gridDim.x) {
      int nt[2], img[2], oy0[2], ox0[2];
      const int rings = pair + gridDim.x < g.tiles ? 2 : 1;
      for (int r = 0; r < rings; ++r) {
        tile_origin(g, pair + r * gridDim.x, nt[r], img[r], oy0[r], ox0[r]);
      }
      for (int k = 0; k < g.steps; ++k) {
        // step k: K chunk c0 of tap t0 (shared: of kernel row ky = t0, every kx)
        const int t0 = k / g.chunks_per_tap;
        const int c0 = (k - t0 * g.chunks_per_tap) * g.chunk;
        for (int r = 0; r < rings; ++r) {
          const int s = r * per_ring + slot[r];
          unsigned char* st = smem + s * g.stage_bytes;
          mbar_wait(&empty[s], ph[r] ^ 1);
          mbar_expect_tx(&full[s], g.a_tx + (g.resident ? 0 : g.taps * g.b_tx));
          if (g.shared) {        // a box of bw + kw - 1 pixels for each output row
            for (int row = 0; row < g.bh; ++row) {
              tma_load(st + row * g.a_box, &tx, &full[s], c0, ox0[r] - g.pad_w,
                       oy0[r] + row - g.pad_h + t0, img[r]);
            }
          } else {
            const int ky = t0 / g.kw, kx = t0 - ky * g.kw;
            tma_load(st, &tx, &full[s], c0, ox0[r] * g.stride - g.pad_w + kx,
                     oy0[r] * g.stride - g.pad_h + ky, img[r]);
          }
          if (!g.resident) {
            for (int t = 0; t < g.taps; ++t) {
              tma_load(st + g.a_area + t * g.b_box, &tw, &full[s],
                       (g.shared ? t0 * g.kw + t : t0) * g.cp + c0, nt[r] * kBN);
            }
          }
          if (++slot[r] == per_ring) {
            slot[r] = 0;
            ph[r] ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes every other tile of the CTA's walk
  // from a ring of its own, so the two run side by side and one's epilogue
  // overlaps the other's products ----
  // warp-uniform for the compiler (a shuffle from lane 0), so the stages'
  // addresses and the wgmma descriptors live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, warp / 4, 0);
  const int wi = warp % 4;
  const int tid = threadIdx.x % 128;
  unsigned char* staging =
      smem + g.staging_offset + wg * (kSwap ? kBN : kGroup) * g.staging_row;
  float* table = reinterpret_cast<float*>(smem + g.table_offset) + wg * 2 * kBN;
  int acc[kMB][kR];
  const float xs = *xscale;

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };

  if (g.resident) mbar_wait(b_full, 0);
  const int per_ring = g.stages / 2;
  int slot = 0;
  uint32_t ph = 0;
  int table_nt = -1;                                         // the N tile in the table
  for (int tile = blockIdx.x + wg * gridDim.x; tile < g.tiles; tile += 2 * gridDim.x) {
    int nt, img, oy0, ox0;
    tile_origin(g, tile, nt, img, oy0, ox0);
    const int n0 = nt * kBN;
    // the N tile's per-channel factors in the out dtype's values, when the N
    // tile changes (their loads would hold up the mainloop on every tile);
    // the last tile's epilogue has read the table (its final named_sync)
    if (nt != table_nt && tid < kBN) {
      const int ch = n0 + tid;
      float sc = 0.0f, bi = 0.0f;
      if (ch < g.co) {
        sc = __fmul_rn(wscale[ch], xs);
        if (bias != nullptr) bi = bias[ch];
        if constexpr (kOut == 1) {
          sc = __bfloat162float(__float2bfloat16_rn(sc));
          bi = __bfloat162float(__float2bfloat16_rn(bi));
        }
      }
      table[tid] = sc;
      table[kBN + tid] = bi;
    }
    table_nt = nt;
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int v = 0; v < kR; ++v) acc[mb][v] = 0;
    }
    int prev = -1;      // the stage of the last step, whose groups may be in flight
    for (int k = 0; k < g.steps; ++k) {
      const int t0 = k / g.chunks_per_tap, cc = k - t0 * g.chunks_per_tap;
      const int s = wg * per_ring + slot;
      const unsigned char* st = smem + s * g.stage_bytes;
      mbar_wait(&full[s], ph);
      // one wgmma group a tap, unrolled at compile time (a loop inside a
      // group would let ptxas split it into batches, and the wait below
      // would then wait for nearly all of them)
      for (int t = 0; t < g.taps; ++t) {
        const int tap = g.shared ? t0 * g.kw + t : t0;
        const unsigned char* b =
            g.resident ? b_mem + (nt * g.b_boxes + tap * g.chunks_per_tap + cc) * g.b_box
                       : st + g.a_area + t * g.b_box;
        // the A operand's rows, computed before the fence (descriptor
        // arithmetic between the fence and a wgmma makes ptxas inject more):
        // swapped, the tile's 128 pixels, one row of the box (shared mode: bh
        // 1) read t rows into it; else m64 block mb's pixels 64 mb .. 64 mb +
        // 63, in shared mode one output row's run (bw >= 64)
        const unsigned char* a[kMB];
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) {
          const int p = 64 * mb;
          a[mb] = g.shared ? st + (p / g.bw) * g.a_box + (p % g.bw + t) * kChunk
                           : st + p * kChunk;
        }
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) fence_operands(acc[mb]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kChunk; ks += 32) {
          if constexpr (kSwap) {
            wgmma_tile(acc[0], smem_desc(b + ks, kChunk), smem_desc(a[0] + ks, kChunk));
          } else {
            const uint64_t db = smem_desc(b + ks, kChunk);
            wgmma_tile(acc[0], smem_desc(a[0] + ks, kChunk), db);
            wgmma_tile(acc[1], smem_desc(a[1] + ks, kChunk), db);
          }
        }
        wgmma_commit();
#pragma unroll
        for (int mb = 0; mb < kMB; ++mb) fence_operands(acc[mb]);
        if (t == 0) {
          wgmma_wait<1>();          // every group of the previous step has completed
          if (prev >= 0) release(&empty[prev]);
        }
      }
      prev = s;
      if (++slot == per_ring) {
        slot = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) fence_operands(acc[mb]);
    release(&empty[prev]);

    if constexpr (kSwap) {
      swap_epilogue<kOut>(acc[0], table, staging, g, bias != nullptr, out, img, oy0, ox0, wi,
                          lane, tid, wg);
    } else {
      // epilogue: kGroup channels at a time through the warpgroup's staged
      // tile ([channel][pixel]).  Register v of m64 block mb holds pixel
      // 64 mb + 16 wi + lane / 4 + 8 ((v / 2) % 2), channel 8 (v / 4) + 2 (lane
      // % 4) + v % 2: each 8-channel chunk j (v = 4 j .. 4 j + 3) is two 8 x 8
      // fragments (pixels 0-7 and 8-15 of the warp's 16), which stmatrix .trans
      // stores as 8 channel rows of 8 pixels (bf16); float32 goes one value a
      // store.
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        constexpr int kChunks = (kBN < kGroup ? kBN : kGroup) / 8;   // 8-channel chunks a group
        named_sync(1 + wg, 128);          // the last group's stores have read it
        float2 fs[kChunks], fb[kChunks];  // this thread's channels' factors
#pragma unroll
        for (int j = 0; j < kChunks; ++j) {
          const int col = 8 * j + 2 * (lane & 3);
          fs[j] = *reinterpret_cast<const float2*>(table + grp * kGroup + col);
          fb[j] = *reinterpret_cast<const float2*>(table + kBN + grp * kGroup + col);
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const int row0 = mb * 64 + wi * 16;
          if constexpr (kOut == 1) {
            uint32_t r[kChunks / 2][4];      // every chain of the block first, then the stores
#pragma unroll
            for (int j = 0; j < kChunks; j += 2) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {    // fragment i: chunk j + i / 2, pixels 8 (i % 2) ..
                const int v = 4 * (grp * kGroup / 8 + j + i / 2) + 2 * (i & 1);
                r[j / 2][i] = finish_bf16(acc[mb][v], acc[mb][v + 1], fs[j + i / 2],
                                          fb[j + i / 2], bias != nullptr, g.act, g.slope);
              }
            }
#pragma unroll
            for (int j = 0; j < kChunks; j += 2) {
              const int i = lane >> 3;          // the fragment whose row this lane addresses
              stmatrix_trans(staging + (8 * (j + i / 2) + (lane & 7)) * g.staging_row +
                                 (row0 + 8 * (i & 1)) * 2,
                             r[j / 2]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < kChunks; ++j) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int v = 4 * (grp * kGroup / 8 + j) + 2 * h;
                const float2 y = finish_f32(acc[mb][v], acc[mb][v + 1], fs[j], fb[j],
                                            bias != nullptr, g.act, g.slope);
                unsigned char* dst = staging + (8 * j + 2 * (lane & 3)) * g.staging_row +
                                     (row0 + (lane >> 2) + 8 * h) * 4;
                *reinterpret_cast<float*>(dst) = y.x;
                *reinterpret_cast<float*>(dst + g.staging_row) = y.y;
              }
            }
          }
        }
        named_sync(1 + wg, 128);
        store_group<kOut>(staging, g, out, img, n0 + grp * kGroup,
                          kBN - grp * kGroup < kGroup ? kBN - grp * kGroup : kGroup, oy0, ox0,
                          tid);
      }
    }
  }
}

// A 4-D map of the NHWC int8 x (cp, w, h, n): boxes of chunk channels x
// (bw + kw - 1) x 1 pixels (shared), or x bw x bh at element strides (1, s,
// s, 1); zeros outside, the chunk's swizzle.  B: a 2-D map (kh kw cp, co),
// boxes of chunk x bn.
bool conv_maps(CUtensorMap* tx, CUtensorMap* tw, const void* xq, const void* wp, int n, int h,
               int w, int cp, int co, int kh, int kw, int stride, int bn, const ConvGeom& g) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const CUtensorMapSwizzle sw = swizzle_mode(g.chunk);
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(cp), static_cast<cuuint64_t>(w),
                               static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstrides[3] = {static_cast<cuuint64_t>(cp),
                                  static_cast<cuuint64_t>(cp) * w,
                                  static_cast<cuuint64_t>(cp) * w * h};
  const cuuint32_t xbox[4] = {
      static_cast<cuuint32_t>(g.chunk),
      static_cast<cuuint32_t>(g.shared ? g.bw + kw - 1 : g.bw * stride),
      static_cast<cuuint32_t>(g.shared ? 1 : g.bh * stride), 1u};
  const cuuint32_t xel[4] = {1u, static_cast<cuuint32_t>(stride),
                             static_cast<cuuint32_t>(stride), 1u};
  if (encode(tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(xq), xdims, xstrides, xbox,
             xel, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  const cuuint64_t k = static_cast<cuuint64_t>(kh) * kw * cp;
  const cuuint64_t wdims[2] = {k, static_cast<cuuint64_t>(co)};
  const cuuint64_t wstrides[1] = {k};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(g.chunk), static_cast<cuuint32_t>(bn)};
  const cuuint32_t wel[2] = {1u, 1u};
  return encode(tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), wdims, wstrides,
                wbox, wel, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kBN, int kOut, int kChunk>
int launch_conv(const CUtensorMap& tx, const CUtensorMap& tw, const float* wscale,
                const float* xscale, const float* bias, const ConvGeom& g, int smem, void* out,
                cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = conv_int8_kernel<kBN, kOut, kChunk>;
  // the most any plan uses (smem <= kMaxSmem), set once per instantiation
  err = allow_dynamic_smem(reinterpret_cast<const void*>(kernel), device, kMaxSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<g.tiles < sms ? g.tiles : sms, kThreads, smem, stream>>>(tx, tw, wscale, xscale, bias,
                                                                    g, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut, int kChunk>
int launch_conv_n(int bn, const CUtensorMap& tx, const CUtensorMap& tw, const float* wscale,
                  const float* xscale, const float* bias, const ConvGeom& g, int smem, void* out,
                  cudaStream_t stream) {
  switch (bn) {
    case 16:
      return launch_conv<16, kOut, kChunk>(tx, tw, wscale, xscale, bias, g, smem, out, stream);
    case 32:
      return launch_conv<32, kOut, kChunk>(tx, tw, wscale, xscale, bias, g, smem, out, stream);
    case 64:
      return launch_conv<64, kOut, kChunk>(tx, tw, wscale, xscale, bias, g, smem, out, stream);
    case 128:
      return launch_conv<128, kOut, kChunk>(tx, tw, wscale, xscale, bias, g, smem, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int kOut>
int launch_conv_c(int bn, const CUtensorMap& tx, const CUtensorMap& tw, const float* wscale,
                  const float* xscale, const float* bias, const ConvGeom& g, int smem, void* out,
                  cudaStream_t stream) {
  switch (g.chunk) {
    case 32: return launch_conv_n<kOut, 32>(bn, tx, tw, wscale, xscale, bias, g, smem, out, stream);
    case 64: return launch_conv_n<kOut, 64>(bn, tx, tw, wscale, xscale, bias, g, smem, out, stream);
    case 128:
      return launch_conv_n<kOut, 128>(bn, tx, tw, wscale, xscale, bias, g, smem, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (n, c, hw) dense, float32 (dtype 0) or bf16 (1); xq (n, hw, cp) int8 with
// cp a multiple of 32 >= c, 16-byte aligned; scale_out one float32;
// mode 0 static (`scale`); 1 dynamic: amax_state two uint32, zero before the
// first dynamic call and left zero by each (one state per stream); 2 device
// amax: amax_state one float32 amax in device memory, read and kept.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int refid_quantize_int8(const void* x, int dtype, int n, int c, int hw, int cp,
                                   int mode, float scale, void* amax_state, void* scale_out,
                                   void* xq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp % kQCh != 0 || cp < c || reinterpret_cast<uintptr_t>(xq) % 16 != 0 || mode < 0 ||
      mode > 2 || (mode != 0 && amax_state == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_quantize<float>(x, n, c, hw, cp, mode, scale, amax_state, scale_out, xq, s);
  }
  if (dtype == 1) {
    return launch_quantize<__nv_bfloat16>(x, n, c, hw, cp, mode, scale, amax_state,
                                          scale_out, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// x (total) dense, float32 (dtype 0) or bf16 (1); amax_state two uint32,
// zero before the call and left zero (the dynamic quantization's state of
// the stream); amax one float32: max |x| afterwards, whatever it held.  One
// launch on `stream`; returns cudaGetLastError().
extern "C" int refid_amax_int8(const void* x, int dtype, long long total, void* amax_state,
                               void* amax, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* state = static_cast<unsigned int*>(amax_state);
  auto* out = static_cast<float*>(amax);
  if (total < 1 || state == nullptr || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_amax(static_cast<const float*>(x), total, state, out, s);
  if (dtype == 1) {
    return launch_amax(static_cast<const __nv_bfloat16*>(x), total, state, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The conv's geometry and tile plan, as the wrapper passes them:
// ops/int8_cuda.py::ConvArgs mirrors this struct field for field (23 4-byte
// fields, in this order), and refid_conv_int8_abi reports its layout.
struct ConvArgs {
  int n, h, w, cp, co, kh, kw, stride, pad_h, pad_w, ho, wo, act;
  float slope;
  int out_dtype, bn, bw, bh, chunk, stages, resident, vector_store, shared;
};
#define CONV_ARGS_FIELDS(X)                                                                   \
  X(n) X(h) X(w) X(cp) X(co) X(kh) X(kw) X(stride) X(pad_h) X(pad_w) X(ho) X(wo) X(act)     \
  X(slope) X(out_dtype) X(bn) X(bw) X(bh) X(chunk) X(stages) X(resident) X(vector_store)    \
  X(shared)
#define CONV_ARGS_OFFSET(f) offsetof(ConvArgs, f),
constexpr size_t kConvArgsOffsets[] = {CONV_ARGS_FIELDS(CONV_ARGS_OFFSET)};
#undef CONV_ARGS_OFFSET
constexpr int kConvArgsFields = sizeof(kConvArgsOffsets) / sizeof(kConvArgsOffsets[0]);

constexpr bool conv_args_packed() {
  for (int i = 0; i < kConvArgsFields; ++i) {
    if (kConvArgsOffsets[i] != 4 * static_cast<size_t>(i)) return false;
  }
  return true;
}
static_assert(kConvArgsFields == 23 && sizeof(ConvArgs) == 23 * 4,
              "ConvArgs: 23 fields of 4 bytes, as ops/int8_cuda.py::ConvArgs");
static_assert(conv_args_packed(), "ConvArgs: fields in declaration order, 4 bytes apart");

// ConvArgs's layout as compiled: abi[0] its size in bytes, then each field's
// offset in declaration order, at most `cap` values; returns how many the
// full layout has (24).
extern "C" int refid_conv_int8_abi(long long* abi, int cap) {
  for (int i = 0; i <= kConvArgsFields && i < cap; ++i) {
    abi[i] = static_cast<long long>(i == 0 ? sizeof(ConvArgs) : kConvArgsOffsets[i - 1]);
  }
  return kConvArgsFields + 1;
}

// xq (n, h, w, cp) int8, wp (co, kh, kw, cp) int8, both 16-byte aligned;
// wscale (co) and xscale (1) float32, bias (co) float32 or null; out (n, co,
// ho, wo) float32 (out_dtype 0) or bf16 (1), 16-byte aligned; pad_h rows of
// zeros above and below, pad_w columns left and right.  act 0 none,
// 1 relu, 2 max(y, y slope).  The tile plan (bn, bw, bh, chunk, stages,
// resident, vector_store, shared) comes from ops/int8_cuda.py::conv_plan;
// a plan that does not fit returns cudaErrorInvalidValue.  The geometry and
// the plan come as one ConvArgs, which the wrapper builds once per conv
// shape.  Launches on `stream`; returns cudaGetLastError(), or a code of its
// own if a tensor map could not be encoded.
extern "C" int refid_conv_int8(const void* xq, const void* wp, const void* wscale,
                               const void* xscale, const void* bias, void* out,
                               const ConvArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ConvArgs& a = *args;
  const int n = a.n, h = a.h, w = a.w, cp = a.cp, co = a.co, kh = a.kh, kw = a.kw;
  const int stride = a.stride, pad_h = a.pad_h, pad_w = a.pad_w, ho = a.ho, wo = a.wo;
  const int act = a.act, out_dtype = a.out_dtype;
  const float slope = a.slope;
  const int bn = a.bn, bw = a.bw, bh = a.bh, chunk = a.chunk, stages = a.stages;
  const int resident = a.resident, vector_store = a.vector_store, shared = a.shared;
  const int out_bytes = out_dtype == 0 ? 4 : 2;
  if ((out_dtype != 0 && out_dtype != 1) || n < 1 || ho < 1 || wo < 1 || co < 1 ||
      (chunk != 32 && chunk != 64 && chunk != 128) || cp % chunk != 0 || bw * bh != kTile ||
      (bw & (bw - 1)) != 0 ||
      bw * stride > 256 || bh * stride > 256 || stages < 4 || stages % 2 != 0 ||
      stages > kMaxStages ||
      (vector_store && (wo % (16 / out_bytes) != 0 || bw % (16 / out_bytes) != 0)) ||
      (shared && (stride != 1 || kw < 2 || bw < 64 || bw + kw - 1 > 256)) ||
      (shared && bn == 64 && bh != 1) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvGeom g;
  g.co = co;
  g.cp = cp;
  g.kw = kw;
  g.stride = stride;
  g.pad_h = pad_h;
  g.pad_w = pad_w;
  g.ho = ho;
  g.wo = wo;
  g.bw = bw;
  g.bh = bh;
  g.bw_shift = __builtin_ctz(static_cast<unsigned>(bw));
  g.chunk = chunk;
  g.stages = stages;
  g.resident = resident;
  g.vector_store = vector_store;
  g.tiles_x = (wo + bw - 1) / bw;
  g.tiles_y = (ho + bh - 1) / bh;
  g.m_tiles = n * g.tiles_x * g.tiles_y;
  g.n_tiles = (co + bn - 1) / bn;
  const long long tiles = static_cast<long long>(g.m_tiles) * g.n_tiles;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  g.shared = shared;
  g.chunks_per_tap = cp / chunk;
  g.taps = shared ? kw : 1;
  g.steps = (shared ? kh : kh * kw) * g.chunks_per_tap;
  g.b_boxes = kh * kw * g.chunks_per_tap;
  g.a_box = shared ? ((bw + kw - 1) * chunk + 1023) / 1024 * 1024 : kTile * chunk;
  g.a_area = shared ? bh * g.a_box : kTile * chunk;
  g.a_tx = shared ? bh * (bw + kw - 1) * chunk : kTile * chunk;
  g.b_tx = bn * chunk;
  g.b_box = (g.b_tx + 1023) / 1024 * 1024;
  g.stage_bytes = g.a_area + (resident ? 0 : g.taps * g.b_box);
  // layout (after aligning the base to 1024 bytes): the stages (A, and B
  // when streamed), the resident B (every N tile), each warpgroup's staged
  // group and factor table, the mbarriers
  g.b_offset = stages * g.stage_bytes;
  g.staging_offset = g.b_offset + (resident ? g.n_tiles * g.b_boxes * g.b_box : 0);
  g.staging_row = kTile * out_bytes + 16;
  // a warpgroup stages kGroup channels at a time, all 64 with swapped operands
  g.table_offset = g.staging_offset + 2 * (bn == 64 ? 64 : kGroup) * g.staging_row;
  g.bar_offset = g.table_offset + 2 * 2 * bn * 4;
  g.act = act;
  g.slope = slope;
  const long long smem = 1024LL + g.bar_offset + 8LL * (2 * stages + 1);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx, tw;
  if (!conv_maps(&tx, &tw, xq, wp, n, h, w, cp, co, kh, kw, stride, bn, g)) {
    return kTensorMapError;
  }
  const auto* wsc = static_cast<const float*>(wscale);
  const auto* xsc = static_cast<const float*>(xscale);
  const auto* b = static_cast<const float*>(bias);
  if (out_dtype == 0) {
    return launch_conv_c<0>(bn, tx, tw, wsc, xsc, b, g, static_cast<int>(smem), out, s);
  }
  return launch_conv_c<1>(bn, tx, tw, wsc, xsc, b, g, static_cast<int>(smem), out, s);
}

extern "C" const char* refid_cuda_error_string(int code) {
  if (code == kTensorMapError) return "cuTensorMapEncodeTiled failed or was not found";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
