// Restormer's pre-norm, for Hopper (sm_90a): the residual add in front of a
// transformer block's LayerNorm, then the LayerNorm over the channels of each
// pixel, in one pass over bf16 tensors.  Wrapper:
// refid_tpu_torch/ops/prenorm.py (prenorm, residual_add); one entry point,
// refid_prenorm.
//
// Replaces no TPU kernel: XLA fuses the add, the norm and the casts around
// them on the TPU.  It was added because PyTorch's eager chain, under bf16
// autocast, runs the norm in float32 on a channels-last view of the NCHW
// bf16 stream: a cast up (6 B an element), a transposing copy (8 B), a
// LayerNorm with one block a row of only 48-384 channels (8 B), and the next
// conv's cast back to bf16 (6 B); and the residual add before it, an NCHW
// stream plus a channels_last FFN output, runs in TensorIterator's strided
// kernel.  At 720p that chain held 107 ms of a 233 ms Restormer image.
//
// The arithmetic, in float32:
//   s = bf16(float(x) + float(r))          the eager bf16 add, bit for bit
//                                          (both roundings explicit, no FMA)
//   mean = sum_c s / C, var = sum_c (s - mean)^2 / C   (biased; two passes
//                                          over s, held in registers)
//   y = bf16((s - mean) * rsqrt(var + eps) * w + b)
// The statistics are taken from the rounded bf16 s, as the eager LayerNorm
// takes them from the sum the eager add returns; y is rounded to bf16 once,
// where the next conv's autocast rounds the float32 LayerNorm output today.
//
// Modes: the norm alone (no r: x is s, 4 B an element), the add and the norm
// (8 B), the add alone (no y: the residual at the end of a stage, 6 B).
//
// Layout.  x, r and s are NCHW-dense or channels_last-dense, each read or
// written where it lies (s in x's layout, as the eager add returns it); y is
// channels_last.  A block takes a tile of kTile = 64 consecutive pixels of
// one image across all C channels: lane l of every warp takes the pixel pair
// 2 l, 2 l + 1, and warp w the groups of 8 channels w, w + W, ... (NI groups
// a warp, W = C / 8 / NI warps: 6, 12, 24 and 24 warps, NI 1, 1, 1 and 2 at
// Restormer's 48, 96, 192 and 384 channels), held in registers as 8 words a
// group, one a channel (the pair's two bf16):
//   an NCHW operand moves as those words, 32 lanes on 128 contiguous bytes
//     of a channel's row;
//   a channels_last operand moves as two 16-byte vectors a pixel pair (8
//     channels of each pixel), turned into the words by byte permutes;
//   the statistics: each thread sums its groups for its two pixels, the W
//     warps' partials meet in shared memory (a barrier each for the mean and
//     the variance);
//   y is staged in shared memory as the tile's NHWC rows and stored as the
//     one contiguous span it is, 16-byte vectors, consecutive lanes on
//     consecutive vectors.  Storing each pair's two 16-byte vectors straight
//     from the registers, 2 C bytes apart, cost 15-30 % more time at the
//     720p shapes, and a design that staged the whole tile in shared memory
//     and reduced from it 5-20 % more (PERF.md §6).
// An NCHW image of an odd plane, and a ragged last tile, are read and written
// by masked 2-byte accesses.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes above.  (1, 96, 720, 1280)
// with a residual is 88.5 M elements, 708 MB, 0.211 ms.  Restormer's 88
// pre-norms and 8 stage ends at 720p move ~21.8 GB, 6.5 ms an image.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kTile = 64;                  // pixels a block
constexpr int kPairs = kTile / 2;          // pixel pairs a block: one a lane
constexpr int kMaxWarps = 32;
constexpr int kMaxGroups = 2;              // groups of 8 channels a warp
constexpr int kMaxChannels = 512;
constexpr int kMaxStage = kTile * (kMaxChannels + 8) * 2;   // y's staged rows

struct Args {
  const uint16_t* x;    // bf16 bits
  const uint16_t* r;    // null: no residual (s is x)
  uint16_t* s;          // null iff r is
  uint16_t* y;          // null: the add alone
  const float* w;
  const float* b;
  long long hw;         // pixels an image
  int channels;
  int tiles;            // tiles an image
  int x_cl, r_cl;       // 1: channels_last
  int words;            // hw even: 4-byte NCHW words
  float eps;
};

// The two bf16 of a word (low: the first pixel) as float32, and back.
__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return pack(__fadd_rn(lo(a), lo(b)), __fadd_rn(hi(a), hi(b)));
}

// A pixel pair's 8 channels (u: the first pixel, v: the second) as 8 words,
// one a channel, and back.
__device__ __forceinline__ void interleave(const uint4& u, const uint4& v, uint32_t w[8]) {
  const uint32_t U[4] = {u.x, u.y, u.z, u.w}, V[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[2 * k] = __byte_perm(U[k], V[k], 0x5410);
    w[2 * k + 1] = __byte_perm(U[k], V[k], 0x7632);
  }
}

__device__ __forceinline__ void deinterleave(const uint32_t w[8], uint4& u, uint4& v) {
  u = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                 __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
  v = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                 __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
}

// Where a thread's operands lie: image n's first channel row (NCHW) and
// first pixel (channels_last), and the pair's first pixel p.
struct At {
  long long plane, pixel, p;
};

// Channels 8 cg .. 8 cg + 7 of pixels p and p + 1 of t as 8 words; zeros
// past the image.
__device__ __forceinline__ void load_group(const uint16_t* t, int cl, const At& at, int cg,
                                           const Args& a, uint32_t w[8]) {
  const long long p = at.p;
  if (cl) {
    uint4 u = make_uint4(0, 0, 0, 0), v = u;
    const uint16_t* q = t + (at.pixel + p) * a.channels + 8 * cg;
    if (p < a.hw) u = __ldg(reinterpret_cast<const uint4*>(q));
    if (p + 1 < a.hw) v = __ldg(reinterpret_cast<const uint4*>(q + a.channels));
    interleave(u, v, w);
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint16_t* row = t + (at.plane + 8 * cg + j) * a.hw;
    if (a.words && p < a.hw) {
      w[j] = __ldg(reinterpret_cast<const uint32_t*>(row + p));
    } else {
      const uint32_t l = p < a.hw ? __ldg(row + p) : 0u;
      const uint32_t h = p + 1 < a.hw ? __ldg(row + p + 1) : 0u;
      w[j] = l | h << 16;
    }
  }
}

__device__ __forceinline__ void store_group(uint16_t* t, int cl, const At& at, int cg,
                                            const Args& a, const uint32_t w[8]) {
  const long long p = at.p;
  if (cl) {
    uint4 u, v;
    deinterleave(w, u, v);
    uint16_t* q = t + (at.pixel + p) * a.channels + 8 * cg;
    if (p < a.hw) *reinterpret_cast<uint4*>(q) = u;
    if (p + 1 < a.hw) *reinterpret_cast<uint4*>(q + a.channels) = v;
    return;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint16_t* row = t + (at.plane + 8 * cg + j) * a.hw;
    if (a.words && p < a.hw) {
      *reinterpret_cast<uint32_t*>(row + p) = w[j];
    } else {
      if (p < a.hw) row[p] = static_cast<uint16_t>(w[j]);
      if (p + 1 < a.hw) row[p + 1] = static_cast<uint16_t>(w[j] >> 16);
    }
  }
}

// The sum over the block's warps of each thread's (pixel 2 l, pixel 2 l + 1)
// sums, in every warp's lane l.
__device__ __forceinline__ float2 block_sum(float2 v, float2 (*part)[kPairs], int warps) {
  const int lane = threadIdx.x % 32;
  part[threadIdx.x / 32][lane] = v;
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
  for (int k = 0; k < warps; ++k) {
    t.x = __fadd_rn(t.x, part[k][lane].x);
    t.y = __fadd_rn(t.y, part[k][lane].y);
  }
  return t;
}

template <int NI>
__global__ void __launch_bounds__(kMaxWarps * 32) prenorm_kernel(Args a) {
  __shared__ float2 part[2][kMaxWarps][kPairs];   // the mean's and the variance's partials
  extern __shared__ uint4 stage[];                 // y: the tile's NHWC rows, C + 8 bf16 each
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const long long n = blockIdx.x / a.tiles;
  const long long p0 = static_cast<long long>(blockIdx.x % a.tiles) * kTile;
  const At at{n * a.channels, n * a.hw, p0 + 2 * lane};

  uint32_t v[NI][8];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int cg = warp + i * warps;
    load_group(a.x, a.x_cl, at, cg, a, v[i]);
    if (a.r != nullptr) {
      uint32_t q[8];
      load_group(a.r, a.r_cl, at, cg, a, q);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = add2(v[i][j], q[j]);
    }
  }
  if (a.s != nullptr) {
#pragma unroll
    for (int i = 0; i < NI; ++i) store_group(a.s, a.x_cl, at, warp + i * warps, a, v[i]);
  }
  if (a.y == nullptr) return;

  // the statistics of the pair's two pixels: the mean, then the centred
  // variance
  const float count = static_cast<float>(a.channels);
  float2 sum = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum.x = __fadd_rn(sum.x, lo(v[i][j]));
      sum.y = __fadd_rn(sum.y, hi(v[i][j]));
    }
  }
  sum = block_sum(sum, part[0], warps);
  const float m0 = __fdiv_rn(sum.x, count), m1 = __fdiv_rn(sum.y, count);
  sum = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d0 = __fsub_rn(lo(v[i][j]), m0), d1 = __fsub_rn(hi(v[i][j]), m1);
      sum.x = __fmaf_rn(d0, d0, sum.x);
      sum.y = __fmaf_rn(d1, d1, sum.y);
    }
  }
  sum = block_sum(sum, part[1], warps);
  const float r0 = rsqrtf(__fadd_rn(__fdiv_rn(sum.x, count), a.eps));
  const float r1 = rsqrtf(__fadd_rn(__fdiv_rn(sum.y, count), a.eps));

  // y into the staged rows, then out as the tile's contiguous NHWC span
  const int groups = a.channels / 8, row = groups + 1;   // 16-byte vectors a staged pixel
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int cg = warp + i * warps;
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * cg + j;
      const float g = __ldg(a.w + c), h = __ldg(a.b + c);
      w[j] = pack(__fmaf_rn(__fmul_rn(__fsub_rn(lo(v[i][j]), m0), r0), g, h),
                  __fmaf_rn(__fmul_rn(__fsub_rn(hi(v[i][j]), m1), r1), g, h));
    }
    deinterleave(w, stage[2 * lane * row + cg], stage[(2 * lane + 1) * row + cg]);
  }
  __syncthreads();
  const int pixels = static_cast<int>(min(static_cast<long long>(kTile), a.hw - p0));
  uint4* out = reinterpret_cast<uint4*>(a.y + (at.pixel + p0) * a.channels);
  for (int k = threadIdx.x; k < pixels * groups; k += blockDim.x) {
    out[k] = stage[k / groups * row + k % groups];
  }
}

template <int NI>
cudaError_t launch(const Args& a, unsigned int blocks, int warps, cudaStream_t stream) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = allow_dynamic_smem(reinterpret_cast<const void*>(prenorm_kernel<NI>), device, kMaxStage);
  if (err != cudaSuccess) return err;
  const int stage = a.y == nullptr ? 0 : kTile * (a.channels + 8) * 2;
  prenorm_kernel<NI><<<blocks, warps * 32, stage, stream>>>(a);
  return cudaGetLastError();
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The pre-norm of `images` images of `channels` x `hw` bf16 values: s = x +
// r (where r is given), y = LayerNorm over the channels of s with the
// float32 scale w and bias b (where y is given).  x_cl / r_cl: 1 where the
// operand is channels_last-dense, 0 where NCHW-dense; s is written in x's
// layout, y channels_last.  r and s are both given or both null; y needs w
// and b; x, r, s and y are 16-byte aligned; channels is a multiple of 8 in
// [8, 512] whose C / 8 groups split evenly into at most 32 warps of at most
// 2 groups (Restormer's 48 to 384); anything else returns
// cudaErrorInvalidValue.  Launches on `stream` and returns a CUDA error code
// (0 on success).
extern "C" int refid_prenorm(const void* x, int x_cl, const void* r, int r_cl, void* s, void* y,
                             const float* w, const float* b, long long images, int channels,
                             long long hw, float eps, void* stream) {
  const long long tiles = (hw + kTile - 1) / kTile;
  const int groups = channels / 8;
  int ni = (groups + kMaxWarps - 1) / kMaxWarps;     // the fewest groups a warp that divide
  while (ni <= kMaxGroups && groups % ni != 0) ++ni;
  if (x == nullptr || (r == nullptr) != (s == nullptr) || (r == nullptr && y == nullptr) ||
      (y != nullptr && (w == nullptr || b == nullptr)) || images < 1 || hw < 1 ||
      channels < 8 || channels > kMaxChannels || channels % 8 != 0 || ni > kMaxGroups ||
      tiles * images > 0x7fffffffLL || !aligned(x) || !aligned(r) || !aligned(s) ||
      !aligned(y) || x_cl < 0 || x_cl > 1 || r_cl < 0 || r_cl > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(r),
               static_cast<uint16_t*>(s), static_cast<uint16_t*>(y), w, b, hw, channels,
               static_cast<int>(tiles), x_cl, r_cl, hw % 2 == 0 ? 1 : 0, eps};
  const unsigned int blocks = static_cast<unsigned int>(tiles * images);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ni == 1 ? launch<1>(a, blocks, groups, st)
                                   : launch<2>(a, blocks, groups / 2, st));
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
