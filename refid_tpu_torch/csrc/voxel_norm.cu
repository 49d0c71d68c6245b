// Zero-mean, unit-deviation normalisation of a voxel grid over its nonzero
// cells, for Hopper (sm_90a): the card path of events/voxel.py::voxel_norm_np
// (wrapper events/voxel_cuda.py::voxel_norm_cuda), one entry point,
// refid_voxel_norm.
//
// Replaces no TPU kernel: refid_tpu/events/voxel.py::voxel_norm_np is host
// numpy in the JAX package too.  It was added because that numpy chain
// (about ten passes over the grid, each into freshly allocated, page-faulted
// memory) held the card idle for ~84 ms a 720p image in the deblur demo,
// while the grid had been on the card a moment earlier (K2 builds it there
// and copies it back into page-locked memory, which is what the wrapper
// takes).
//
// The formula is numpy's, in numpy's float64: count = #(v != 0) (a NaN
// counts), mean = sum / count, std = sqrt(sumsq / count - mean * mean),
// out = v != 0 ? (float)((v - mean) / std) : 0.  The sums are taken in
// float64 (numpy sums the float32 array in float32); every float64 step is an
// explicit round-to-nearest intrinsic, so no FMA contraction changes it.
//
// Bound on an H100 SXM (3.35 TB/s) at the demo's 720 x 1280 x 6 grid (22.1
// MB): read it once and write the result once, 44.2 MB, 0.0132 ms; the
// apply kernel's second read finds the grid in the 50 MB L2 (three passes
// from device memory would be 66.4 MB, 0.0198 ms).  The copies to and from
// the host (PCIe) cost far more.
//
// Design.  Two launches on the caller's stream, no float atomics, so the
// result is the same bits from run to run:
//   1. voxel_norm_stats_kernel, kBlocks blocks (a constant, so the order of
//      the sums depends on the grid's size alone): 16-byte loads, kUnroll in
//      flight a thread, grid-stride; each thread counts its nonzero floats
//      and sums them and their squares in float64; a fixed shuffle tree and
//      a fixed pass over the warps give the block's partial.
//   2. voxel_norm_apply_kernel, kBlocks blocks: warp 0 of each block reduces
//      the kBlocks partials in one fixed order, so every block computes the
//      same mean and deviation; then 16-byte loads (kUnroll in flight) and
//      stores of the result.
//      Block 0 also writes {count, mean, std} for the wrapper, whose count
//      decides whether an all-zero grid comes back unchanged.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 264;          // partials; two blocks an SM on an H100
constexpr int kUnroll = 4;            // 16-byte loads in flight a thread

struct Moments {
  double count, sum, sumsq;
};

__device__ __forceinline__ void accumulate(float v, Moments& m) {
  const double d = static_cast<double>(v);
  m.count = __dadd_rn(m.count, v != 0.f ? 1.0 : 0.0);
  m.sum = __dadd_rn(m.sum, d);
  m.sumsq = __dadd_rn(m.sumsq, __dmul_rn(d, d));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v = __dadd_rn(v, __shfl_down_sync(0xffffffffu, v, offset));
  }
  return v;
}

__device__ __forceinline__ Moments warp_sum(Moments m) {
  return {warp_sum(m.count), warp_sum(m.sum), warp_sum(m.sumsq)};
}

__device__ __forceinline__ float normalised(float v, double mean, double std) {
  return v != 0.f ? __double2float_rn(__ddiv_rn(__dsub_rn(static_cast<double>(v), mean), std))
                  : 0.f;
}

// partials: kBlocks counts, then kBlocks sums, then kBlocks sums of squares.
__global__ void __launch_bounds__(kThreads)
voxel_norm_stats_kernel(const float* __restrict__ in, long long n, double* __restrict__ partials) {
  __shared__ Moments per_warp[kWarps];
  const float4* in4 = reinterpret_cast<const float4*>(in);
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(kBlocks) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  Moments m{0.0, 0.0, 0.0};
  for (long long k = first; k < n4; k += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {   // zeros past the end add nothing
      const long long j = k + u * stride;
      v[u] = j < n4 ? in4[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      accumulate(v[u].x, m);
      accumulate(v[u].y, m);
      accumulate(v[u].z, m);
      accumulate(v[u].w, m);
    }
  }
  if (first < n - (n4 << 2)) accumulate(in[(n4 << 2) + first], m);   // the ragged tail
  m = warp_sum(m);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) per_warp[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? per_warp[lane] : Moments{0.0, 0.0, 0.0};
    m = warp_sum(m);
    if (lane == 0) {
      partials[blockIdx.x] = m.count;
      partials[kBlocks + blockIdx.x] = m.sum;
      partials[2 * kBlocks + blockIdx.x] = m.sumsq;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
voxel_norm_apply_kernel(const float* __restrict__ in, long long n,
                        const double* __restrict__ partials, float* __restrict__ out,
                        double* __restrict__ stats) {
  __shared__ double mean_std[2];
  if (threadIdx.x < 32) {
    Moments m{0.0, 0.0, 0.0};
    for (int b = threadIdx.x; b < kBlocks; b += 32) {
      m.count = __dadd_rn(m.count, partials[b]);
      m.sum = __dadd_rn(m.sum, partials[kBlocks + b]);
      m.sumsq = __dadd_rn(m.sumsq, partials[2 * kBlocks + b]);
    }
    m = warp_sum(m);
    if (threadIdx.x == 0) {
      const double mean = __ddiv_rn(m.sum, m.count);
      const double std =
          __dsqrt_rn(__dsub_rn(__ddiv_rn(m.sumsq, m.count), __dmul_rn(mean, mean)));
      mean_std[0] = mean;
      mean_std[1] = std;
      if (blockIdx.x == 0) {
        stats[0] = m.count;
        stats[1] = mean;
        stats[2] = std;
      }
    }
  }
  __syncthreads();
  const double mean = mean_std[0], std = mean_std[1];
  const float4* in4 = reinterpret_cast<const float4*>(in);
  float4* out4 = reinterpret_cast<float4*>(out);
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(kBlocks) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long k = first; k < n4; k += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u * stride < n4) v[u] = in4[k + u * stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k + u * stride < n4) {
        out4[k + u * stride] =
            make_float4(normalised(v[u].x, mean, std), normalised(v[u].y, mean, std),
                        normalised(v[u].z, mean, std), normalised(v[u].w, mean, std));
      }
    }
  }
  if (first < n - (n4 << 2)) {
    const long long j = (n4 << 2) + first;
    out[j] = normalised(in[j], mean, std);
  }
}

}  // namespace

// Float64 words of the scratch `refid_voxel_norm` takes: the partials, then
// {count, mean, std}.
extern "C" int refid_voxel_norm_scratch() { return 3 * kBlocks + 3; }

// Normalise the n >= 1 floats of `in` into `out` (both 16-byte aligned,
// distinct), two launches on `stream`; `scratch` holds
// refid_voxel_norm_scratch() doubles, and its last three get {count, mean,
// std}.  Returns the first CUDA error (0 on success).
extern "C" int refid_voxel_norm(const float* in, long long n, double* scratch, float* out,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  voxel_norm_stats_kernel<<<kBlocks, kThreads, 0, s>>>(in, n, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  voxel_norm_apply_kernel<<<kBlocks, kThreads, 0, s>>>(in, n, scratch, out,
                                                       scratch + 3 * kBlocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
