// Event -> voxel-grid scatter-add for Hopper (sm_90a): two kernels.
//
// K1, voxelize_kernel, replaces the TPU kernel
// refid_tpu/events/voxel_pallas.py::_voxel_kernel_masked (entry
// voxelize_device), with the contract of
// refid_tpu/events/voxel.py::_voxelize_padded: a time-sorted (CAP, 4) f32
// buffer of [t, x, y, p] rows, the first n_valid of them events, voted into a
// (bins, height, width) f32 grid.
//
// K2, voxel_grid_kernel, replaces the TPU kernel
// refid_tpu/events/voxel_pallas.py::_voxel_kernel (entry
// events_to_voxel_grid_pallas), the host-array voxelizer the training
// datasets call: N unpadded time-sorted rows, voted into a (bins, height,
// width) grid or, for HWC, a (height, width, bins) grid written directly.
//
// Both: timestamps are rescaled to [0, bins-1] from the first and last
// events (a zero span counts as 1), p == 0 votes as -1, and each event adds
// p*(1-dt) to bin floor(t) and p*dt to bin floor(t)+1 at (y, x).  Votes
// into a bin >= bins, and events whose truncated x or y lies outside the
// frame, are dropped.
//
// Design.  The TPU kernels sort events by 8-row band (K2 on the host) and
// accumulate one-hot row x column matmuls because the TPU has no fast
// scatter (voxel_pallas.py:10-24).  Hopper has one: one thread per event
// (grid-stride), the timestamp arithmetic in the same f32 order as the plain
// version, with explicit round-to-nearest intrinsics so no FMA contraction
// changes a vote, and two global atomicAdds.  The wrapper zeroes the grid.
// In HWC an event's two votes land in neighbouring floats of one 32-byte
// sector; in CHW they are a plane (3.7 MB at 720p) apart.
//
// Bound on an H100 SXM (3.35 TB/s) at the main paths' shape: read 2^20 x 16 B
// of events (16.8 MB) and write the 24 x 720 x 1280 f32 grid once (88.5 MB):
// 105 MB, about 31 us.  The grid is larger than the 50 MB L2, so the zeroing
// pass writes it once, and each of the 2^21 atomics is a read-modify-write
// of a 32 B sector in L2 that the random pixel order mostly finds cold:
// about 2 x 32 B of device-memory traffic per vote (~134 MB) on top of the
// bound (half that in HWC, where both votes share a sector).  Expect two to
// four times the bound; a shared-memory tile per row band would remove the
// sector traffic and is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// The rescale and the two votes of one event, shared by K1 and K2.
// `bin_stride` is the distance between neighbouring bins of one pixel and
// `pixel_stride` that between neighbouring pixels of one bin (plane and 1 in
// CHW, 1 and bins in HWC).
__device__ __forceinline__ void vote(const float4 e, float first, float delta,
                                     float scale, int bins, int width,
                                     int height, long long bin_stride,
                                     long long pixel_stride,
                                     float* __restrict__ grid) {
  // (bins - 1) * (t - first) / delta, each step rounded like the plain version
  const float ts = __fdiv_rn(__fmul_rn(scale, __fsub_rn(e.x, first)), delta);
  const int ti = __float2int_rz(ts);
  const float dt = __fsub_rn(ts, static_cast<float>(ti));
  const int x = __float2int_rz(e.y);
  const int y = __float2int_rz(e.z);
  if (x < 0 || x >= width || y < 0 || y >= height || ti < 0) return;
  const float p = e.w == 0.0f ? -1.0f : e.w;
  float* cell = grid + (static_cast<long long>(y) * width + x) * pixel_stride;
  if (ti < bins) atomicAdd(cell + ti * bin_stride, __fmul_rn(p, __fsub_rn(1.0f, dt)));
  if (ti + 1 < bins) atomicAdd(cell + (ti + 1) * bin_stride, __fmul_rn(p, dt));
}

// K1: padded buffer, stamps from rows 0 and n_valid - 1, CHW grid.
__global__ void __launch_bounds__(kThreads)
voxelize_kernel(const float4* __restrict__ events, int n_valid, int bins,
                int width, int height, float* __restrict__ grid) {
  const float first = events[0].x;
  const float last = events[n_valid > 0 ? n_valid - 1 : 0].x;
  float delta = __fsub_rn(last, first);
  if (delta == 0.0f) delta = 1.0f;
  const float scale = static_cast<float>(bins - 1);
  const long long plane = static_cast<long long>(width) * height;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n_valid; i += stride) {
    vote(events[i], first, delta, scale, bins, width, height, plane, 1, grid);
  }
}

// K2: n >= 1 unpadded rows, CHW or HWC grid.
template <bool kHWC>
__global__ void __launch_bounds__(kThreads)
voxel_grid_kernel(const float4* __restrict__ events, int n, int bins,
                  int width, int height, float* __restrict__ grid) {
  const float first = events[0].x;
  float delta = __fsub_rn(events[n - 1].x, first);
  if (delta == 0.0f) delta = 1.0f;
  const float scale = static_cast<float>(bins - 1);
  const long long plane = static_cast<long long>(width) * height;
  const long long bin_stride = kHWC ? 1 : plane;
  const long long pixel_stride = kHWC ? bins : 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;

  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    vote(events[i], first, delta, scale, bins, width, height, bin_stride,
         pixel_stride, grid);
  }
}

int grid_blocks(long long rows, int* blocks) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long b = (rows + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > static_cast<long long>(sms) * kBlocksPerSm) b = static_cast<long long>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(b);
  return 0;
}

}  // namespace

// K1.  Launches on `stream` and returns cudaGetLastError() (0 on success).
// `events` must be 16-byte aligned and hold at least one row; `grid` must be
// zeroed.  The caller checks shapes.
extern "C" int refid_voxelize(const float* events, int n_valid, int bins,
                              int width, int height, float* grid,
                              void* stream) {
  int blocks = 0;
  const int err = grid_blocks(n_valid, &blocks);
  if (err != 0) return err;
  voxelize_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(events), n_valid, bins, width, height,
      grid);
  return static_cast<int>(cudaGetLastError());
}

// K2.  The same contract for n >= 1 unpadded rows; `hwc` != 0 writes a
// (height, width, bins) grid, else (bins, height, width).
extern "C" int refid_voxel_grid(const float* events, int n, int bins,
                                int width, int height, int hwc, float* grid,
                                void* stream) {
  int blocks = 0;
  const int err = grid_blocks(n, &blocks);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* ev = reinterpret_cast<const float4*>(events);
  if (hwc) {
    voxel_grid_kernel<true><<<blocks, kThreads, 0, s>>>(ev, n, bins, width, height, grid);
  } else {
    voxel_grid_kernel<false><<<blocks, kThreads, 0, s>>>(ev, n, bins, width, height, grid);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
