// Event -> voxel-grid scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel refid_tpu/events/voxel_pallas.py::_voxel_kernel_masked
// (entry voxelize_device), with the contract of
// refid_tpu/events/voxel.py::_voxelize_padded: a time-sorted (CAP, 4) f32
// buffer of [t, x, y, p] rows, the first n_valid of them events, voted into a
// (bins, height, width) f32 grid.  Timestamps are rescaled to [0, bins-1]
// from the first and last valid stamps (a zero span counts as 1), p == 0
// votes as -1, and each event adds p*(1-dt) to bin floor(t) and p*dt to bin
// floor(t)+1 at (y, x).  Votes into a bin >= bins, and events whose truncated
// x or y lies outside the frame, are dropped.
//
// Design.  The TPU kernel sorts events by 8-row band and accumulates one-hot
// row x column matmuls because the TPU has no fast scatter
// (voxel_pallas.py:10-24).  Hopper has one: one thread per event
// (grid-stride), the timestamp arithmetic in the same f32 order as the plain
// version, with explicit round-to-nearest intrinsics so no FMA contraction
// changes a vote, and two global atomicAdds.  The wrapper zeroes the grid.
//
// Bound on an H100 SXM (3.35 TB/s) at the main path's shape: read 2^20 x 16 B
// of events (16.8 MB) and write the 24 x 720 x 1280 f32 grid once (88.5 MB):
// 105 MB, about 31 us.  The grid is larger than the 50 MB L2, so the zeroing
// pass writes it once, and each of the 2^21 atomics is a read-modify-write
// of a 32 B sector in L2 that the random pixel order mostly finds cold:
// about 2 x 32 B of device-memory traffic per vote (~134 MB) on top of the
// bound.  Expect two to four times the bound; a shared-memory tile per row
// band would remove the sector traffic and is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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
    const float4 e = events[i];
    // (bins - 1) * (t - first) / delta, each step rounded like the plain version
    const float ts = __fdiv_rn(__fmul_rn(scale, __fsub_rn(e.x, first)), delta);
    const int ti = __float2int_rz(ts);
    const float dt = __fsub_rn(ts, static_cast<float>(ti));
    const int x = __float2int_rz(e.y);
    const int y = __float2int_rz(e.z);
    if (x < 0 || x >= width || y < 0 || y >= height || ti < 0) continue;
    const float p = e.w == 0.0f ? -1.0f : e.w;
    float* cell = grid + static_cast<long long>(y) * width + x;
    if (ti < bins) atomicAdd(cell + ti * plane, __fmul_rn(p, __fsub_rn(1.0f, dt)));
    if (ti + 1 < bins) atomicAdd(cell + (ti + 1) * plane, __fmul_rn(p, dt));
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `events` must be 16-byte aligned and hold at least one row; `grid` must be
// zeroed.  The caller checks shapes.
extern "C" int refid_voxelize(const float* events, int n_valid, int bins,
                              int width, int height, float* grid,
                              void* stream) {
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (static_cast<long long>(n_valid) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm) blocks = sms * kBlocksPerSm;
  voxelize_kernel<<<static_cast<int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(events), n_valid, bins, width, height,
      grid);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
