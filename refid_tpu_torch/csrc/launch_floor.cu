// The launch floor: an empty kernel and the cost of the runtime queries a
// launcher can make, for chip_smoke.py's launch_path phase
// (tools/launch_path.py).  Replaces no TPU kernel and runs on no path of
// the port: it is the yardstick the kernels' launch path is measured by.

#include <cuda_runtime.h>

#include <chrono>

#include "launch.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of a 1-block, 32-thread kernel that does nothing, on `stream`.
extern "C" int refid_launch_floor_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// Nanoseconds a call, each over `iters` calls on the current device, into
// ns[0..4]: cudaGetDevice; cudaDeviceGetAttribute(SM count);
// cudaFuncSetAttribute(max dynamic shared memory, 48 KB) on the empty
// kernel; device_sms (the launchers' cached form of the first two);
// allow_dynamic_smem (the cached form of the third).  Returns a CUDA error
// code.
extern "C" int refid_launch_floor_queries(int iters, double* ns) {
  using clock = std::chrono::steady_clock;
  int device = 0, sms = 0;
  const void* kernel = reinterpret_cast<const void*>(empty_kernel);
  cudaError_t err = cudaSuccess;
  auto per_call = [iters](clock::time_point t0) {
    return std::chrono::duration<double, std::nano>(clock::now() - t0).count() / iters;
  };
  // once each first: this library's first runtime call initialises its
  // (static) runtime, which is no query's cost
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 48 << 10);
  }
  auto t0 = clock::now();
  for (int i = 0; i < iters && err == cudaSuccess; ++i) err = cudaGetDevice(&device);
  ns[0] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < iters && err == cudaSuccess; ++i) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  ns[1] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < iters && err == cudaSuccess; ++i) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 48 << 10);
  }
  ns[2] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < iters && err == cudaSuccess; ++i) err = device_sms(&device, &sms);
  ns[3] = per_call(t0);
  t0 = clock::now();
  for (int i = 0; i < iters && err == cudaSuccess; ++i) {
    err = allow_dynamic_smem(kernel, device, 48 << 10);
  }
  ns[4] = per_call(t0);
  return static_cast<int>(err);
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
