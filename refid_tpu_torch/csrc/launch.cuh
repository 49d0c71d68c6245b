// Host-side launch helpers shared by the kernel libraries: what a launcher
// asks the CUDA runtime once and then keeps.
//
// * device_sms: the current device and its SM count.  cudaGetDevice is a
//   thread-local read; the SM count is queried once per device.
// * allow_dynamic_smem: cudaFuncSetAttribute(MaxDynamicSharedMemorySize)
//   once per kernel and device.  A kernel's launchers always pass the same
//   size, the most any of its launches uses: a limit set per launch size
//   would let one thread lower it under another thread's larger launch
//   (the data loader launches K2 from several threads).
//
// Both are safe to call from several threads.  Everything here sits in an
// anonymous namespace: each .cu that includes it is a library of its own.

#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kMaxDevices = 64;

cudaError_t device_sms(int* device, int* sms) {
  static std::atomic<int> counts[kMaxDevices];   // 0 until queried
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  if (*device < 0 || *device >= kMaxDevices) {
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, *device);
  }
  int count = counts[*device].load(std::memory_order_relaxed);
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, *device);
    if (err != cudaSuccess) return err;
    counts[*device].store(count, std::memory_order_relaxed);
  }
  *sms = count;
  return cudaSuccess;
}

// `bytes` must be the same on every call for one kernel (see above).
cudaError_t allow_dynamic_smem(const void* kernel, int device, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, device}) != 0) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.insert({kernel, device});
  return err;
}

}  // namespace
