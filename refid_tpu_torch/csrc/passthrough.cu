// y = 2x + 1 passthrough kernels for Hopper (sm_90a): P1 and P2 of the
// poison probe (refid_tpu_torch/probes/poison.py).
//
// P1, passthrough_kernel, replaces the TPU kernel
// scripts/probe_poison.py::_passthrough_kernel (entry pallas_op): 2x + 1 over
// a (1, h, w, c) array in blocks of `band` rows, the BlockSpec (1, band, w, c).
// Here a band is `band` rows of `row_elems` elements, contiguous in
// channels_last storage, and a few CUDA blocks share it (below).  The last band may be
// short: the TPU grid h // band leaves such rows unwritten, this one writes
// them.
//
// P2, passthrough_slice_kernel, replaces scripts/probe_poison.py::tiny_pallas:
// 2x + 1 on one strided (rows, cols) view, in place (the probe's view is
// d[0, :8, :128, 0] of an NHWC array).
//
// Both compute in float32 and round once to the storage type.  2x is exact,
// so the result is the bits of x * 2 + 1 evaluated as two rounded steps.
//
// Bound on an H100 SXM (3.35 TB/s): P1 reads and writes each element once,
// 2 x 29.5 MB at the probe's (1, 360, 640, 64) bf16, about 18 us.  Each thread
// moves 16 bytes per load and store.  The probe has 45 bands of 8 rows: one
// block a band would leave 87 of the 132 SMs idle, so each band is split
// into `parts` contiguous pieces, one block each (about eight 256-thread
// blocks an SM in all).  P2 moves 2 KB: launch latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float twice_plus_one(float v) {
  return __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T at a time: 4 floats or 8 bf16.
__device__ __forceinline__ uint4 twice_plus_one_vec(uint4 v, float) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = twice_plus_one(f[i]);
  return v;
}
__device__ __forceinline__ uint4 twice_plus_one_vec(uint4 v, __nv_bfloat16) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = __float2bfloat16_rn(twice_plus_one(__bfloat162float(h[i])));
  }
  return v;
}

// Block (b, part) takes piece `part` of band b's rows (gridDim.y pieces of
// whole 16-byte vectors when `vec`, else of elements; the band's last
// count % 8 or 4 elements go to its last piece).  `vec` when every band
// starts on a 16-byte boundary (the wrapper checks the base pointers).
template <typename T>
__global__ void __launch_bounds__(kThreads)
passthrough_kernel(const T* __restrict__ x, long long n_rows,
                   long long row_elems, int band, bool vec, T* __restrict__ y) {
  const long long first = static_cast<long long>(blockIdx.x) * band;
  const long long rows = min(static_cast<long long>(band), n_rows - first);
  const long long begin = first * row_elems;
  const long long count = rows * row_elems;
  constexpr int kPerVec = 16 / sizeof(T);
  const long long units = vec ? count / kPerVec : count;
  const long long per = (units + gridDim.y - 1) / gridDim.y;
  const long long u0 = static_cast<long long>(blockIdx.y) * per;
  const long long u1 = min(units, u0 + per);
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + begin);
    uint4* yv = reinterpret_cast<uint4*>(y + begin);
#pragma unroll 4
    for (long long i = u0 + threadIdx.x; i < u1; i += kThreads) {
      yv[i] = twice_plus_one_vec(xv[i], T());
    }
    if (blockIdx.y == gridDim.y - 1) {
      for (long long i = units * kPerVec + threadIdx.x; i < count; i += kThreads) {
        store_f(y + begin + i, twice_plus_one(load_f(x + begin + i)));
      }
    }
  } else {
    for (long long i = u0 + threadIdx.x; i < u1; i += kThreads) {
      store_f(y + begin + i, twice_plus_one(load_f(x + begin + i)));
    }
  }
}

template <typename T>
__global__ void passthrough_slice_kernel(T* ptr, int rows, int cols,
                                         long long row_stride,
                                         long long col_stride) {
  const int n = rows * cols;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    T* p = ptr + (i / cols) * row_stride + (i % cols) * col_stride;
    store_f(p, twice_plus_one(load_f(p)));
  }
}

}  // namespace

// P1.  dtype 0 = float32, 1 = bfloat16; x and y dense buffers of n_rows x
// row_elems elements.  Launches on `stream` and returns a CUDA error code.
extern "C" int refid_passthrough(const void* x, long long n_rows,
                                 long long row_elems, int band, int dtype,
                                 int vec, void* y, void* stream) {
  if (n_rows < 1 || row_elems < 1 || band < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  const cudaError_t err = device_sms(&device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long bands = (n_rows + band - 1) / band;
  // pieces a band: about 8 blocks an SM in all, none with less than one
  // vector a thread, at most 65535
  const long long band_units =
      (band < n_rows ? band : n_rows) * row_elems / (vec ? 16 / (dtype == 0 ? 4 : 2) : 1);
  long long parts = (8LL * sms + bands - 1) / bands;
  const long long most = (band_units + kThreads - 1) / kThreads;
  if (parts > most) parts = most;
  if (parts > 65535) parts = 65535;
  if (parts < 1) parts = 1;
  const dim3 grid(static_cast<unsigned>(bands), static_cast<unsigned>(parts));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    passthrough_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), n_rows, row_elems, band, vec != 0,
        static_cast<float*>(y));
  } else {
    passthrough_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), n_rows, row_elems, band,
        vec != 0, static_cast<__nv_bfloat16*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

// P2.  In place on the (rows, cols) view at `ptr` with element strides
// row_stride and col_stride.
extern "C" int refid_passthrough_slice(void* ptr, int rows, int cols,
                                       long long row_stride,
                                       long long col_stride, int dtype,
                                       void* stream) {
  const int threads = 256;
  const int blocks = (rows * cols + threads - 1) / threads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    passthrough_slice_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<float*>(ptr), rows, cols, row_stride, col_stride);
  } else {
    passthrough_slice_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<__nv_bfloat16*>(ptr), rows, cols, row_stride, col_stride);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
