// y = 2x + 1 passthrough kernels for Hopper (sm_90a): P1 and P2 of the
// poison probe (refid_tpu_torch/probes/poison.py).
//
// P1, passthrough_kernel, replaces the TPU kernel
// scripts/probe_poison.py::_passthrough_kernel (entry pallas_op): 2x + 1 over
// a (1, h, w, c) array in blocks of `band` rows, the BlockSpec (1, band, w, c).
// Here one CUDA block owns `band` rows of `row_elems` elements; in
// channels_last storage those rows are contiguous.  The last band may be
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
// moves 16 bytes per load and store; with 45 bands of 8 rows only 45 of the
// 132 SMs have work, which the band split of the TPU kernel imposes.  P2 moves
// 2 KB: launch latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

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

// One block per band of `band` rows; `vec` when every band starts on a
// 16-byte boundary (the wrapper checks the base pointers).
template <typename T>
__global__ void __launch_bounds__(kThreads)
passthrough_kernel(const T* __restrict__ x, long long n_rows,
                   long long row_elems, int band, bool vec, T* __restrict__ y) {
  const long long first = static_cast<long long>(blockIdx.x) * band;
  const long long rows = min(static_cast<long long>(band), n_rows - first);
  const long long begin = first * row_elems;
  const long long count = rows * row_elems;
  constexpr int kPerVec = 16 / sizeof(T);
  long long done = 0;
  if (vec) {
    const long long n_vec = count / kPerVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x + begin);
    uint4* yv = reinterpret_cast<uint4*>(y + begin);
    for (long long i = threadIdx.x; i < n_vec; i += kThreads) {
      yv[i] = twice_plus_one_vec(xv[i], T());
    }
    done = n_vec * kPerVec;
  }
  for (long long i = done + threadIdx.x; i < count; i += kThreads) {
    store_f(y + begin + i, twice_plus_one(load_f(x + begin + i)));
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
// row_elems elements.  Launches on `stream` and returns cudaGetLastError().
extern "C" int refid_passthrough(const void* x, long long n_rows,
                                 long long row_elems, int band, int dtype,
                                 int vec, void* y, void* stream) {
  const long long bands = (n_rows + band - 1) / band;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    passthrough_kernel<float><<<bands, kThreads, 0, s>>>(
        static_cast<const float*>(x), n_rows, row_elems, band, vec != 0,
        static_cast<float*>(y));
  } else {
    passthrough_kernel<__nv_bfloat16><<<bands, kThreads, 0, s>>>(
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
