// The epilogue of a cuDNN conv, for Hopper (sm_90a): the conv's bias, then
// the activation its module applies next, in one pass over the output, in
// place.  Wrapper: refid_tpu_torch/ops/conv_epilogue.py::conv_epilogue_; one
// entry point, refid_conv_epilogue.
//
// Replaces no TPU kernel: XLA fuses a conv's bias and activation into the
// conv on the TPU.  It was added because PyTorch's cuDNN path does not:
// aten::_convolution runs cudnn_convolution and then
// output.add_(bias.reshape(1, C, 1, 1)), a broadcast add that TensorIterator
// runs in its unvectorized fallback kernel (elementwise_kernel<128, 4>), and
// the module's leaky ReLU or ReLU reads and writes the output once more.
//
// The arithmetic is the eager chain's, step by step, in float32, each step
// rounded to the output type T as PyTorch's opmath rounds it:
//   v = T(float(y) + float(T(bias)))       the add; autocast hands it a bias
//                                          cast to T (round to nearest even)
//   ReLU:  isnan(v) ? v : fmaxf(v, 0)      clamp_min(v, 0)
//   leaky: v > 0 ? v : T(v * slope)        once, or twice with a second slope
//                                          (the encoder stage's two stacked
//                                          leaky ReLUs)
// Every float step is an explicit round-to-nearest intrinsic, so no FMA
// contraction changes it: the result is the eager chain's bits.
//
// Layout.  Element i's channel is (i / run) % C, with run = 1 for a
// channels_last output and run = H * W for a contiguous NCHW one.  Three
// instances of one kernel, chosen by the launcher, read the bias of a
// 16-byte vector (8 bf16 or 4 float32 outputs):
//   kRows    run == 1 and C a multiple of the vector: the vector's channels
//            are C0 .. C0 + 7, read as 16-byte loads of the bias;
//   kPlanes  run a multiple of the vector: one channel for the whole vector;
//   kSteps   anything else (C = 2 or 3, an odd plane): the channel of each
//            element, stepped from the vector's first.
// The last n % 8 (or 4) elements are a scalar tail of the same kernel.  The
// divisions by run and by C are a multiply and a shift (Divider), so indices
// are 32-bit: n < 2^31 (the wrapper checks).
//
// One vector a thread, one pass over the output: on the H100 it moved 2.76-
// 2.89 TB/s at the window's largest outputs, as much as a copy (2.90), where
// a grid of 8 blocks an SM striding over 4 vectors a thread moved 2.33-2.40.
//
// Bound on an H100 SXM (3.35 TB/s): the output read and written once, 4 bytes
// an element in bf16; a (1, 64, 720, 1280) bf16 output (59.0 M elements) is
// 236 MB, 0.0704 ms.  The bias, C floats, stays in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum Activation : int { kNone = 0, kRelu = 1, kLeaky = 2, kLeakyTwice = 3 };
enum BiasRead : int { kRows = 0, kPlanes = 1, kSteps = 2 };

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31, as a high multiply and a shift
// (the round-up method; t + n cannot overflow since t <= n < 2^31).
struct Divider {
  unsigned int d, magic, shift;

  __device__ __forceinline__ unsigned int div(unsigned int n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
  __device__ __forceinline__ unsigned int mod(unsigned int n) const { return n - div(n) * d; }
};

Divider make_divider(unsigned int d) {
  unsigned int shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint64_t magic = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return {d, static_cast<unsigned int>(magic), shift};
}

struct Epilogue {
  const float* bias;     // C float32 values
  Divider run;           // elements that share a channel before the next one
  Divider channels;      // C
  int act;
  float slope, slope2;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// float(T(v))
__device__ __forceinline__ float rounded(float v, float) { return v; }
__device__ __forceinline__ float rounded(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ float finish(float y, float bias, const Epilogue& e) {
  float v = rounded(__fadd_rn(y, rounded(bias, T())), T());
  if (e.act == kRelu) {
    v = isnan(v) ? v : fmaxf(v, 0.f);
  } else if (e.act >= kLeaky) {
    v = v > 0.f ? v : rounded(__fmul_rn(v, e.slope), T());
    if (e.act == kLeakyTwice) v = v > 0.f ? v : rounded(__fmul_rn(v, e.slope2), T());
  }
  return v;
}

// The channel of element i, and how many elements of that channel's run
// precede i.
__device__ __forceinline__ void locate(unsigned int i, const Epilogue& e, unsigned int* c,
                                       unsigned int* r) {
  const unsigned int p = e.run.div(i);
  *r = i - p * e.run.d;
  *c = e.channels.mod(p);
}

template <typename T, int kRead>
__device__ __forceinline__ void finish_vector(uint4& raw, unsigned int i, const Epilogue& e) {
  constexpr int kPerVec = 16 / sizeof(T);
  T* x = reinterpret_cast<T*>(&raw);
  float b[kPerVec];
  if (kRead == kRows) {
    const float4* b4 = reinterpret_cast<const float4*>(e.bias + e.channels.mod(i));
#pragma unroll
    for (int q = 0; q < kPerVec / 4; ++q) {
      const float4 f = __ldg(b4 + q);
      b[4 * q] = f.x;
      b[4 * q + 1] = f.y;
      b[4 * q + 2] = f.z;
      b[4 * q + 3] = f.w;
    }
  } else if (kRead == kPlanes) {
    const float one = __ldg(e.bias + e.channels.mod(e.run.div(i)));
#pragma unroll
    for (int k = 0; k < kPerVec; ++k) b[k] = one;
  } else {
    unsigned int c, r;
    locate(i, e, &c, &r);
#pragma unroll
    for (int k = 0; k < kPerVec; ++k) {
      b[k] = __ldg(e.bias + c);
      if (++r == e.run.d) {
        r = 0;
        if (++c == e.channels.d) c = 0;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerVec; ++k) from_float(finish<T>(to_float(x[k]), b[k], e), &x[k]);
}

// One 16-byte vector a thread, in one pass; thread `vectors` takes the last
// n % 8 (or 4) elements.
template <typename T, int kRead>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(T* data, unsigned int n, Epilogue e) {
  constexpr int kPerVec = 16 / sizeof(T);
  const unsigned int vectors = n / kPerVec;
  const unsigned int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < vectors) {
    uint4* p = reinterpret_cast<uint4*>(data) + j;
    uint4 v = *p;
    finish_vector<T, kRead>(v, j * kPerVec, e);
    *p = v;
  } else if (j == vectors) {
    for (unsigned int i = j * kPerVec; i < n; ++i) {
      unsigned int c, r;
      locate(i, e, &c, &r);
      from_float(finish<T>(to_float(data[i]), __ldg(e.bias + c), e), &data[i]);
    }
  }
}

template <typename T>
cudaError_t launch_epilogue(T* data, unsigned int n, const Epilogue& e, int read,
                            cudaStream_t s) {
  const unsigned int blocks = (n / (16 / sizeof(T)) + kThreads) / kThreads;
  if (read == kRows) {
    conv_epilogue_kernel<T, kRows><<<blocks, kThreads, 0, s>>>(data, n, e);
  } else if (read == kPlanes) {
    conv_epilogue_kernel<T, kPlanes><<<blocks, kThreads, 0, s>>>(data, n, e);
  } else {
    conv_epilogue_kernel<T, kSteps><<<blocks, kThreads, 0, s>>>(data, n, e);
  }
  return cudaGetLastError();
}

}  // namespace

// Finish the n conv outputs at `data` in place: add `bias` (C float32
// values, rounded to the output type first) and apply `act` (0 none, 1 ReLU,
// 2 leaky ReLU with `slope`, 3 leaky ReLU with `slope` then with `slope2`).
// dtype 0 = float32, 1 = bfloat16; element i belongs to channel
// (i / run) % channels.  `data` is 16-byte aligned; 1 <= n < 2^31.  Launches
// on `stream` and returns a CUDA error code (0 on success).
extern "C" int refid_conv_epilogue(void* data, int dtype, long long n, int channels,
                                   long long run, const float* bias, int act, float slope,
                                   float slope2, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || channels < 1 || run < 1 || run > 0x7fffffffLL ||
      dtype < 0 || dtype > 1 || act < kNone || act > kLeakyTwice ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Epilogue e{bias, make_divider(static_cast<unsigned int>(run)),
                   make_divider(static_cast<unsigned int>(channels)), act, slope, slope2};
  const int per_vec = dtype == 0 ? 4 : 8;
  const bool aligned_bias = reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const int read = run == 1 && channels % per_vec == 0 && aligned_bias ? kRows
                   : run % per_vec == 0                                 ? kPlanes
                                                                        : kSteps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int count = static_cast<unsigned int>(n);
  const cudaError_t err =
      dtype == 0 ? launch_epilogue(static_cast<float*>(data), count, e, read, s)
                 : launch_epilogue(static_cast<__nv_bfloat16*>(data), count, e, read, s);
  return static_cast<int>(err);
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
