// int8 convolution for Hopper (sm_90a): the int8 serving path of
// refid_tpu_torch/serve/quant.py, two kernels.
//
// They replace no TPU kernel: the JAX package's int8 conv
// (refid_tpu/serve/quant.py::conv_int8, :147) is XLA's conv_general_dilated
// with int8 operands and int32 sums, and no PyTorch call computes an int8
// convolution on CUDA.
//
// quantize_int8: NCHW float32 or bf16 x -> NHWC int8 with the channels padded
// with zeros to a multiple of 32 (the MMA depth), q = clamp(rint(x / scale),
// -127, 127), x / scale a correctly rounded division (__fdiv_rn) as the plain
// version's.  Dynamic mode first reduces amax |x| into device memory
// (amax_kernel, one atomicMax of the float's bits per block: non-negative
// floats order as their bits), and every block of the quantize pass derives
// scale = max(amax, 1e-12) / 127 from it; block 0 writes the scale to device
// memory, where the conv kernel reads it, so no value goes back to the host.
// Static mode takes the scale as an argument.  Each block transposes a tile of
// 32 channels x 32 pixels through shared memory: reads coalesce along the
// pixels of a channel, writes are 4-byte words of 4 channels.  Bound: bytes,
// x read once (twice in dynamic mode) and xq written once.
//
// conv_int8: implicit GEMM, M = output pixels (n ho wo), N = Cout, K = kh kw
// Cin_padded, s8 x s8 -> s32 with mma.sync.m16n8k32.  Weights are packed once
// by the wrapper as (Cout, kh, kw, Cin_padded): K-major rows, as an 8-bit MMA
// needs for both operands.  A block computes 128 pixels x 128 channels with 8
// warps (4 along M x 2 along N, 32 x 64 each); each K step is one tap and 32
// channels: 128 rows x 32 bytes of A (the tap's input pixel, zero outside the
// image, which clips the padding of the 3x3/1 and 4x4/2 convs) and of B, each
// row two 16-byte cp.async, in a ring of kStages stages.  Rows past M or
// Cout read zeros and are never stored.  The two 16-byte halves of a row
// swap on rows 4-7 of each 8 (the fragment loads of a warp then hit 32
// distinct banks).  Epilogue, fused, in the plain version's order and
// rounding: acc -> out dtype; x (wscale[co] xscale -> out dtype); + bias in
// the out dtype; relu or max(y, y slope); NCHW stores.  Bound: operations
// (2 M N K at 1979 TOP/s) at the production shapes.  This is the simple
// design; the path to the bound is P4's TMA ring and wgmma (band_conv.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 32;          // int8 channels per K step (bytes per row)
constexpr int kBM = 128;            // output pixels per block
constexpr int kBN = 128;            // output channels per block
constexpr int kStages = 4;          // cp.async ring
constexpr int kThreads = 256;       // 8 warps

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---- quantize ----

template <typename T>
__global__ void __launch_bounds__(256) amax_kernel(const T* __restrict__ x, long long total,
                                                   unsigned int* __restrict__ amax_bits) {
  float m = 0.0f;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    m = fmaxf(m, fabsf(to_float(x[i])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float part[8];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < 8 ? part[lane] : 0.0f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(amax_bits, __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x,
                                                       signed char* __restrict__ xq, int c,
                                                       int hw, int cp,
                                                       const unsigned int* __restrict__ amax_bits,
                                                       float static_scale,
                                                       float* __restrict__ scale_out) {
  const float scale =
      amax_bits != nullptr ? __fdiv_rn(fmaxf(__uint_as_float(*amax_bits), 1e-12f), 127.0f)
                           : static_scale;
  if (blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0) {
    *scale_out = scale;
  }
  __shared__ int tile[32][33];          // [channel][pixel]
  const int img = blockIdx.z, c0 = blockIdx.y * 32, p0 = blockIdx.x * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ch = c0 + ty + 8 * k, p = p0 + tx;
    int q = 0;
    if (ch < c && p < hw) {
      const float v = to_float(x[(static_cast<long long>(img) * c + ch) * hw + p]);
      q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f), 127.0f));
    }
    tile[ty + 8 * k][tx] = q;
  }
  __syncthreads();
  const int pl = threadIdx.x >> 3, word = threadIdx.x & 7;   // pixel, 4-channel word
  const int p = p0 + pl;
  if (p < hw) {
    const uint32_t packed = (static_cast<uint32_t>(tile[4 * word][pl]) & 0xFFu) |
                            ((static_cast<uint32_t>(tile[4 * word + 1][pl]) & 0xFFu) << 8) |
                            ((static_cast<uint32_t>(tile[4 * word + 2][pl]) & 0xFFu) << 16) |
                            (static_cast<uint32_t>(tile[4 * word + 3][pl]) << 24);
    *reinterpret_cast<uint32_t*>(xq + (static_cast<long long>(img) * hw + p) * cp + c0 +
                                 4 * word) = packed;
  }
}

// ---- conv ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !pred (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kN>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// d (16 x 8, s32) += a (16 x 32, s8, row) b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte offset of bytes [16 half, 16 half + 16) of row r in a 32-byte-row tile
__device__ __forceinline__ int swz(int r, int half) { return r * kDepth + ((half ^ ((r >> 2) & 1)) << 4); }

__device__ __forceinline__ uint32_t ld32(const signed char* tile, int r, int col) {
  return *reinterpret_cast<const uint32_t*>(tile + swz(r, col >> 4) + (col & 15));
}

template <int kOut>    // 0: float32 out, 1: bf16 out
__global__ void __launch_bounds__(kThreads) conv_int8_kernel(
    const signed char* __restrict__ xq, const signed char* __restrict__ wp,
    const float* __restrict__ wscale, const float* __restrict__ xscale,
    const float* __restrict__ bias, int h, int w, int cp, int co, int kh, int kw, int stride,
    int pad, int ho, int wo, long long m_total, int act, float slope, void* __restrict__ out) {
  __shared__ __align__(128) signed char sa[kStages][kBM * kDepth];
  __shared__ __align__(128) signed char sb[kStages][kBN * kDepth];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const long long hwo = static_cast<long long>(ho) * wo;

  // this thread's loads: row lr (pixel m0 + lr of A, channel n0 + lr of B), half lh
  const int lr = tid >> 1, lh = tid & 1;
  const long long m = m0 + lr;
  const bool m_ok = m < m_total;
  int oy = 0, ox = 0;
  long long img = 0;
  if (m_ok) {
    img = m / hwo;
    const long long pix = m - img * hwo;
    oy = static_cast<int>(pix / wo);
    ox = static_cast<int>(pix - static_cast<long long>(oy) * wo);
  }
  const int iy0 = oy * stride - pad, ix0 = ox * stride - pad;
  const signed char* x_img = xq + img * h * w * cp + lh * 16;
  const bool n_ok = n0 + lr < co;
  const signed char* w_row =
      wp + static_cast<long long>(n_ok ? n0 + lr : 0) * kh * kw * cp + lh * 16;
  const int chunks = cp / kDepth;
  const int steps = kh * kw * chunks;

  auto load = [&](int step, int stage) {
    const int tap = step / chunks, cc = step - tap * chunks;
    const int ky = tap / kw, kx = tap - ky * kw;
    const int iy = iy0 + ky, ix = ix0 + kx;
    const bool a_ok = m_ok && iy >= 0 && iy < h && ix >= 0 && ix < w;
    const signed char* a_src =
        a_ok ? x_img + (static_cast<long long>(iy) * w + ix) * cp + cc * kDepth : xq;
    cp_async16(&sa[stage][swz(lr, lh)], a_src, a_ok);
    cp_async16(&sb[stage][swz(lr, lh)], n_ok ? w_row + tap * cp + cc * kDepth : wp, n_ok);
  };

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  const int g = lane >> 2, t4 = lane & 3;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();     // step s has landed (this thread's copies)
    __syncthreads();                  // ... everyone's; and step s - 1 is consumed
    const int next = s + kStages - 1;
    if (next < steps) load(next, next % kStages);
    cp_async_commit();
    const signed char* A = sa[s % kStages];
    const signed char* B = sb[s % kStages];
    uint32_t af[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + g;
      af[i][0] = ld32(A, r, t4 * 4);
      af[i][1] = ld32(A, r + 8, t4 * 4);
      af[i][2] = ld32(A, r, 16 + t4 * 4);
      af[i][3] = ld32(A, r + 8, 16 + t4 * 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wn * 64 + j * 8 + g;
      bf[j][0] = ld32(B, r, t4 * 4);
      bf[j][1] = ld32(B, r, 16 + t4 * 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row g, columns 2 t4 + {0, 1}); c2, c3 at row g + 8
  const float xs = *xscale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const long long mm = m0 + wm * 32 + i * 16 + g + 8 * e2;
      if (mm >= m_total) continue;
      const long long im = mm / hwo;
      const long long pix = mm - im * hwo;
      const long long base = im * co * hwo + pix;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const int ch = n0 + wn * 64 + j * 8 + 2 * t4 + e1;
          if (ch >= co) continue;
          const int a = acc[i][j][2 * e2 + e1];
          const float s = __fmul_rn(wscale[ch], xs);
          const long long o = base + static_cast<long long>(ch) * hwo;
          if constexpr (kOut == 0) {
            float y = __fmul_rn(__int2float_rn(a), s);
            if (bias != nullptr) y = __fadd_rn(y, bias[ch]);
            if (act == 1) {
              y = fmaxf(y, 0.0f);
            } else if (act == 2) {
              y = fmaxf(y, __fmul_rn(y, slope));
            }
            static_cast<float*>(out)[o] = y;
          } else {
            float y = __bfloat162float(__float2bfloat16_rn(__int2float_rn(a)));
            y = __bfloat162float(
                __float2bfloat16_rn(__fmul_rn(y, __bfloat162float(__float2bfloat16_rn(s)))));
            if (bias != nullptr) {
              y = __bfloat162float(__float2bfloat16_rn(
                  __fadd_rn(y, __bfloat162float(__float2bfloat16_rn(bias[ch])))));
            }
            if (act == 1) {
              y = fmaxf(y, 0.0f);
            } else if (act == 2) {
              y = fmaxf(y, __bfloat162float(__float2bfloat16_rn(__fmul_rn(y, slope))));
            }
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
          }
        }
      }
    }
  }
}

template <typename T>
int launch_quantize(const void* x, int n, int c, int hw, int cp, int dynamic, float scale,
                    void* amax_scratch, void* scale_out, void* xq, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  unsigned int* bits = nullptr;
  if (dynamic) {
    bits = static_cast<unsigned int*>(amax_scratch);
    cudaError_t err = cudaMemsetAsync(bits, 0, sizeof(unsigned int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(n) * c * hw;
    long long blocks = (total + 4095) / 4096;
    if (blocks > 2048) blocks = 2048;
    if (blocks < 1) blocks = 1;
    amax_kernel<T><<<static_cast<int>(blocks), 256, 0, stream>>>(xt, total, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((hw + 31) / 32, cp / 32, n);
  quantize_kernel<T><<<grid, 256, 0, stream>>>(xt, static_cast<signed char*>(xq), c, hw, cp,
                                                bits, scale, static_cast<float*>(scale_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, c, hw) dense, float32 (dtype 0) or bf16 (1); xq (n, hw, cp) int8 with
// cp a multiple of 32 >= c; scale_out one float32; amax_scratch one uint32
// (dynamic mode).  Launches on `stream`; returns cudaGetLastError().
extern "C" int refid_quantize_int8(const void* x, int dtype, int n, int c, int hw, int cp,
                                   int dynamic, float scale, void* amax_scratch, void* scale_out,
                                   void* xq, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp % 32 != 0 || cp < c) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_quantize<float>(x, n, c, hw, cp, dynamic, scale, amax_scratch, scale_out, xq, s);
  if (dtype == 1) {
    return launch_quantize<__nv_bfloat16>(x, n, c, hw, cp, dynamic, scale, amax_scratch,
                                          scale_out, xq, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// xq (n, h, w, cp) int8, wp (co, kh, kw, cp) int8, wscale (co) and xscale (1)
// float32, bias (co) float32 or null; out (n, co, ho, wo) float32 (out_dtype 0)
// or bf16 (1).  act 0 none, 1 relu, 2 max(y, y slope).  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int refid_conv_int8(const void* xq, const void* wp, const void* wscale,
                               const void* xscale, const void* bias, int n, int h, int w, int cp,
                               int co, int kh, int kw, int stride, int pad, int ho, int wo,
                               int act, float slope, int out_dtype, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cp % kDepth != 0 || n < 1 || ho < 1 || wo < 1 || co < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long m_total = static_cast<long long>(n) * ho * wo;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM), (co + kBN - 1) / kBN);
  const auto* xs = static_cast<const signed char*>(xq);
  const auto* ws = static_cast<const signed char*>(wp);
  const auto* wsc = static_cast<const float*>(wscale);
  const auto* xsc = static_cast<const float*>(xscale);
  const auto* b = static_cast<const float*>(bias);
  if (out_dtype == 0) {
    conv_int8_kernel<0><<<grid, kThreads, 0, s>>>(xs, ws, wsc, xsc, b, h, w, cp, co, kh, kw,
                                                  stride, pad, ho, wo, m_total, act, slope, out);
  } else if (out_dtype == 1) {
    conv_int8_kernel<1><<<grid, kThreads, 0, s>>>(xs, ws, wsc, xsc, b, h, w, cp, co, kh, kw,
                                                  stride, pad, ho, wo, m_total, act, slope, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* refid_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
