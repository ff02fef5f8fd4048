// Fused RMSNorm for Hopper (sm_90a): y = x rsqrt(mean(x^2) + eps) (1 + scale)
// over the last axis, in f32, stored in x's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/rmsnorm.py::rmsnorm.  Same
// function on x (rows, D) and a (D,) scale (taken as f32); unlike the
// Pallas kernel, any row count (its rows % block_rows limit is TPU
// blocking).
//
// What bounds it on the card: memory.  It does 4 flops per element
// against 2 * itemsize bytes read and written, so its least time is
// 2 * rows * D * itemsize bytes over 3.35 TB/s.
//
// How the design answers that: one block of 256 threads per row.  The
// threads read the row once from device memory as 16-byte words, sum
// the squares in f32 (shuffles inside each warp, then shared memory
// across the 8 warps), then read their words again -- a row of at most
// a few tens of KB is still in L1 -- and write the result once, as
// 16-byte words.

#include "attn_common.cuh"

namespace {

using attn::word_to_float;

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ uint4 float_to_word(const float* f);

template <>
__device__ __forceinline__ uint4 float_to_word<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

template <>
__device__ __forceinline__ uint4 float_to_word<__nv_bfloat16>(const float* f) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float part[kThreads / 32];
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * D);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * D);
  const int n_words = D / kVec;

  float ss = 0.f;
  for (int w = threadIdx.x; w < n_words; w += kThreads) {
    float f[kVec];
    word_to_float<T>(__ldg(xr + w), f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) ss = fmaf(f[e], f[e], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(D) + eps);

  for (int w = threadIdx.x; w < n_words; w += kThreads) {
    float f[kVec];
    word_to_float<T>(__ldg(xr + w), f);
    const float4* sc = reinterpret_cast<const float4*>(scale + w * kVec);
#pragma unroll
    for (int i = 0; i < kVec / 4; ++i) {
      const float4 s = __ldg(sc + i);
      f[4 * i] = f[4 * i] * inv * (1.f + s.x);
      f[4 * i + 1] = f[4 * i + 1] * inv * (1.f + s.y);
      f[4 * i + 2] = f[4 * i + 2] * inv * (1.f + s.z);
      f[4 * i + 3] = f[4 * i + 3] * inv * (1.f + s.w);
    }
    orow[w] = float_to_word<T>(f);
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int D,
           float eps, cudaStream_t stream) {
  if (D % (16 / sizeof(T))) return static_cast<int>(cudaErrorInvalidValue);
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x and out: 0 = float32, 1 = bfloat16; scale is float32.
// D must be a whole number of 16-byte words.  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a dtype or D it does not take).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int dtype, int rows, int d, float eps,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
