// Decode attention for Hopper (sm_90a): one query token per sequence
// against a contiguous KV cache with a per-row valid length.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention.  Same function:
// q (B, Hq, D); k/v caches (B, Hkv, S, D) with Hq % Hkv == 0; kv_len
// (B,) int32.  Query head hi reads KV head hi / (Hq / Hkv) (GQA by
// index: the cache is never copied per query head), positions at or
// past kv_len are masked and never read, the online softmax runs in f32
// with scale = D^-0.5, and a row with kv_len == 0 gets zeros.  Unlike
// the Pallas kernel, S need not be a multiple of a tile.
//
// What bounds it on the card: memory.  Each (b, head) reads
// kv_len_b * D * 2 elements of K/V and does 4 * D flops per token, about
// one flop per byte in bf16, far below the ~295 flops per byte at which
// the H100's compute would be the limit.  The least time is
// sum_b kv_len_b * Hkv * D * 2 * itemsize bytes / 3.35 TB/s.
//
// How the design answers that: the split-KV layout of attn_common.cuh
// (gemma3's decode batch has 8 x 8 (b, head) pairs, too few blocks for
// the memory system), with a contiguous address: token t of KV head hk
// of row b starts at element ((b * Hkv + hk) * S + t) * D.

#include "attn_common.cuh"

namespace {

using namespace attn;

template <int D>
struct ContiguousRows {
  size_t head;  // first element of this (b, KV head)'s rows
  __device__ __forceinline__ size_t operator()(int t) const {
    return head + (size_t)t * D;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_attention_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ kv_len,
                              float* __restrict__ ws, int hq, int hkv, int S,
                              int n_split, int chunk, float scale) {
  const int split = blockIdx.x;
  const int hi = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hi / (hq / hkv);
  const int len = max(0, min(kv_len[b], S));
  const int t0 = split * chunk;
  const ContiguousRows<D> rows{((size_t)b * hkv + hk) * S * D};
  decode_chunk<T, D>(q, k, v, rows, b, hq, hi, t0, min(len, t0 + chunk), scale,
                     ws_row<D>(ws, b, hq, hi, n_split, split));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* ws, void* out, int b, int hq, int hkv, int S, int n_split,
           cudaStream_t stream) {
  const int chunk = (S + n_split - 1) / n_split;
  decode_attention_split_kernel<T, D>
      <<<dim3(n_split, hq, b), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(kv_len),
          static_cast<float*>(ws), hq, hkv, S, n_split, chunk,
          1.0f / sqrtf(static_cast<float>(D)));
  return launch_merge<T, D>(ws, out, b, hq, n_split, stream);
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v,
               const void* kv_len, void* ws, void* out, int b, int hq,
               int hkv, int S, int n_split, cudaStream_t stream) {
#define DA_CASE(D_)                                                       \
  case D_:                                                                \
    return launch<T, D_>(q, k, v, kv_len, ws, out, b, hq, hkv, S, n_split, \
                         stream);
  switch (head_dim) {
    DA_CASE(16)
    DA_CASE(64)
    DA_CASE(112)
    DA_CASE(128)
    DA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws: f32 workspace of
// B * Hq * n_split * (head_dim + 2) floats (no initial value needed).
// Returns the cudaError_t of the two launches (cudaErrorInvalidValue for
// a dtype or head_dim the kernel does not take).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_len, void* ws,
                                       void* out, int dtype, int b, int hq,
                                       int hkv, int head_dim, int seq_len,
                                       int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k_cache, v_cache, kv_len, ws, out,
                             b, hq, hkv, seq_len, n_split, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k_cache, v_cache, kv_len,
                                     ws, out, b, hq, hkv, seq_len, n_split,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
