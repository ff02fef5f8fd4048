// Paged decode attention for Hopper (sm_90a): one query token per
// sequence against a KV cache stored in a pool of fixed-size pages.
//
// Replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::paged_decode_attention.  Same
// function: q (B, Hq, D); k/v pages (NP, Hkv, ps, D); page_table
// (B, MP) int32 with ids clamped into [0, NP); kv_len (B,) int32.
// Query head hi reads KV head hi / (Hq / Hkv) (GQA without replicating
// the pool), positions at or past kv_len are masked, pages wholly past
// kv_len are never read, the online softmax runs in f32 with
// scale = D^-0.5, and a row with kv_len == 0 gets zeros.
//
// What bounds it on the card: memory.  Each (b, head) reads
// kv_len_b * D * 2 elements of K/V and does 4 * D flops per token, about
// one flop per byte in bf16, far below the ~295 flops per byte at
// which the H100's compute would be the limit.  The least time is
// sum_b kv_len_b * Hkv * D * 2 * itemsize bytes / 3.35 TB/s.
//
// How the design answers that: the split-KV layout of attn_common.cuh,
// shared with decode_attention.cu, with a paged address: token t of KV
// head hk of row b lies at offset t % ps of page page_table[b][t / ps],
// so the K/V rows of a page are contiguous and neighbouring lane groups
// still read neighbouring memory.  (One block per (b, head), walking
// all of its tokens, leaves the memory system half idle at qwen7b's
// decode shape: 256 blocks of 1 000-2 000 serial tokens.)

#include "attn_common.cuh"

namespace {

using namespace attn;

template <int D>
struct PagedRows {
  const int* __restrict__ table;  // this row's page table (MP entries)
  int n_pages;
  int ps;
  size_t page_stride;  // elements per page: Hkv * ps * D
  size_t head;         // this KV head's offset inside a page
  __device__ __forceinline__ size_t operator()(int t) const {
    const int lp = t / ps;
    const int page = min(max(__ldg(table + lp), 0), n_pages - 1);
    return (size_t)page * page_stride + head + (size_t)(t - lp * ps) * D;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
paged_decode_attention_split_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k_pages,
                                    const T* __restrict__ v_pages,
                                    const int* __restrict__ page_table,
                                    const int* __restrict__ kv_len,
                                    float* __restrict__ ws, int n_pages,
                                    int hq, int hkv, int ps, int max_pages,
                                    int n_split, int chunk, float scale) {
  const int split = blockIdx.x;
  const int hi = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hi / (hq / hkv);
  // tokens past the table's last page are never attended (the Pallas
  // grid stops at MP pages); a negative length attends to nothing
  const int len = max(0, min(kv_len[b], max_pages * ps));
  const int t0 = split * chunk;
  const PagedRows<D> rows{page_table + (size_t)b * max_pages, n_pages, ps,
                          (size_t)hkv * ps * D, (size_t)hk * ps * D};
  decode_chunk<T, D>(q, k_pages, v_pages, rows, b, hq, hi, t0,
                     min(len, t0 + chunk), scale,
                     ws_row<D>(ws, b, hq, hi, n_split, split));
}

template <typename T, int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* kv_len, void* ws, void* out,
           int b, int hq, int hkv, int n_pages, int ps, int max_pages,
           int n_split, cudaStream_t stream) {
  const int chunk = (max_pages * ps + n_split - 1) / n_split;
  paged_decode_attention_split_kernel<T, D>
      <<<dim3(n_split, hq, b), kDecodeThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
          static_cast<const int*>(kv_len), static_cast<float*>(ws), n_pages,
          hq, hkv, ps, max_pages, n_split, chunk,
          1.0f / sqrtf(static_cast<float>(D)));
  return launch_merge<T, D>(ws, out, b, hq, n_split, stream);
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k_pages,
               const void* v_pages, const void* page_table,
               const void* kv_len, void* ws, void* out, int b, int hq,
               int hkv, int n_pages, int ps, int max_pages, int n_split,
               cudaStream_t stream) {
#define PDA_CASE(D_)                                                      \
  case D_:                                                                \
    return launch<T, D_>(q, k_pages, v_pages, page_table, kv_len, ws, out, \
                         b, hq, hkv, n_pages, ps, max_pages, n_split,     \
                         stream);
  switch (head_dim) {
    PDA_CASE(8)
    PDA_CASE(16)
    PDA_CASE(64)
    PDA_CASE(112)
    PDA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PDA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws: f32 workspace of
// B * Hq * n_split * (head_dim + 2) floats (no initial value needed).
// Returns the cudaError_t of the two launches (cudaErrorInvalidValue for
// a dtype or head_dim the kernel does not take).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* ws, void* out,
    int dtype, int b, int hq, int hkv, int head_dim, int n_pages,
    int page_size, int max_pages, int n_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k_pages, v_pages, page_table,
                             kv_len, ws, out, b, hq, hkv, n_pages, page_size,
                             max_pages, n_split, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k_pages, v_pages,
                                     page_table, kv_len, ws, out, b, hq, hkv,
                                     n_pages, page_size, max_pages, n_split,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
