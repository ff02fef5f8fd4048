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
// How the design answers that: the Pallas grid walks the page axis in
// sequence, one (ps, D) tile per step; here the blocks run in parallel
// and nothing carries between them, so one block owns one (b, hi) and
// walks all of its tokens itself.  Inside the block, groups of lanes
// each own one token at a time (a group is D / EPT lanes, each lane
// holding EPT elements read as 16-byte vectors, so neighbouring groups
// read neighbouring tokens of a page and the loads coalesce).  Every
// group keeps its own (m, l, acc) online-softmax state and issues the
// K and V loads of kUnroll tokens before it does any arithmetic on
// them, which keeps several loads in flight per lane.  The groups
// merge through shared memory once at the end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;

template <typename T>
__device__ __forceinline__ void word_to_float(const uint4& w, float* out);

template <>
__device__ __forceinline__ void word_to_float<float>(const uint4& w,
                                                     float* out) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

template <>
__device__ __forceinline__ void word_to_float<__nv_bfloat16>(const uint4& w,
                                                             float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// N elements starting at p (16-byte aligned) into f32 registers.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kPerWord = 16 / sizeof(T);
  static_assert(N % kPerWord == 0, "lane slice must be whole 16-byte words");
  const uint4* w = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < N / kPerWord; ++i) {
    uint4 u = __ldg(w + i);
    word_to_float<T>(u, out + i * kPerWord);
  }
}

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ page_table,
                              const int* __restrict__ kv_len,
                              T* __restrict__ out, int n_pages, int hq,
                              int hkv, int ps, int max_pages, float scale) {
  // elements per lane: one 16-byte word, or more when D > 32 words
  constexpr int kPerWord = 16 / sizeof(T);
  constexpr int kEPT = (D / 32 > kPerWord) ? D / 32 : kPerWord;
  constexpr int kLanes = D / kEPT;  // lanes per token group (power of 2)
  constexpr int kGroupsPerWarp = 32 / kLanes;
  constexpr int kGroups = kWarps * kGroupsPerWarp;
  static_assert(D % kEPT == 0 && kLanes <= 32 && 32 % kLanes == 0,
                "head_dim must be a power of two the lanes can split");

  __shared__ float s_acc[kGroups][D];
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];

  const int hi = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = hi / (hq / hkv);
  // tokens past the table's last page are never attended (the Pallas
  // grid stops at MP pages); a negative length attends to nothing
  const int len = max(0, min(kv_len[b], max_pages * ps));
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int gid = (threadIdx.x >> 5) * kGroupsPerWarp + lane / kLanes;

  float qv[kEPT];
  load_vec<T, kEPT>(q + ((size_t)b * hq + hi) * D + sub * kEPT, qv);
#pragma unroll
  for (int e = 0; e < kEPT; ++e) qv[e] *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kEPT];
#pragma unroll
  for (int e = 0; e < kEPT; ++e) acc[e] = 0.f;

  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head_stride = (size_t)ps * D;
  const size_t page_stride = (size_t)hkv * head_stride;
  const size_t lane_off = (size_t)hk * head_stride + sub * kEPT;

  // the loop bound is uniform across the block, so every lane reaches
  // every shuffle below
  for (int base = 0; base < len; base += kGroups * kUnroll) {
    float kf[kUnroll][kEPT];
    float vf[kUnroll][kEPT];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kGroups + gid;
      valid[u] = t < len;
      if (valid[u]) {
        const int lp = t / ps;
        const int page = min(max(pt[lp], 0), n_pages - 1);
        const size_t off =
            (size_t)page * page_stride + (size_t)(t - lp * ps) * D + lane_off;
        load_vec<T, kEPT>(k_pages + off, kf[u]);
        load_vec<T, kEPT>(v_pages + off, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kEPT; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kEPT; ++e) dot = fmaf(qv[e], kf[u][e], dot);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      s[u] = valid[u] ? dot : -INFINITY;
    }
    // tokens of a group are issued in order, so valid[0] is false only
    // when all of this step's tokens lie past kv_len
    if (valid[0]) {
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, s[u]);
      const float alpha = expf(m - m_new);  // 0 on the first token
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kEPT; ++e) acc[e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(s[u] - m_new);  // 0 for masked tokens
        l += p;
#pragma unroll
        for (int e = 0; e < kEPT; ++e) acc[e] = fmaf(p, vf[u][e], acc[e]);
      }
      m = m_new;
    }
  }

#pragma unroll
  for (int e = 0; e < kEPT; ++e) s_acc[gid][sub * kEPT + e] = acc[e];
  if (sub == 0) {
    s_m[gid] = m;
    s_l[gid] = l;
  }
  __syncthreads();

  // merge the groups' states; a group that saw no token has l == 0
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mx = -INFINITY;
    for (int g = 0; g < kGroups; ++g)
      if (s_l[g] > 0.f) mx = fmaxf(mx, s_m[g]);
    float num = 0.f;
    float den = 0.f;
    for (int g = 0; g < kGroups; ++g) {
      if (s_l[g] > 0.f) {
        const float w = expf(s_m[g] - mx);
        num = fmaf(w, s_acc[g][d], num);
        den = fmaf(w, s_l[g], den);
      }
    }
    store_elem(out + ((size_t)b * hq + hi) * D + d,
               den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k_pages, const void* v_pages,
            const void* page_table, const void* kv_len, void* out, int b,
            int hq, int hkv, int n_pages, int ps, int max_pages,
            cudaStream_t stream) {
  const dim3 grid(hq, b);
  paged_decode_attention_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(page_table),
      static_cast<const int*>(kv_len), static_cast<T*>(out), n_pages, hq,
      hkv, ps, max_pages, 1.0f / sqrtf(static_cast<float>(D)));
}

template <typename T>
bool launch_dim(int head_dim, const void* q, const void* k_pages,
                const void* v_pages, const void* page_table,
                const void* kv_len, void* out, int b, int hq, int hkv,
                int n_pages, int ps, int max_pages, cudaStream_t stream) {
#define PDA_CASE(D_)                                                      \
  case D_:                                                                \
    launch<T, D_>(q, k_pages, v_pages, page_table, kv_len, out, b, hq,   \
                  hkv, n_pages, ps, max_pages, stream);                   \
    return true;
  switch (head_dim) {
    PDA_CASE(8)
    PDA_CASE(16)
    PDA_CASE(64)
    PDA_CASE(128)
    default:
      return false;
  }
#undef PDA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a dtype or head_dim the kernel
// does not take).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* out, int dtype, int b,
    int hq, int hkv, int head_dim, int n_pages, int page_size, int max_pages,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == 0)
    ok = launch_dim<float>(head_dim, q, k_pages, v_pages, page_table, kv_len,
                           out, b, hq, hkv, n_pages, page_size, max_pages, s);
  else if (dtype == 1)
    ok = launch_dim<__nv_bfloat16>(head_dim, q, k_pages, v_pages, page_table,
                                   kv_len, out, b, hq, hkv, n_pages,
                                   page_size, max_pages, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
