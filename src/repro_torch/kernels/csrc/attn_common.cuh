// Device code shared by the port's kernels (sm_90a): 16-byte loads of
// f32 or bf16 into f32 registers and stores back (every kernel), and the
// split-KV decode that paged_decode_attention.cu and decode_attention.cu
// both run.  The two decode kernels differ only in how a token index becomes
// an address in their cache, which they pass in as a functor.
//
// Split-KV decode, one query token per (b, query head): the Pallas grid
// walks the KV axis in sequence with its online-softmax state in VMEM;
// on the card blocks run in parallel and carry nothing.  A decode batch
// has few (b, head) pairs, too few blocks to keep the memory system
// busy, so the sequence is cut into n_split chunks and one block owns
// one (chunk, head, b).  Inside a block, groups of lanes each own one
// token at a time (a group is D / EPT lanes rounded up to a power of
// two, each lane holding EPT elements read as 16-byte vectors, so
// neighbouring groups read neighbouring tokens and the loads coalesce;
// at D = 112 the last lanes of a group hold nothing), keep their own (m, l,
// acc) state, and issue the K and V loads of kDecodeUnroll tokens before
// any arithmetic on them.  The groups merge in shared memory and the
// block writes its chunk's unnormalized (acc, m, l) to an f32 workspace;
// a second, small kernel merges the chunks of each (b, head).  Chunks
// that start at or past kv_len exit at once; a row whose chunks are all
// empty (kv_len 0) gets zeros.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace attn {

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

// The least power of two >= v.
__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * 32;
constexpr int kDecodeUnroll = 4;

// Workspace row of one (b, head, chunk): D accumulator sums, then m, l.
template <int D>
__device__ __forceinline__ float* ws_row(float* ws, int b, int hq, int hi,
                                         int n_split, int split) {
  return ws + (((size_t)b * hq + hi) * n_split + split) * (D + 2);
}

// The block's chunk of split-KV decode: query head hi of row b against
// the tokens [t0, t1); token t's K and V rows start at element addr(t)
// of k and v.  Writes the chunk's (acc, m, l) to workspace row w.
// Every thread of the block must call it.
template <typename T, int D, typename Addr>
__device__ __forceinline__ void decode_chunk(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const Addr& addr, int b, int hq, int hi,
    int t0, int t1, float scale, float* __restrict__ w) {
  // elements per lane: one 16-byte word, or more when D > 32 words
  constexpr int kPerWord = 16 / sizeof(T);
  constexpr int kEPT = (D / 32 > kPerWord) ? D / 32 : kPerWord;
  constexpr int kUsed = D / kEPT;                 // lanes holding elements
  constexpr int kLanes = pow2_at_least(kUsed);    // lanes per token group
  constexpr int kGroupsPerWarp = 32 / kLanes;
  constexpr int kGroups = kDecodeWarps * kGroupsPerWarp;
  constexpr int kUnroll = kDecodeUnroll;
  static_assert(D % kEPT == 0 && kEPT % kPerWord == 0 && kLanes <= 32,
                "head_dim must split into whole 16-byte words per lane");

  __shared__ float s_acc[kGroups][D];
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];

  if (t0 >= t1) {  // nothing of this row lies in the chunk
    if (threadIdx.x == 0) {
      w[D] = -INFINITY;
      w[D + 1] = 0.f;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const int gid = (threadIdx.x >> 5) * kGroupsPerWarp + lane / kLanes;
  // a lane past the head's last word holds zeros and adds 0 to the dots
  const bool active = sub < kUsed;

  float qv[kEPT];
  if (active) {
    load_vec<T, kEPT>(q + ((size_t)b * hq + hi) * D + sub * kEPT, qv);
  } else {
#pragma unroll
    for (int e = 0; e < kEPT; ++e) qv[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < kEPT; ++e) qv[e] *= scale;

  float m = -INFINITY;
  float l = 0.f;
  float acc[kEPT];
#pragma unroll
  for (int e = 0; e < kEPT; ++e) acc[e] = 0.f;

  // the loop bound is uniform across the block, so every lane reaches
  // every shuffle below
  for (int base = t0; base < t1; base += kGroups * kUnroll) {
    float kf[kUnroll][kEPT];
    float vf[kUnroll][kEPT];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * kGroups + gid;
      valid[u] = t < t1;
      if (valid[u] && active) {
        const size_t off = addr(t) + sub * kEPT;
        load_vec<T, kEPT>(k + off, kf[u]);
        load_vec<T, kEPT>(v + off, vf[u]);
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
    // when all of this step's tokens lie past the chunk's end
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

  if (active) {
#pragma unroll
    for (int e = 0; e < kEPT; ++e) s_acc[gid][sub * kEPT + e] = acc[e];
  }
  if (sub == 0) {
    s_m[gid] = m;
    s_l[gid] = l;
  }
  __syncthreads();

  // merge the groups' states; a group that saw no token has l == 0
  float mx = -INFINITY;
  for (int g = 0; g < kGroups; ++g)
    if (s_l[g] > 0.f) mx = fmaxf(mx, s_m[g]);
  for (int d = threadIdx.x; d < D; d += kDecodeThreads) {
    float num = 0.f;
    for (int g = 0; g < kGroups; ++g)
      if (s_l[g] > 0.f) num = fmaf(expf(s_m[g] - mx), s_acc[g][d], num);
    w[d] = num;
  }
  if (threadIdx.x == 0) {
    float den = 0.f;
    for (int g = 0; g < kGroups; ++g)
      if (s_l[g] > 0.f) den = fmaf(expf(s_m[g] - mx), s_l[g], den);
    w[D] = mx;
    w[D + 1] = den;
  }
}

// One block per (head, b): merge the n_split chunk states into the
// output row; a row whose chunks are all empty (kv_len 0) gets zeros.
template <typename T, int D>
__global__ void decode_merge_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out, int hq,
                                    int n_split) {
  const int hi = blockIdx.x;
  const int b = blockIdx.y;
  const float* row = ws + ((size_t)b * hq + hi) * n_split * (D + 2);
  float mx = -INFINITY;
  for (int c = 0; c < n_split; ++c) {
    const float* w = row + (size_t)c * (D + 2);
    if (w[D + 1] > 0.f) mx = fmaxf(mx, w[D]);
  }
  float den = 0.f;
  for (int c = 0; c < n_split; ++c) {
    const float* w = row + (size_t)c * (D + 2);
    if (w[D + 1] > 0.f) den = fmaf(expf(w[D] - mx), w[D + 1], den);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float* w = row + (size_t)c * (D + 2);
      if (w[D + 1] > 0.f) num = fmaf(expf(w[D] - mx), w[d], num);
    }
    store_elem(out + ((size_t)b * hq + hi) * D + d,
               den > 0.f ? num / den : 0.f);
  }
}

// Check the split launch that came before, then launch the merge.
template <typename T, int D>
int launch_merge(const void* ws, void* out, int b, int hq, int n_split,
                 cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T, D><<<dim3(hq, b), D, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<T*>(out), hq, n_split);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's dynamic shared memory limit is an attribute of the device
// that is current at cudaFuncSetAttribute.  Sets it on the current device
// unless `done` (the calling instance's own static: one bit a device)
// says it is set there already, so each card pays the call once: a decode
// pass launches these kernels once a layer, and the host's time per
// launch is what the pass waits on.  Past device 63, on every call.
template <typename Kernel>
cudaError_t max_dynamic_smem_on_device(Kernel kernel, int bytes,
                                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace attn
