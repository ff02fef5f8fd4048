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
// What bounds it on the card: memory.  Each (b, KV head) must read
// kv_len_b * D * 2 elements of K/V, and each of its G = Hq / Hkv query
// heads does 4 * D flops per token, a few flops per byte in bf16, far
// below the ~295 flops per byte at which the H100's compute would be
// the limit.  The least time is
// sum_b kv_len_b * Hkv * D * 2 * itemsize bytes / 3.35 TB/s.
//
// How the design answers that (decode_attention_launch, namespace ring):
//
// * K/V bytes are read once per pair of query heads.  One block owns one
//   (chunk, KV head, b) and computes NG = 2 query heads of the KV head's
//   group (1 for MHA; a larger group takes several blocks on the grid's
//   y axis, and a head past the group's end is computed on zeros and not
//   written).  Each K row is dotted with both queries, so gemma3's pairs
//   no longer pull their K/V through L2 once per query head as the split
//   kernel below does.  Blocks of 4 and 8 heads were slower at groups of
//   5 and 8 (qwen2.5-14b's, llama70b's): the per-head dots, shuffles and
//   exponentials of one block then outgrow what its warps issue.
// * Enough bytes are in flight.  The (b, KV head) rows of a contiguous
//   cache are one slab, so a stage of K (and one of V) is a single
//   cp.async.bulk of stage_tokens * D * itemsize bytes into shared
//   memory, completing on the stage's mbarrier; a ring of kStages stages
//   (3 x 32 KB of K and V at D 256) is kept in flight per block while
//   the block computes on the oldest.  The last stage of a chunk copies
//   only the tokens below min(kv_len, S): nothing past a row's end, or
//   past the cache's end, is read.  One thread arms each barrier and
//   issues both copies; once the whole block has consumed a stage
//   (__syncthreads) it refills that slot with the stage kStages ahead.
//   No producer warp.
// * Compute from shared memory with the split kernel's lane mapping: a
//   group of kLanes lanes owns one token at a time, each lane holding
//   kEPT elements (one or two 16-byte words; a lane's second word is
//   kUsed words on, so a warp's 16-byte reads stay conflict-free), NG
//   dots and NG xor-shuffle reductions per token, an f32 online softmax
//   per head in base 2 (q is scaled by D^-0.5 * log2(e), so each
//   exponential is one exp2f; the workspace gets m back in base e).  The
//   groups merge in the ring's shared memory at the end and the block
//   writes NG workspace rows in the split kernel's layout, so
//   attn_common.cuh's merge kernel serves both.
// * The split over the sequence is sized from S on the host (no read of
//   kv_len): the grid and the workspace depend on shapes alone, and the
//   launch neither allocates nor synchronizes.  Chunks that start at or
//   past kv_len exit at once.
//
// decode_attention_split_launch keeps the split kernel of attn_common.cuh
// (one block per (chunk, query head, b), K/V through registers): the
// yardstick the ring kernel is timed against.  Token t of KV head hk of
// row b starts at element ((b * Hkv + hk) * S + t) * D in both.

#include "attn_common.cuh"
#include "hopper.cuh"

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

namespace ring {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;           // stages of the ring in flight
constexpr int kMaxG = 2;             // query heads a block computes at most
constexpr int kStageTokens = 32;     // tokens of a full stage, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// How a token's row is spread over a group of lanes.
template <typename T, int D>
struct Lanes {
  static constexpr int kPerWord = 16 / sizeof(T);
  // elements per lane: one 16-byte word, or more when D > 32 words
  static constexpr int kEPT = (D / 32 > kPerWord) ? D / 32 : kPerWord;
  static constexpr int kWords = kEPT / kPerWord;          // per lane
  static constexpr int kUsed = D / kEPT;                  // lanes with data
  static constexpr int kLanes = pow2_at_least(kUsed);     // lanes per group
  static constexpr int kGroupsPerWarp = 32 / kLanes;
  static constexpr int kGroups = kWarps * kGroupsPerWarp;
  static_assert(D % kEPT == 0 && kEPT % kPerWord == 0 && kLanes <= 32,
                "head_dim must split into whole 16-byte words per lane");

  // Element of word w, position e, of lane `sub`: words of one lane are
  // kUsed words apart.
  static __device__ __forceinline__ int elem(int sub, int w, int e) {
    return (sub + w * kUsed) * kPerWord + e;
  }

  // The lane's kEPT elements of a row of D (16-byte aligned) as f32.
  static __device__ __forceinline__ void load(const T* row, int sub,
                                              float (&out)[kEPT]) {
    const uint4* words = reinterpret_cast<const uint4*>(row);
#pragma unroll
    for (int w = 0; w < kWords; ++w)
      word_to_float<T>(words[sub + w * kUsed], out + w * kPerWord);
  }
};

// Shared memory of one block: the ring, which the final merge of the
// lane groups' states reuses.
template <typename T, int D, int NG>
size_t smem_bytes(int stage_tokens) {
  const size_t ring = (size_t)kStages * 2 * stage_tokens * D * sizeof(T);
  const size_t merge =
      (size_t)Lanes<T, D>::kGroups * NG * (D + 2) * sizeof(float);
  return ring > merge ? ring : merge;
}

template <typename T, int D, int NG>
__global__ void __launch_bounds__(kThreads)
decode_ring_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_len,
                   float* __restrict__ ws, int hq, int hkv, int S,
                   int n_split, int chunk, int stage_tokens, float scale) {
  using L = Lanes<T, D>;
  constexpr int kEPT = L::kEPT;
  // tokens a group takes per step: about four reduction chains in flight,
  // and no more tokens a step than a stage holds
  constexpr int kChains = 4 / NG;
  constexpr int kFit = kStageTokens / L::kGroups > 0
                           ? kStageTokens / L::kGroups : 1;
  constexpr int kU = kChains < kFit ? kChains : kFit;

  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kStages];

  const int split = blockIdx.x;
  const int group = hq / hkv;
  const int head_blocks = (group + NG - 1) / NG;
  const int kvh = blockIdx.y / head_blocks;
  const int h0 = (blockIdx.y % head_blocks) * NG;  // first head in the group
  const int nh = min(NG, group - h0);               // heads written
  const int hi0 = kvh * group + h0;
  const int b = blockIdx.z;
  const int len = max(0, min(kv_len[b], S));
  const int t0 = split * chunk;
  const int n_tok = min(len, t0 + chunk) - t0;
  if (n_tok <= 0) {  // nothing of this row lies in the chunk
    if ((int)threadIdx.x < nh) {
      float* w = ws_row<D>(ws, b, hq, hi0 + threadIdx.x, n_split, split);
      w[D] = -INFINITY;
      w[D + 1] = 0.f;
    }
    return;
  }
  const int n_stage = (n_tok + stage_tokens - 1) / stage_tokens;
  const size_t slot_elems = (size_t)stage_tokens * D;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + kStages * slot_elems;
  const size_t first = (((size_t)b * hkv + kvh) * S + t0) * D;

  // stage st of the chunk into its slot: its K and V rows, two bulk
  // copies that complete on the slot's barrier
  auto issue = [&](int st) {
    const int slot = st % kStages;
    const int tok = min(stage_tokens, n_tok - st * stage_tokens);
    const uint32_t bytes = (uint32_t)(tok * D * sizeof(T));
    const size_t off = first + (size_t)st * slot_elems;
    hk::mbar_expect_tx(&full[slot], 2 * bytes);
    hk::bulk_load(sk + slot * slot_elems, k + off, bytes, &full[slot]);
    hk::bulk_load(sv + slot * slot_elems, v + off, bytes, &full[slot]);
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hk::mbar_init(&full[s], 1);
    hk::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages && st < n_stage; ++st) issue(st);
  }

  const int lane = threadIdx.x & 31;
  const int sub = lane % L::kLanes;
  const int gid = (threadIdx.x >> 5) * L::kGroupsPerWarp + lane / L::kLanes;
  // a lane past the head's last word holds zeros and adds 0 to the dots
  const bool active = sub < L::kUsed;

  float qv[NG][kEPT];
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    if (active && h < nh) {
      L::load(q + ((size_t)b * hq + hi0 + h) * D, sub, qv[h]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPT; ++e) qv[h][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kEPT; ++e) qv[h][e] *= scale;
  }
  float m[NG], l[NG], acc[NG][kEPT];
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < kEPT; ++e) acc[h][e] = 0.f;
  }

  for (int st = 0; st < n_stage; ++st) {
    const int slot = st % kStages;
    const int tok = min(stage_tokens, n_tok - st * stage_tokens);
    const T* ks = sk + slot * slot_elems;
    const T* vs = sv + slot * slot_elems;
    hk::mbar_wait(&full[slot], (st / kStages) & 1);
    // the loop bound is uniform across the block, so every lane reaches
    // every shuffle below
    for (int base = 0; base < tok; base += L::kGroups * kU) {
      float s[kU][NG];
      bool valid[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = base + u * L::kGroups + gid;
        valid[u] = j < tok;
        float kf[kEPT];
        if (valid[u] && active) {
          L::load(ks + (size_t)j * D, sub, kf);
        } else {
#pragma unroll
          for (int e = 0; e < kEPT; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < kEPT; ++e) dot = fmaf(qv[h][e], kf[e], dot);
#pragma unroll
          for (int o = L::kLanes / 2; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          s[u][h] = valid[u] ? dot : -INFINITY;
        }
      }
      // a group's tokens are taken in order, so valid[0] is false only
      // when all of this step's tokens lie past the stage's end
      if (valid[0]) {
#pragma unroll
        for (int h = 0; h < NG; ++h) {
          float m_new = m[h];
#pragma unroll
          for (int u = 0; u < kU; ++u) m_new = fmaxf(m_new, s[u][h]);
          const float alpha = exp2f(m[h] - m_new);  // 0 on the first token
          l[h] *= alpha;
#pragma unroll
          for (int e = 0; e < kEPT; ++e) acc[h][e] *= alpha;
          m[h] = m_new;
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          // a slot's rows past `tok` hold stale or no data: never read
          if (!valid[u]) continue;
          float vf[kEPT];
          if (active) {
            L::load(vs + (size_t)(base + u * L::kGroups + gid) * D, sub, vf);
          } else {
#pragma unroll
            for (int e = 0; e < kEPT; ++e) vf[e] = 0.f;
          }
#pragma unroll
          for (int h = 0; h < NG; ++h) {
            const float p = exp2f(s[u][h] - m[h]);
            l[h] += p;
#pragma unroll
            for (int e = 0; e < kEPT; ++e)
              acc[h][e] = fmaf(p, vf[e], acc[h][e]);
          }
        }
      }
    }
    __syncthreads();  // the slot is consumed by every thread
    if (threadIdx.x == 0 && st + kStages < n_stage) issue(st + kStages);
  }

  // every stage issued was waited for and consumed: the ring's memory
  // now holds the groups' states, [group][head][D] then m and l
  float* s_acc = reinterpret_cast<float*>(smem);
  float* s_m = s_acc + L::kGroups * NG * D;
  float* s_l = s_m + L::kGroups * NG;
#pragma unroll
  for (int h = 0; h < NG; ++h) {
    if (active) {
#pragma unroll
      for (int w = 0; w < L::kWords; ++w)
#pragma unroll
        for (int e = 0; e < L::kPerWord; ++e)
          s_acc[(gid * NG + h) * D + L::elem(sub, w, e)] =
              acc[h][w * L::kPerWord + e];
    }
    if (sub == 0) {
      s_m[gid * NG + h] = m[h];
      s_l[gid * NG + h] = l[h];
    }
  }
  __syncthreads();

  // merge the groups' states per head; a group that saw no token has l 0
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float mx = -INFINITY;
    for (int g = 0; g < L::kGroups; ++g)
      if (s_l[g * NG + h] > 0.f) mx = fmaxf(mx, s_m[g * NG + h]);
    float num = 0.f;
    float den = 0.f;
    for (int g = 0; g < L::kGroups; ++g) {
      if (s_l[g * NG + h] > 0.f) {
        const float c = exp2f(s_m[g * NG + h] - mx);
        num = fmaf(c, s_acc[(g * NG + h) * D + d], num);
        den = fmaf(c, s_l[g * NG + h], den);
      }
    }
    float* w = ws_row<D>(ws, b, hq, hi0 + h, n_split, split);
    w[d] = num;
    if (d == 0) {
      w[D] = mx * kLn2;  // the merge kernel's base e
      w[D + 1] = den;
    }
  }
}

template <typename T, int D, int NG>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* ws, void* out, int b, int hq, int hkv, int S, int n_split,
           int stage_tokens, cudaStream_t stream) {
  if (stage_tokens < 1 || stage_tokens > kStageTokens)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_ring_kernel<T, D, NG>;
  // once per instance, at the most any stage size takes (192 KB at f32
  // D 256): a decode pass launches this kernel once a layer, and the
  // host's time per launch is what the pass waits on
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, D, NG>(kStageTokens)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem = smem_bytes<T, D, NG>(stage_tokens);
  const int chunk = (S + n_split - 1) / n_split;
  const int head_blocks = (hq / hkv + NG - 1) / NG;
  kernel<<<dim3(n_split, hkv * head_blocks, b), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<float*>(ws), hq, hkv, S, n_split, chunk, stage_tokens,
      kLog2e / sqrtf(static_cast<float>(D)));
  return launch_merge<T, D>(ws, out, b, hq, n_split, stream);
}

template <typename T, int D>
int launch_group(int heads_per_block, const void* q, const void* k,
                 const void* v, const void* kv_len, void* ws, void* out, int b,
                 int hq, int hkv, int S, int n_split, int stage_tokens,
                 cudaStream_t stream) {
#define NG_CASE(NG_)                                                  \
  case NG_:                                                           \
    return launch<T, D, NG_>(q, k, v, kv_len, ws, out, b, hq, hkv, S, \
                             n_split, stage_tokens, stream);
  switch (heads_per_block) {
    NG_CASE(1)
    NG_CASE(kMaxG)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef NG_CASE
}

template <typename T>
int launch_dim(int head_dim, int heads_per_block, const void* q,
               const void* k, const void* v, const void* kv_len, void* ws,
               void* out, int b, int hq, int hkv, int S, int n_split,
               int stage_tokens, cudaStream_t stream) {
#define DR_CASE(D_)                                                         \
  case D_:                                                                  \
    return launch_group<T, D_>(heads_per_block, q, k, v, kv_len, ws, out, b, \
                               hq, hkv, S, n_split, stage_tokens, stream);
  switch (head_dim) {
    DR_CASE(16)
    DR_CASE(64)
    DR_CASE(112)
    DR_CASE(128)
    DR_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DR_CASE
}

}  // namespace ring
}  // namespace

// The ring kernel.  dtype: 0 = float32, 1 = bfloat16.  ws: f32 workspace
// of B * Hq * n_split * (head_dim + 2) floats (no initial value needed).
// heads_per_block: query heads one block computes (1 or 2; a group of
// Hq / Hkv heads takes ceil(group / heads_per_block) blocks);
// stage_tokens: tokens per stage of the ring (1 to kStageTokens).
// Returns the cudaError_t of the two launches (cudaErrorInvalidValue for
// a dtype, head_dim, heads_per_block or stage size the kernel does not
// take).
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache,
                                       const void* kv_len, void* ws,
                                       void* out, int dtype, int b, int hq,
                                       int hkv, int head_dim, int seq_len,
                                       int n_split, int heads_per_block,
                                       int stage_tokens, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split < 1 || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return ring::launch_dim<float>(head_dim, heads_per_block, q, k_cache,
                                   v_cache, kv_len, ws, out, b, hq, hkv,
                                   seq_len, n_split, stage_tokens, s);
  if (dtype == 1)
    return ring::launch_dim<__nv_bfloat16>(
        head_dim, heads_per_block, q, k_cache, v_cache, kv_len, ws, out, b,
        hq, hkv, seq_len, n_split, stage_tokens, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split kernel of attn_common.cuh, one block per (chunk, query head,
// b): the yardstick.  Arguments as above without the ring's two.
extern "C" int decode_attention_split_launch(const void* q,
                                             const void* k_cache,
                                             const void* v_cache,
                                             const void* kv_len, void* ws,
                                             void* out, int dtype, int b,
                                             int hq, int hkv, int head_dim,
                                             int seq_len, int n_split,
                                             void* stream) {
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
