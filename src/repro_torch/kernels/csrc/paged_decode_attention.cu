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
// What bounds it on the card: memory.  Each (b, KV head) must read
// kv_len_b * D * 2 elements of K/V, and each of its G = Hq / Hkv query
// heads does 4 * D flops per token: a few flops per byte in bf16, far
// below the ~295 flops per byte at which the H100's tensor cores would be
// the limit.  The least time is
// sum_b kv_len_b * Hkv * D * 2 * itemsize bytes / 3.35 TB/s.
//
// How the design answers that (paged_decode_attention_launch, namespace
// group):
//
// * One K/V read per group.  One block owns one (chunk, KV head, b) and
//   computes all G query heads of the KV head's group (G up to 16), so a
//   page is pulled through L2 once, not once per query head as the split
//   kernel below does (5 times at qwen32b's 40 / 8).
// * Dots on the tensor cores: mma.sync m16n8k16, bf16 in, f32 out.  The
//   group's heads are the 16 M rows (rows past G hold zeros and are never
//   written), so a group of 5 costs 16 rows of products: ~16 flops a
//   byte, still far under the tensor cores' limit.  Q is loaded once into
//   A fragments.  Each warp owns 16-token slices of a stage:
//   S = Q K^T takes its K rows as B fragments (ldmatrix), is scaled,
//   masked by position with a select (stale data never reaches the
//   softmax, NaN included) and run through an online softmax in base 2
//   (f32); P is rounded to bf16 in registers, where the accumulator
//   layout of S is already the A layout of O += P V, and V comes as B
//   fragments through ldmatrix.trans (FlashAttention-2's register
//   layout).  P is cast to V's dtype as the plain version casts its
//   probabilities.  The warps' (m, l, O) merge in shared memory at the
//   end of the chunk, and the block writes G rows of the split kernel's
//   f32 workspace, which attn_common.cuh's merge kernel reads unchanged:
//   a call is two launches, as before.
// * Bytes in flight.  A chunk is whole pages, cut into stages of whole
//   pages and a multiple of 16 tokens (64 at ps 16).  One thread keeps a
//   ring of kStages stages in flight: each page's K and V slab of this KV
//   head ((page * Hkv + hk) * ps rows of D, contiguous) arrives as TMA
//   boxes of 64 columns x ps rows over a 2-D tensor map of the pool
//   (NP * Hkv * ps, D), completing on the stage's mbarrier.  Once every
//   warp has consumed a stage (__syncthreads) the thread refills its
//   slot with the stage kStages ahead.  Pages wholly past kv_len are not
//   loaded; the chunk's page ids are read once into shared memory.
// * No bank conflicts.  A linear copy of 256-byte rows (D 128) would put
//   all eight rows of an ldmatrix on the same banks; TMA writes the
//   128-byte swizzle instead (the 16-byte chunk c of row r at c ^ r % 8,
//   hopper.cuh), and the ldmatrix addresses follow it.  A page's box
//   starts on a 1024-byte swizzle atom, so ps must be a multiple of 8.
//   D 112 is laid out as 128 columns (TMA zero-fills the last 16, which
//   no product reads).  TMA was taken over cp.async: one thread issues a
//   stage, and the swizzle costs no instruction.
// * Stale rows.  The last live page of a row holds, past kv_len, what a
//   freed page held or memory never written, possibly NaN.  P is 0 there
//   by the select, but 0 x NaN in P V is NaN, so the warp that owns the
//   slice holding kv_len zeroes those V rows in shared memory first.
// * The grid (n_split, Hkv, B) is sized from shapes alone (no read of
//   kv_len, no synchronization, no allocation): decode_attention.py's
//   paged_plan picks chunk and stage.  A chunk that starts at or past
//   kv_len writes m = -inf, l = 0 for its G rows and exits.
//
// Routes (paged_plan): bf16 at D 64, 112, 128 with ps a multiple of 8
// takes the group kernel; f32 (an f32 product on the tensor cores could
// not hold the f32 parity's 2e-5), the smoke widths D 8 and 16, and
// other page sizes take the split kernel of attn_common.cuh
// (paged_decode_attention_split_launch: one block per (chunk, query
// head, b), K/V through registers), which also serves as the yardstick
// the group kernel is timed against.

#include "attn_common.cuh"
#include "hopper.cuh"

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

namespace group {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;            // stages of the ring in flight
constexpr int kMaxG = 16;             // query heads a block computes: mma's M
constexpr int kMaxStageTokens = 128;  // tokens of a stage, at most
constexpr int kMaxChunkPages = 64;    // pages of a chunk, at most
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Shape {
  static_assert(D % 16 == 0 && D <= 128, "head_dim: whole k16 steps, <= 128");
  static constexpr int kBlocks = (D + 63) / 64;  // 64-column blocks of a row
  static constexpr int kKSteps = D / 16;         // k16 steps of Q K^T
  static constexpr int kPairs = D / 16;          // n8 tile pairs of P V
};

// Shared memory of one block: the ring (K then V, [slot][64-column
// block][token] rows of 128 bytes), which the warps' merge reuses, and
// 1024 bytes to align the base to a swizzle atom.
template <int D>
size_t smem_bytes(int stage_tokens, int group) {
  const size_t ring =
      (size_t)kStages * 2 * Shape<D>::kBlocks * stage_tokens * 128;
  const size_t merge = (size_t)kWarps * (group * D + 2 * kMaxG) * 4;
  return (ring > merge ? ring : merge) + 1024;
}

DEV uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage st of a chunk into its slot, by one thread: the K and V boxes of
// its live pages (64 columns x one page each), completing on the slot's
// barrier.
template <int D>
DEV void issue(const CUtensorMap* kmap, const CUtensorMap* vmap, uint8_t* ks,
               uint8_t* vs, uint64_t* full, const int* pages, int st,
               int stage_pages, int live_pages, int ps, int hkv, int kvh,
               uint32_t block_bytes) {
  const int slot = st % kStages;
  const int p0 = st * stage_pages;
  const int np = min(stage_pages, live_pages - p0);
  const uint32_t slot_bytes = Shape<D>::kBlocks * block_bytes;
  hk::mbar_expect_tx(full + slot,
                     (uint32_t)np * 2 * Shape<D>::kBlocks * ps * 128);
  for (int p = 0; p < np; ++p) {
    const int row = (pages[p0 + p] * hkv + kvh) * ps;
#pragma unroll
    for (int c = 0; c < Shape<D>::kBlocks; ++c) {
      const uint32_t off = slot * slot_bytes + c * block_bytes + p * ps * 128;
      hk::tma_load_2d(ks + off, kmap, full + slot, 64 * c, row);
      hk::tma_load_2d(vs + off, vmap, full + slot, 64 * c, row);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_group_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const bf16* __restrict__ q,
                   const int* __restrict__ page_table,
                   const int* __restrict__ kv_len, float* __restrict__ ws,
                   int n_pages, int hq, int hkv, int ps, int max_pages,
                   int n_split, int chunk_pages, int stage_pages,
                   float scale_log2) {
  using Sh = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ int s_page[kMaxChunkPages];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int hi0 = kvh * group;  // the group's first query head
  const int len = max(0, min(kv_len[b], max_pages * ps));
  const int chunk = chunk_pages * ps;
  const int t0 = split * chunk;
  const int n_tok = min(len, t0 + chunk) - t0;
  if (n_tok <= 0) {  // nothing of this row lies in the chunk
    if ((int)threadIdx.x < group) {
      float* w = ws_row<D>(ws, b, hq, hi0 + threadIdx.x, n_split, split);
      w[D] = -INFINITY;
      w[D + 1] = 0.f;
    }
    return;
  }
  const int stage_tokens = stage_pages * ps;
  const int n_stage = (n_tok + stage_tokens - 1) / stage_tokens;
  const int live_pages = (n_tok + ps - 1) / ps;
  const uint32_t block_bytes = (uint32_t)stage_tokens * 128;
  const uint32_t slot_bytes = Sh::kBlocks * block_bytes;
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = base;                        // [slot][block][token]
  uint8_t* vs = base + kStages * slot_bytes;  // the same for V

  const int* table = page_table + (size_t)b * max_pages + split * chunk_pages;
  for (int p = threadIdx.x; p < live_pages; p += kThreads)
    s_page[p] = min(max(table[p], 0), n_pages - 1);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) hk::mbar_init(&full[s], 1);
    hk::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages && st < n_stage; ++st)
      issue<D>(&kmap, &vmap, ks, vs, full, s_page, st, stage_pages,
               live_pages, ps, hkv, kvh, block_bytes);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;        // accumulator rows g and g + 8
  const int c2 = 2 * (lane & 3);  // accumulator columns c2, c2 + 1
  // Q as A fragments of every k16 step; rows past the group are zeros
  uint32_t qf[Sh::kKSteps][4];
  {
    const bf16* q0 = q + ((size_t)b * hq + hi0) * D;
    const bool lo = g < group, hi = g + 8 < group;
#pragma unroll
    for (int kk = 0; kk < Sh::kKSteps; ++kk) {
      const int c = 16 * kk + c2;
      qf[kk][0] = lo ? ld_pair(q0 + g * D + c) : 0u;
      qf[kk][1] = hi ? ld_pair(q0 + (g + 8) * D + c) : 0u;
      qf[kk][2] = lo ? ld_pair(q0 + g * D + c + 8) : 0u;
      qf[kk][3] = hi ? ld_pair(q0 + (g + 8) * D + c + 8) : 0u;
    }
  }
  float o[2 * Sh::kPairs][4];
#pragma unroll
  for (int n = 0; n < 2 * Sh::kPairs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's share of the row sums

  // the ldmatrix row of this lane: K's matrices are (tokens 0-7, chunk
  // c), (0-7, c + 1), (8-15, c), (8-15, c + 1); V's (0-7, c), (8-15, c),
  // (0-7, c + 1), (8-15, c + 1)
  const int k_row = (lane & 7) + ((lane >> 4) << 3);
  const int k_chunk = (lane >> 3) & 1;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int v_chunk = lane >> 4;
  const int slices = stage_tokens / 16;

  for (int st = 0; st < n_stage; ++st) {
    const int slot = st % kStages;
    const uint32_t kb = hk::smem_u32(ks + slot * slot_bytes);
    const uint32_t vb = hk::smem_u32(vs + slot * slot_bytes);
    hk::mbar_wait(&full[slot], (st / kStages) & 1);
    // the warps take the chunk's slices in turn
    for (int i = ((warp - st * slices) % kWarps + kWarps) % kWarps;
         i < slices; i += kWarps) {
      const int j0 = 16 * i;                         // first row in the slot
      const int live = n_tok - st * stage_tokens - j0;  // live rows
      if (live <= 0) break;
      if (live < 16) {
        // rows past kv_len hold stale data or none: zero their V, or
        // P = 0 times a NaN there poisons the row
        for (int x = lane; x < (16 - live) * 8 * Sh::kBlocks; x += 32) {
          const int r = j0 + live + x / (8 * Sh::kBlocks);
          const int c = x % (8 * Sh::kBlocks);
          *reinterpret_cast<uint4*>(vs + slot * slot_bytes +
                                    (c / 8) * block_bytes + r * 128 +
                                    (c % 8) * 16) = make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // S = Q K^T over two n8 tiles of 8 tokens
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      {
        const int r = j0 + k_row;
#pragma unroll
        for (int kk = 0; kk < Sh::kKSteps; ++kk) {
          const int chunk16 = (kk % 4) * 2 + k_chunk;
          uint32_t f[4];
          hk::ldmatrix_x4(f, kb + (kk / 4) * block_bytes + r * 128 +
                                 ((chunk16 ^ (r & 7)) << 4));
          hk::mma_bf16_16816(s[0], qf[kk], f[0], f[1]);
          hk::mma_bf16_16816(s[1], qf[kk], f[2], f[3]);
        }
      }
      // scale into base 2 and mask by position: a select, so whatever
      // the stale rows gave S never reaches the softmax
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = 8 * n + c2 + (e & 1) < live;
          s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // row 0 of the slice is live, so mx is finite
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = hk::ex2(m[h] - m_new);  // 0 on the first slice
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = hk::ex2(s[n][e] - m[e >> 1]);  // 0 where masked
          l[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < 2 * Sh::kPairs; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // P in bf16 as the A operand: S's accumulator layout is A's
      const uint32_t pa[4] = {hk::pack_bf16(s[0][0], s[0][1]),
                              hk::pack_bf16(s[0][2], s[0][3]),
                              hk::pack_bf16(s[1][0], s[1][1]),
                              hk::pack_bf16(s[1][2], s[1][3])};
      // O += P V over pairs of n8 tiles of 8 columns
      {
        const int r = j0 + v_row;
#pragma unroll
        for (int pp = 0; pp < Sh::kPairs; ++pp) {
          const int chunk16 = (pp % 4) * 2 + v_chunk;
          uint32_t f[4];
          hk::ldmatrix_x4_trans(f, vb + (pp / 4) * block_bytes + r * 128 +
                                       ((chunk16 ^ (r & 7)) << 4));
          hk::mma_bf16_16816(o[2 * pp], pa, f[0], f[1]);
          hk::mma_bf16_16816(o[2 * pp + 1], pa, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // the slot is consumed by every warp
    if (threadIdx.x == 0 && st + kStages < n_stage)
      issue<D>(&kmap, &vmap, ks, vs, full, s_page, st + kStages, stage_pages,
               live_pages, ps, hkv, kvh, block_bytes);
  }

  // every stage issued was waited for and consumed: the ring's memory
  // now holds the warps' states, [warp][head][D] then m and l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  float* s_o = reinterpret_cast<float*>(base);
  float* s_m = s_o + kWarps * group * D;
  float* s_l = s_m + kWarps * kMaxG;
#pragma unroll
  for (int n = 0; n < 2 * Sh::kPairs; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1);
      if (r < group) s_o[(warp * group + r) * D + 8 * n + c2 + (e & 1)] = o[n][e];
    }
  if ((lane & 3) == 0) {
    s_m[warp * kMaxG + g] = m[0];
    s_m[warp * kMaxG + g + 8] = m[1];
    s_l[warp * kMaxG + g] = l[0];
    s_l[warp * kMaxG + g + 8] = l[1];
  }
  __syncthreads();

  // merge the warps' states per head; a warp that saw no token has l 0
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mxw = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (s_l[w * kMaxG + r] > 0.f) mxw = fmaxf(mxw, s_m[w * kMaxG + r]);
    float num = 0.f;
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (s_l[w * kMaxG + r] > 0.f) {
        const float c = hk::ex2(s_m[w * kMaxG + r] - mxw);
        num = fmaf(c, s_o[(w * group + r) * D + d], num);
        den = fmaf(c, s_l[w * kMaxG + r], den);
      }
    }
    float* w = ws_row<D>(ws, b, hq, hi0 + r, n_split, split);
    w[d] = num;
    if (d == 0) {
      w[D] = mxw * kLn2;  // the merge kernel's base e
      w[D + 1] = den;
    }
  }
}

template <int D>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* kv_len, void* ws, void* out,
           int b, int hq, int hkv, int n_pages, int ps, int max_pages,
           int n_split, int chunk_pages, int stage_pages,
           cudaStream_t stream) {
  const int group = hq / hkv;
  const int stage_tokens = stage_pages * ps;
  if (group > kMaxG || ps % 8 || ps > 256 || stage_pages < 1 ||
      stage_tokens % 16 || stage_tokens > kMaxStageTokens ||
      chunk_pages % stage_pages || chunk_pages > kMaxChunkPages ||
      (long long)n_split * chunk_pages < max_pages)
    return static_cast<int>(cudaErrorInvalidValue);
  // the pool as rows of D: (page * Hkv + hk) * ps + t, boxes of 64
  // columns x one page (D 112: the last 16 columns zero-filled)
  CUtensorMap km, vm;
  const uint64_t dims[2] = {(uint64_t)D, (uint64_t)n_pages * hkv * ps};
  const uint64_t strides[1] = {(uint64_t)D * 2};
  const uint32_t box[2] = {64, (uint32_t)ps};
  if (!hk_host::tmap_bf16(&km, k_pages, 2, dims, strides, box) ||
      !hk_host::tmap_bf16(&vm, v_pages, 2, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_group_kernel<D>;
  // once per instance and card, at the most any stage or group takes
  static std::atomic<unsigned long long> attr_set{0};
  const cudaError_t attr = max_dynamic_smem_on_device(
      kernel, static_cast<int>(smem_bytes<D>(kMaxStageTokens, kMaxG)),
      attr_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<dim3(n_split, hkv, b), kThreads,
           smem_bytes<D>(stage_tokens, group), stream>>>(
      km, vm, static_cast<const bf16*>(q),
      static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
      static_cast<float*>(ws), n_pages, hq, hkv, ps, max_pages, n_split,
      chunk_pages, stage_pages, kLog2e / sqrtf(static_cast<float>(D)));
  return launch_merge<bf16, D>(ws, out, b, hq, n_split, stream);
}

}  // namespace group
}  // namespace

// The group kernel (bf16 only).  ws: f32 workspace of
// B * Hq * n_split * (head_dim + 2) floats (no initial value needed);
// chunk_pages: pages of a chunk (the grid's x covers max_pages);
// stage_pages: pages of a ring stage (stage_pages * page_size a multiple
// of 16 tokens, at most 128; chunk_pages a multiple of it); page_size a
// multiple of 8; Hq / Hkv at most 16.  Returns the cudaError_t of the
// two launches (cudaErrorInvalidValue for a dtype, head_dim or plan the
// kernel does not take).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* page_table, const void* kv_len, void* ws, void* out,
    int dtype, int b, int hq, int hkv, int head_dim, int n_pages,
    int page_size, int max_pages, int n_split, int chunk_pages,
    int stage_pages, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1 || n_split < 1 || hkv < 1 || hq % hkv)
    return static_cast<int>(cudaErrorInvalidValue);
#define PG_CASE(D_)                                                        \
  case D_:                                                                 \
    return group::launch<D_>(q, k_pages, v_pages, page_table, kv_len, ws,  \
                             out, b, hq, hkv, n_pages, page_size,          \
                             max_pages, n_split, chunk_pages, stage_pages, \
                             s);
  switch (head_dim) {
    PG_CASE(64)
    PG_CASE(112)
    PG_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PG_CASE
}

// The split kernel of attn_common.cuh, one block per (chunk, query head,
// b).  dtype: 0 = float32, 1 = bfloat16; the other arguments as above
// without the group kernel's two.
extern "C" int paged_decode_attention_split_launch(
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
