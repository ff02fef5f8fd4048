// Flash attention (prefill) for Hopper (sm_90a): every query of a
// sequence against the keys of the same sequence, causal, windowed or
// bidirectional, without materializing the (S, S) score matrix.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention.  Same function:
// q (B, Hq, S, D); k/v (B, Hkv, S, D) with Hq % Hkv == 0; query head h
// reads KV head h / (Hq / Hkv) (GQA by index: K/V are never copied per
// query head); key k is kept for query q when k <= q (causal) and
// q - k < window (window > 0); the online softmax runs in f32 with
// scale = D^-0.5, and the output is acc / max(l, 1e-30) in q's dtype.
// Unlike the Pallas kernel, S need not be a multiple of the tile: the
// ragged last tile is masked (keys) and not stored (queries).
//
// What bounds it on the card: operations.  Each unmasked (q, k) pair
// costs 4 * D flops (QK^T and PV) against 2 * D elements of K/V that a
// tile reuses for all of its queries, far above the ~295 flops per byte
// at which the H100 stops being memory-bound.  The least time is
// 4 * B * Hq * D * (unmasked pairs) / 989 TFLOP/s (bf16 tensor cores).
//
// Three instances, picked by dtype and D in flash_attention_launch:
//
// * bf16, D in {64, 112, 128, 256} (gemma3's 256, qwen7b's 128, zamba2's
//   112): the tensor-core instance (namespace tc).
//   A block owns 128 query rows of one (b, head) and runs two warpgroups
//   and a warp.  One
//   thread of the warp (the producer) loads Q once and streams K and V
//   tiles of BK keys (64; 32 at D 256) through a ring of 2 stages (4 at
//   D 256) with TMA (3-D tensor maps over (D, S, B * H), so the ragged
//   last tile is zero-filled by the hardware and never reads the next
//   head's rows), each load completing on an mbarrier.  The two consumer
//   warpgroups own 64 query rows apiece: S = Q K^T runs on wgmma
//   m64nBKk16 from shared memory (both operands K-major, bf16 in,
//   f32 out); the online softmax runs on those f32 registers; P is
//   rounded to bf16 in registers and is wgmma's A operand for O += P V
//   (m64nDk16, V MN-major in shared memory), with O in registers.
//   Nothing of S or P goes to shared memory.  Operands keep the 128-byte
//   swizzle TMA writes (hopper.cuh); D = 112 rows are 224 bytes, not a
//   whole number of 128-byte atoms, so the tile is laid out as D = 128
//   with TMA filling the columns past D with zeros: QK^T takes 7 k-steps,
//   PV runs at n = 128 and the epilogue stores D columns.  KV tiles
//   wholly above the diagonal or outside the window are skipped; the
//   element mask runs only on tiles that cross the diagonal, the window
//   edge or S; the longest causal rows go first in the grid.
//   Shared memory: Q 2 * 64 * Dp * 2 bytes + the stages of K and V
//   (BK * Dp * 2 each): 192 KB at D 256, 96 KB at 128 and 112.
//   Registers: O is Dp / 2 floats per consumer thread (128 at D 256),
//   S BK / 2.  The block is 288 threads (two warpgroups and the producer
//   warp), and ptxas and the card budget registers for it in whole
//   warpgroups, as for 384 threads: 168 a thread.  At D 256 with BK 64
//   the consumer needs more, so ptxas spilled ~330 bytes a thread and
//   serialized some wgmma; BK 32 halves S and P and leaves ~90 bytes of
//   spill.  The other ways out failed: setmaxnreg (240 for the consumers,
//   24 for a producer warpgroup) left ptxas compiling the consumers in
//   168, and __maxnreg__(224) compiled spill-free but the launch then
//   fails with cudaErrorLaunchOutOfResources.
//   GQA packing (the query heads of one KV head sharing its K/V tiles in
//   one block) was not taken: gemma3's groups are 2, so it would halve
//   K/V traffic that L2 already serves (the sibling block reads the same
//   tiles at about the same time), for a block twice as large.
//   What bounds it now: each consumer warpgroup waits for its QK^T before
//   the softmax and for its PV before the next QK^T; the two warpgroups
//   overlap each other, not their own softmax with their own products
//   (issuing the next QK^T behind the PV was slower within 168
//   registers); K/V tiles are loaded once per query head.
//
// * bf16, D = 80 (hubert's encoder layers, 48 launches a forward): the
//   tensor-core instance of namespace tc80, designed for this width.
//   What bounds it: the tensor cores and, as much, everything that does
//   not overlap them.  A 64-row x 128-key tile of one warpgroup is ~640
//   clocks of products at the bf16 peak and 8192 exp2 at 16 a clock per
//   SM (~512 clocks), so run one after the other the two cap it near
//   55 % of the bound; one after the other on a tile padded to 128
//   columns, as D 112 is (37.5 % of PV's products on zeros), they
//   reached 22 % on an H100 (700 W).  The design:
//   - 80 columns, none padded.  Each row of Q, K and V is a 64-column
//     block in the 128-byte swizzle and a 16-column block in the 32-byte
//     swizzle (two TMA boxes per tile, hopper.cuh).  QK^T is, per 64
//     keys, m64n64 over 4 k-steps on the first block and 1 on the second;
//     PV is, per 16 keys, m64n64 on the first block plus m64n16 on the
//     second (V MN-major): 80 columns, and no HGMMA.64x128x16 anywhere
//     (chip_smoke.py checks the SASS).  PV at n 80 over an MN-major V
//     1.25 swizzle atoms wide was not tried.
//   - Q in registers: each warpgroup reads its Q tile out of shared
//     memory into wgmma A fragments once per tile, so QK^T reads only K
//     from shared memory (with Q there too, QK^T at n 64 needs the SM's
//     whole 128 bytes a clock of shared-memory bandwidth at the peak).
//   - BK 128: the ring holds 4 stages of 128 keys (20 KB each of K and
//     V, 180 KB with Q), halving the barriers, turns and waits per key
//     of BK 64.  S is 64 floats a thread, P 32 registers, O 40, Q 20,
//     which 168 registers a thread cannot hold without spilling; so the
//     producer is a whole warpgroup that gives up its registers with
//     setmaxnreg (24), and the consumers take 240.
//   - The softmax overlapped with the products.  Inside a warpgroup,
//     the next tile's QK^T is issued before the last tile's PV, and the
//     softmax of the new scores runs while that PV does (wgmma_wait<1>;
//     FlashAttention-3, arXiv:2407.08608, sec. 3.2): S and P are
//     separate registers, O is rescaled between the two issues.  Between
//     the two consumer warpgroups, named barriers 1 and 2 give each in
//     turn the right to issue its products, so one warpgroup's softmax
//     runs under the other's products (sec. 3.1).
//   - A persistent grid: one block per SM walks the (b, head, q tile)
//     tiles, so the next tile's Q and first K/V tiles load while this
//     tile's last PV and stores run; Q is released (q_empty) as soon as
//     it is in registers.
//   What bounds it now: each tile's first softmax and its epilogue run
//   without products of their own warpgroup behind them, the exp2 (6 %
//   of the time on an H100 at 700 W), and the two warpgroups' products
//   strictly in turns.
//   Times and the variants measured on the way (one block per tile, BK
//   64 with 4 or 8 stages, 3 stages, no turns, no exp2): PERF.md, from
//   chip_smoke.py --flash80-variants.
//
// * f32 (any D), and bf16 at D 16 / 32 (the smoke configs): the CUDA-core
//   instance of the first port (namespace fma), unchanged.  It stages
//   tiles as f32 in shared memory and computes in f32 FMAs, so it is
//   bounded by the 67 TFLOP/s f32 rate; the f32 parity runs depend on its
//   full-f32 products.  One block owns one (b, head, 64-query tile) and
//   loops over its reachable KV tiles; 256 threads form a 16 x 16 grid:
//   thread (ty, tx) owns query rows 4ty..4ty+3, scores at keys tx + 16j
//   and output columns spread over tx.  flash_attention_fma_launch runs
//   it for either dtype (a yardstick for the tensor-core instance).

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {
namespace fma {

using attn::store_elem;
using attn::word_to_float;

constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)
constexpr int kBQ = 64;        // query rows per block
constexpr int kRM = kBQ / 16;  // query rows per thread

// One 16-byte word of T at src (zeros when !ok) into f32 shared memory.
template <typename T>
__device__ __forceinline__ void stage16(const T* __restrict__ src, float* dst,
                                        bool ok) {
  constexpr int N = 16 / sizeof(T);
  float f[N];
  if (ok) {
    word_to_float<T>(__ldg(reinterpret_cast<const uint4*>(src)), f);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(dst + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

template <int D>
struct Shape {
  static constexpr int BK = D >= 128 ? 32 : 64;  // keys per KV tile
  static constexpr int CN = BK / 16;             // score columns per thread
  static constexpr int DC = D / 16;              // output columns per thread
  static constexpr bool V4 = D % 64 == 0;        // columns as float4 runs
  static constexpr int KST = D + 4;              // K row stride (floats)
  static constexpr int PST = BK + 4;             // P row stride (floats)
  static constexpr int kSmemFloats = kBQ * D + BK * KST + BK * D + kBQ * PST;
  static constexpr int kSmemBytes = kSmemFloats * 4;
};

// Output column of the c-th accumulator of thread tx.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  return Shape<D>::V4 ? 4 * tx + 64 * (c / 4) + (c % 4) : tx + 16 * c;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int S, int causal, int window, float scale) {
  using Sh = Shape<D>;
  constexpr int BK = Sh::BK, CN = Sh::CN, DC = Sh::DC;
  constexpr int KST = Sh::KST, PST = Sh::PST;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  static_assert(D % 16 == 0 && D % kVec == 0, "head_dim must split 16 ways");

  extern __shared__ float4 smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // kBQ x D
  float* Ks = Qs + kBQ * D;                        // BK x KST
  float* Vs = Ks + BK * KST;                       // BK x D
  float* Ps = Vs + BK * D;                         // kBQ x PST

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // the longest causal rows first, so they do not trail the grid
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (hq / hkv);
  const int q_start = q_tile * kBQ;
  const T* qb = q + ((size_t)b * hq + head) * S * D;
  const T* kb = k + ((size_t)b * hkv + kvh) * S * D;
  const T* vb = v + ((size_t)b * hkv + kvh) * S * D;

  for (int e = threadIdx.x * kVec; e < kBQ * D; e += kThreads * kVec) {
    const int row = e / D;
    stage16<T>(qb + (size_t)(q_start + row) * D + e % D, Qs + e,
               q_start + row < S);
  }

  float m[kRM], l[kRM], acc[kRM][DC];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that hold at least one key some query of this tile keeps
  const int n_kv = (S + BK - 1) / BK;
  const int q_last = min(q_start + kBQ, S) - 1;
  const int kt_end = causal ? min(n_kv, q_last / BK + 1) : n_kv;
  const int k_min = window > 0 ? q_start - window + 1 : 0;
  const int kt_begin = k_min > 0 ? k_min / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = threadIdx.x * kVec; e < BK * D; e += kThreads * kVec) {
      const int row = e / D;
      const int col = e % D;
      const bool ok = k_start + row < S;
      const size_t g = (size_t)(k_start + row) * D + col;
      stage16<T>(kb + g, Ks + row * KST + col, ok);
      stage16<T>(vb + g, Vs + e, ok);
    }
    __syncthreads();

    // scores of rows 4ty+i at keys tx+16j
    float s[kRM][CN];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRM], kv[CN];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * kRM + i) * D + d);
#pragma unroll
      for (int j = 0; j < CN; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KST + d);
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // mask, online softmax over the 16 threads of the row group
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qpos = q_start + ty * kRM + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k_start + tx + 16 * j;
        const bool keep = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
        s[i][j] = keep ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // no key kept yet in this row: nothing to rescale, nothing to add
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[(ty * kRM + i) * PST + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V, four keys per step
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * kRM + i) * PST + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * D;
        float vv[DC];
        if constexpr (Sh::V4) {
#pragma unroll
          for (int c = 0; c < DC; c += 4) {
            const float4 w =
                *reinterpret_cast<const float4*>(vrow + out_col<D>(tx, c));
            vv[c] = w.x;
            vv[c + 1] = w.y;
            vv[c + 2] = w.z;
            vv[c + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DC; ++c) vv[c] = vrow[out_col<D>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y
                        : e == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int row = q_start + ty * kRM + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + (((size_t)b * hq + head) * S + row) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) store_elem(orow + out_col<D>(tx, c),
                                            acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int S, int causal, int window,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const int smem = Shape<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, S, causal,
      window, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v,
               void* out, int b, int hq, int hkv, int S, int causal,
               int window, cudaStream_t stream) {
#define FA_CASE(D_) \
  case D_:          \
    return launch<T, D_>(q, k, v, out, b, hq, hkv, S, causal, window, stream);
  switch (head_dim) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(80)
    FA_CASE(112)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

}  // namespace fma

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBQ = 64 * kConsumers;            // query rows per block
constexpr int kBlock = 64 * 128;  // bytes of a 64-row, 64-column bf16 block

template <int D>
struct Shape {
  // columns laid out in smem: rows of 112 are not whole 128-byte swizzle
  // atoms, so they are padded to 128 (TMA zero-fills the rest)
  static constexpr int DP = D == 112 ? 128 : D;
  static constexpr int CB = DP / 64;             // 64-column blocks
  static constexpr int KSTEPS = D / 16;          // QK^T reduction steps
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per KV tile
  static constexpr int kStages = D == 256 ? 4 : 2;
  static constexpr int kKVBlock = BK * 128;      // a 64-column block of K or V
  static constexpr int kQBytes = kConsumers * CB * kBlock;
  static constexpr int kTileBytes = CB * kKVBlock;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // + 1024 to align the base, + the mbarriers
  static constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (1 + 3 * kStages);
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                bf16* __restrict__ out, int hq, int hkv, int S, int causal,
                int window, float scale_log2) {
  using Sh = Shape<D>;
  constexpr int DP = Sh::DP, CB = Sh::CB;
  constexpr int kBK = Sh::BK, kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = base;                               // [wg][cb] blocks
  uint8_t* Ks = Qs + Sh::kQBytes;                   // [stage][cb] blocks
  uint8_t* Vs = Ks + kStages * Sh::kTileBytes;      // [stage][cb] blocks
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Sh::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  // the longest causal rows first, so they do not trail the grid
  const int q_tile = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;  // b * hq + head
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q_start = q_tile * kBQ;
  // KV tiles that hold at least one key some query of this block keeps
  const int n_kv = (S + kBK - 1) / kBK;
  const int q_last = min(q_start + kBQ, S) - 1;
  const int kt_end = causal ? min(n_kv, q_last / kBK + 1) : n_kv;
  const int k_min = window > 0 ? q_start - window + 1 : 0;
  const int kt_begin = k_min > 0 ? k_min / kBK : 0;

  if (threadIdx.x == 0) {
    hk::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hk::mbar_init(k_full + s, 1);
      hk::mbar_init(v_full + s, 1);
      hk::mbar_init(empty + s, 4 * kConsumers);  // one arrival per warp
    }
    hk::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 128 * kConsumers) {
      hk::mbar_expect_tx(q_full, Sh::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < CB; ++c)
          hk::tma_load_3d(Qs + (w * CB + c) * kBlock, &qmap, q_full, 64 * c,
                          q_start + 64 * w, bh);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        hk::mbar_wait(empty + stage, phase ^ 1);
        uint8_t* kd = Ks + stage * Sh::kTileBytes;
        uint8_t* vd = Vs + stage * Sh::kTileBytes;
        hk::mbar_expect_tx(k_full + stage, Sh::kTileBytes);
        for (int c = 0; c < CB; ++c)
          hk::tma_load_3d(kd + c * Sh::kKVBlock, &kmap, k_full + stage, 64 * c,
                          kt * kBK, bkv);
        hk::mbar_expect_tx(v_full + stage, Sh::kTileBytes);
        for (int c = 0; c < CB; ++c)
          hk::tma_load_3d(vd + c * Sh::kKVBlock, &vmap, v_full + stage, 64 * c,
                          kt * kBK, bkv);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    const int tid = threadIdx.x % 128;
    const int row0 = q_start + 64 * wg;  // first query row of this warpgroup
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    const uint8_t* q_wg = Qs + wg * CB * kBlock;
    hk::mbar_wait(q_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = kt_begin; kt < kt_end; ++kt) {
      const uint8_t* kt_s = Ks + stage * Sh::kTileBytes;
      const uint8_t* vt_s = Vs + stage * Sh::kTileBytes;
      // S = Q K^T over the D / 16 reduction steps
      float s[kBK / 2];
      hk::mbar_wait(k_full + stage, phase);
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Sh::KSTEPS; ++kk) {
        const int off = (kk % 4) * 32;
        hk::Wgmma<kBK>::ss(s, hk::desc_sw128(q_wg + (kk / 4) * kBlock + off, 16, 1024),
                           hk::desc_sw128(kt_s + (kk / 4) * Sh::kKVBlock + off, 16, 1024), kk > 0);
      }
      hk::wgmma_commit();
      hk::wgmma_wait<0>();
      hk::fence_regs(s);

      // the element mask, only on tiles that cross the diagonal, the
      // window edge or S
      const int k0 = kt * kBK;
      const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                          (window > 0 && row0 + 63 - k0 >= window);
      if (masked) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int qpos = row0 + hk::acc_row(tid, i);
          const int kpos = k0 + hk::acc_col(tid, i);
          const bool keep = kpos < S && (!causal || kpos <= qpos) &&
                            (window <= 0 || qpos - kpos < window);
          if (!keep) s[i] = -INFINITY;
        }
      }
      // online softmax on the registers: rows h = 0, 1 of this thread,
      // each shared with the 3 other threads of its quad
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // no key kept yet in this row: nothing to rescale
        alpha[h] = mx[h] == -INFINITY ? 1.f : exp2f((m[h] - mx[h]) * scale_log2);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      uint32_t pa[kBK / 16][4];  // P as wgmma A fragments, one per 16 keys
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        const int h = (i >> 1) & 1;
        const float mh = m[h] * scale_log2;
        const float p0 = s[i] == -INFINITY ? 0.f : exp2f(s[i] * scale_log2 - mh);
        const float p1 =
            s[i + 1] == -INFINITY ? 0.f : exp2f(s[i + 1] * scale_log2 - mh);
        l[h] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = hk::pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V over the 64 keys of the tile
      hk::mbar_wait(v_full + stage, phase);
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        hk::Wgmma<DP>::rs_mn(o, pa[kk],
                             hk::desc_sw128(vt_s + kk * 2048, Sh::kKVBlock, 1024), 1);
      hk::wgmma_commit();
      hk::wgmma_wait<0>();
      hk::fence_regs(o);
      __syncwarp();
      if ((tid & 31) == 0) hk::mbar_arrive(empty + stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
    bf16* ob = out + (size_t)bh * S * D;
#pragma unroll
    for (int i = 0; i < DP / 2; i += 2) {
      const int row = row0 + hk::acc_row(tid, i);
      const int col = hk::acc_col(tid, i);
      const float f = inv[(i >> 1) & 1];
      if (row < S && col < D)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + col) =
            hk::pack_bf16(o[i] * f, o[i + 1] * f);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int S, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)b * hq};
  const uint64_t dkv[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)b * hkv};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)S * D * 2};
  const uint32_t box[3] = {64, 64, 1};
  const uint32_t kvbox[3] = {64, (uint32_t)Shape<D>::BK, 1};
  if (!hk_host::tmap_bf16(&qm, q, 3, dq, strides, box) ||
      !hk_host::tmap_bf16(&km, k, 3, dkv, strides, kvbox) ||
      !hk_host::tmap_bf16(&vm, v, 3, dkv, strides, kvbox))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_tc_kernel<D>;
  const int smem = Shape<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(out), hq, hkv, S, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// The tensor-core instance at D 80 (hubert's head dim): the header says
// what bounds it and what its design does about that.
namespace tc80 {

using bf16 = __nv_bfloat16;

constexpr int D = 80;
constexpr int kBK = 128;       // keys per KV tile
constexpr int kStages = 4;     // of the K/V ring
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kBQ = 64 * kConsumers;              // query rows per tile
constexpr int kWide = 128;   // bytes of a row's columns 0-63 (128-byte swizzle)
constexpr int kNarrow = 32;  // bytes of its columns 64-79 (32-byte swizzle)
constexpr int kQWide = 64 * kWide;      // one warpgroup's Q, columns 0-63
constexpr int kQNarrow = 64 * kNarrow;  // and 64-79
constexpr int kQBytes = kConsumers * (kQWide + kQNarrow);
constexpr int kKVWide = kBK * kWide;
constexpr int kKVNarrow = kBK * kNarrow;
constexpr int kTile = kKVWide + kKVNarrow;  // one K or V tile
constexpr int kStage = 2 * kTile;           // K then V
constexpr int kBarOffset = kQBytes + kStages * kStage;
// + 1024 to align the base, + the mbarriers
constexpr int kSmemBytes = kBarOffset + 1024 + 8 * (2 + 3 * kStages);
static_assert(kQWide % 1024 == 0 && kQNarrow % 1024 == 0 &&
              kKVWide % 1024 == 0 && kKVNarrow % 1024 == 0,
              "every block stays 1024-byte aligned");
// named barriers 1 and 2: the turn of warpgroup 0 / 1 to issue its products
constexpr int kTurn = 1;
// registers a thread after setmaxnreg: 2 x 128 x 240 + 128 x 24 <= 65536
constexpr int kConsumerRegs = 240, kProducerRegs = 24;

// Tile t of the grid's walk: the q tiles of one (b, head) in a row, the
// last (longest causal) first, and the KV tiles that hold at least one
// key some query of the tile keeps.
struct Tile {
  int bh, bkv, q_start, kt_begin, kt_end;
};

__device__ __forceinline__ Tile tile_at(int t, int n_q, int hq, int hkv,
                                        int S, int causal, int window) {
  Tile r;
  r.bh = t / n_q;  // b * hq + head
  r.bkv = (r.bh / hq) * hkv + (r.bh % hq) / (hq / hkv);
  r.q_start = (n_q - 1 - t % n_q) * kBQ;
  const int n_kv = (S + kBK - 1) / kBK;
  const int q_last = min(r.q_start + kBQ, S) - 1;
  r.kt_end = causal ? min(n_kv, q_last / kBK + 1) : n_kv;
  const int k_min = window > 0 ? r.q_start - window + 1 : 0;
  r.kt_begin = k_min > 0 ? k_min / kBK : 0;
  return r;
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

// One arrival per warp on `bar` once the warp is done with what it guards.
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hk::mbar_arrive(bar);
}

// This thread's Q as wgmma A fragments, one per 16 columns (the
// accumulator layout of m64n16), read out of the two swizzles.
__device__ __forceinline__ void load_q(uint32_t (&qa)[5][4], const uint8_t* qw,
                                       const uint8_t* qn, int tid) {
  const int r = 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int c = 2 * (tid & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = r + 8 * (j & 1), col = 8 * (j >> 1) + c;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      qa[kk][j] = *reinterpret_cast<const uint32_t*>(
          qw + hk::sw128_offset(row, 16 * kk + col, 64));
    qa[4][j] = *reinterpret_cast<const uint32_t*>(
        qn + row * kNarrow + (((col >> 3) ^ ((row >> 2) & 1)) << 4) +
        (col & 7) * 2);
  }
}

// Keys 64 h .. 64 h + 63 of a tile's scores: accumulator h of m64n64.
__device__ __forceinline__ float (&keys64(float (&s)[kBK / 2], int h))[32] {
  return *reinterpret_cast<float(*)[32]>(s + 32 * h);
}

// S = Q K^T, Q in registers, m64n64 per 64 keys: 4 k-steps over the
// 128-byte-swizzled columns of K, 1 over the 32-byte-swizzled ones.
__device__ __forceinline__ void qk(float (&s)[kBK / 2],
                                   const uint32_t (&qa)[5][4],
                                   const uint8_t* kw, const uint8_t* kn) {
#pragma unroll
  for (int h = 0; h < kBK / 64; ++h) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hk::Wgmma<64>::rs(keys64(s, h), qa[kk],
                        hk::desc_sw128(kw + h * 64 * kWide + 32 * kk, 16, 1024),
                        kk > 0);
    hk::Wgmma<64>::rs(keys64(s, h), qa[4],
                      hk::desc_sw32(kn + h * 64 * kNarrow, 16, 256), 1);
  }
}

// O += P V: per 16 keys, n 64 over the 128-byte-swizzled columns of V and
// n 16 over the 32-byte-swizzled ones (V MN-major).
__device__ __forceinline__ void pv(float (&ow)[32], float (&on)[8],
                                   const uint32_t (&pa)[kBK / 16][4],
                                   const uint8_t* vw, const uint8_t* vn) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    hk::Wgmma<64>::rs_mn(ow, pa[kk], hk::desc_sw128(vw + kk * 2048, 8192, 1024),
                         1);
    hk::Wgmma<16>::rs_mn(on, pa[kk], hk::desc_sw32(vn + kk * 512, 512, 256), 1);
  }
}

// The online softmax of one tile's scores, in place: s becomes P (f32),
// m the new row maxima, l the rescaled sums plus this tile's, alpha the
// factor the output takes before this tile's P V.  Rows h = 0, 1 of this
// thread, each shared with the 3 other threads of its quad.
__device__ __forceinline__ void softmax(float (&s)[kBK / 2], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        int tid, int row0, int k0, int S,
                                        int causal, int window,
                                        float scale_log2) {
  // the element mask, only on tiles that cross the diagonal, the window
  // edge or S
  const bool masked = k0 + kBK > S || (causal && k0 + kBK - 1 > row0) ||
                      (window > 0 && row0 + 63 - k0 >= window);
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int qpos = row0 + hk::acc_row(tid, i);
      const int kpos = k0 + hk::acc_col(tid, i);
      const bool keep = kpos < S && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
      if (!keep) s[i] = -INFINITY;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // no key kept yet in this row: subtract 0, so masked keys give
    // 2^-inf = 0 and alpha = 0 rescales nothing but zeros
    mh[h] = mx[h] == -INFINITY ? 0.f : mx[h] * scale_log2;
    alpha[h] = hk::ex2(m[h] * scale_log2 - mh[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = hk::ex2(fmaf(s[i], scale_log2, -mh[h]));
    l[h] += s[i];
  }
}

__device__ __forceinline__ void rescale(float (&ow)[32], float (&on)[8],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) ow[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 8; ++i) on[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void to_bf16(const float (&s)[kBK / 2],
                                        uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBK / 2; i += 2)
    pa[i / 8][(i % 8) / 2] = hk::pack_bf16(s[i], s[i + 1]);
}

__global__ void __launch_bounds__(kThreads, 1)
flash80_kernel(const __grid_constant__ CUtensorMap q_wide,
               const __grid_constant__ CUtensorMap q_narrow,
               const __grid_constant__ CUtensorMap k_wide,
               const __grid_constant__ CUtensorMap k_narrow,
               const __grid_constant__ CUtensorMap v_wide,
               const __grid_constant__ CUtensorMap v_narrow,
               bf16* __restrict__ out, int hq, int hkv, int S, int n_q,
               int n_tiles, int causal, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Q: [wg] wide blocks, then [wg] narrow blocks; stage s of the ring: K
  // wide, K narrow, V wide, V narrow
  uint8_t* Qs = base;
  uint8_t* ring = base + kQBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* k_full = bars + 2;
  uint64_t* v_full = bars + 2 + kStages;
  uint64_t* empty = bars + 2 + 2 * kStages;

  if (threadIdx.x == 0) {
    hk::mbar_init(q_full, 1);
    hk::mbar_init(q_empty, 4 * kConsumers);  // one arrival per warp
    for (int s = 0; s < kStages; ++s) {
      hk::mbar_init(k_full + s, 1);
      hk::mbar_init(v_full + s, 1);
      hk::mbar_init(empty + s, 4 * kConsumers);
    }
    hk::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 128 * kConsumers) return;
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const Tile tl = tile_at(t, n_q, hq, hkv, S, causal, window);
      // the consumers hold the last tile's Q in registers
      hk::mbar_wait(q_empty, q_phase ^ 1);
      q_phase ^= 1;
      hk::mbar_expect_tx(q_full, kQBytes);
      for (int w = 0; w < kConsumers; ++w) {
        hk::tma_load_3d(Qs + w * kQWide, &q_wide, q_full, 0,
                        tl.q_start + 64 * w, tl.bh);
        hk::tma_load_3d(Qs + kConsumers * kQWide + w * kQNarrow, &q_narrow,
                        q_full, 64, tl.q_start + 64 * w, tl.bh);
      }
      for (int kt = tl.kt_begin; kt < tl.kt_end; ++kt) {
        hk::mbar_wait(empty + stage, phase ^ 1);
        uint8_t* kd = ring + stage * kStage;
        uint8_t* vd = kd + kTile;
        hk::mbar_expect_tx(k_full + stage, kTile);
        hk::tma_load_3d(kd, &k_wide, k_full + stage, 0, kt * kBK, tl.bkv);
        hk::tma_load_3d(kd + kKVWide, &k_narrow, k_full + stage, 64,
                        kt * kBK, tl.bkv);
        hk::mbar_expect_tx(v_full + stage, kTile);
        hk::tma_load_3d(vd, &v_wide, v_full + stage, 0, kt * kBK, tl.bkv);
        hk::tma_load_3d(vd + kKVWide, &v_narrow, v_full + stage, 64,
                        kt * kBK, tl.bkv);
        advance(stage, phase);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int turn = kTurn + wg, next = kTurn + (wg ^ 1);
  const uint8_t* qw = Qs + wg * kQWide;
  const uint8_t* qn = Qs + kConsumers * kQWide + wg * kQNarrow;
  if (wg == 1) hk::named_arrive(kTurn, 256);  // warpgroup 0 goes first
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const Tile tl = tile_at(t, n_q, hq, hkv, S, causal, window);
    const int row0 = tl.q_start + 64 * wg;  // first query row of this warpgroup
    float ow[32], on[8];  // O, columns 0-63 and 64-79
#pragma unroll
    for (int i = 0; i < 32; ++i) ow[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) on[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    uint32_t qa[5][4];         // Q as wgmma A fragments, one per 16 columns
    uint32_t pa[kBK / 16][4];  // P as wgmma A fragments, one per 16 keys
    hk::mbar_wait(q_full, q_phase);
    q_phase ^= 1;
    load_q(qa, qw, qn, tid);
    warp_arrive(q_empty);

    // the first KV tile: S = Q K^T, then its softmax
    {
      const uint8_t* ks = ring + stage * kStage;
      float s[kBK / 2];
      hk::mbar_wait(k_full + stage, phase);
      hk::named_sync(turn, 256);
      hk::wgmma_fence();
      qk(s, qa, ks, ks + kKVWide);
      hk::wgmma_commit();
      hk::named_arrive(next, 256);
      hk::wgmma_wait<0>();
      hk::fence_regs(s);
      softmax(s, m, l, alpha, tid, row0, tl.kt_begin * kBK, S, causal,
              window, scale_log2);
      to_bf16(s, pa);
    }
    // the stage whose V the pending P V reads
    int p_stage = stage;
    uint32_t p_phase = phase;
    advance(stage, phase);
    for (int kt = tl.kt_begin + 1; kt < tl.kt_end; ++kt) {
      const uint8_t* ks = ring + stage * kStage;
      const uint8_t* vs = ring + p_stage * kStage + kTile;
      float s[kBK / 2];
      hk::mbar_wait(k_full + stage, phase);
      hk::named_sync(turn, 256);
      // this tile's QK^T, then the last tile's P V behind it
      hk::wgmma_fence();
      qk(s, qa, ks, ks + kKVWide);
      hk::wgmma_commit();
      rescale(ow, on, alpha);
      hk::mbar_wait(v_full + p_stage, p_phase);
      hk::wgmma_fence();
      pv(ow, on, pa, vs, vs + kKVWide);
      hk::wgmma_commit();
      hk::named_arrive(next, 256);
      // this tile's softmax while the P V runs
      hk::wgmma_wait<1>();
      hk::fence_regs(s);
      softmax(s, m, l, alpha, tid, row0, kt * kBK, S, causal, window,
              scale_log2);
      hk::wgmma_wait<0>();
      hk::fence_regs(ow);
      hk::fence_regs(on);
      warp_arrive(empty + p_stage);
      to_bf16(s, pa);
      p_stage = stage;
      p_phase = phase;
      advance(stage, phase);
    }
    // the last tile's P V
    {
      const uint8_t* vs = ring + p_stage * kStage + kTile;
      rescale(ow, on, alpha);
      hk::mbar_wait(v_full + p_stage, p_phase);
      hk::wgmma_fence();
      pv(ow, on, pa, vs, vs + kKVWide);
      hk::wgmma_commit();
      hk::wgmma_wait<0>();
      hk::fence_regs(ow);
      hk::fence_regs(on);
      warp_arrive(empty + p_stage);
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
    bf16* ob = out + (size_t)tl.bh * S * D;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + hk::acc_row(tid, i);
      const float f = inv[(i >> 1) & 1];
      if (row < S)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + hk::acc_col(tid, i)) =
            hk::pack_bf16(ow[i] * f, ow[i + 1] * f);
    }
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int row = row0 + hk::acc_row(tid, i);
      const float f = inv[(i >> 1) & 1];
      if (row < S)
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 64 +
                                     hk::acc_col(tid, i)) =
            hk::pack_bf16(on[i] * f, on[i + 1] * f);
    }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int S, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap qw, qn, kw, kn, vw, vn;
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)b * hq};
  const uint64_t dkv[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)b * hkv};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)S * D * 2};
  const uint32_t q_box_w[3] = {64, 64, 1}, q_box_n[3] = {16, 64, 1};
  const uint32_t kv_box_w[3] = {64, kBK, 1}, kv_box_n[3] = {16, kBK, 1};
  const CUtensorMapSwizzle sw32 = CU_TENSOR_MAP_SWIZZLE_32B;
  if (!hk_host::tmap_bf16(&qw, q, 3, dq, strides, q_box_w) ||
      !hk_host::tmap_bf16(&qn, q, 3, dq, strides, q_box_n, sw32) ||
      !hk_host::tmap_bf16(&kw, k, 3, dkv, strides, kv_box_w) ||
      !hk_host::tmap_bf16(&kn, k, 3, dkv, strides, kv_box_n, sw32) ||
      !hk_host::tmap_bf16(&vw, v, 3, dkv, strides, kv_box_w) ||
      !hk_host::tmap_bf16(&vn, v, 3, dkv, strides, kv_box_n, sw32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash80_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_q = (S + kBQ - 1) / kBQ;
  const int n_tiles = n_q * b * hq;
  // a persistent grid: one block per SM walks the tiles, so the next
  // tile's Q and K/V load while this one's last products and stores run
  const int grid = n_tiles < sms ? n_tiles : sms;
  flash80_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      qw, qn, kw, kn, vw, vn, static_cast<bf16*>(out), hq, hkv, S, n_q,
      n_tiles, causal, window,
      1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc80
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window: 0 = none.
// bf16 at D 64, 80, 112, 128 and 256 runs the tensor-core instance, every
// other (dtype, D) the CUDA-core one.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a dtype or head_dim the kernel does
// not take, or a tensor map the driver refuses).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int hq, int hkv, int seq_len,
                                      int head_dim, int causal, int window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fma::launch_dim<float>(head_dim, q, k, v, out, b, hq, hkv,
                                  seq_len, causal, window, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
#define TC_CASE(D_) \
  case D_:          \
    return tc::launch<D_>(q, k, v, out, b, hq, hkv, seq_len, causal, window, s);
  switch (head_dim) {
    TC_CASE(64)
    case 80:
      return tc80::launch(q, k, v, out, b, hq, hkv, seq_len, causal, window,
                          s);
    TC_CASE(112)
    TC_CASE(128)
    TC_CASE(256)
    default:
      return fma::launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, b, hq,
                                            hkv, seq_len, causal, window, s);
  }
#undef TC_CASE
}

// The CUDA-core instance for either dtype: the yardstick the tensor-core
// instance is timed against.  Same arguments and return as above.
extern "C" int flash_attention_fma_launch(const void* q, const void* k,
                                          const void* v, void* out, int dtype,
                                          int b, int hq, int hkv, int seq_len,
                                          int head_dim, int causal, int window,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fma::launch_dim<float>(head_dim, q, k, v, out, b, hq, hkv,
                                  seq_len, causal, window, s);
  if (dtype == 1)
    return fma::launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, b, hq, hkv,
                                          seq_len, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
