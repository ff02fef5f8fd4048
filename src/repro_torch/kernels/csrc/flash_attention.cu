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
// Two instances, picked by dtype and D in flash_attention_launch:
//
// * bf16, D in {64, 112, 128, 256} (gemma3's 256, qwen7b's 128, zamba2's
//   112): the tensor-core instance (namespace tc).  A block owns 128
//   query rows of one (b, head) and runs two warpgroups and a warp.  One
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
//   with TMA filling columns 112..127 with zeros: QK^T takes 7 k-steps,
//   PV runs at n = 128 and the epilogue stores 112 columns.  KV tiles
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
  static constexpr int DP = D == 112 ? 128 : D;  // columns laid out in smem
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
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window: 0 = none.
// bf16 at D 64, 112, 128 and 256 runs the tensor-core instance, every
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
