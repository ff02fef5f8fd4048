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
// How the design answers that, as a first kernel: it computes on the
// CUDA cores in f32 (for f32 and bf16 inputs alike), so it is bounded
// by the 67 TFLOP/s f32 rate, not the tensor cores' 989; wgmma is later
// work.  The Pallas grid walks the KV axis in sequence and carries the
// online-softmax state in VMEM between grid steps; on the card blocks
// run in parallel and carry nothing, so one block owns one (b, head,
// 64-query tile) and loops over the KV tiles itself, skipping the tiles
// that lie wholly above the causal diagonal or outside the window.
// Each KV tile is staged once in shared memory (as f32) and reused by
// all 64 queries.  256 threads form a 16 x 16 grid: thread (ty, tx)
// owns query rows 4ty..4ty+3, scores at keys tx + 16j and output
// columns spread over tx, so the inner loops read shared memory as
// 16-byte vectors, without bank conflicts, and do 4-16 FMAs per load.
// Row maxima and sums reduce over the 16 threads of a row group with
// shuffles (they are one half-warp).

#include "attn_common.cuh"

namespace {

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window: 0 = none.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a
// dtype or head_dim the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int b, int hq, int hkv, int seq_len,
                                      int head_dim, int causal, int window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(head_dim, q, k, v, out, b, hq, hkv, seq_len,
                             causal, window, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, out, b, hq, hkv,
                                     seq_len, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
