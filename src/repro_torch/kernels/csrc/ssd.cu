// Mamba-2 chunked SSD (state-space duality) scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py::ssd.  Same
// function: x (B, S, H, P); dt (B, S, H) f32 (post-softplus, 0 on pad
// rows); a (H,) f32 < 0; B and C (B, S, N), one group shared by every
// head; S a multiple of the chunk Q.  Per chunk, with cum the inclusive
// prefix sum of dt * a over the chunk:
//   y_q   = sum_{k <= q} (C_q . B_k) exp(cum_q - cum_k) dt_k x_k
//         + exp(cum_q) C_q . state
//   state = state exp(cum_last) + sum_k dt_k exp(cum_last - cum_k) x_k (x) B_k
// y comes back in x's dtype, the final state (B, H, P, N) in f32.  A pad
// row (dt = 0) leaves the state as it was, so the final state is the
// state at each row's true end.  Any chunk length gives the same
// function (the recurrence is exact); the chunk only orders the sums.
//
// What bounds it on the card: bytes.  The least work is C B^T once per
// (b, chunk) for all heads, and per (b, head, chunk) the causal half of
// (masked S) x, C . state and the state update; at mamba2's prefill shape
// (B 4, S 2048, H 80, P 64, N 128, Q 256) that is 32.5 GFLOP, 0.033 ms at
// 989 TFLOP/s, against 185 MB of x, y, B, C, dt and the final state,
// 0.055 ms at 3.35 TB/s.
//
// Two instances:
//
// * bf16 with (P, N) = (64, 128) (mamba2) or (64, 64) (zamba2) and S a
//   multiple of 64: the tensor-core instance (namespace tc, entry point
//   ssd_tc_launch), two kernels on one stream.
//   1. ssd_cb_kernel: C B^T of each 64-row chunk, once per (b, chunk)
//      for all heads (wgmma m64n64k16, bf16 operands exact), into an f32
//      workspace in the accumulator's own register order, so the second
//      kernel reads it with conflict-free 16-byte loads: B * S * 64 * 4
//      bytes (2 MB at mamba2's shape, read from L2 by every head).
//   2. ssd_tc_kernel: one block per (b, pair of heads), walking the
//      chunks of 64 rows in sequence.  A producer thread streams each
//      chunk's C, B (TMA, 2-D maps over (N, B * S)), x of both heads (3-D map over (P, H, B * S)) and the
//      C B^T tile (a bulk copy) through a 2-stage ring of mbarriers; each
//      of two consumer warpgroups owns one head and keeps its (P, N) state
//      in f32 registers (the accumulator of the update) from the first
//      chunk to the last:
//        y  = exp(cum_q) C . state    wgmma, state staged in shared memory
//           + M x                     wgmma, M from registers
//        state = state exp(cum_last) + (w x)^T B    wgmma, (w x) from
//                                                   registers
//      where M = C B^T exp(cum_q - cum_k) dt_k below the diagonal and 0
//      above it (the exponent is never taken there: it could overflow,
//      and inf * 0 is NaN), w_k = dt_k exp(cum_last - cum_k).
//   Precision: C, B and x are bf16 and go into wgmma as they are.  The
//   f32 operands (M, w x and the state) are cut into hi + lo, two bf16
//   halves, and each product runs twice (hi, then lo, into the same f32
//   accumulator), which holds them to 2^-17 of their size (tf32 would
//   give 2^-11 and bf16 alone 2^-9, too coarse for y near 0 against
//   rtol = atol = 2e-2).  The state itself stays f32 throughout.
//   The chunk is 64 rows whatever Q the caller names: it is the wgmma
//   tile, and it does less quadratic work than 256 rows (the state terms,
//   linear in the chunk count, cost no more than the (Q, Q) product they
//   replace).  The cost of the workspace: 2 MB written and 2 MB read per
//   head pair from L2; the chunks' states never leave the block.
//   Shared memory at N 128: 2 stages of C, B (16 KB each), x (2 x 8 KB)
//   and C B^T (16 KB), and each head's staged state (hi and lo, 16 KB
//   each): 194 KB; registers: the state is N / 2 floats a thread.
//   What bounds it now: each chunk's products wait for the previous
//   chunk's state (C . state) and for each other within a warpgroup;
//   160 blocks for 132 SMs at mamba2's shape (one head per block, 320
//   blocks of 160 threads, was slower); registers: the 288-thread block
//   is budgeted as three warpgroups (168 a thread, see
//   flash_attention.cu), which the N 128 instance fills.
//
// * f32 (any shape), and bf16 at every other (P, N) or chunk (the smoke
//   and test shapes): the CUDA-core instance of the first port (namespace
//   fma, entry point ssd_launch), unchanged.  One block owns one (head,
//   b), loops over the chunks with the state in shared memory, cuts a
//   chunk into tiles of 64 rows (16 or 32 for a smaller Q) and computes
//   on the CUDA cores in f32 from tiles staged as f32 in shared memory
//   (rows padded by 4 floats, a 16 x 16 thread grid reading 16-byte
//   vectors along the reduction axis).  Its f32 products are what the
//   2e-3 tests and the f32 parity runs rely on; x, dt, B and C are read
//   in their model layout.

#include "attn_common.cuh"
#include "hopper.cuh"

namespace {
namespace fma {

using attn::store_elem;
using attn::word_to_float;

constexpr int kThreads = 256;  // 16 (ty) x 16 (tx)

template <int T_, int P_, int N_>
struct Shape {
  static constexpr int T = T_;               // rows of a query or key tile
  static constexpr int RM = T / 16;          // tile rows per thread
  static constexpr int PC = (P_ + 15) / 16;  // x columns (and state rows) per thread
  static constexpr int NC = N_ / 16;         // state columns per thread
  static constexpr int P16 = 16 * PC;        // P padded to the thread grid
  static constexpr int LN = N_ + 4;          // row stride of C, B, state (floats)
  static constexpr int LT = T + 4;           // row stride of S and x^T (floats)
  // C_i, B_j, state, x_j^T, S; then cum, dt and w of the chunk (3 Q)
  static constexpr int kFixedFloats = 2 * T * LN + P16 * LN + P16 * LT + T * LT;
};

// acc[i][j] += sum_k A[(ty R + i) lda + k] * Bm[(tx + 16 j) ldb + k],
// four k at a time as 16-byte shared-memory loads.
template <int R, int C, int K, int LDA, int LDB>
__device__ __forceinline__ void mm_rows(float (&acc)[R][C],
                                        const float* __restrict__ A,
                                        const float* __restrict__ Bm, int ty,
                                        int tx) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[R], bv[C];
#pragma unroll
    for (int i = 0; i < R; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty * R + i) * LDA + k);
#pragma unroll
    for (int j = 0; j < C; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LDB + k);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// `rows` rows of n elements of T starting at src (a row every n
// elements) into f32 shared memory with row stride ld.
template <typename T, int n, int ld>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  for (int e = threadIdx.x * kVec; e < rows * n; e += kThreads * kVec) {
    const int r = e / n;
    const int c = e % n;
    float f[kVec];
    word_to_float<T>(__ldg(reinterpret_cast<const uint4*>(src + e)), f);
#pragma unroll
    for (int i = 0; i < kVec; i += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
}

template <typename Tp, int T, int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_kernel(const Tp* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const Tp* __restrict__ bm,
           const Tp* __restrict__ cm, Tp* __restrict__ y,
           float* __restrict__ state_out, int S, int H, int Q) {
  using Sh = Shape<T, P, N>;
  constexpr int RM = Sh::RM, PC = Sh::PC, NC = Sh::NC, P16 = Sh::P16;
  constexpr int LN = Sh::LN, LT = Sh::LT;
  constexpr int kVec = 16 / sizeof(Tp);
  static_assert(T % 16 == 0 && N % 16 == 0, "tile and d_state split 16 ways");
  static_assert(P % kVec == 0 && N % kVec == 0,
                "head_dim and d_state must be whole 16-byte words");

  extern __shared__ float4 smem_raw[];
  float* Cs = reinterpret_cast<float*>(smem_raw);  // T x LN: C of query tile
  float* Bs = Cs + T * LN;                         // T x LN: B of key tile
  float* st = Bs + T * LN;                         // P16 x LN: state (p, n)
  float* xT = st + P16 * LN;                       // P16 x LT: x of key tile, (p, k)
  float* Ss = xT + P16 * LT;                       // T x LT: masked scores
  float* cum = Ss + T * LT;                        // Q: prefix sum of dt a
  float* dts = cum + Q;                            // Q: dt
  float* wts = dts + Q;                            // Q: dt exp(cum_last - cum)

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float ah = a[h];
  // rows p >= P of the state and of x^T stay zero: no staging writes them
  for (int e = threadIdx.x; e < P16 * LN; e += kThreads) st[e] = 0.f;
  for (int e = threadIdx.x; e < P16 * LT; e += kThreads) xT[e] = 0.f;

  const int n_tiles = Q / T;
  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with cum, dts, wts
    for (int k = threadIdx.x; k < Q; k += kThreads) {
      const float d = dt[((size_t)b * S + s0 + k) * H + h];
      dts[k] = d;
      cum[k] = d * ah;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // inclusive scan of cum: a run per lane, then lanes
      const int lane = threadIdx.x;
      const int per = (Q + 31) / 32;
      const int lo = min(Q, lane * per);
      const int hi = min(Q, lo + per);
      float run = 0.f;
      for (int k = lo; k < hi; ++k) {
        run += cum[k];
        cum[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const float off = incl - run;
      for (int k = lo; k < hi; ++k) cum[k] += off;
    }
    __syncthreads();
    const float c_last = cum[Q - 1];
    for (int k = threadIdx.x; k < Q; k += kThreads)
      wts[k] = dts[k] * expf(c_last - cum[k]);

    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * T;
      const bool last = it == n_tiles - 1;
      __syncthreads();  // Cs of the previous tile consumed; wts written
      stage_rows<Tp, N, LN>(cm + ((size_t)b * S + s0 + q0) * N, Cs, T);
      __syncthreads();

      // the carried state's term: exp(cum_q) C_q . state
      float acc[RM][PC];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] = 0.f;
      mm_rows<RM, PC, N, LN, LN>(acc, Cs, st, ty, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float e = expf(cum[q0 + ty * RM + i]);
#pragma unroll
        for (int j = 0; j < PC; ++j) acc[i][j] *= e;
      }

      float upd[PC][NC];  // the state update, summed over the last tile's keys
#pragma unroll
      for (int i = 0; i < PC; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) upd[i][j] = 0.f;

      for (int jt = 0; jt <= it; ++jt) {
        const int k0 = jt * T;
        __syncthreads();  // Bs, xT and Ss of the previous key tile consumed
        stage_rows<Tp, N, LN>(bm + ((size_t)b * S + s0 + k0) * N, Bs, T);
        for (int e = threadIdx.x * kVec; e < T * P; e += kThreads * kVec) {
          const int k = e / P;
          const int p = e % P;
          float f[kVec];
          word_to_float<Tp>(__ldg(reinterpret_cast<const uint4*>(
                                x + (((size_t)b * S + s0 + k0 + k) * H + h) * P +
                                p)),
                            f);
#pragma unroll
          for (int u = 0; u < kVec; ++u) xT[(p + u) * LT + k] = f[u];
        }
        __syncthreads();

        // S = C_i B_j^T, decayed, dt-weighted and causally masked
        float sc[RM][RM];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RM; ++j) sc[i][j] = 0.f;
        mm_rows<RM, RM, N, LN, LN>(sc, Cs, Bs, ty, tx);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int q = q0 + ty * RM + i;
          const float cq = cum[q];
#pragma unroll
          for (int j = 0; j < RM; ++j) {
            const int k = k0 + tx + 16 * j;
            Ss[(ty * RM + i) * LT + tx + 16 * j] =
                k <= q ? sc[i][j] * expf(cq - cum[k]) * dts[k] : 0.f;
          }
        }
        __syncthreads();
        mm_rows<RM, PC, T, LT, LT>(acc, Ss, xT, ty, tx);

        if (last) {
          // upd[p][n] += sum_k x_k[p] w_k B_k[n], rows p = ty PC + i
#pragma unroll 2
          for (int k = 0; k < T; k += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wts + k0 + k);
            float4 xv[PC];
#pragma unroll
            for (int i = 0; i < PC; ++i) {
              xv[i] = *reinterpret_cast<const float4*>(xT + (ty * PC + i) * LT + k);
              xv[i].x *= w4.x;
              xv[i].y *= w4.y;
              xv[i].z *= w4.z;
              xv[i].w *= w4.w;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int j = 0; j < NC; ++j) {
                const float bv = Bs[(k + u) * LN + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < PC; ++i) {
                  const float xw = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                                 : u == 2 ? xv[i].z : xv[i].w;
                  upd[i][j] = fmaf(xw, bv, upd[i][j]);
                }
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < RM; ++i) {
        Tp* yrow = y + (((size_t)b * S + s0 + q0 + ty * RM + i) * H + h) * P;
#pragma unroll
        for (int j = 0; j < PC; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store_elem(yrow + p, acc[i][j]);
        }
      }
      if (last) {
        // every thread read the old state before the key loop's first
        // barrier, so each may now overwrite its own entries
        const float decay = expf(c_last);
#pragma unroll
        for (int i = 0; i < PC; ++i) {
          const int p = ty * PC + i;
          if (p >= P) continue;
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            float* sp = st + p * LN + tx + 16 * j;
            *sp = fmaf(*sp, decay, upd[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int e = threadIdx.x; e < P * N; e += kThreads)
    so[e] = st[(e / N) * LN + e % N];
}

template <typename Tp, int T, int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int b, int S, int H, int Q,
           cudaStream_t stream) {
  auto kernel = ssd_kernel<Tp, T, P, N>;
  const int smem = (Shape<T, P, N>::kFixedFloats + 3 * Q) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, b), kThreads, smem, stream>>>(
      static_cast<const Tp*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const Tp*>(bm),
      static_cast<const Tp*>(cm), static_cast<Tp*>(y),
      static_cast<float*>(state), S, H, Q);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tp, int P, int N>
int launch_tile(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, void* y, void* state, int b, int S, int H,
                int Q, cudaStream_t stream) {
  if (Q % 64 == 0)
    return launch<Tp, 64, P, N>(x, dt, a, bm, cm, y, state, b, S, H, Q, stream);
  if (Q % 32 == 0)
    return launch<Tp, 32, P, N>(x, dt, a, bm, cm, y, state, b, S, H, Q, stream);
  if (Q % 16 == 0)
    return launch<Tp, 16, P, N>(x, dt, a, bm, cm, y, state, b, S, H, Q, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename Tp>
int launch_dims(int P, int N, const void* x, const void* dt, const void* a,
                const void* bm, const void* cm, void* y, void* state, int b,
                int S, int H, int Q, cudaStream_t stream) {
#define SSD_CASE(P_, N_)                                                   \
  if (P == P_ && N == N_)                                                  \
    return launch_tile<Tp, P_, N_>(x, dt, a, bm, cm, y, state, b, S, H, Q, \
                                   stream);
  SSD_CASE(64, 128)  // mamba2-2.7b
  SSD_CASE(64, 64)   // zamba2-7b
  SSD_CASE(8, 16)    // the smoke configs
  SSD_CASE(16, 32)   // the shapes of the kernel tests
  SSD_CASE(32, 64)
#undef SSD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace fma

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;        // rows of a chunk (the wgmma tile)
constexpr int kP = 64;        // head_dim
constexpr int kStages = 2;
constexpr int kBlock = 64 * 128;         // bytes of a 64 x 64 bf16 block
constexpr int kCBBytes = kT * kT * 4;    // one chunk's C B^T, f32

// ---- 1. C B^T of every (b, chunk) ----------------------------------------

template <int N>
__global__ void __launch_bounds__(128)
ssd_cb_kernel(const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap bmap,
              float4* __restrict__ cb, int S) {
  constexpr int kTile = N / 64 * kBlock;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Cs = base;
  uint8_t* Bs = base + kTile;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 2 * kTile);
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int row = b * S + c * kT;
  if (tid == 0) {
    hk::mbar_init(bar, 1);
    hk::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    hk::mbar_expect_tx(bar, 2 * kTile);
    for (int j = 0; j < N / 64; ++j) {
      hk::tma_load_2d(Cs + j * kBlock, &cmap, bar, 64 * j, row);
      hk::tma_load_2d(Bs + j * kBlock, &bmap, bar, 64 * j, row);
    }
  }
  hk::mbar_wait(bar, 0);
  float acc[32];
  hk::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int off = (kk / 4) * kBlock + (kk % 4) * 32;
    hk::Wgmma<64>::ss(acc, hk::desc_sw128(Cs + off, 16, 1024),
                      hk::desc_sw128(Bs + off, 16, 1024), kk > 0);
  }
  hk::wgmma_commit();
  hk::wgmma_wait<0>();
  hk::fence_regs(acc);
  // register order: float4 j of thread t at (j * 128 + t)
  float4* dst = cb + ((size_t)(b * gridDim.x + c) * 8) * 128;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    dst[j * 128 + tid] = make_float4(acc[4 * j], acc[4 * j + 1],
                                     acc[4 * j + 2], acc[4 * j + 3]);
}

// ---- 2. the scan ----------------------------------------------------------

template <int N>
struct Shape {
  static constexpr int kTile = N / 64 * kBlock;  // C, B or a staged state
  // C, B, x of two heads, C B^T
  static constexpr int kStage = 2 * kTile + 2 * kBlock + kCBBytes;
  static constexpr int kStateOffset = kStages * kStage;  // [wg][hi, lo]
  static constexpr int kScalarOffset = kStateOffset + 4 * kTile;
  // per warpgroup: cum, dt (64 floats each) and a scan carry
  static constexpr int kBarOffset = kScalarOffset + 2 * (2 * kT + 4) * 4;
  static constexpr int kSmemBytes = kBarOffset + 8 * 2 * kStages + 1024;
};

template <int N>
__global__ void __launch_bounds__(288, 1)
ssd_tc_kernel(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap cmap,
              const __grid_constant__ CUtensorMap bmap,
              const float* __restrict__ cb, const float* __restrict__ dt,
              const float* __restrict__ a, bf16* __restrict__ y,
              float* __restrict__ state_out, int S, int H) {
  using Sh = Shape<N>;
  constexpr int kTile = Sh::kTile;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Sh::kBarOffset);
  uint64_t* empty = full + kStages;
  const int b = blockIdx.y;
  const int nc = S / kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hk::mbar_init(full + s, 1);
      hk::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    hk::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer warp ----
    if (threadIdx.x == 256) {
      const int n_heads = min(2, H - 2 * (int)blockIdx.x);
      const uint32_t bytes = 2 * kTile + n_heads * kBlock + kCBBytes;
      int stage = 0;
      uint32_t phase = 0;
      for (int c = 0; c < nc; ++c) {
        hk::mbar_wait(empty + stage, phase ^ 1);
        uint8_t* st = base + stage * Sh::kStage;
        uint64_t* bar = full + stage;
        const int row = b * S + c * kT;
        hk::mbar_expect_tx(bar, bytes);
        for (int j = 0; j < N / 64; ++j) {
          hk::tma_load_2d(st + j * kBlock, &cmap, bar, 64 * j, row);
          hk::tma_load_2d(st + kTile + j * kBlock, &bmap, bar, 64 * j, row);
        }
        for (int w = 0; w < n_heads; ++w)
          hk::tma_load_3d(st + 2 * kTile + w * kBlock, &xmap, bar, 0,
                          2 * blockIdx.x + w, row);
        hk::bulk_load(st + 2 * kTile + 2 * kBlock,
                      cb + (size_t)(b * nc + c) * kT * kT, kCBBytes, bar);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns head h ----
  const int h = 2 * blockIdx.x + wg;
  const bool active = h < H;
  const int tid = threadIdx.x % 128;
  const int lane = tid & 31, warp = tid >> 5;
  const int bar_id = 1 + wg;  // named barrier of this warpgroup
  uint8_t* st_hi = base + Sh::kStateOffset + wg * 2 * kTile;
  uint8_t* st_lo = st_hi + kTile;
  float* cum = reinterpret_cast<float*>(base + Sh::kScalarOffset) +
               wg * (2 * kT + 4);
  float* dts = cum + kT;
  float* carry = dts + kT;
  const float ah = active ? a[h] : 0.f;

  float sacc[N / 2];  // the (P, N) state: rows p, columns n
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sacc[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (int c = 0; c < nc; ++c) {
    const uint8_t* st = base + stage * Sh::kStage;
    const uint8_t* Cs = st;
    const uint8_t* Bs = st + kTile;
    const uint8_t* Xs = st + 2 * kTile + wg * kBlock;
    const float4* CBs = reinterpret_cast<const float4*>(st + 2 * kTile +
                                                        2 * kBlock);
    const int row = b * S + c * kT;
    if (active) {
      // dt of the chunk and the inclusive prefix sum of dt * a
      float d = 0.f, v = 0.f;
      if (tid < kT) {
        d = dt[(size_t)(row + tid) * H + h];
        v = d * ah;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        if (tid == 31) carry[0] = v;
      }
      hk::named_sync(bar_id, 128);
      if (tid < kT) {
        cum[tid] = tid >= 32 ? v + carry[0] : v;
        dts[tid] = d;
      }
      hk::named_sync(bar_id, 128);
    }
    hk::mbar_wait(full + stage, phase);

    if (active) {
      const float c_last = cum[kT - 1];
      // y = exp(cum_q) C . state, the state staged as hi + lo (chunk > 0)
      float yacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
      if (c > 0) {
        hk::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const int off = (kk / 4) * kBlock + (kk % 4) * 32;
          const uint64_t dc = hk::desc_sw128(Cs + off, 16, 1024);
          hk::Wgmma<64>::ss(yacc, dc, hk::desc_sw128(st_hi + off, 16, 1024), 1);
          hk::Wgmma<64>::ss(yacc, dc, hk::desc_sw128(st_lo + off, 16, 1024), 1);
        }
        hk::wgmma_commit();
      }
      // meanwhile M = C B^T exp(cum_q - cum_k) dt_k (k <= q) as A fragments
      uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 f = CBs[j * 128 + tid];
        const float cbv[4] = {f.x, f.y, f.z, f.w};
        float mv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int q = hk::acc_row(tid, i), k = hk::acc_col(tid, i);
          mv[e] = k <= q ? cbv[e] * __expf(cum[q] - cum[k]) * dts[k] : 0.f;
        }
        // registers 4j, 4j+1 are row r0, 4j+2, 4j+3 row r0 + 8
        const int kk = j / 2, r = (j % 2) * 2;
        hk::split_bf16(mv[0], mv[1], mhi[kk][r], mlo[kk][r]);
        hk::split_bf16(mv[2], mv[3], mhi[kk][r + 1], mlo[kk][r + 1]);
      }
      const float e0 = __expf(cum[hk::acc_row(tid, 0)]);
      const float e1 = __expf(cum[hk::acc_row(tid, 2)]);
      if (c > 0) {
        hk::wgmma_wait<0>();
        hk::fence_regs(yacc);
#pragma unroll
        for (int i = 0; i < 32; ++i) yacc[i] *= ((i >> 1) & 1) ? e1 : e0;
      }
      // y += M x, x MN-major (P contiguous)
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hk::desc_sw128(Xs + kk * 2048, kBlock, 1024);
        hk::Wgmma<64>::rs_mn(yacc, mhi[kk], dx, 1);
        hk::Wgmma<64>::rs_mn(yacc, mlo[kk], dx, 1);
      }
      hk::wgmma_commit();
      hk::wgmma_wait<0>();
      hk::fence_regs(yacc);
      bf16* yb = y + ((size_t)row * H + h) * kP;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int q = hk::acc_row(tid, i), p = hk::acc_col(tid, i);
        *reinterpret_cast<uint32_t*>(yb + (size_t)q * H * kP + p) =
            hk::pack_bf16(yacc[i], yacc[i + 1]);
      }

      // (w x)^T as A fragments: row p, column k, w_k = dt_k exp(cum_last -
      // cum_k); built once M and y are dead, which keeps the N 128
      // instance within its 168 registers (built beside the M x product,
      // ptxas spilled 232 bytes a thread)
      uint32_t whi[4][4], wlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = 16 * warp + (lane >> 2) + 8 * (r & 1);
          const int k = 16 * kk + 2 * (lane & 3) + 8 * (r >> 1);
          const float x0 = __bfloat162float(*reinterpret_cast<const bf16*>(
              Xs + hk::sw128_offset(k, p, kT)));
          const float x1 = __bfloat162float(*reinterpret_cast<const bf16*>(
              Xs + hk::sw128_offset(k + 1, p, kT)));
          hk::split_bf16(x0 * dts[k] * __expf(c_last - cum[k]),
                         x1 * dts[k + 1] * __expf(c_last - cum[k + 1]),
                         whi[kk][r], wlo[kk][r]);
        }
      // state = state exp(cum_last) + (w x)^T B, B MN-major (N contiguous)
      const float decay = __expf(c_last);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sacc[i] *= decay;
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = hk::desc_sw128(Bs + kk * 2048, kBlock, 1024);
        hk::Wgmma<N>::rs_mn(sacc, whi[kk], db, 1);
        hk::Wgmma<N>::rs_mn(sacc, wlo[kk], db, 1);
      }
      hk::wgmma_commit();
      hk::wgmma_wait<0>();
      hk::fence_regs(sacc);
    }
    __syncwarp();
    if (lane == 0) hk::mbar_arrive(empty + stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
    if (active && c + 1 < nc) {
      // stage the state for the next chunk's C . state: hi + lo, K-major
#pragma unroll
      for (int i = 0; i < N / 2; i += 2) {
        const uint32_t off =
            hk::sw128_offset(hk::acc_row(tid, i), hk::acc_col(tid, i), kP);
        uint32_t hi, lo;
        hk::split_bf16(sacc[i], sacc[i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(st_hi + off) = hi;
        *reinterpret_cast<uint32_t*>(st_lo + off) = lo;
      }
      hk::fence_proxy_async();
      hk::named_sync(bar_id, 128);
    }
  }
  if (active) {
    float* so = state_out + ((size_t)b * H + h) * kP * N;
#pragma unroll
    for (int i = 0; i < N / 2; i += 2)
      *reinterpret_cast<float2*>(so + hk::acc_row(tid, i) * N +
                                 hk::acc_col(tid, i)) =
          make_float2(sacc[i], sacc[i + 1]);
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, void* ws, int b, int S,
           int H, cudaStream_t stream) {
  CUtensorMap xm, cmap, bmap;
  const uint64_t dx[3] = {(uint64_t)kP, (uint64_t)H, (uint64_t)b * S};
  const uint64_t sx[2] = {(uint64_t)kP * 2, (uint64_t)H * kP * 2};
  const uint32_t bx[3] = {64, 1, kT};
  const uint64_t dbc[2] = {(uint64_t)N, (uint64_t)b * S};
  const uint64_t sbc[1] = {(uint64_t)N * 2};
  const uint32_t bbc[2] = {64, kT};
  if (!hk_host::tmap_bf16(&xm, x, 3, dx, sx, bx) ||
      !hk_host::tmap_bf16(&cmap, cm, 2, dbc, sbc, bbc) ||
      !hk_host::tmap_bf16(&bmap, bm, 2, dbc, sbc, bbc))
    return static_cast<int>(cudaErrorInvalidValue);

  auto k1 = ssd_cb_kernel<N>;
  const int smem1 = 2 * (N / 64) * kBlock + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<dim3(S / kT, b), 128, smem1, stream>>>(cmap, bmap,
                                              static_cast<float4*>(ws), S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto k2 = ssd_tc_kernel<N>;
  const int smem2 = Shape<N>::kSmemBytes;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem2);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3((H + 1) / 2, b), 288, smem2, stream>>>(
      xm, cmap, bmap, static_cast<const float*>(ws),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<bf16*>(y), static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// The CUDA-core instance, for either dtype and every (head_dim, d_state)
// of the DIMS table.  dtype of x, B, C and y: 0 = float32, 1 = bfloat16;
// dt, a and the state are float32.  S must be a multiple of chunk, and
// chunk of 16.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a dtype, (head_dim, d_state) pair or chunk
// the kernel does not take).
extern "C" int ssd_launch(const void* x, const void* dt, const void* a,
                          const void* b_mat, const void* c_mat, void* y,
                          void* final_state, int dtype, int batch, int seq_len,
                          int n_heads, int head_dim, int d_state, int chunk,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || seq_len % chunk) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return fma::launch_dims<float>(head_dim, d_state, x, dt, a, b_mat, c_mat,
                                   y, final_state, batch, seq_len, n_heads,
                                   chunk, s);
  if (dtype == 1)
    return fma::launch_dims<__nv_bfloat16>(head_dim, d_state, x, dt, a, b_mat,
                                           c_mat, y, final_state, batch,
                                           seq_len, n_heads, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core instance: bf16 x, B, C and y, head_dim 64, d_state 128
// or 64, S a multiple of 64 (the chunk the caller names does not change
// the function).  `workspace` holds batch * seq_len * 64 floats (C B^T of
// every 64-row chunk).  Launches two kernels on `stream`; returns the
// first cudaError_t (cudaErrorInvalidValue for a shape it does not take).
extern "C" int ssd_tc_launch(const void* x, const void* dt, const void* a,
                             const void* b_mat, const void* c_mat, void* y,
                             void* final_state, void* workspace, int batch,
                             int seq_len, int n_heads, int head_dim,
                             int d_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != tc::kP || seq_len % tc::kT)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_state == 128)
    return tc::launch<128>(x, dt, a, b_mat, c_mat, y, final_state, workspace,
                           batch, seq_len, n_heads, s);
  if (d_state == 64)
    return tc::launch<64>(x, dt, a, b_mat, c_mat, y, final_state, workspace,
                          batch, seq_len, n_heads, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
