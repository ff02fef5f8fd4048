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
// state at each row's true end.
//
// What bounds it on the card: both, nearly equally.  Per (b, head,
// chunk) the two (Q, Q) products over their causal half, C . state and
// the state update cost Q(Q+1)(N+P) + 4QPN flops, about 21 MFLOP at
// Q 256, P 64, N 128; at mamba2's prefill shape (B 4, S 2048, H 80) that
// is 54 GFLOP, 0.054 ms at 989 TFLOP/s (bf16 tensor cores), against
// 185 MB of x, y, B, C, dt and the final state, 0.055 ms at 3.35 TB/s.
//
// How the design answers that, as a first kernel: it computes on the
// CUDA cores in f32 (for f32 and bf16 inputs alike), so its ceiling is
// the 67 TFLOP/s f32 rate; wgmma is later work.  The Pallas grid walks
// the chunks in sequence with the (P, N) state in VMEM scratch; on the
// card blocks run in parallel and carry nothing, so one block owns one
// (head, b), loops over the chunks itself and keeps the state in shared
// memory.  The (Q, Q) score matrix does not fit beside the f32 B and C
// chunks, so a chunk is cut into tiles of T = 64 rows (16 or 32 for a
// smaller Q): for query tile i and key tile j <= i the block forms
// S = C_i B_j^T, scales it by exp(cum_q - cum_k) dt_k where k <= q and
// sets it to 0 elsewhere (the exponent is never taken above the
// diagonal, where it could overflow), and adds S x_j to the tile's
// output; the carried state's term goes in first.  While it walks the
// last query tile, whose key tiles cover the whole chunk, it also sums
// the state update.  Tiles are staged as f32 in shared memory with rows
// padded by 4 floats; 256 threads form a 16 x 16 grid whose inner loops
// read 16-byte vectors along the reduction axis without bank conflicts,
// as in flash_attention.cu.  x, dt, B and C are read in their model
// layout; the TPU wrapper's transposes are blocking and are not needed.

#include "attn_common.cuh"

namespace {

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

}  // namespace

// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, a and the state
// are float32.  S must be a multiple of chunk, and chunk of 16.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a dtype,
// (head_dim, d_state) pair or chunk the kernel does not take).
extern "C" int ssd_launch(const void* x, const void* dt, const void* a,
                          const void* b_mat, const void* c_mat, void* y,
                          void* final_state, int dtype, int batch, int seq_len,
                          int n_heads, int head_dim, int d_state, int chunk,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk <= 0 || seq_len % chunk) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_dims<float>(head_dim, d_state, x, dt, a, b_mat, c_mat, y,
                              final_state, batch, seq_len, n_heads, chunk, s);
  if (dtype == 1)
    return launch_dims<__nv_bfloat16>(head_dim, d_state, x, dt, a, b_mat,
                                      c_mat, y, final_state, batch, seq_len,
                                      n_heads, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
