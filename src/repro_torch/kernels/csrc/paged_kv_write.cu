// Paged KV write for Hopper (sm_90a): a chunk's new K and V tokens into
// the page pools of one layer, both pools in one launch.
//
// Replaces no Pallas kernel.  The JAX package writes a chunk's K/V with
// one scatter whose out-of-bounds indices are dropped
// (repro/models/attention.py::update_paged_cache, mode="drop"): frozen
// lanes and unallocated pages aim past the pool and write nothing.
// PyTorch has no scatter that drops, so the port's plain version
// (repro_torch/kernels/ref.py::paged_kv_write_ref) filters the lanes on
// the host with nonzero(), which syncs the host with the card and gives
// a shape known only after the sync: neither can be captured in a CUDA
// graph.  This kernel reads the page table, the starts and the lengths
// on the card and decides each lane there.
//
// Function: k_new, v_new (B, H, C, D) with any strides on B, H and C
// (D contiguous); page_table (B, MP), start (B,), lens (B,) int32; pools
// (NP, H, ps, D).  Every lane (b, c) with c < lens[b] writes
//   k_pages[page, h, off, :] = k_new[b, h, c, :]  (and V alike)
// for each head h, where p = start[b] + c, page = page_table[b,
// clamp(p / ps, 0, MP - 1)] and off = p % ps, unless page < 0 (not
// allocated).  Other lanes write nothing.
//
// What bounds it on the card: memory, and at the engine's sizes the
// launch.  Each written lane reads and writes H * D elements of K and of
// V: 4 * lanes * H * D * itemsize bytes over 3.35 TB/s, under a
// microsecond for a decode pass.  How the design answers that: one block
// per lane, its threads copying the lane's H head rows of K and V in the
// widest unit that the rows, the strides and the pointers allow (16-byte
// vectors at every shape the engine uses); a lane that writes nothing
// returns after reading three integers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Strides {
  long long b, h, c;  // in units of V
};

template <typename V>
__global__ void paged_kv_write_kernel(const V* __restrict__ k_new,
                                      const V* __restrict__ v_new,
                                      V* __restrict__ k_pages,
                                      V* __restrict__ v_pages,
                                      const int* __restrict__ page_table,
                                      const int* __restrict__ start,
                                      const int* __restrict__ lens, int chunk,
                                      int heads, int page_size, int max_pages,
                                      int n_pages, int row, Strides ks,
                                      Strides vs) {
  const int b = blockIdx.x / chunk;
  const int c = blockIdx.x % chunk;
  if (c >= lens[b]) return;
  const int p = start[b] + c;
  const int logical = min(max(p / page_size, 0), max_pages - 1);
  const int page = page_table[(size_t)b * max_pages + logical];
  if (page < 0 || page >= n_pages) return;
  const int off = p % page_size;
  const V* ksrc = k_new + b * ks.b + c * ks.c;
  const V* vsrc = v_new + b * vs.b + c * vs.c;
  for (int i = threadIdx.x; i < heads * row; i += blockDim.x) {
    const int h = i / row;
    const int d = i % row;
    const size_t dst = (((size_t)page * heads + h) * page_size + off) * row + d;
    k_pages[dst] = ksrc[h * ks.h + d];
    v_pages[dst] = vsrc[h * vs.h + d];
  }
}

template <typename V>
void launch(const void* k_new, const void* v_new, void* k_pages,
            void* v_pages, const int* table, const int* start,
            const int* lens, int batch, int chunk, int heads, int page_size,
            int max_pages, int n_pages, int row_bytes, const long long* kst,
            const long long* vst, cudaStream_t stream) {
  const int row = row_bytes / (int)sizeof(V);
  const Strides ks{kst[0] / (long long)sizeof(V), kst[1] / (long long)sizeof(V),
                   kst[2] / (long long)sizeof(V)};
  const Strides vs{vst[0] / (long long)sizeof(V), vst[1] / (long long)sizeof(V),
                   vst[2] / (long long)sizeof(V)};
  int threads = ((heads * row + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  paged_kv_write_kernel<V><<<batch * chunk, threads, 0, stream>>>(
      static_cast<const V*>(k_new), static_cast<const V*>(v_new),
      static_cast<V*>(k_pages), static_cast<V*>(v_pages), table, start, lens,
      chunk, heads, page_size, max_pages, n_pages, row, ks, vs);
}

}  // namespace

// row_bytes = D * itemsize; the six strides of k_new and v_new (batch,
// head, chunk) are in bytes.  Returns the cudaError_t of the launch.
extern "C" int paged_kv_write_launch(
    const void* k_new, const void* v_new, void* k_pages, void* v_pages,
    const void* page_table, const void* start, const void* lens, int batch,
    int chunk, int heads, int page_size, int max_pages, int n_pages,
    int row_bytes, long long k_sb, long long k_sh, long long k_sc,
    long long v_sb, long long v_sh, long long v_sc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || chunk <= 0 || heads <= 0 || page_size <= 0 ||
      max_pages <= 0 || n_pages <= 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long kst[3] = {k_sb, k_sh, k_sc};
  const long long vst[3] = {v_sb, v_sh, v_sc};
  uintptr_t align = reinterpret_cast<uintptr_t>(k_new) |
                    reinterpret_cast<uintptr_t>(v_new) |
                    reinterpret_cast<uintptr_t>(k_pages) |
                    reinterpret_cast<uintptr_t>(v_pages) |
                    static_cast<uintptr_t>(row_bytes);
  for (int i = 0; i < 3; ++i)
    align |= static_cast<uintptr_t>(kst[i]) | static_cast<uintptr_t>(vst[i]);
  const int* table = static_cast<const int*>(page_table);
  const int* st = static_cast<const int*>(start);
  const int* ln = static_cast<const int*>(lens);
#define PKW_LAUNCH(V)                                                        \
  launch<V>(k_new, v_new, k_pages, v_pages, table, st, ln, batch, chunk,     \
            heads, page_size, max_pages, n_pages, row_bytes, kst, vst, s)
  if (align % 16 == 0)
    PKW_LAUNCH(uint4);
  else if (align % 8 == 0)
    PKW_LAUNCH(uint2);
  else if (align % 4 == 0)
    PKW_LAUNCH(unsigned int);
  else if (align % 2 == 0)
    PKW_LAUNCH(unsigned short);
  else
    PKW_LAUNCH(unsigned char);
#undef PKW_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
