// Page gather for Hopper (sm_90a): linearize one sequence's paged KV
// cache, for every layer in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/page_gather.py::page_gather,
// which the JAX package vmaps over the layer dimension
// (repro/serving/kv_manager.py::_gather_pages_leaf).  Function:
// pages (L, NP, H, ps, D) and page_ids (M,) int32 give
// out (L, H, M * ps, D), where out[l, h, m * ps + o] = pages[l, id_m, h, o]
// and id_m is page_ids[m] clamped into [0, NP) (so -1 reads page 0;
// callers slice the output to the valid token count).
//
// What bounds it on the card: memory.  It is a pure copy, so the least
// time is 2 * L * M * H * ps * D * itemsize bytes / 3.35 TB/s (each byte
// read once and written once).
//
// How the design answers that: each (page, head) tile of one layer is
// ps * D contiguous elements at both ends, so one block copies one tile
// (grid M x H x L), its threads striding over the tile in the widest
// unit that the tile size and both pointers allow — 16-byte vectors at
// every shape the engine uses.  The Pallas kernel DMAs the same tiles in
// a sequential (H, M) grid; here all tiles of all layers are in flight
// at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void page_gather_kernel(const V* __restrict__ pages,
                                   const int* __restrict__ page_ids,
                                   V* __restrict__ out, int n_pages,
                                   int heads, int n_ids, long long tile) {
  const int m = blockIdx.x;
  const int h = blockIdx.y;
  const int l = blockIdx.z;
  const int page = min(max(page_ids[m], 0), n_pages - 1);
  const V* src = pages + (((size_t)l * n_pages + page) * heads + h) * tile;
  V* dst = out + (((size_t)l * heads + h) * n_ids + m) * tile;
  for (long long i = threadIdx.x; i < tile; i += blockDim.x) dst[i] = src[i];
}

template <typename V>
void launch(const void* pages, const void* page_ids, void* out, int n_layers,
            int n_pages, int heads, int n_ids, long long tile_bytes,
            cudaStream_t stream) {
  const long long tile = tile_bytes / (long long)sizeof(V);
  long long threads = ((tile + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(n_ids, heads, n_layers);
  page_gather_kernel<V><<<grid, (unsigned)threads, 0, stream>>>(
      static_cast<const V*>(pages), static_cast<const int*>(page_ids),
      static_cast<V*>(out), n_pages, heads, n_ids, tile);
}

}  // namespace

// tile_bytes = ps * D * itemsize.  Returns the cudaError_t of the launch.
extern "C" int page_gather_launch(const void* pages, const void* page_ids,
                                  void* out, int n_layers, int n_pages,
                                  int heads, int n_ids, long long tile_bytes,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_layers <= 0 || heads <= 0 || n_ids <= 0 || n_pages <= 0 ||
      tile_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = reinterpret_cast<uintptr_t>(pages) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(tile_bytes);
  if (align % 16 == 0)
    launch<uint4>(pages, page_ids, out, n_layers, n_pages, heads, n_ids,
                  tile_bytes, s);
  else if (align % 8 == 0)
    launch<uint2>(pages, page_ids, out, n_layers, n_pages, heads, n_ids,
                  tile_bytes, s);
  else if (align % 4 == 0)
    launch<unsigned int>(pages, page_ids, out, n_layers, n_pages, heads,
                         n_ids, tile_bytes, s);
  else if (align % 2 == 0)
    launch<unsigned short>(pages, page_ids, out, n_layers, n_pages, heads,
                           n_ids, tile_bytes, s);
  else
    launch<unsigned char>(pages, page_ids, out, n_layers, n_pages, heads,
                          n_ids, tile_bytes, s);
  return static_cast<int>(cudaGetLastError());
}
