// gather.cu — gathers along axis 0 and axis 1, for Hopper (sm_90a).
//
// Replaces the two TPU probe kernels of tools/exp_gather.py:
//   gather_axis0_kernel (:18): out[s, l] = x[idx[s, l], l]
//   gather_axis1_kernel (:22): out[s, l] = x[s, idx[s, l]]
// (both launched by `build`, pl.pallas_call at :27), i.e. numpy's
// take_along_axis for f32 x (S, L) and i32 idx (S, L), row-major.
//
// What bounds them on the H100: bytes. Each output element reads one index
// (4 B) and one value (4 B) and writes one value (4 B), with no arithmetic:
// 12 B per element, 12.6 MB at (1024, 1024), 3.76 us at 3.35 TB/s.
//
// gather_axis0: read one element per thread straight from x, a warp's 32
// lanes would read 32 random rows at neighbouring columns, 32 sectors for
// 128 useful bytes, and the kernel would be bound by L2 sector traffic. So a
// block owns a column tile of W = 32 columns and stages the whole tile
// x[0:S, c0:c0+32] in shared memory, row stride 32 floats: element (j, lane)
// lies in bank `lane` for every j, and a warp whose lanes are the tile's 32
// columns reads tile[idx[s, c0+lane]][lane] free of bank conflicts for any
// indices. Its output rows' indices, idx[s0:s1, c0:c0+32], are staged beside
// the tile in groups of up to 256 rows, so that no register array and no
// unrolled loop has to keep loads in flight (the time of a launch grew with
// such a body, by microseconds at the small probe sizes: PERF.md). Tile and
// indices arrive by TMA (2-D boxes of at most 256 rows x 32 columns over
// tensor maps of x and idx, completion on one mbarrier) where the shape
// allows it: row pitches that are a multiple of 16 bytes (L % 4 == 0) and
// 16-byte aligned x and idx. Otherwise every thread copies its share with
// 4-byte cp.async (a warp copies one 128-byte row segment). Then each thread
// walks the group's elements, a warp one row at a time: a shared-memory read
// of the index, one of the tile, and a store that is coalesced across the
// warp.
// A column tile's rows are split over `splits` blocks so that ~128 blocks,
// one per SM, fill the card; each stages the tile itself. (A thread-block
// cluster sharing one TMA multicast of the tile measured slower: PERF.md.)
// S beyond what a block may hold (1536 rows = 192 KB beside the indices) is
// staged in chunks, one pass each; in a pass an output element takes its
// value only if its index falls inside the chunk, so it is written once.
// The plan (W, the chunking, splits) is `plan_axis0` below. Its mbarrier
// wait traps after a second, so a fault fails the launch instead of hanging.
//
// gather_axis1: a block owns a tile of whole rows (or of one row's columns
// where L > 1024) and each of its 256 threads gathers 4 elements with every
// load in flight at once: where L % 4 == 0 and the arrays are 16-byte
// aligned, 4 neighbouring indices in one 16-byte load, the 4 values from the
// row (independent loads) and one 16-byte store; otherwise 4 elements 256
// apart, each load and store coalesced across the warp. A 1024-row array is
// 1024 blocks, all resident at once (8 a SM), so the launch is one wave of
// two dependent trips to memory (index, then value), not the four waves of a
// thread per element. The value loads go through the SM's L1 (ld.global.nc),
// which can serve a block's repeated touches of its 4 KB row; the stores are
// marked streaming (st.global.cs), which measured faster cold. Staging rows in shared memory by
// bulk async copies through a ring of stages was built and measured slower
// at every shape (PERF.md): the wider threads are what win. The plan (rows
// and columns of a tile, the grid) is `plan_axis1` below; small arrays take
// fewer rows or columns to a tile, so that their loads spread over the SMs.
//
// Each plan is computed by its C entry point; the card tests check that it
// covers every output by launching into an output filled with NaN. An index
// must lie in [0, n). The wrapper checks that on the host when
// asked; the kernels clamp, so a bad index never reads outside x.
#include <cuda.h>           // CUtensorMap and its enums (a header: no libcuda link)
#include <cudaTypedefs.h>   // PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kW = 32;               // columns of a tile: a warp's lanes
constexpr int kRowBytes = kW * 4;
constexpr int kBoxRows = 256;        // TMA's largest box dimension
constexpr int kGroupRows = kBoxRows; // output rows whose indices are staged at once
constexpr int kChunkRows = 6 * kBoxRows;   // 192 KB of x, 32 KB of indices:
constexpr int kBarBytes = 16;              // of the 227 KB a block may use
constexpr int kMaxSmem = (kChunkRows + kGroupRows) * kRowBytes + kBarBytes;
constexpr int kMinRows = 64;         // output rows a block gets at least
constexpr int kTargetBlocks = 128;   // blocks to aim for: ~one per SM of the 132
constexpr int kTileThreads = 512;    // threads of a block (256 and 1024: slower)

__device__ __forceinline__ int clamp_index(int j, int n) {
  return j < 0 ? 0 : (j >= n ? n - 1 : j);
}

// ---- gather_axis0 ------------------------------------------------------------

struct Plan {
  int tiles;        // column tiles, ceil(L / 32)
  int box_rows;     // rows of one TMA box of x
  int chunk_rows;   // rows of x staged per pass
  int chunks;       // passes over x's rows
  int splits;       // blocks per column tile (gridDim.x)
  int group_rows;   // output rows whose indices are staged at once
  int smem_bytes;   // dynamic shared memory per block
  int tma;          // 1: TMA loads, 0: cp.async loads
};

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

Plan plan_axis0(int S, int L, bool tma) {
  Plan p;
  p.tiles = cdiv(L, kW);
  if (S <= kChunkRows) {
    const int boxes = cdiv(S, kBoxRows);
    p.box_rows = cdiv(S, boxes);
    p.chunk_rows = boxes * p.box_rows;
    p.chunks = 1;
  } else {
    p.box_rows = kBoxRows;
    p.chunk_rows = kChunkRows;
    p.chunks = cdiv(S, kChunkRows);
  }
  int splits = cdiv(kTargetBlocks, p.tiles);
  if (splits > S / kMinRows) splits = S / kMinRows;
  p.splits = splits < 1 ? 1 : splits;
  p.group_rows = S < kGroupRows ? S : kGroupRows;
  p.smem_bytes = (p.chunk_rows + p.group_rows) * kRowBytes + kBarBytes;
  p.tma = tma ? 1 : 0;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the barrier's phase of parity `parity` to complete. A copy that
// has not landed after a second is a fault: the kernel traps (the launch
// then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 1000000000ull) __trap();
  }
}

// One 2-D TMA box (columns from c, rows from r) of `map` into shared memory
// at `dst`, completing on the barrier at `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c,
                                        int r, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// rows x 32 four-byte elements of a row-major (., L) array, from row r0 and
// column c0, into shared memory at `dst` (row stride 32), by every thread
// with cp.async; columns beyond L are filled with zeros.
__device__ __forceinline__ void cp_async_rows(uint32_t dst, const void* src, int r0,
                                              int rows, int c0, int L) {
  for (int e = threadIdx.x; e < rows * kW; e += kTileThreads) {
    const int c = c0 + (e & (kW - 1));
    const char* from = static_cast<const char*>(src) +
                       4 * ((long long)(r0 + (e >> 5)) * L + (c < L ? c : L - 1));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst + 4u * e), "l"(from), "r"(c < L ? 4 : 0) : "memory");
  }
}

template <bool kTma>
__global__ void __launch_bounds__(kTileThreads, 1)
gather_axis0_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap imap,
                         const float* __restrict__ x, const int* __restrict__ idx,
                         float* __restrict__ out, int S, int L, Plan p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* tile = reinterpret_cast<const float*>(smem);
  const int* ids = reinterpret_cast<const int*>(smem + p.chunk_rows * kRowBytes);
  const uint32_t tile_a = smem_u32(smem);
  const uint32_t ids_a = tile_a + p.chunk_rows * kRowBytes;
  const uint32_t bar_a = ids_a + p.group_rows * kRowBytes;
  const int s0 = (int)((long long)blockIdx.x * S / p.splits);
  const int s1 = (int)((long long)(blockIdx.x + 1) * S / p.splits);
  const int lane = threadIdx.x & (kW - 1);
  if (kTma && threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&imap)) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barrier is set up before any copy may signal it

  uint32_t phase = 0;
  for (int ct = blockIdx.y; ct < p.tiles; ct += gridDim.y) {
    const int c0 = ct * kW;
    const bool col_ok = c0 + lane < L;
    for (int g0 = s0; g0 < s1; g0 += p.group_rows) {
      const int n = min(p.group_rows, s1 - g0) * kW;   // elements of the group
      for (int k = 0; k < p.chunks; ++k, ++phase) {
        const int r0 = k * p.chunk_rows;
        const int rows = min(p.chunk_rows, S - r0);
        // x's chunk is staged unless it is the one already there (one chunk,
        // one column tile); the group's indices with the first chunk
        const bool load_x = p.chunks > 1 || g0 == s0;
        const bool load_ids = k == 0;
        if (phase > 0) __syncthreads();   // every thread is done with what it replaces
        if (kTma) {
          if (threadIdx.x == 0) {
            const int boxes = load_x ? (rows + p.box_rows - 1) / p.box_rows : 0;
            const uint32_t box_bytes = (uint32_t)p.box_rows * kRowBytes;
            // TMA counts a box's out-of-bounds rows, filled with zeros, too
            const uint32_t bytes = boxes * box_bytes +
                                   (load_ids ? (uint32_t)p.group_rows * kRowBytes : 0u);
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(bar_a), "r"(bytes) : "memory");
            for (int b = 0; b < boxes; ++b)
              tma_box(tile_a + b * box_bytes, &xmap, c0, r0 + b * p.box_rows, bar_a);
            if (load_ids) tma_box(ids_a, &imap, c0, g0, bar_a);
          }
          mbar_wait(bar_a, phase & 1u);
        } else {
          if (load_x) cp_async_rows(tile_a, x, r0, rows, c0, L);
          if (load_ids) cp_async_rows(ids_a, idx, g0, n / kW, c0, L);
          asm volatile("cp.async.commit_group;\n"
                       "cp.async.wait_all;\n" ::: "memory");
          __syncthreads();
        }
        // a warp takes one output row at a time, lane = column
#pragma unroll 4
        for (int e = threadIdx.x; e < n; e += kTileThreads) {
          const int j = clamp_index(ids[e], S) - r0;
          if (col_ok && (unsigned)j < (unsigned)rows)
            __stcs(out + (long long)(g0 + (e >> 5)) * L + c0 + lane, tile[j * kW + lane]);
        }
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15u) == 0; }

// TMA takes a row-major (S, L) array of 4-byte elements when its rows start
// on 16-byte boundaries.
bool tma_ok(const void* a, int L) { return L % 4 == 0 && aligned16(a); }

// A tensor map of a row-major (S, L) array of 4-byte elements, in boxes of
// 32 columns x box_rows rows.
CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* a, int S,
                int L, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_SUPPORTED;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)S};
  const cuuint64_t strides[1] = {(cuuint64_t)L * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kW, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(a), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Lets the kernel take up to kMaxSmem of dynamic shared memory on the
// current device (the attribute is per device: once for each).
template <bool kTma>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(gather_axis0_tile_kernel<kTma>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (dev < kMaxDevices) done[dev] = err == cudaSuccess;
  return err;
}

template <bool kTma>
cudaError_t launch_axis0(const CUtensorMap& xmap, const CUtensorMap& imap, const float* x,
                         const int* idx, float* out, int S, int L, const Plan& p,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem<kTma>();
  if (err != cudaSuccess) return err;
  // the column tiles beyond 65535 are looped in the kernel
  const dim3 grid(p.splits, p.tiles < 65535 ? p.tiles : 65535);
  gather_axis0_tile_kernel<kTma><<<grid, kTileThreads, p.smem_bytes, stream>>>(
      xmap, imap, x, idx, out, S, L, p);
  return cudaGetLastError();
}

int gather_axis0(const float* x, const int* idx, float* out, int S, int L,
                 cudaStream_t stream) {
  if ((long long)S * L == 0) return 0;
  const bool tma = tma_ok(x, L) && tma_ok(idx, L);
  const Plan p = plan_axis0(S, L, tma);
  CUtensorMap xmap = {}, imap = {};
  if (!tma) return (int)launch_axis0<false>(xmap, imap, x, idx, out, S, L, p, stream);
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, S, L, p.box_rows) ||
      encode(&imap, CU_TENSOR_MAP_DATA_TYPE_INT32, idx, S, L, p.group_rows))
    return (int)cudaErrorInvalidValue;   // a map TMA refuses
  return (int)launch_axis0<true>(xmap, imap, x, idx, out, S, L, p, stream);
}

// ---- gather_axis1 ------------------------------------------------------------

// A block's tile of the output: `rows` whole rows (`cols` = L < kTile), or
// `cols` columns of one row (long rows, or a small array spread over more
// blocks); the grid is (row tiles, column tiles).
struct Plan1 {
  int rows, cols;
  int grid_x, grid_y;
};

constexpr int kThreads1 = 256;             // threads of a block
constexpr int kTile = 4 * kThreads1;       // elements of a block: 4 a thread
constexpr int kSms = 132;                  // the H100 SXM's SMs
constexpr int kMinCols = 128;              // a tile spans at least one warp's quads

// Returns false where the column tiles do not fit in the grid's y.
bool plan_axis1(int S, int L, Plan1* p) {
  p->cols = std::min(L, kTile);
  // small arrays spread their loads over the SMs: no more rows to a tile
  // than leave two tiles per SM, and narrower tiles while the grid has fewer
  // blocks than half the SMs (the thresholds measured best: PERF.md)
  p->rows = std::max(1, std::min(kTile / p->cols, cdiv(S, 2 * kSms)));
  while ((long long)cdiv(S, p->rows) * cdiv(L, p->cols) < kSms / 2 &&
         p->cols / 2 >= kMinCols)
    p->cols = (p->cols / 2 + 3) / 4 * 4;   // a multiple of 4 keeps quads in a tile
  p->grid_x = cdiv(S, p->rows);
  p->grid_y = cdiv(L, p->cols);
  return p->grid_y <= 65535;
}

// out[s, l] = x[s, clamp(idx[s, l])] for the block's tile, 4 elements a
// thread with every load in flight at once: kVec (L % 4 == 0, 16-byte
// aligned arrays) takes 4 neighbouring elements, one 16-byte index load, 4
// loads from the row and one 16-byte store; otherwise the thread takes 4
// elements kThreads1 apart, each load and store coalesced across the warp.
template <bool kVec>
__global__ void __launch_bounds__(kThreads1)
gather_axis1_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                    float* __restrict__ out, int S, int L, Plan1 p) {
  const long long r0 = (long long)blockIdx.x * p.rows;
  const int c0 = blockIdx.y * p.cols;
  if (kVec) {
    const int e = 4 * threadIdx.x;   // the quad's first element in the tile
    const int r = p.rows == 1 ? 0 : e / p.cols;
    const int c = c0 + e - r * p.cols;
    const long long s = r0 + r;
    if (r < p.rows && s < S && c < min(L, c0 + p.cols)) {
      const float* row = x + s * L;
      const int4 j = __ldg(reinterpret_cast<const int4*>(idx + s * L + c));
      float4 v;
      v.x = __ldg(row + clamp_index(j.x, L));
      v.y = __ldg(row + clamp_index(j.y, L));
      v.z = __ldg(row + clamp_index(j.z, L));
      v.w = __ldg(row + clamp_index(j.w, L));
      __stcs(reinterpret_cast<float4*>(out + s * L + c), v);
    }
  } else {
    long long row[4];   // offset of the element's row in x; -1: no element
    int c[4], j[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = threadIdx.x + k * kThreads1;
      const int r = p.rows == 1 ? 0 : e / p.cols;
      const long long s = r0 + r;
      c[k] = c0 + e - r * p.cols;
      row[k] = r < p.rows && s < S && c[k] < min(L, c0 + p.cols) ? s * L : -1;
      j[k] = row[k] >= 0 ? __ldg(idx + row[k] + c[k]) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (row[k] >= 0)
        __stcs(out + row[k] + c[k], __ldg(x + row[k] + clamp_index(j[k], L)));
  }
}

int gather_axis1(const float* x, const int* idx, float* out, int S, int L,
                 cudaStream_t stream) {
  if ((long long)S * L == 0) return 0;
  Plan1 p;
  if (!plan_axis1(S, L, &p)) return (int)cudaErrorInvalidValue;
  const dim3 grid(p.grid_x, p.grid_y);
  if (L % 4 == 0 && aligned16(x) && aligned16(idx) && aligned16(out))
    gather_axis1_kernel<true><<<grid, kThreads1, 0, stream>>>(x, idx, out, S, L, p);
  else
    gather_axis1_kernel<false><<<grid, kThreads1, 0, stream>>>(x, idx, out, S, L, p);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes); each returns the cudaError_t of its
// launch. `out` must not alias `x`.
extern "C" int heligym_gather_axis0(const float* x, const int* idx, float* out,
                                    int S, int L, void* stream) {
  return gather_axis0(x, idx, out, S, L, (cudaStream_t)stream);
}

extern "C" int heligym_gather_axis1(const float* x, const int* idx, float* out,
                                    int S, int L, void* stream) {
  return gather_axis1(x, idx, out, S, L, (cudaStream_t)stream);
}
