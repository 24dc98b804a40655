// Hand-written CUDA kernels for the two hops of the masked boolean
// semiring (ops/semiring.py). Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Each entry point
// launches on the stream it is given (PyTorch's current stream), allocates
// nothing, does not synchronise, and returns a cudaError_t value so the
// Python wrapper can raise on a refused launch. Every sparsity decision
// is made on the device: the host never reads a count.
//
// ---------------------------------------------------------------------------
// bit_or_matmul — replaces the Pallas TPU kernel
//   spicedb_kubeapi_proxy_tpu/ops/bitprop.py: bit_or_matmul / _bit_kernel
//
//   out[b, d] = (OR_k A_bits[d, k] & V_bits[b, k]) != 0,  b < n_b <= 8
//
// The push hop over a bit-packed block (one bit per potential edge). A
// frontier word that is zero in every batch row contributes nothing, so
// the card must read only the 32-byte sectors of each A_bits row that
// hold a live word: n_dst * 32 B * (live sectors a row). The list
// filter's B=1 frontier lights 1-2 of 512 words: 4.2-8.4 MB of sectors
// on the headline dual, against 268 MB for the whole stream.
//
// Design. A grid-stride kernel: a few blocks a SM walk all rows. Each
// block first compacts the live frontier words into shared memory: the
// union over the n_b rows of V_bits[b, k] != 0 (never > 0: bit 31 is a
// negative int32), with __ballot_sync and __popc prefix sums, reading
// n_b * K words from L2. The path is then the same in every block:
//  - sparse, when at most max_live words are live: T lanes a dst row (the
//    live count rounded up to a power of two, at most a warp) load only
//    a_bits[d, w] for their share of the live words, AND them with the
//    frontier words kept in shared memory, OR-reduce with shuffles, and
//    write [n_b, n_dst] with neighbouring rows in neighbouring threads;
//  - dense, otherwise: the whole row is streamed, one warp a row, 16-byte
//    loads (512 B a warp-step), n_b OR accumulators in registers and an
//    __any_sync vote.
// max_live < 0 (a dual too small for the sparse path to pay) launches
// bit_or_matmul_stream_kernel instead: the same row stream, one warp a
// row and a block per 8 rows, with no shared memory and no compaction.
// On 2-4 MiB duals the grid-stride kernel ran 10-20% slower than this
// shape (PERF.md).
// The threshold is the caller's alone (ops/bitprop.py,
// bit_sparse_max_live, with the readings behind it in PERF.md); the entry
// point only refuses a max_live past the shared list's capacity.
//
// ---------------------------------------------------------------------------
// dense_or_matmul — replaces the Pallas TPU kernel
//   spicedb_kubeapi_proxy_tpu/ops/bitprop.py: dense_or_matmul / _dense_kernel
//
//   out[b, d] = (sum_s f[b, s] * A[d, s]) > 0,   int8 x uint8, int32 sum
//
// The pull hop. A 32-byte src column that is zero in every frontier row
// contributes nothing, so the card must read only n_dst * 32 B * (live
// 32-byte columns): at the bulk check's B=16, 17 of 512 columns.
//
// Design, three stream-ordered steps (no host sync):
//  1. a 4-byte memset zeroes the live count in the caller's scratch;
//  2. dense_live_tiles_kernel reads the frontier once (lane = one 32-byte
//     column, the block's warps split the batch rows) and appends the live
//     columns to the scratch list, in order within a warp, one atomicAdd a
//     warp. An all-zero frontier leaves the count at 0 (an all-zero out);
//  3. dense_or_matmul_kernel reads the count and loops over the live
//     columns only, four to a pipeline stage. A block owns 128 dst rows
//     (1,024 blocks at 131,072 rows) in 8 warps of 16, and 8 * NT batch
//     rows (the batch rounded up to 8, NT in {1, 2, 4, 8}; grid.y covers
//     larger batches). A five-stage shared-memory ring is filled with
//     16-byte cp.async copies (zero-filled past the dst, batch and src
//     edges, so the wrapper pads nothing): four stages, 64 KB of A, in
//     flight a block. When at least half the columns are live the copies
//     ask L2 for 256-byte spans, so a nearly dense frontier streams whole
//     lines. The product runs on the tensor cores as
//     mma.sync.m16n8k32.row.col.s32.s8.u8.s32 with dst as M (both operands
//     K-major as they lie in memory, A[d, s] and f[b, s]) and the batch as
//     N, so B=16 wastes no column. mma.sync rather than wgmma: at B <= 64
//     the hop does 2 * B operations a byte of A, far under the card's
//     int8 ridge (~590), so even mma.sync's rate leaves it memory-bound.
//     Shared rows hold their 16-byte chunks XOR-swizzled by the row, so
//     the fragment loads hit 32 distinct banks. The epilogue stages the
//     0/1 tile in shared memory and writes it with neighbouring threads on
//     neighbouring dst.
// The frontier may be a strided view (row stride ld_f, a multiple of 16
// bytes), so the fixpoint passes its slice of the state without a copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// ---------------------------------------------------------------- bit ---

constexpr int kBitThreads = 256;
constexpr int kBitWarps = kBitThreads / 32;
constexpr int kBitSparseCap = 64;     // live-word list capacity (shared)

// at most 64 registers, so that four blocks (32 warps) fit a SM and the
// grid-stride kernel keeps enough rows in flight to stream
constexpr int kBitMinBlocksPerSM = 4;

// one warp streams dst row `row` whole: 16-byte loads, n_b OR accumulators
// and a vote; lane 0 writes the row's n_b outputs
__device__ __forceinline__ void bit_stream_row(const int4* __restrict__ a4,
                                               const int4* __restrict__ v4,
                                               uint8_t* __restrict__ out,
                                               int64_t row, int64_t n_dst,
                                               int64_t k4, int n_b,
                                               int lane) {
  unsigned acc[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) acc[b] = 0u;
  const int4* a_row = a4 + row * k4;
  for (int64_t q = lane; q < k4; q += 32) {
    const int4 w = a_row[q];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < n_b) {
        const int4 v = __ldg(v4 + b * k4 + q);
        acc[b] |= (unsigned)((w.x & v.x) | (w.y & v.y) | (w.z & v.z) |
                             (w.w & v.w));
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b < n_b) {
      const int hit = __any_sync(0xffffffffu, acc[b] != 0u);
      if (lane == 0) out[(int64_t)b * n_dst + row] = (uint8_t)hit;
    }
  }
}

// the small-dual kernel: a block per kBitWarps rows, a warp a row
__global__ void __launch_bounds__(kBitThreads)
bit_or_matmul_stream_kernel(const int32_t* __restrict__ a_bits,
                            const int32_t* __restrict__ v_bits,
                            uint8_t* __restrict__ out, int64_t n_dst,
                            int64_t k, int n_b) {
  const int64_t row = (int64_t)blockIdx.x * kBitWarps + (threadIdx.x >> 5);
  if (row >= n_dst) return;  // warp-uniform: the whole warp leaves
  bit_stream_row(reinterpret_cast<const int4*>(a_bits),
                 reinterpret_cast<const int4*>(v_bits), out, row, n_dst,
                 k >> 2, n_b, threadIdx.x & 31);
}

// grid-stride kernel: gridDim.x blocks (a few per SM) walk all rows
__global__ void __launch_bounds__(kBitThreads, kBitMinBlocksPerSM)
bit_or_matmul_kernel(const int32_t* __restrict__ a_bits,
                     const int32_t* __restrict__ v_bits,
                     uint8_t* __restrict__ out, int64_t n_dst, int64_t k,
                     int n_b, int max_live) {
  __shared__ int live_idx[kBitSparseCap];
  __shared__ unsigned live_v[8][kBitSparseCap];
  __shared__ int warp_count[kBitWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. compact the live frontier words (union over the n_b rows); stop
  // counting once past max_live, which already decides the dense path
  int live = 0;  // block-uniform
  for (int64_t k0 = 0; k0 < k && live <= max_live; k0 += kBitThreads) {
    const int64_t w = k0 + t;
    unsigned v[8];
    bool nz = false;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      v[b] = 0u;
      if (b < n_b && w < k) {
        v[b] = (unsigned)__ldg(v_bits + b * k + w);
        nz |= v[b] != 0u;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, nz);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int base = live, total = live;
#pragma unroll
    for (int i = 0; i < kBitWarps; ++i) {
      if (i < warp) base += warp_count[i];
      total += warp_count[i];
    }
    if (nz) {
      const int pos = base + __popc(ballot & ((1u << lane) - 1u));
      if (pos < max_live) {
        live_idx[pos] = (int)w;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (b < n_b) live_v[b][pos] = v[b];
      }
    }
    __syncthreads();  // warp_count is rewritten by the next step
    live = total;
  }

  if (live <= max_live) {
    // 2a. sparse path: T lanes a row read only the live words; a pass of
    // the grid covers gridDim.x * (kBitThreads / T) consecutive rows
    int T = 1;
    while (T < live && T < 32) T <<= 1;
    const int sub = t & (T - 1);
    const int per_block = kBitThreads / T;
    const int64_t per_pass = (int64_t)gridDim.x * per_block;
    for (int64_t r0 = (int64_t)blockIdx.x * per_block; r0 < n_dst;
         r0 += per_pass) {  // block-uniform
      const int64_t row = r0 + t / T;
      const bool ok = row < n_dst;
      unsigned acc[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[b] = 0u;
      if (ok) {
        const int32_t* a_row = a_bits + row * k;
#pragma unroll 4
        for (int i = sub; i < live; i += T) {
          const unsigned a = (unsigned)__ldg(a_row + live_idx[i]);
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (b < n_b) acc[b] |= a & live_v[b][i];
        }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (b < n_b) {  // block-uniform: every lane reaches the shuffles
          unsigned x = acc[b];
          for (int off = T >> 1; off > 0; off >>= 1)
            x |= __shfl_xor_sync(0xffffffffu, x, off);
          if (ok && sub == 0) out[(int64_t)b * n_dst + row] = (uint8_t)(x != 0u);
        }
      }
    }
    return;
  }

  // 2b. dense path: one warp a row streams the whole row, rows strided
  // over every warp of the grid
  for (int64_t row = (int64_t)blockIdx.x * kBitWarps + warp; row < n_dst;
       row += (int64_t)gridDim.x * kBitWarps)
    bit_stream_row(reinterpret_cast<const int4*>(a_bits),
                   reinterpret_cast<const int4*>(v_bits), out, row, n_dst,
                   k >> 2, n_b, lane);
}

// -------------------------------------------------------------- dense ---

constexpr int kTileBytes = 32;     // one k32 MMA step: the live-list grain
constexpr int kStageTiles = 4;     // live columns a pipeline stage
constexpr int kChunks = 2 * kStageTiles;  // 16-byte chunks a stage row
constexpr int kStages = 5;         // shared-memory ring depth
constexpr int kDenseBM = 128;      // dst rows a block
constexpr int kWarpRows = 16;      // dst rows a warp: one m16 fragment
constexpr int kMI = kWarpRows / 16;
constexpr int kDenseThreads = 32 * (kDenseBM / kWarpRows);
static_assert(kDenseThreads % kChunks == 0, "a thread keeps one chunk");
constexpr int kRowBytes = kChunks * 16;  // 128 B, chunks swizzled
constexpr int kAStage = kDenseBM * kRowBytes;
constexpr int kPreThreads = 256;   // pre-pass: lane = column, 8 warps

__host__ __device__ constexpr int dense_smem_bytes(int nt) {
  return kStages * (kAStage + 8 * nt * kRowBytes);
}

// byte offset of 16-byte chunk ch of stage row r: chunks are XOR-swizzled
// by the row so the 8 rows a fragment load touches hit distinct banks
__device__ __forceinline__ int soff(int r, int ch) {
  return r * kRowBytes + 16 * (ch ^ (r & (kChunks - 1)));
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  const int n = ok ? 16 : 0;  // 0: nothing read, 16 zero bytes written
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gptr), "r"(n)
               : "memory");
}

// the same copy, asking L2 to fetch the whole 256-byte span around it
__device__ __forceinline__ void cp_async16_wide(void* smem_ptr,
                                                const void* gptr, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_ptr);
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gptr), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A (16x32 s8, row) * B (32x8 u8, col) + D, int32 accumulators
__device__ __forceinline__ void mma_s8u8(int (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// live[0] = count, live[1 + i] = the i-th live 32-byte src column
__global__ void __launch_bounds__(kPreThreads)
dense_live_tiles_kernel(const uint8_t* __restrict__ f, int64_t ld_f,
                        int64_t n_src, int64_t batch, int64_t n_tiles,
                        int* __restrict__ live) {
  __shared__ int nz_s[kPreThreads / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t tile = (int64_t)blockIdx.x * 32 + lane;
  const int64_t col = tile * kTileBytes;
  const bool in0 = tile < n_tiles;
  const bool in1 = in0 && col + 16 < n_src;  // n_src % 32 == 16: half tile
  int nz = 0;
#pragma unroll 4
  for (int64_t b = warp; b < batch; b += kPreThreads / 32) {
    const uint8_t* row = f + b * ld_f + col;
    if (in0) {
      const int4 v = *reinterpret_cast<const int4*>(row);
      nz |= v.x | v.y | v.z | v.w;
    }
    if (in1) {
      const int4 v = *reinterpret_cast<const int4*>(row + 16);
      nz |= v.x | v.y | v.z | v.w;
    }
  }
  nz_s[warp][lane] = nz != 0;
  __syncthreads();
  if (warp != 0) return;
  int any = 0;
#pragma unroll
  for (int i = 0; i < kPreThreads / 32; ++i) any |= nz_s[i][lane];
  const unsigned ballot = __ballot_sync(0xffffffffu, any != 0);
  if (ballot == 0u) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(live, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (any) live[1 + base + __popc(ballot & ((1u << lane) - 1u))] = (int)tile;
}

template <int NT>
__global__ void __launch_bounds__(kDenseThreads)
dense_or_matmul_kernel(const int8_t* __restrict__ A,
                       const uint8_t* __restrict__ f, int64_t ld_f,
                       uint8_t* __restrict__ out,
                       const int* __restrict__ live, int64_t n_dst,
                       int64_t n_src, int64_t batch) {
  constexpr int BN = 8 * NT;
  constexpr int kFStage = BN * kRowBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* a_s = smem;                      // [kStages][kDenseBM][kRowBytes]
  uint8_t* f_s = smem + kStages * kAStage;  // [kStages][BN][kRowBytes]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;  // MMA fragment coordinates
  const int64_t d0 = (int64_t)blockIdx.x * kDenseBM;
  const int64_t b0 = (int64_t)blockIdx.y * BN;
  const int count = live[0];
  const int* list = live + 1;
  const int n_steps = (count + kStageTiles - 1) / kStageTiles;

  // Every thread copies the same 16-byte chunk position ch of its rows
  // in every stage (the thread count is a multiple of kChunks): row
  // pointers and shared offsets are fixed, only the live column moves.
  constexpr int kRowsPerIt = kDenseThreads / kChunks;
  constexpr int kAIts = kDenseBM / kRowsPerIt;
  constexpr int kFIts = (BN + kRowsPerIt - 1) / kRowsPerIt;
  const int ch = t & (kChunks - 1), r_lo = t / kChunks;
  const int half = 16 * (ch & 1);
  const int8_t* a_row[kAIts];
  bool a_ok[kAIts];
#pragma unroll
  for (int it = 0; it < kAIts; ++it) {
    const int64_t d = d0 + r_lo + it * kRowsPerIt;
    a_ok[it] = d < n_dst;
    a_row[it] = A + (a_ok[it] ? d : 0) * n_src + half;
  }
  const uint8_t* f_row[kFIts];
  bool f_ok[kFIts];
#pragma unroll
  for (int it = 0; it < kFIts; ++it) {
    const int r = r_lo + it * kRowsPerIt;
    const int64_t b = b0 + r;
    f_ok[it] = r < BN && b < batch;
    f_row[it] = f + (f_ok[it] ? b : 0) * ld_f + half;
  }
  // the live column of this thread's chunk for stage `step`
  auto column = [&](int step) -> int64_t {
    const int e = step * kStageTiles + (ch >> 1);
    if (e >= count) return -1;
    const int64_t col = (int64_t)list[e] * kTileBytes;
    return col + half < n_src ? col : -1;  // -1: zero-fill
  };
  // one stage: kStageTiles live columns of the block's A rows and batch
  // rows, 16-byte chunks, zero-filled past every edge
  // at least half the columns live: consecutive stages mostly read
  // adjacent bytes of each row, so L2 fetches 256-byte spans ahead
  // (block-uniform; a sparse list would only over-fetch)
  const bool wide =
      2 * (int64_t)count >= (n_src + kTileBytes - 1) / kTileBytes;
  auto load_stage = [&](int64_t col, int slot) {
    uint8_t* as = a_s + slot * kAStage;
    uint8_t* fs = f_s + slot * kFStage;
#pragma unroll
    for (int it = 0; it < kAIts; ++it) {
      const bool ok = col >= 0 && a_ok[it];
      const void* src = ok ? (const void*)(a_row[it] + col) : (const void*)A;
      if (wide)
        cp_async16_wide(as + soff(r_lo + it * kRowsPerIt, ch), src, ok);
      else
        cp_async16(as + soff(r_lo + it * kRowsPerIt, ch), src, ok);
    }
#pragma unroll
    for (int it = 0; it < kFIts; ++it) {
      const int r = r_lo + it * kRowsPerIt;
      if (r < BN) {
        const bool ok = col >= 0 && f_ok[it];
        cp_async16(fs + soff(r, ch),
                   ok ? (const void*)(f_row[it] + col) : (const void*)f, ok);
      }
    }
  };

  int acc[kMI][NT][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_stage(column(s), s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  // the next stage's column is read one step ahead, off the copy's path
  int64_t col_next = column(kStages - 1);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this stage landed; the slot refilled below is free
    const int nxt = step + kStages - 1;
    if (nxt < n_steps) load_stage(col_next, nxt % kStages);
    cp_async_commit();
    col_next = column(nxt + 1);
    const uint8_t* as = a_s + (step % kStages) * kAStage;
    const uint8_t* fs = f_s + (step % kStages) * kFStage;
#pragma unroll
    for (int j = 0; j < kStageTiles; ++j) {
      unsigned af[kMI][4], bf[NT][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        // A fragment (PTX ISA, m16n8k32 .s8 row): a0 row g bytes 4q..4q+3,
        // a1 row g+8, a2 row g bytes 16+4q.., a3 row g+8 bytes 16+4q..
        const int r = warp * kWarpRows + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const unsigned*>(
            as + soff(r, 2 * j) + 4 * q);
        af[mi][1] = *reinterpret_cast<const unsigned*>(
            as + soff(r + 8, 2 * j) + 4 * q);
        af[mi][2] = *reinterpret_cast<const unsigned*>(
            as + soff(r, 2 * j + 1) + 4 * q);
        af[mi][3] = *reinterpret_cast<const unsigned*>(
            as + soff(r + 8, 2 * j + 1) + 4 * q);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        // B fragment (.col): b0 column g bytes 4q..4q+3, b1 bytes 16+4q..
        const int r = ni * 8 + g;
        bf[ni][0] = *reinterpret_cast<const unsigned*>(
            fs + soff(r, 2 * j) + 4 * q);
        bf[ni][1] = *reinterpret_cast<const unsigned*>(
            fs + soff(r, 2 * j + 1) + 4 * q);
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_s8u8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the output tile

  // C fragment: c0 (row g, col 2q), c1 (g, 2q+1), c2 (g+8, 2q), c3 (g+8,
  // 2q+1); rows are dst, columns batch
  uint8_t* o_s = smem;  // [BN][kDenseBM]
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int dl = warp * kWarpRows + mi * 16 + g + (i >= 2 ? 8 : 0);
        const int bl = ni * 8 + 2 * q + (i & 1);
        o_s[bl * kDenseBM + dl] = (uint8_t)(acc[mi][ni][i] > 0);
      }
  __syncthreads();
  for (int idx = t; idx < BN * kDenseBM; idx += kDenseThreads) {
    const int64_t b = b0 + idx / kDenseBM, d = d0 + idx % kDenseBM;
    if (b < batch && d < n_dst) out[b * n_dst + d] = o_s[idx];
  }
}

// Per-device facts read once, not at every launch: the bit kernel's grid
// (resident blocks a SM x SMs) and, for each dense instantiation, whether
// its dynamic shared-memory limit is raised. 0 = not yet read; racing
// first launches write the same value.
constexpr int kMaxDevices = 64;
std::atomic<int> g_bit_blocks[kMaxDevices];
std::atomic<int> g_dense_smem_set[kMaxDevices][4];

cudaError_t current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  return err;
}

template <int NT>
constexpr int nt_slot() {
  return NT == 1 ? 0 : NT == 2 ? 1 : NT == 4 ? 2 : 3;
}

template <int NT>
cudaError_t launch_dense(const int8_t* A, const uint8_t* f, int64_t ld_f,
                         uint8_t* out, const int* live, int64_t n_dst,
                         int64_t n_src, int64_t batch, cudaStream_t stream) {
  constexpr int smem = dense_smem_bytes(NT);
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>& set = g_dense_smem_set[dev][nt_slot<NT>()];
  if (!set.load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(dense_or_matmul_kernel<NT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    set.store(1, std::memory_order_release);
  }
  const dim3 grid((unsigned)((n_dst + kDenseBM - 1) / kDenseBM),
                  (unsigned)((batch + 8 * NT - 1) / (8 * NT)));
  dense_or_matmul_kernel<NT><<<grid, kDenseThreads, smem, stream>>>(
      A, f, ld_f, out, live, n_dst, n_src, batch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a_bits [n_dst, k_words] int32 (k_words % 4 == 0), v_bits [8, k_words]
// int32, out [n_b, n_dst] uint8; blocks take the sparse path when at most
// max_live frontier words are live (< 0: the stream kernel, no
// compaction). The caller decides max_live (ops/bitprop.py's
// bit_sparse_max_live); a value past the shared list's capacity
// (kBitSparseCap) is refused. Returns a cudaError_t value.
int bitprop_bit_or_matmul(const void* a_bits, const void* v_bits, void* out,
                          int64_t n_dst, int64_t k_words, int n_b,
                          int max_live, void* stream) {
  if (max_live > kBitSparseCap) return (int)cudaErrorInvalidValue;
  if (n_dst <= 0 || n_b <= 0) return (int)cudaGetLastError();
  const int64_t need = (n_dst + kBitWarps - 1) / kBitWarps;
  if (max_live < 0) {
    bit_or_matmul_stream_kernel<<<(unsigned)need, kBitThreads, 0,
                                  (cudaStream_t)stream>>>(
        (const int32_t*)a_bits, (const int32_t*)v_bits, (uint8_t*)out, n_dst,
        k_words, n_b);
    return (int)cudaGetLastError();
  }
  // enough blocks to fill every SM once, no more than one warp a row
  int dev = 0;
  cudaError_t err = current_device(&dev);
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = g_bit_blocks[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bit_or_matmul_kernel, kBitThreads, 0);
    if (err != cudaSuccess) return (int)err;
    blocks = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    g_bit_blocks[dev].store((int)blocks, std::memory_order_relaxed);
  }
  if (blocks > need) blocks = need;
  bit_or_matmul_kernel<<<(unsigned)blocks, kBitThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)a_bits, (const int32_t*)v_bits, (uint8_t*)out, n_dst,
      k_words, n_b, max_live);
  return (int)cudaGetLastError();
}

// A [n_dst, n_src] int8, f [batch, n_src] uint8 with row stride ld_f
// (n_src and ld_f multiples of 16), out [batch, n_dst] uint8, scratch
// int32 [1 + ceil(n_src / 32)] (live count and column list). Returns a
// cudaError_t value.
int bitprop_dense_or_matmul(const void* A, const void* f, int64_t ld_f,
                            void* out, void* scratch, int64_t n_dst,
                            int64_t n_src, int64_t batch, void* stream) {
  if (n_dst <= 0 || batch <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int* live = (int*)scratch;
  const int64_t n_tiles = (n_src + kTileBytes - 1) / kTileBytes;
  cudaError_t err = cudaMemsetAsync(live, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    dense_live_tiles_kernel<<<(unsigned)((n_tiles + 31) / 32), kPreThreads, 0,
                              s>>>((const uint8_t*)f, ld_f, n_src, batch,
                                   n_tiles, live);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t frags = (batch + 7) / 8;
  const int8_t* a = (const int8_t*)A;
  const uint8_t* fr = (const uint8_t*)f;
  uint8_t* o = (uint8_t*)out;
  if (frags <= 1)
    err = launch_dense<1>(a, fr, ld_f, o, live, n_dst, n_src, batch, s);
  else if (frags <= 2)
    err = launch_dense<2>(a, fr, ld_f, o, live, n_dst, n_src, batch, s);
  else if (frags <= 4)
    err = launch_dense<4>(a, fr, ld_f, o, live, n_dst, n_src, batch, s);
  else
    err = launch_dense<8>(a, fr, ld_f, o, live, n_dst, n_src, batch, s);
  return (int)err;
}

}  // extern "C"
