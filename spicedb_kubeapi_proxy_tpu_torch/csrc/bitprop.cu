// Hand-written CUDA kernels for the two hops of the masked boolean
// semiring (ops/semiring.py). Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes. Each entry point
// launches on the stream it is given (PyTorch's current stream), allocates
// nothing, does not synchronise, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// bit_or_matmul — replaces the Pallas TPU kernel
//   spicedb_kubeapi_proxy_tpu/ops/bitprop.py: bit_or_matmul / _bit_kernel
//
//   out[b, d] = (OR_k A_bits[d, k] & V_bits[b, k]) != 0,  b < n_b <= 8
//
// The push hop over a bit-packed block (one bit per potential edge).
// Bound on an H100: the A_bits stream (n_dst * K * 4 bytes, read once) at
// 3.35 TB/s; the ALU work (one AND + OR per word and batch row) is far
// below the integer rate. Design for that bound: one warp per dst row,
// lanes stride over the row in 16-byte (int4) loads so a warp reads 512
// contiguous bytes per step, every lane keeps n_b OR accumulators in
// registers, and a warp vote (__any_sync) reduces them. The packed
// frontier (8 x K words, a few KB) is read through the read-only cache
// and stays L1/L2 resident; it is not copied to shared memory. Output is
// written directly as [n_b, n_dst] (the semiring's [B, n_dst] layout).
// Words whose frontier bits are all zero are still streamed: a sparsity
// skip is left to a later change.
//
// ---------------------------------------------------------------------------
// dense_or_matmul — replaces the Pallas TPU kernel
//   spicedb_kubeapi_proxy_tpu/ops/bitprop.py: dense_or_matmul / _dense_kernel
//
//   out[b, d] = (sum_s f[b, s] * A[d, s]) > 0,   int8 in, int32 sum
//
// The pull hop: an int8 product with an int32 accumulator, then > 0.
// Bound on an H100: the A stream (n_dst * n_src bytes) at 3.35 TB/s; the
// int8 work (2 * B * n_dst * n_src ops) at 1,979 TOP/s only binds for
// B above ~590. Design: a block owns a 64 (batch) x 128 (dst) output tile
// and walks the src axis in 64-byte steps; frontier and A tiles are staged
// in shared memory and contracted with __dp4a (4 int8 products per
// instruction) into 32 int32 accumulators per thread. A frontier tile that
// is all zero is detected with __syncthreads_or and skipped before its A
// tile is loaded, so sparse frontiers also skip the A bytes. Any batch size
// is accepted (ragged batch and dst edges are masked). Tensor cores
// (wgmma) and TMA are left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBitWarpsPerBlock = 8;

__global__ void bit_or_matmul_kernel(const int4* __restrict__ a_bits,
                                     const int4* __restrict__ v_bits,
                                     uint8_t* __restrict__ out,
                                     int64_t n_dst, int64_t k4, int n_b) {
  const int64_t row =
      (int64_t)blockIdx.x * kBitWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_dst) return;  // warp-uniform: the whole warp leaves
  unsigned acc[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) acc[b] = 0u;
  const int4* a_row = a_bits + row * k4;
  for (int64_t k = lane; k < k4; k += 32) {
    const int4 w = a_row[k];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b < n_b) {
        const int4 v = __ldg(v_bits + b * k4 + k);
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

constexpr int kDenseBM = 64;    // batch rows per block
constexpr int kDenseBN = 128;   // dst rows per block
constexpr int kDenseBKW = 16;   // src int32 words (64 bytes) per step
constexpr int kDenseThreads = 256;
constexpr int kPad = kDenseBKW + 1;  // shared-memory row stride (words)

__global__ void __launch_bounds__(kDenseThreads)
dense_or_matmul_kernel(const int8_t* __restrict__ A,
                       const uint8_t* __restrict__ f,
                       uint8_t* __restrict__ out,
                       int64_t n_dst, int64_t n_src, int64_t batch) {
  __shared__ int f_s[kDenseBM][kPad];
  __shared__ int a_s[kDenseBN][kPad];
  const int t = threadIdx.x;
  const int tx = t & 15;   // dst lane: d = d0 + tx + 16 * j
  const int ty = t >> 4;   // batch lane: b = b0 + ty + 16 * i
  const int64_t d0 = (int64_t)blockIdx.x * kDenseBN;
  const int64_t b0 = (int64_t)blockIdx.y * kDenseBM;
  const int64_t src_words = n_src >> 2;  // n_src % 16 == 0 (checked)

  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  // each thread stages one int4 of the frontier tile (64 rows x 4 int4)
  // and two int4 of the A tile (128 rows x 4 int4) per step
  const int f_row = t >> 2, f_q = t & 3;
  for (int64_t kw = 0; kw < src_words; kw += kDenseBKW) {
    int4 fv = make_int4(0, 0, 0, 0);
    const int64_t fb = b0 + f_row;
    const int64_t fw = kw + f_q * 4;
    if (fb < batch && fw < src_words)
      fv = *reinterpret_cast<const int4*>(f + fb * n_src + fw * 4);
    const int nz = (fv.x | fv.y | fv.z | fv.w) != 0;
    // block-uniform: an all-zero frontier tile contributes nothing, so
    // neither it nor the A tile it would meet is touched
    if (!__syncthreads_or(nz)) continue;
    f_s[f_row][f_q * 4 + 0] = fv.x;
    f_s[f_row][f_q * 4 + 1] = fv.y;
    f_s[f_row][f_q * 4 + 2] = fv.z;
    f_s[f_row][f_q * 4 + 3] = fv.w;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = t + r * kDenseThreads;
      const int a_row = idx >> 2, a_q = idx & 3;
      const int64_t ad = d0 + a_row;
      const int64_t aw = kw + a_q * 4;
      int4 av = make_int4(0, 0, 0, 0);
      if (ad < n_dst && aw < src_words)
        av = *reinterpret_cast<const int4*>(A + ad * n_src + aw * 4);
      a_s[a_row][a_q * 4 + 0] = av.x;
      a_s[a_row][a_q * 4 + 1] = av.y;
      a_s[a_row][a_q * 4 + 2] = av.z;
      a_s[a_row][a_q * 4 + 3] = av.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDenseBKW; ++k) {
      int fr[4], ar[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) fr[i] = f_s[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) ar[j] = a_s[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(fr[i], ar[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t b = b0 + ty + 16 * i;
    if (b >= batch) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t d = d0 + tx + 16 * j;
      if (d < n_dst) out[b * n_dst + d] = (uint8_t)(acc[i][j] > 0);
    }
  }
}

}  // namespace

extern "C" {

// a_bits [n_dst, k_words] int32 (k_words % 4 == 0), v_bits [8, k_words]
// int32, out [n_b, n_dst] uint8. Returns a cudaError_t value.
int bitprop_bit_or_matmul(const void* a_bits, const void* v_bits, void* out,
                          int64_t n_dst, int64_t k_words, int n_b,
                          void* stream) {
  if (n_dst <= 0 || n_b <= 0) return (int)cudaGetLastError();
  const int64_t blocks =
      (n_dst + kBitWarpsPerBlock - 1) / kBitWarpsPerBlock;
  bit_or_matmul_kernel<<<(unsigned)blocks, kBitWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
      (const int4*)a_bits, (const int4*)v_bits, (uint8_t*)out, n_dst,
      k_words / 4, n_b);
  return (int)cudaGetLastError();
}

// A [n_dst, n_src] int8, f [batch, n_src] uint8 (n_src % 16 == 0),
// out [batch, n_dst] uint8. Returns a cudaError_t value.
int bitprop_dense_or_matmul(const void* A, const void* f, void* out,
                            int64_t n_dst, int64_t n_src, int64_t batch,
                            void* stream) {
  if (n_dst <= 0 || batch <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_dst + kDenseBN - 1) / kDenseBN),
                  (unsigned)((batch + kDenseBM - 1) / kDenseBM));
  dense_or_matmul_kernel<<<grid, kDenseThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const uint8_t*)f, (uint8_t*)out, n_dst, n_src,
      batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
