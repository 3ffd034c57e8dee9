// Padded-ELL block-sparse x dense matmul for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/pallas/blocksparse.py
// `_ell_matmul_pallas`: for every block row i,
//
//     out[i*bm : (i+1)*bm, :] = sum_k blocks[i, k] @ b[indices[i, k]*bn : +bn, :]
//
// Padded slots hold a zero block at column 0 and add nothing; duplicate
// (i, j) blocks add up. Inputs: indices int32 (nbr, K), blocks f32
// (nbr, K, bm, bn), b f32 (d_pad, N) with d_pad % bn == 0, all contiguous;
// out f32 (nbr*bm, N). Any bm, bn in 1..128.
//
// What bounds it on the card: for the block-sparse Gram (A^T)_bsr @ A_dense
// each stored block streams a (bn, N) panel of the dense operand, so the
// kernel reads K*bn*N floats per block row and does 2*bm flops per float
// read: memory and L2 bound (the slice's first call reads ~11 GB of panels
// for ~9.2e10 useful flops), with no data reuse across block rows beyond
// what L2 catches.
//
// Design:
// - The TPU grid runs block rows in order on one core with a (bm, N)
//   accumulator in VMEM. Here a thread block owns one (block row, 128-column
//   tile, 16-row tile) of the output, so no two blocks write the same
//   element: no atomics, and the result is deterministic.
// - There is no scalar prefetch: each thread block reads its own K indices.
// - Per slot, the (16 x 16) chunk of the block (transposed) and the
//   (16 x 128) chunk of the B panel are staged in shared memory; each of the
//   128 threads accumulates a 4 x 4 register tile with fp32 FFMA, reading B
//   as float4 when N % 4 == 0 and the pointers are 16-byte aligned.
// - Blocks are launched with block rows on grid.x, so consecutive blocks
//   work on one column tile of B; block rows that share a panel (and all
//   padded slots, which read panel 0) then hit it in L2.
// - The ragged N edge and tiles smaller than 16 are masked with zeros.
//   Offsets are 64-bit: j*bn*N reaches ~1e9 at the slice's size.
// - A slot whose index lies outside [0, d_pad/bn) is skipped, so a bad
//   index never reads out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;                          // output rows per thread block
constexpr int TN = 128;                         // output columns per thread block
constexpr int TK = 16;                          // contraction rows per stage
constexpr int RM = 4;                           // rows per thread
constexpr int RN = 4;                           // columns per thread
constexpr int THREADS = (TM / RM) * (TN / RN);  // 128
constexpr int A_STRIDE = TM + 4;                // padded row of a_s, keeps float4 alignment

constexpr int ERR_BAD_TILE = -1;
constexpr int ERR_BAD_SHAPE = -2;
constexpr int ERR_TOO_LARGE = -3;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ell_matmul_kernel(const int* __restrict__ indices,
                  const float* __restrict__ blocks,
                  const float* __restrict__ b,
                  float* __restrict__ out,
                  int k_slots, int bm, int bn, long long nbc, long long n) {
  __shared__ __align__(16) float a_s[TK][A_STRIDE];  // a_s[c][r] = block[r0 + r][c0 + c]
  __shared__ __align__(16) float b_s[TK][TN];        // b_s[c][q] = b[j*bn + c0 + c][n0 + q]

  const long long i = blockIdx.x;
  const long long n0 = static_cast<long long>(blockIdx.y) * TN;
  const int r0 = blockIdx.z * TM;
  const int tid = threadIdx.x;
  const int tx = tid % (TN / RN);
  const int ty = tid / (TN / RN);

  float acc[RM][RN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int s = 0; s < RN; ++s) acc[r][s] = 0.f;

  const int* idx_row = indices + i * k_slots;
  const long long block_elems = static_cast<long long>(bm) * bn;
  const float* blk_row = blocks + i * k_slots * block_elems;

  for (int k = 0; k < k_slots; ++k) {
    const long long j = idx_row[k];
    if (j < 0 || j >= nbc) continue;  // uniform across the block
    const float* blk = blk_row + k * block_elems;
    const float* panel = b + j * bn * n;
    for (int c0 = 0; c0 < bn; c0 += TK) {
      for (int e = tid; e < TM * TK; e += THREADS) {
        const int r = e / TK, c = e % TK;
        float v = 0.f;
        if (r0 + r < bm && c0 + c < bn)
          v = blk[static_cast<long long>(r0 + r) * bn + c0 + c];
        a_s[c][r] = v;
      }
      if (VEC) {
        for (int e = tid; e < TK * TN / 4; e += THREADS) {
          const int c = e / (TN / 4), q = (e % (TN / 4)) * 4;
          const long long col = n0 + q;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c0 + c < bn && col < n)  // n % 4 == 0: the whole float4 is inside
            v = *reinterpret_cast<const float4*>(panel + (c0 + c) * n + col);
          *reinterpret_cast<float4*>(&b_s[c][q]) = v;
        }
      } else {
        for (int e = tid; e < TK * TN; e += THREADS) {
          const int c = e / TN, q = e % TN;
          const long long col = n0 + q;
          b_s[c][q] = (c0 + c < bn && col < n) ? panel[(c0 + c) * n + col] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        const float4 a4 = *reinterpret_cast<const float4*>(&a_s[c][ty * RM]);
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[c][tx * RN]);
        const float av[RM] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[RN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int s = 0; s < RN; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = r0 + ty * RM + r;
    if (row >= bm) continue;
    float* orow = out + (i * bm + row) * n;
    const long long col = n0 + tx * RN;
    if (VEC) {
      if (col < n)
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int s = 0; s < RN; ++s)
        if (col + s < n) orow[col + s] = acc[r][s];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of CUDA device `device`. Returns 0,
// a cudaError_t from the launch, or a negative code for arguments the kernel
// does not take (see keystone_ell_matmul_error).
int keystone_ell_matmul_f32(const void* indices, const void* blocks, const void* b,
                            void* out, long long nbr, long long k_slots, long long bm,
                            long long bn, long long d_pad, long long n, int device,
                            void* stream) {
  if (bm < 1 || bm > 128 || bn < 1 || bn > 128) return ERR_BAD_TILE;
  if (nbr < 1 || k_slots < 1 || n < 1 || d_pad < bn || d_pad % bn != 0)
    return ERR_BAD_SHAPE;
  const long long n_tiles = (n + TN - 1) / TN;
  if (nbr > 0x7fffffffLL || n_tiles > 65535 || k_slots > 0x7fffffffLL) return ERR_TOO_LARGE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(nbr), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((bm + TM - 1) / TM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indices);
  const float* bp = static_cast<const float*>(blocks);
  const float* dp = static_cast<const float*>(b);
  float* op = static_cast<float*>(out);
  if (vec)
    ell_matmul_kernel<true><<<grid, THREADS, 0, s>>>(ip, bp, dp, op, (int)k_slots, (int)bm,
                                                     (int)bn, d_pad / bn, n);
  else
    ell_matmul_kernel<false><<<grid, THREADS, 0, s>>>(ip, bp, dp, op, (int)k_slots, (int)bm,
                                                      (int)bn, d_pad / bn, n);
  return static_cast<int>(cudaGetLastError());
}

const char* keystone_ell_matmul_error(int code) {
  switch (code) {
    case ERR_BAD_TILE: return "block shape outside 1..128";
    case ERR_BAD_SHAPE: return "empty operand or d_pad not a positive multiple of bn";
    case ERR_TOO_LARGE: return "grid too large (block rows > 2^31-1 or N > 65535*128)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
