// Padded-ELL block-sparse x dense matmul for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel keystone_tpu/ops/pallas/blocksparse.py
// `_ell_matmul_pallas`: for every block row i,
//
//     out[i*bm : (i+1)*bm, :] = sum_{k < count_i} blocks[i, k] @ b[indices[i, k]*bn : +bn, :]
//
// count_i is counts[i] when a counts array is given, else K (every slot, the
// TPU kernel's semantics: padded slots hold a zero block at column 0).
// Duplicate (i, j) blocks add up. Inputs: indices int32 (nbr, K), counts
// int32 (nbr,) or null, blocks f32 (nbr, K, bm, bn), b f32 (d_pad, N) with
// d_pad % bn == 0, all contiguous; out f32 (nbr*bm, N). Any bm, bn in 1..128.
//
// What bounds it on the card: each stored block streams a (bn, N) panel of
// b, so for the block-sparse Gram (A^T)_bsr @ A_dense the kernel reads
// stored_blocks * bn * N floats of panels (11.6 GB at the slice's AtA shape,
// 2.7x the 4.3 GB of b, since a panel has ~2.7 readers) for 2 * bm FLOP per
// float read. Its floor is the unique bytes from HBM (b and the output,
// 1.6 ms); the 9.2e10 useful FLOP of fp32 FFMA need 1.4 ms at the 67
// TFLOP/s peak. Measured with builds that dropped one part at a time
// (PERF.md): the copies bound it. Copies alone take ~90% of the kernel's
// time and the arithmetic alone ~65%; the panel copies take 2.3x longer on
// the slice's indices than when the panels stay in L2, so most panel
// re-reads miss L2 and go to HBM.
//
// Design, item by item:
// - Slot counts. The slot loop stops at count_i (uniform across the warp):
//   padded slots are neither read nor computed (61.6% of the slice's ELL
//   slots). A row with count 0 writes zeros.
// - One warp owns one (block row, column tile, 16-row tile) of the output:
//   no atomics, a fixed order of summation (slot, then contraction row), so
//   the result is deterministic. Warps never wait on each other, so a short
//   row does not hold up a long one.
// - An asynchronous-copy ring of STAGES = 3 stages per warp in shared
//   memory. A stage holds one work item: the (16 x 16) chunk of a block,
//   stored transposed, and the (16 x TN) chunk of its b panel. cp.async
//   (16-byte .cg for b when N % 4 == 0 and b is 16-byte aligned, else 4
//   bytes; 4-byte .ca for the block, which it transposes) keeps the next two
//   items in flight while the warp computes the current one; ragged edges
//   are zero-filled by the copy itself (src-size 0). One __syncwarp per item
//   is the only barrier. Panel copies carry an L2 evict_last hint and the
//   output is stored evict-first (__stcs), so L2 keeps panels for their
//   other readers rather than output lines.
// - Register tile: each thread holds all 16 rows of its CPT columns. The
//   block's 16 values of one contraction row are a warp-uniform broadcast
//   (4 LDS.128), and each b value is read once per thread and used 16
//   times. Per contraction row a thread issues 16 * CPT FFMA for 4 + 1
//   LDS: FFMA:LDS = 64:5 = 12.8 on the wide tile, 16:5 = 3.2 on the narrow.
// - Column tile chosen from N: CPT = 4 (TN = 128, one warp per thread block)
//   for N > 32, CPT = 1 (TN = 32, NARROW_WARPS block rows per thread block)
//   for N <= 32, so a 20-column operand masks 12 lanes, not 108. Block rows
//   are fastest on the grid so that a panel's readers run close together;
//   TN stays at 128, whose column tile of b (33.5 MB at 65,536 rows) was
//   reckoned to fit the 50 MB L2. The measurement above says it mostly does
//   not; a 64-column tile was no faster on the card.
// - Offsets are 64-bit: j*bn*N reaches ~1e9 at the slice's size. A slot
//   whose index lies outside [0, d_pad/bn) contributes nothing (its block
//   and panel chunks are zero-filled, never read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 16;            // output rows per warp
constexpr int TK = 16;            // contraction rows per work item
constexpr int STAGES = 3;         // cp.async ring depth per warp
constexpr int WIDE_CPT = 4;       // columns per thread on the wide tile
constexpr int NARROW_WARPS = 4;   // block rows per thread block on the narrow tile
constexpr int NARROW_MAX_N = 32;  // N at or below this takes the narrow tile

constexpr int ERR_BAD_TILE = -1;
constexpr int ERR_BAD_SHAPE = -2;
constexpr int ERR_TOO_LARGE = -3;

template <int CPT>
struct Tile {
  static constexpr int TN = 32 * CPT;          // output columns per warp
  static constexpr int A_FLOATS = TK * TM;     // a_s[c][r] = block[r0 + r][c0 + c]
  static constexpr int B_FLOATS = TK * TN;     // b_s[c][q] = b[j*bn + c0 + c][n0 + q]
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int WARP_BYTES = STAGES * STAGE * 4;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 4 : 0));
}

// A 16-byte copy with an L2 `policy` (evict_last for panels: each has ~2.7
// readers, and the output and block chunks should leave L2 first).
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool in,
                                           uint64_t policy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(s),
               "l"(gmem), "r"(in ? 16 : 0), "l"(policy));
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Issues the copies of work item t (slot t / chunks, contraction rows
// (t % chunks) * TK ...) into `stage`. Out-of-range elements are zero-filled.
// Every loop has a trip count known at compile time; a lane's row of the
// block chunk and its columns of the panel chunk stay fixed across items.
template <int CPT, bool VEC>
__device__ __forceinline__ void load_item(float* stage, int t, int chunks, int lane,
                                          uint64_t keep, const int* idx_row,
                                          const float* blk_row, const float* b, int bm, int bn,
                                          int r0, long long n0, long long nbc, long long n) {
  using T = Tile<CPT>;
  const int k = t / chunks;
  const int c0 = (t - k * chunks) * TK;
  const long long j = idx_row[k];
  const bool ok = j >= 0 && j < nbc;
  // Block chunk, transposed: lane -> row lane % TM, columns lane / TM + 2u.
  {
    constexpr int COLS_PER_PASS = 32 / TM;
    const int r = lane % TM;
    const int c = lane / TM;
    const bool row_in = ok && r0 + r < bm;
    const float* src = blk_row + static_cast<long long>(k) * bm * bn +
                       static_cast<long long>(row_in ? r0 + r : 0) * bn + c0 + c;
    float* dst = stage + c * TM + r;
#pragma unroll
    for (int u = 0; u < TK / COLS_PER_PASS; ++u) {
      const bool in = row_in && c0 + c + u * COLS_PER_PASS < bn;
      cp_async4(dst + u * COLS_PER_PASS * TM, in ? src + u * COLS_PER_PASS : blk_row, in);
    }
  }
  float* b_s = stage + T::A_FLOATS;
  const float* panel = b + (ok ? j : 0) * bn * n + static_cast<long long>(c0) * n;
  if constexpr (VEC) {
    // Panel chunk: 16-byte copies, lane -> 4 columns; rows per pass fixed.
    constexpr int LANES_PER_ROW = T::TN / 4;
    constexpr int ROWS_PER_PASS = 32 / LANES_PER_ROW;
    const int q = (lane % LANES_PER_ROW) * 4;
    const int c = lane / LANES_PER_ROW;
    const bool col_in = ok && n0 + q < n;  // n % 4 == 0: the whole float4 is inside
    const float* src = panel + c * n + n0 + q;
    float* dst = b_s + c * T::TN + q;
#pragma unroll
    for (int u = 0; u < TK / ROWS_PER_PASS; ++u) {
      const bool in = col_in && c0 + c + u * ROWS_PER_PASS < bn;
      cp_async16(dst + u * ROWS_PER_PASS * T::TN, in ? src + u * ROWS_PER_PASS * n : b, in, keep);
    }
  } else {
    // Panel chunk: 4-byte copies, lane -> CPT columns (one per pass).
#pragma unroll
    for (int s = 0; s < CPT; ++s) {
      const int q = lane + 32 * s;
      const bool col_in = ok && n0 + q < n;
      const float* src = panel + n0 + q;
#pragma unroll
      for (int c = 0; c < TK; ++c) {
        const bool in = col_in && c0 + c < bn;
        cp_async4(b_s + c * T::TN + q, in ? src + c * n : b, in);
      }
    }
  }
}

template <int CPT, bool VEC>
__global__ void __launch_bounds__(CPT == 1 ? 32 * NARROW_WARPS : 32)
ell_matmul_kernel(const int* __restrict__ indices, const int* __restrict__ counts,
                  const float* __restrict__ blocks, const float* __restrict__ b,
                  float* __restrict__ out, int k_slots, int bm, int bn, long long nbr,
                  long long nbc, long long n) {
  using T = Tile<CPT>;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + warp;
  if (i >= nbr) return;  // no block-wide barrier below: a warp may leave
  const long long n0 = static_cast<long long>(blockIdx.y) * T::TN;
  const int r0 = blockIdx.z * TM;
  float* ring = smem + warp * (STAGES * T::STAGE);

  int count = k_slots;
  if (counts != nullptr) count = min(max(counts[i], 0), k_slots);
  const int chunks = (bn + TK - 1) / TK;
  const int items = count * chunks;
  const int* idx_row = indices + i * k_slots;
  const float* blk_row = blocks + i * k_slots * static_cast<long long>(bm) * bn;
  const uint64_t keep = l2_evict_last();

  float acc[TM][CPT];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int s = 0; s < CPT; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < items)
      load_item<CPT, VEC>(ring + t * T::STAGE, t, chunks, lane, keep, idx_row, blk_row, b, bm,
                          bn, r0, n0, nbc, n);
    cp_async_commit();
  }
  for (int t = 0; t < items; ++t) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of item t have landed
    __syncwarp();                 // ... and every lane's; stage (t - 1) is free
    const int next = t + STAGES - 1;
    if (next < items)
      load_item<CPT, VEC>(ring + (next % STAGES) * T::STAGE, next, chunks, lane, keep,
                          idx_row, blk_row, b, bm, bn, r0, n0, nbc, n);
    cp_async_commit();
    const float* a_s = ring + (t % STAGES) * T::STAGE;
    const float* b_s = a_s + T::A_FLOATS;
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      float av[TM];
#pragma unroll
      for (int r = 0; r < TM; r += 4) {
        const float4 a4 = *reinterpret_cast<const float4*>(a_s + c * TM + r);
        av[r] = a4.x, av[r + 1] = a4.y, av[r + 2] = a4.z, av[r + 3] = a4.w;
      }
      float bv[CPT];
      if constexpr (CPT == 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(b_s + c * T::TN + lane * 4);
        bv[0] = b4.x, bv[1] = b4.y, bv[2] = b4.z, bv[3] = b4.w;
      } else {
#pragma unroll
        for (int s = 0; s < CPT; ++s) bv[s] = b_s[c * T::TN + lane * CPT + s];
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int s = 0; s < CPT; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
  }
  cp_async_wait<0>();  // leave no copy in flight into freed shared memory

  const long long col = n0 + lane * CPT;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = r0 + r;
    if (row >= bm) break;
    float* orow = out + (i * bm + row) * n;
    if constexpr (VEC && CPT == 4) {
      if (col < n)
        __stcs(reinterpret_cast<float4*>(orow + col),  // streamed: evict first
               make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    } else {
#pragma unroll
      for (int s = 0; s < CPT; ++s)
        if (col + s < n) __stcs(orow + col + s, acc[r][s]);
    }
  }
}

template <int CPT, bool VEC>
int launch(const int* ip, const int* cp, const float* bp, const float* dp, float* op,
           long long nbr, long long k_slots, long long bm, long long bn, long long d_pad,
           long long n, cudaStream_t s) {
  using T = Tile<CPT>;
  const int warps = CPT == 1 ? NARROW_WARPS : 1;
  const long long grid_x = (nbr + warps - 1) / warps;
  const long long n_tiles = (n + T::TN - 1) / T::TN;
  if (grid_x > 0x7fffffffLL || n_tiles > 65535) return ERR_TOO_LARGE;
  auto kernel = ell_matmul_kernel<CPT, VEC>;
  // Favour shared memory over L1: the ring is what bounds residency.
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>((bm + TM - 1) / TM));
  kernel<<<grid, 32 * warps, warps * T::WARP_BYTES, s>>>(ip, cp, bp, dp, op, (int)k_slots,
                                                         (int)bm, (int)bn, nbr, d_pad / bn, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` (a cudaStream_t) of CUDA device `device`. `counts`
// may be null (every slot takes part). Returns 0, a cudaError_t from the
// launch, or a negative code for arguments the kernel does not take (see
// keystone_ell_matmul_error).
int keystone_ell_matmul_f32(const void* indices, const void* counts, const void* blocks,
                            const void* b, void* out, long long nbr, long long k_slots,
                            long long bm, long long bn, long long d_pad, long long n,
                            int device, void* stream) {
  if (bm < 1 || bm > 128 || bn < 1 || bn > 128) return ERR_BAD_TILE;
  if (nbr < 1 || k_slots < 1 || n < 1 || d_pad < bn || d_pad % bn != 0)
    return ERR_BAD_SHAPE;
  if (k_slots > 0x7fffffffLL / ((bn + TK - 1) / TK)) return ERR_TOO_LARGE;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool narrow = n <= NARROW_MAX_N;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(indices);
  const int* cp = static_cast<const int*>(counts);
  const float* bp = static_cast<const float*>(blocks);
  const float* dp = static_cast<const float*>(b);
  float* op = static_cast<float*>(out);
  if (narrow)
    return vec ? launch<1, true>(ip, cp, bp, dp, op, nbr, k_slots, bm, bn, d_pad, n, s)
               : launch<1, false>(ip, cp, bp, dp, op, nbr, k_slots, bm, bn, d_pad, n, s);
  return vec ? launch<WIDE_CPT, true>(ip, cp, bp, dp, op, nbr, k_slots, bm, bn, d_pad, n, s)
             : launch<WIDE_CPT, false>(ip, cp, bp, dp, op, nbr, k_slots, bm, bn, d_pad, n, s);
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
