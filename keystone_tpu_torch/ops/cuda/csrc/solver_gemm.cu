// Solver-grade dense products at an explicit cuBLAS compute type.
//
// Not the port of a TPU kernel: the JAX package leaves these products to
// XLA and pins their precision per call (`precision=` on every matmul,
// keystone_tpu/parallel/linalg.py). PyTorch's own cuBLAS handle takes its
// math mode from process-wide flags (`torch.backends.cuda.matmul.allow_tf32`,
// `torch.set_float32_matmul_precision`), which any library may change. This
// binding owns its handles, keeps them in CUBLAS_DEFAULT_MATH and names the
// compute type on every call, so a product's precision is what the caller
// asked for and nothing else:
//
//   kind 0  fp32 A/B/C, CUBLAS_COMPUTE_32F            (IEEE fp32)
//   kind 1  fp32 A/B/C, CUBLAS_COMPUTE_32F_FAST_TF32  (TF32 products)
//   kind 2  bf16 A/B, fp32 C, CUBLAS_COMPUTE_32F      (one bf16 pass,
//                                                      fp32 accumulation)
//   kind 3  fp64 A/B/C, CUBLAS_COMPUTE_64F
//
// One bf16 pass over fp32 data takes bf16 copies of the inputs (the
// caller rounds them): CUBLAS_COMPUTE_32F_FAST_16BF on fp32 inputs only
// allows cuBLAS to down-convert, so the precision would be the library's
// choice, not the caller's.
//
// Matrices are row-major with a leading dimension (the row stride); a
// transposed operand is passed as a flag on its row-major storage, never
// copied. Row-major C = op(A)·op(B) is column-major Cᵀ = op(B)ᵀ·op(A)ᵀ,
// so cuBLAS is called with the operands swapped.
//
// Handles: one per (device, thread), created at the thread's first call on
// that device and returned to a process-wide pool when the thread exits
// (never destroyed: the pool outlives the CUDA runtime's teardown). Every
// call sets the handle's stream to the caller's, so work queues on
// PyTorch's current stream of the calling thread.
//
// What bounds these products on an H100: large Grams are bound by
// operations (67 TFLOP/s fp32 outside the tensor cores, 495 TF32, 989
// bf16); the (n, k) residual products with k ≈ 138 by bytes.

#include <cublas_v2.h>
#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr int ERR_BAD_KIND = -1;
constexpr int ERR_BAD_SHAPE = -2;
constexpr int CUBLAS_ERR_BASE = 100000;

struct Pool {
  std::mutex lock;
  std::unordered_map<int, std::vector<cublasHandle_t>> free_by_device;
};

Pool& pool() {
  static Pool* p = new Pool;  // never freed: see the file's comment
  return *p;
}

struct ThreadHandles {
  std::unordered_map<int, cublasHandle_t> by_device;
  ~ThreadHandles() {
    Pool& p = pool();
    std::lock_guard<std::mutex> guard(p.lock);
    for (auto& kv : by_device) p.free_by_device[kv.first].push_back(kv.second);
  }
};

thread_local ThreadHandles thread_handles;

int handle_for(int device, cublasHandle_t* out) {
  auto it = thread_handles.by_device.find(device);
  if (it != thread_handles.by_device.end()) {
    *out = it->second;
    return 0;
  }
  cublasHandle_t h = nullptr;
  {
    Pool& p = pool();
    std::lock_guard<std::mutex> guard(p.lock);
    auto& spare = p.free_by_device[device];
    if (!spare.empty()) {
      h = spare.back();
      spare.pop_back();
    }
  }
  if (h == nullptr) {
    cublasStatus_t st = cublasCreate(&h);
    if (st != CUBLAS_STATUS_SUCCESS) return CUBLAS_ERR_BASE + static_cast<int>(st);
  }
  cublasStatus_t st = cublasSetMathMode(h, CUBLAS_DEFAULT_MATH);
  if (st != CUBLAS_STATUS_SUCCESS) return CUBLAS_ERR_BASE + static_cast<int>(st);
  thread_handles.by_device[device] = h;
  *out = h;
  return 0;
}

struct KindTypes {
  cudaDataType_t ab, c;
  cublasComputeType_t compute;
};

bool kind_types(int kind, KindTypes* t) {
  switch (kind) {
    case 0: *t = {CUDA_R_32F, CUDA_R_32F, CUBLAS_COMPUTE_32F}; return true;
    case 1: *t = {CUDA_R_32F, CUDA_R_32F, CUBLAS_COMPUTE_32F_FAST_TF32}; return true;
    case 2: *t = {CUDA_R_16BF, CUDA_R_32F, CUBLAS_COMPUTE_32F}; return true;
    case 3: *t = {CUDA_R_64F, CUDA_R_64F, CUBLAS_COMPUTE_64F}; return true;
    default: return false;
  }
}

size_t elem_bytes(cudaDataType_t t) {
  return t == CUDA_R_64F ? 8 : t == CUDA_R_32F ? 4 : 2;
}

// Set up (device, handle, stream); returns 0 or an error code.
int prepare(int device, void* stream, cublasHandle_t* h) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = handle_for(device, h);
  if (rc != 0) return rc;
  cublasStatus_t st = cublasSetStream(*h, static_cast<cudaStream_t>(stream));
  return st == CUBLAS_STATUS_SUCCESS ? 0 : CUBLAS_ERR_BASE + static_cast<int>(st);
}

// Row-major C (m×n) = alpha·op(A)·op(B) + beta·C; op(A) is m×k, op(B) k×n.
int gemm_row_major(cublasHandle_t h, const KindTypes& t, int trans_a, int trans_b,
                   long long m, long long n, long long k, double alpha,
                   const void* a, long long lda, const void* b, long long ldb,
                   double beta, void* c, long long ldc) {
  // alpha/beta are of the compute type's scalar type: double for 64F,
  // float for every 32F compute type.
  float alpha_f = static_cast<float>(alpha), beta_f = static_cast<float>(beta);
  const void* pa = t.compute == CUBLAS_COMPUTE_64F ? static_cast<const void*>(&alpha)
                                                   : static_cast<const void*>(&alpha_f);
  const void* pb = t.compute == CUBLAS_COMPUTE_64F ? static_cast<const void*>(&beta)
                                                   : static_cast<const void*>(&beta_f);
  cublasStatus_t st = cublasGemmEx(
      h, trans_b ? CUBLAS_OP_T : CUBLAS_OP_N, trans_a ? CUBLAS_OP_T : CUBLAS_OP_N,
      static_cast<int>(n), static_cast<int>(m), static_cast<int>(k), pa,
      b, t.ab, static_cast<int>(ldb), a, t.ab, static_cast<int>(lda), pb,
      c, t.c, static_cast<int>(ldc), t.compute, CUBLAS_GEMM_DEFAULT);
  return st == CUBLAS_STATUS_SUCCESS ? 0 : CUBLAS_ERR_BASE + static_cast<int>(st);
}

bool fits_int(long long v) { return v >= 0 && v <= 0x7fffffffLL; }

// gemm_row_major for `batch` independent products whose operands and
// outputs sit `stride_*` elements apart (one cuBLAS call).
int gemm_row_major_strided(cublasHandle_t h, const KindTypes& t, int trans_a, int trans_b,
                           long long m, long long n, long long k, double alpha,
                           const void* a, long long lda, long long stride_a,
                           const void* b, long long ldb, long long stride_b, double beta,
                           void* c, long long ldc, long long stride_c, long long batch) {
  float alpha_f = static_cast<float>(alpha), beta_f = static_cast<float>(beta);
  const void* pa = t.compute == CUBLAS_COMPUTE_64F ? static_cast<const void*>(&alpha)
                                                   : static_cast<const void*>(&alpha_f);
  const void* pb = t.compute == CUBLAS_COMPUTE_64F ? static_cast<const void*>(&beta)
                                                   : static_cast<const void*>(&beta_f);
  cublasStatus_t st = cublasGemmStridedBatchedEx(
      h, trans_b ? CUBLAS_OP_T : CUBLAS_OP_N, trans_a ? CUBLAS_OP_T : CUBLAS_OP_N,
      static_cast<int>(n), static_cast<int>(m), static_cast<int>(k), pa,
      b, t.ab, static_cast<int>(ldb), stride_b, a, t.ab, static_cast<int>(lda), stride_a, pb,
      c, t.c, static_cast<int>(ldc), stride_c, static_cast<int>(batch), t.compute,
      CUBLAS_GEMM_DEFAULT);
  return st == CUBLAS_STATUS_SUCCESS ? 0 : CUBLAS_ERR_BASE + static_cast<int>(st);
}

}  // namespace

extern "C" {

// C = alpha·op(A)·op(B) + beta·C, all row-major (see the file's comment).
// Returns 0, or a code for keystone_gemm_error.
int keystone_gemm(int kind, int trans_a, int trans_b, long long m, long long n,
                  long long k, double alpha, const void* a, long long lda,
                  const void* b, long long ldb, double beta, void* c, long long ldc,
                  int device, void* stream) {
  KindTypes t;
  if (!kind_types(kind, &t)) return ERR_BAD_KIND;
  if (!fits_int(m) || !fits_int(n) || !fits_int(k) || !fits_int(lda) || !fits_int(ldb) ||
      !fits_int(ldc))
    return ERR_BAD_SHAPE;
  if (m == 0 || n == 0) return 0;
  cublasHandle_t h;
  int rc = prepare(device, stream, &h);
  if (rc != 0) return rc;
  return gemm_row_major(h, t, trans_a, trans_b, m, n, k, alpha, a, lda, b, ldb, beta, c, ldc);
}

// C (m×n) = beta·C + Σ_chunks A[r:r+rows]ᵀ·B[r:r+rows], over the `total`
// rows of row-major A (total×m, row stride lda) and B (total×n, row
// stride ldb), `rows` at a time: the first chunk's product is scaled by
// beta's C, every later one accumulates with beta = 1. One call runs the
// whole loop, so a Gram over millions of rows costs one host call.
int keystone_gemm_tn_chunked(int kind, long long total, long long m, long long n,
                             long long rows, const void* a, long long lda,
                             const void* b, long long ldb, double beta, void* c,
                             long long ldc, int device, void* stream) {
  KindTypes t;
  if (!kind_types(kind, &t)) return ERR_BAD_KIND;
  if (!fits_int(m) || !fits_int(n) || !fits_int(lda) || !fits_int(ldb) || !fits_int(ldc) ||
      total < 0 || rows < 1 || !fits_int(rows))
    return ERR_BAD_SHAPE;
  if (m == 0 || n == 0 || total == 0) return 0;
  cublasHandle_t h;
  int rc = prepare(device, stream, &h);
  if (rc != 0) return rc;
  const size_t eb = elem_bytes(t.ab);
  for (long long r = 0; r < total; r += rows) {
    long long kr = total - r < rows ? total - r : rows;
    const char* ar = static_cast<const char*>(a) + static_cast<size_t>(r) * lda * eb;
    const char* br = static_cast<const char*>(b) + static_cast<size_t>(r) * ldb * eb;
    // Row-major A chunk is (kr × m); Aᵀ is its transpose: trans_a = 1.
    rc = gemm_row_major(h, t, 1, 0, m, n, kr, 1.0, ar, lda, br, ldb,
                        r == 0 ? beta : 1.0, c, ldc);
    if (rc != 0) return rc;
  }
  return 0;
}

// C[i] = alpha·op(A[i])·op(B[i]) + beta·C[i] for i < batch, each matrix
// row-major as in keystone_gemm, matrix i of an operand `stride_*`
// elements after matrix i − 1 (the Fisher-vector statistics: one product
// per image).
int keystone_gemm_strided_batched(int kind, int trans_a, int trans_b, long long m,
                                  long long n, long long k, double alpha, const void* a,
                                  long long lda, long long stride_a, const void* b,
                                  long long ldb, long long stride_b, double beta, void* c,
                                  long long ldc, long long stride_c, long long batch,
                                  int device, void* stream) {
  KindTypes t;
  if (!kind_types(kind, &t)) return ERR_BAD_KIND;
  if (!fits_int(m) || !fits_int(n) || !fits_int(k) || !fits_int(lda) || !fits_int(ldb) ||
      !fits_int(ldc) || !fits_int(batch) || stride_a < 0 || stride_b < 0 || stride_c < 0)
    return ERR_BAD_SHAPE;
  if (m == 0 || n == 0 || batch == 0) return 0;
  cublasHandle_t h;
  int rc = prepare(device, stream, &h);
  if (rc != 0) return rc;
  return gemm_row_major_strided(h, t, trans_a, trans_b, m, n, k, alpha, a, lda, stride_a, b,
                                ldb, stride_b, beta, c, ldc, stride_c, batch);
}

const char* keystone_gemm_error(int code) {
  switch (code) {
    case ERR_BAD_KIND: return "unknown product kind";
    case ERR_BAD_SHAPE: return "a dimension or leading dimension outside 0..2^31-1";
    default:
      if (code >= CUBLAS_ERR_BASE)
        return cublasGetStatusString(static_cast<cublasStatus_t>(code - CUBLAS_ERR_BASE));
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
