// Quantized GEMM for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel faster_distributed_training_tpu/ops/quant.py::
// quant_dot_pallas (kernel _quant_matmul_kernel :233):
//
//   out[m, n] = cast_out(float(sum_k xq[m, k] * wq[n, k]) * inv),
//   inv = 1.0f / (sx * sw)
//
// with xq [M, K] and wq [N, K] (nn.Linear's (out, in) layout, the JAX
// (K, N) kernel transposed) already quantized.  int8: exact int32 sums, so
// the result equals the plain version bit for bit.  E4M3: operands upcast
// to fp32 and summed with FMA in fp32, as the TPU kernel upcasts and runs an
// fp32 dot (fp8 tensor-core mma is later work).  The scales arrive as device
// pointers, so the caller never waits on the card for them.
//
// What bounds it on this card: at the record's qkv shape (8192 x 512 ->
// 1536, int8 operands, bf16 out) the work is 12.9 GOP against ~30 MB of
// traffic, 6.5 us at 1,979 TOP/s and 9.0 us at 3.35 TB/s: the bytes,
// barely.  The TPU kernel keeps wq resident in VMEM across row blocks;
// here wq stays in the 50 MB L2 and every block re-reads its tiles.
//
// Design, int8: one block per 64 x 64 output tile, four warps of 32 x 32
// (2 x 2 WMMA s8 m16n16k16 fragments, int32 accumulators), K in steps of
// 64 staged through shared memory.  WMMA wants 256-bit aligned fragment
// pointers, which a row-major int8 tile at k offset 16 cannot give, so the
// operands are staged tile-major: each 16 x 16 tile is 256 contiguous
// bytes with a leading dimension of 16.  The int32 tile goes through
// shared memory to the epilogue (convert, descale, cast).  E4M3: one block
// per 64 x 64 tile, 256 threads of 4 x 4 outputs, K in steps of 16 staged
// as fp32.  No pipelining, no wgmma: the simple, correct version.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64;

// -- int8: WMMA s8 ------------------------------------------------------------
constexpr int BK8 = 64;
constexpr int NT8 = 128;
constexpr int CS = BN + 4;  // int32 epilogue tile stride

template <typename T>
__global__ void __launch_bounds__(NT8)
    qmm_int8_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    T* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(128) int8_t As[BM * BK8];
  __shared__ __align__(128) int8_t Bs[BN * BK8];
  __shared__ __align__(128) int Cs[BM * CS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  constexpr int KT = BK8 / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < K; k0 += BK8) {
    __syncthreads();
    // 64 rows x 4 sixteen-byte pieces of each operand; piece (r, q) lands
    // in tile (r / 16, q) at row r % 16
    for (int v = tid; v < 2 * BM * KT; v += NT8) {
      const bool is_b = v >= BM * KT;
      const int u = is_b ? v - BM * KT : v;
      const int r = u / KT, q = u % KT, k = k0 + 16 * q;
      const int g = (is_b ? n0 : m0) + r;
      const int lim = is_b ? N : M;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < lim && k < K)
        val = *reinterpret_cast<const uint4*>((is_b ? wq : xq) + (size_t)g * K + k);
      int8_t* dst = (is_b ? Bs : As) + ((r >> 4) * KT + q) * 256 + (r & 15) * 16;
      *reinterpret_cast<uint4*>(dst) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + ((2 * wm + i) * KT + kt) * 256, 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + ((2 * wn + j) * KT + kt) * 256, 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (32 * wm + 16 * i) * CS + 32 * wn + 16 * j, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();
  const float inv = __fdiv_rn(1.0f, __fmul_rn(sx[0], sw[0]));
  for (int e = tid; e < BM * BN; e += NT8) {
    const int r = e / BN, c = e % BN, m = m0 + r, n = n0 + c;
    if (m < M && n < N)
      out[(size_t)m * N + n] = from_f<T>(__fmul_rn(__int2float_rn(Cs[r * CS + c]), inv));
  }
}

// -- E4M3: fp32 FMA -------------------------------------------------------------
constexpr int BKF = 16;
constexpr int NTF = 256;
constexpr int FS = BM + 4;  // fp32 operand tile stride ([k][row])

__device__ __forceinline__ float e4m3_to_f(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

template <typename T>
__global__ void __launch_bounds__(NTF)
    qmm_e4m3_kernel(const uint8_t* __restrict__ xq, const uint8_t* __restrict__ wq,
                    const float* __restrict__ sx, const float* __restrict__ sw,
                    T* __restrict__ out, int M, int N, int K) {
  __shared__ float As[BKF * FS];
  __shared__ float Bs[BKF * FS];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BKF) {
    __syncthreads();
    if (tid < 2 * BM) {
      // one 16-byte row piece of A (threads 0..63) or B (64..127)
      const bool is_b = tid >= BM;
      const int r = is_b ? tid - BM : tid;
      const int g = (is_b ? n0 : m0) + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (g < (is_b ? N : M))
        val = *reinterpret_cast<const uint4*>((is_b ? wq : xq) + (size_t)g * K + k0);
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&val);
      float* dst = is_b ? Bs : As;
#pragma unroll
      for (int k = 0; k < BKF; ++k) dst[k * FS + r] = e4m3_to_f(bytes[k]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BKF; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * FS + 4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k * FS + 4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  const float inv = __fdiv_rn(1.0f, __fmul_rn(sx[0], sw[0]));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < M && n < N) out[(size_t)m * N + n] = from_f<T>(__fmul_rn(acc[i][j], inv));
    }
  }
}

template <typename T>
cudaError_t launch(const void* xq, const void* wq, const float* sx, const float* sw, void* out,
                   int fmt, int M, int N, int K, cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (fmt == 0)
    qmm_int8_kernel<T><<<grid, NT8, 0, s>>>(static_cast<const int8_t*>(xq),
                                            static_cast<const int8_t*>(wq), sx, sw,
                                            static_cast<T*>(out), M, N, K);
  else
    qmm_e4m3_kernel<T><<<grid, NTF, 0, s>>>(static_cast<const uint8_t*>(xq),
                                            static_cast<const uint8_t*>(wq), sx, sw,
                                            static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fmt: 0 = int8, 1 = E4M3.  out_dtype: 0 = float32, 1 = bfloat16.
// xq [M, K], wq [N, K] contiguous and 16-byte aligned, K % 16 == 0; sx, sw
// one fp32 each on the device; out [M, N].
int fdt_quant_matmul(const void* xq, const void* wq, const void* sx, const void* sw, void* out,
                     int fmt, int out_dtype, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || (fmt != 0 && fmt != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(sx);
  const float* b = static_cast<const float*>(sw);
  cudaError_t err = out_dtype == 1
                        ? launch<__nv_bfloat16>(xq, wq, a, b, out, fmt, M, N, K, s)
                        : launch<float>(xq, wq, a, b, out, fmt, M, N, K, s);
  return (int)err;
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
