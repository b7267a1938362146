// Fused classifier MLP forward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces the TPU kernel faster_distributed_training_tpu/ops/
// fused_mlp.py::_mlp_fwd_pallas (kernel _mlp_kernel :93): per row,
// h = x.w1^T + b1 with fp32 accumulation, relu(h) cast to x's dtype,
// out = a.w2^T + b2 in fp32, cast once.  Weights are (out, in), so each
// hidden unit is one contiguous dot product.
//
// What bounds it on this card: at the serving shape (8 rows x 512 ->
// 1024 -> 4, bf16) the work is 8.4 MFLOP against the 1 MB w1 read --
// purely the weight bytes (~0.3 us at 3.35 TB/s).  With one 8-row block
// the TPU's "row block per grid step" would stream all of w1 through one
// SM, so the hidden units are split across blocks as well as the rows.
//
// Design: block (row block of 8, chunk of 32 hidden units), 8 warps of 4
// units.  The 8 x-rows are staged in shared memory; each warp reads its
// w1 rows with 16-byte loads, every lane a strided slice of d_in, and
// reduces the 8 row sums by shuffles.  The hidden chunk goes to shared
// memory as x's dtype after the relu and never leaves the block.  Each
// block writes its fp32 partial outputs (8 x d_out floats) to scratch;
// the last block of a row block to finish (atomic ticket) sums the
// partials in split order, adds b2 and casts once -- deterministic, so a
// row's logits never depend on which other rows share its batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int R = 8;       // rows per block
constexpr int UNITS = 32;  // hidden units per block
constexpr int NT = 256;    // 8 warps
constexpr int UPW = UNITS / (NT / 32);  // units per warp

template <typename T>
__global__ void __launch_bounds__(NT)
    mlp_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, T* __restrict__ out, float* partial,
                   int* counters, int rows, int d_in, int d_h, int d_out) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [R][d_in]
  T* as = xs + (size_t)R * d_in;       // [R][UNITS] hidden chunk
  __shared__ int is_last;

  const int rb = blockIdx.x, split = blockIdx.y, n_splits = gridDim.y;
  const int r0 = rb * R, u0 = split * UNITS;
  const int nr = min(R, rows - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid * VEC; i < R * d_in; i += NT * VEC) {
    const int r = i / d_in, c = i % d_in;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr) val = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * d_in + c);
    *reinterpret_cast<uint4*>(xs + (size_t)r * d_in + c) = val;
  }
  __syncthreads();

  for (int uu = 0; uu < UPW; ++uu) {
    const int ul = warp * UPW + uu, u = u0 + ul;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (u < d_h) {
      const T* wrow = w1 + (size_t)u * d_in;
      for (int c = lane * VEC; c < d_in; c += 32 * VEC) {
        const uint4 wv = *reinterpret_cast<const uint4*>(wrow + c);
        const T* wt = reinterpret_cast<const T*>(&wv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + (size_t)r * d_in + c);
          const T* xt = reinterpret_cast<const T*>(&xv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r] = fmaf(to_f(xt[e]), to_f(wt[e]), acc[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float h = u < d_h ? acc[r] + to_f(b1[u]) : 0.f;
        as[r * UNITS + ul] = from_f<T>(fmaxf(h, 0.f));
      }
    }
  }
  __syncthreads();

  const int nu = min(UNITS, d_h - u0);
  for (int i = tid; i < nr * d_out; i += NT) {
    const int r = i / d_out, j = i % d_out;
    const T* w2row = w2 + (size_t)j * d_h + u0;
    float s = 0.f;
    for (int t = 0; t < nu; ++t) s = fmaf(to_f(as[r * UNITS + t]), to_f(w2row[t]), s);
    partial[((size_t)split * rows + r0 + r) * d_out + j] = s;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[rb], 1) == n_splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < nr * d_out; i += NT) {
    const int r = i / d_out, j = i % d_out;
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp)
      s += __ldcg(&partial[((size_t)sp * rows + r0 + r) * d_out + j]);
    out[(size_t)(r0 + r) * d_out + j] = from_f<T>(s + to_f(b2[j]));
  }
  if (tid == 0) counters[rb] = 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, float* partial, int* counters, int rows,
                   int d_in, int d_h, int d_out, cudaStream_t stream) {
  const size_t bytes = ((size_t)R * d_in + (size_t)R * UNITS) * sizeof(T);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((rows + R - 1) / R, (d_h + UNITS - 1) / UNITS);
  mlp_fwd_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), partial,
      counters, rows, d_in, d_h, d_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes the wrapper sizes its scratch by: partial holds
// n_splits * rows * d_out floats (n_splits = ceil(d_h / units)), counters
// ceil(rows / rows_per_block) zeroed ints.
int fdt_mlp_rows_per_block(void) { return R; }
int fdt_mlp_units_per_block(void) { return UNITS; }

// dtype: 0 = float32, 1 = bfloat16.  x [rows, d_in], w1 [d_h, d_in],
// b1 [d_h], w2 [d_out, d_h], b2 [d_out], out [rows, d_out]; all
// contiguous, d_in a multiple of 16 bytes' worth of elements.
int fdt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2,
                      const void* b2, void* out, void* partial, void* counters, int dtype,
                      int rows, int d_in, int d_h, int d_out, void* stream) {
  if (rows <= 0 || d_in <= 0 || d_h <= 0 || d_out <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  int* c = static_cast<int*>(counters);
  cudaError_t err =
      dtype == 1 ? launch<__nv_bfloat16>(x, w1, b1, w2, b2, out, p, c, rows, d_in, d_h, d_out, s)
                 : launch<float>(x, w1, b1, w2, b2, out, p, c, rows, d_in, d_h, d_out, s);
  return (int)err;
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
