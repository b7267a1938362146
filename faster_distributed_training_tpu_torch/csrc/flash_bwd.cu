// Flash-attention backward for Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces three TPU functions of faster_distributed_training_tpu/ops/
// flash_attention.py, which compute one function and differ in how they
// fit VMEM; the two kernels below serve all three:
//   * _flash_bwd_pallas_stats (:716, kernel body :757) -- the saved-stats
//     backward: p = exp(s - lse) from the forward's row lse, and
//     delta = sum_d dO*out computed outside the kernel (:809-811);
//   * _flash_bwd_kblocked (:379, dq_kernel :421, dkv_kernel :448) -- the
//     same function tiled over k blocks for long context (path E's L 8192);
//   * _flash_bwd_pallas (:847, kernel body :888) -- the recompute
//     backward, whose residuals are the inputs only.  The port's recompute
//     route re-runs the forward kernel (csrc/flash_fwd.cu, emit_lse) to
//     rebuild out and lse and then launches the same two kernels.
//
// Per (q row, key), with the keep factor of the forward's hash dropout
// regenerated from (seed, b*H + h, q row, key):
//   s  = q.k^T * scale + key bias           (fp32; keys past Lk: -inf)
//   p  = exp((s - lse) - lse_lo)  (lse_lo: the forward's low-order lse
//                                   term, 0 when not given; it keeps a
//                                   fully masked row normalized)
//   pt = p * keep,  dp = (dO.v^T) * keep
//   ds = p * (dp - delta) * scale
//   dv += pt^T.dO,  dk += ds^T.q,  dq += ds.k
// pt and ds are rounded to bf16 as product operands (the plain version
// rounds at the same points).
//
// What bounds it on this card: seven L x L x D products (two kernels each
// recompute s and dp) against O(L D) bytes.  Path E's shape (B 4, H 8,
// L 8192, D 64) is operations-bound: the five products the function needs
// take 1.39 ms at 989 TFLOP/s against ~0.1 ms of traffic.  At the
// training shape (B 16, H 8, L 512) the two bounds are near the bf16
// ridge (0.022 ms).  So the kernels have to keep the tensor cores fed and
// keep every score-shaped tile out of device memory and shared memory.
//
// Design, bf16 (the training dtype): wgmma on register-resident score
// tiles, cp.async tile loads overlapping the products.  Two kernels and no
// atomics, so gradients are bitwise deterministic across launches; the
// price is seven products instead of FA-2/3's five with an atomic dq.
//   * dkdv_kernel_sm90: one block per (b*h, 128-key tile), two warpgroups
//     of 64 keys (wgmma M = 64).  K and V stay resident in shared memory in
//     the swizzle the wgmma descriptors name (csrc/sm90.cuh).  Q, dO and
//     the per-row lse, lse_lo, delta and dropout hash stream through a
//     two-stage ring of 64-row q tiles (32 rows at D 128): every thread
//     issues 16-byte cp.async for the next tile before the products of
//     this one.  S^T = K.Q^T and dP^T = V.dO^T are wgmma SS (B = the Q or
//     dO tile, K-major); the elementwise phase runs in registers on the
//     accumulator fragments (bias per key row, lse/delta/hash per q
//     column); Pt^T and dS^T are packed to bf16 in registers and feed
//     dV += Pt^T.dO and dK += dS^T.Q as wgmma RS operands, B = the same dO
//     or Q tile read MN-major through the transpose bit.  dK and dV stay
//     fp32 in registers for the whole q loop; the epilogue stores them into
//     the strided dk/dv views (the fused [B, L, 3, H, D] gradient, no
//     transpose copy).
//   * dq_kernel_sm90: one block per (b*h, 128 q rows), two warpgroups of 64
//     rows; Q, dO and the row statistics resident (statistics in
//     registers); K, V and the key bias stream through the ring in 64-key
//     tiles.  S = Q.K^T and dP = dO.V^T are SS; dS stays in registers and
//     feeds dQ += dS.K as RS with B = the K tile MN-major; dQ stays fp32 in
//     registers.
// Occupancy at D 64: dkdv holds dK, dV, S^T and dP^T (128 fp32) a thread
// and runs one 8-warp block an SM; dq fits 128 registers, so two blocks
// share an SM and hide each other's latencies (at one block it measured
// 1.5x slower).  The elementwise phase, not the tensor cores, bounds both
// (PERF.md).
// Against the WMMA kernels this replaces: shared memory holds only bf16
// operand tiles (66 KB at D 64, not 123 KB with fp32 score tiles and
// accumulators), loads are 16-byte and asynchronous instead of 2-byte and
// synchronous, no fp32 intermediate goes through shared memory, the
// products are wgmma over 64-row tiles instead of WMMA 16x16x16, and the
// elementwise phase spreads over all 256 threads' fragments instead of two
// threads a row.  Edges: rows past Lk/Lq load as zeros (cp.async with
// source size 0) and are masked in registers (p = 0), so a zero key row
// never scores 0 into a softmax.
//
// fp32 (correctness checks only) keeps the FMA kernels dkdv_kernel /
// dq_kernel: 64-row tiles, fp32 score tiles and accumulators in shared
// memory, products on the FMA units at full precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [B*H, Lq]
  const float* lse_lo;  // [B*H, Lq] or null
  const float* delta;   // [B*H, Lq]
  const float* bias;   // [B, Lk] additive key bias, or null
  void* dq;
  void* dk;
  void* dv;
  long long sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h, sv_l, so_b, so_h, so_l;
  long long sdq_b, sdq_h, sdq_l, sdk_b, sdk_h, sdk_l, sdv_b, sdv_h, sdv_l;
  int H, Lq, Lk;
  float scale;
  int dropout;
  const uint32_t* seed;  // the dropout seed on the device (read when dropout)
  uint32_t b0, h0;
  int h_glob;
  uint32_t thresh;
  float keep_scale;
};

// fmix(seed ^ bh) with the GLOBAL bh of flattened instance n: the head of
// the forward's dropout stream, fmix(fmix(head ^ q row) ^ key)
__device__ __forceinline__ uint32_t head_hash(const Args& a, int n) {
  const uint32_t bh = (a.b0 + (uint32_t)(n / a.H)) * (uint32_t)a.h_glob + a.h0 +
                      (uint32_t)(n % a.H);
  return fmix32(__ldg(a.seed) ^ bh);
}

// ---------------------------------------------------------------------------
// bf16: the wgmma kernels

using bf16 = __nv_bfloat16;
constexpr int NTW = 256;  // two warpgroups

template <int D>
struct Cfg {
  static constexpr int BKV = 128;                 // keys per dkdv block
  static constexpr int BQ = D == 128 ? 32 : 64;   // q rows a dkdv ring stage
  static constexpr int BQB = 128;                 // q rows per dq block
  static constexpr int BK = 64;                   // keys a dq ring stage
  using KV = SwTile<D, BKV>;
  using QT = SwTile<D, BQ>;
  using QB = SwTile<D, BQB>;
  using KT = SwTile<D, BK>;
  // K, V | 2 x (Q, dO) | 2 x (lse, lse_lo, delta, hash) ; +1 KB to align
  static constexpr int dkdv_bytes = 2 * KV::BYTES + 4 * QT::BYTES + 2 * 4 * BQ * 4 + 1024;
  // Q, dO | 2 x (K, V) | 2 x key bias ; +1 KB to align
  static constexpr int dq_bytes = 2 * QB::BYTES + 4 * KT::BYTES + 2 * BK * 4 + 1024;
};

// rows r0 .. r0+R-1 of a (b, h) slice into a swizzled tile; rows past n
// are zero-filled (nothing is read for them)
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src, long long sl, int r0,
                                          int n, int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < R * CH; i += NTW) {
    const int r = i / CH, c = i % CH, g = r0 + r;
    const bf16* p = src + (long long)(g < n ? g : 0) * sl + 8 * c;
    cp_async16(tile + SwTile<D, R>::offset(r, c), p, g < n ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTW, 1) dkdv_kernel_sm90(const Args a) {
  using C = Cfg<D>;
  using KV = typename C::KV;
  using QT = typename C::QT;
  constexpr int BQ = C::BQ, NA = D / 2, NS = BQ / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + KV::BYTES;
  const uint32_t sQ = sV + KV::BYTES;        // 2 stages
  const uint32_t sO = sQ + 2 * QT::BYTES;    // 2 stages
  float* stats = reinterpret_cast<float*>(smem_raw + (sO + 2 * QT::BYTES - raw));

  const int n = blockIdx.x, k0 = blockIdx.y * C::BKV;
  const int b = n / a.H, h = n % a.H;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq_b + h * a.sq_h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk_b + h * a.sk_h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv_b + h * a.sv_h;
  const bf16* dout = static_cast<const bf16*>(a.dout) + b * a.so_b + h * a.so_h;
  const uint32_t hhead = a.dropout ? head_hash(a, n) : 0u;

  // q tile t into ring stage s: Q, dO, and lse / lse_lo / delta / row hash
  auto load_stage = [&](int t, int s) {
    const int q0 = t * BQ;
    load_tile<D, BQ>(sQ + s * QT::BYTES, q, a.sq_l, q0, a.Lq, tid);
    load_tile<D, BQ>(sO + s * QT::BYTES, dout, a.so_l, q0, a.Lq, tid);
    if (tid < BQ) {
      const int qr = q0 + tid;
      const bool ok = qr < a.Lq;
      const long long gi = (long long)n * a.Lq + (ok ? qr : 0);
      float* st = stats + s * 4 * BQ;
      // rows past Lq: lse = +inf, so p = 0 (zero-filled lse_lo / delta)
      if (ok)
        cp_async4(smem_u32(st + tid), a.lse + gi, 4);
      else
        st[tid] = pos_inf();
      cp_async4(smem_u32(st + BQ + tid), a.lse_lo ? a.lse_lo + gi : a.lse + gi,
                ok && a.lse_lo ? 4 : 0);
      cp_async4(smem_u32(st + 2 * BQ + tid), a.delta + gi, ok ? 4 : 0);
      reinterpret_cast<uint32_t*>(st)[3 * BQ + tid] = fmix32(hhead ^ (uint32_t)qr);
    }
  };

  load_tile<D, C::BKV>(sK, k, a.sk_l, k0, a.Lk, tid);
  load_tile<D, C::BKV>(sV, v, a.sv_l, k0, a.Lk, tid);
  load_stage(0, 0);
  cp_async_commit();

  // this thread's two key rows (accumulator rows 16w + l/4 and +8 of its
  // warpgroup's 64): bias, -inf past Lk
  int key_r[2];
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key_r[i] = k0 + 64 * wg + 16 * w + (l >> 2) + 8 * i;
    bias_r[i] = key_r[i] < a.Lk ? (a.bias ? a.bias[(long long)b * a.Lk + key_r[i]] : 0.f)
                                : neg_inf();
  }

  float dK[NA], dV[NA], S[NS], P[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) dK[i] = dV[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) S[i] = P[i] = 0.f;

  const int nq = (a.Lq + BQ - 1) / BQ;
  for (int t = 0; t < nq; ++t) {
    const int s = t & 1;
    cp_async_wait<0>();   // tile t (and, at t = 0, K and V) landed
    fence_proxy_async();
    __syncthreads();      // ... for every thread; stage s ^ 1 is free
    if (t + 1 < nq) load_stage(t + 1, s ^ 1);
    cp_async_commit();
    const uint32_t q_s = sQ + s * QT::BYTES, o_s = sO + s * QT::BYTES;

    // S^T = K.Q^T, dP^T = V.dO^T (this warpgroup's 64 keys x BQ q rows)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(S, KV::kmajor(sK, 64 * wg, kk), QT::kmajor(q_s, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::ss(P, KV::kmajor(sV, 64 * wg, kk), QT::kmajor(o_s, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    fence_regs(P);

    // elementwise, in registers: S <- pt, P <- ds
    const float* st = stats + s * 4 * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int col = 8 * j + 2 * (l & 3);
      const float2 lse2 = *reinterpret_cast<const float2*>(st + col);
      const float2 lo2 = *reinterpret_cast<const float2*>(st + BQ + col);
      const float2 dl2 = *reinterpret_cast<const float2*>(st + 2 * BQ + col);
      const uint2 hq2 = *reinterpret_cast<const uint2*>(st + 3 * BQ + col);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lse = c ? lse2.y : lse2.x, lo = c ? lo2.y : lo2.x;
        const float dl = c ? dl2.y : dl2.x;
        const uint32_t hq = c ? hq2.y : hq2.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          const float p = __expf((S[x] * a.scale + bias_r[i] - lse) - lo);
          if (a.dropout) {
            const float keep =
                fmix32(hq ^ (uint32_t)key_r[i]) < a.thresh ? a.keep_scale : 0.f;
            S[x] = p * keep;
            P[x] = p * fmaf(P[x], keep, -dl) * a.scale;
          } else {
            S[x] = p;
            P[x] = p * (P[x] - dl) * a.scale;
          }
        }
      }
    }
    // the m64k16 A fragment of k step kk is accumulator columns 16kk..+15
    uint32_t fp[BQ / 16][4], fs[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        fp[kk][r] = pack_bf16(S[8 * kk + 2 * r], S[8 * kk + 2 * r + 1]);
        fs[kk][r] = pack_bf16(P[8 * kk + 2 * r], P[8 * kk + 2 * r + 1]);
      }

    // dV += Pt^T.dO, dK += dS^T.Q (B read MN-major)
    fence_regs(dV);
    fence_regs(dK);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D>::rs(dV, fp[kk], QT::mnmajor(o_s, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D>::rs(dK, fs[kk], QT::mnmajor(q_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dV);
    fence_regs(dK);
  }

  bf16* dk = static_cast<bf16*>(a.dk) + b * a.sdk_b + h * a.sdk_h;
  bf16* dv = static_cast<bf16*>(a.dv) + b * a.sdv_b + h * a.sdv_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key_r[i] >= a.Lk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (l & 3), x = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(dk + key_r[i] * a.sdk_l + col) = pack_bf16(dK[x], dK[x + 1]);
      *reinterpret_cast<uint32_t*>(dv + key_r[i] * a.sdv_l + col) = pack_bf16(dV[x], dV[x + 1]);
    }
  }
}

// Two blocks an SM at D <= 64 (<= 128 registers a thread): the dq kernel
// hides its latencies with the second block; at D 128 its accumulators
// need more registers, and one block runs.
template <int D>
__global__ void __launch_bounds__(NTW, D <= 64 ? 2 : 1) dq_kernel_sm90(const Args a) {
  using C = Cfg<D>;
  using QB = typename C::QB;
  using KT = typename C::KT;
  constexpr int BK = C::BK, NA = D / 2, NS = BK / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sO = sQ + QB::BYTES;
  const uint32_t sK = sO + QB::BYTES;        // 2 stages
  const uint32_t sV = sK + 2 * KT::BYTES;    // 2 stages
  float* bias_s = reinterpret_cast<float*>(smem_raw + (sV + 2 * KT::BYTES - raw));

  const int n = blockIdx.x, q0 = blockIdx.y * C::BQB;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3, l = tid & 31;

  // key tile t into ring stage s: K, V and the key bias (-inf past Lk).
  // The operand pointers are rebuilt here, so none holds registers across
  // the loop.
  auto load_stage = [&](int t, int s) {
    const int b = n / a.H, h = n % a.H, k0 = t * BK;
    load_tile<D, BK>(sK + s * KT::BYTES,
                     static_cast<const bf16*>(a.k) + b * a.sk_b + h * a.sk_h, a.sk_l, k0,
                     a.Lk, tid);
    load_tile<D, BK>(sV + s * KT::BYTES,
                     static_cast<const bf16*>(a.v) + b * a.sv_b + h * a.sv_h, a.sv_l, k0,
                     a.Lk, tid);
    if (tid < BK) {
      const int kc = k0 + tid;
      float* dst = bias_s + s * BK + tid;
      if (kc >= a.Lk)
        *dst = neg_inf();   // keys past Lk: p = 0
      else if (a.bias)
        cp_async4(smem_u32(dst), a.bias + (long long)b * a.Lk + kc, 4);
      else
        *dst = 0.f;
    }
  };

  {
    const int b = n / a.H, h = n % a.H;
    load_tile<D, C::BQB>(sQ, static_cast<const bf16*>(a.q) + b * a.sq_b + h * a.sq_h, a.sq_l,
                         q0, a.Lq, tid);
    load_tile<D, C::BQB>(sO, static_cast<const bf16*>(a.dout) + b * a.so_b + h * a.so_h,
                         a.so_l, q0, a.Lq, tid);
  }
  load_stage(0, 0);
  cp_async_commit();

  // this thread's two q rows: statistics in registers; rows past Lq get
  // lse = +inf, so p = 0
  const uint32_t hhead = a.dropout ? head_hash(a, n) : 0u;
  const int row0 = q0 + 64 * wg + 16 * w + (l >> 2);
  float lse_r[2], lo_r[2], dl_r[2];
  uint32_t hq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    const bool ok = qr < a.Lq;
    const long long gi = (long long)n * a.Lq + qr;
    lse_r[i] = ok ? a.lse[gi] : pos_inf();
    lo_r[i] = ok && a.lse_lo ? a.lse_lo[gi] : 0.f;
    dl_r[i] = ok ? a.delta[gi] : 0.f;
    hq_r[i] = fmix32(hhead ^ (uint32_t)qr);
  }

  float dQ[NA], S[NS], P[NS];
#pragma unroll
  for (int i = 0; i < NA; ++i) dQ[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) S[i] = P[i] = 0.f;

  const int nk = (a.Lk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int s = t & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < nk) load_stage(t + 1, s ^ 1);
    cp_async_commit();
    const uint32_t k_s = sK + s * KT::BYTES, v_s = sV + s * KT::BYTES;

    // S = Q.K^T, dP = dO.V^T (this warpgroup's 64 q rows x BK keys)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(S, QB::kmajor(sQ, 64 * wg, kk), KT::kmajor(k_s, 0, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::ss(P, QB::kmajor(sO, 64 * wg, kk), KT::kmajor(v_s, 0, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(S);
    fence_regs(P);

    const float* bs = bias_s + s * BK;
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = 8 * j + 2 * (l & 3);
      const float2 bias2 = *reinterpret_cast<const float2*>(bs + col);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const uint32_t key = k0 + col + c;
        const float bias = c ? bias2.y : bias2.x;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i + c;
          const float p = __expf((S[x] * a.scale + bias - lse_r[i]) - lo_r[i]);
          if (a.dropout) {
            const float keep = fmix32(hq_r[i] ^ key) < a.thresh ? a.keep_scale : 0.f;
            P[x] = p * fmaf(P[x], keep, -dl_r[i]) * a.scale;
          } else {
            P[x] = p * (P[x] - dl_r[i]) * a.scale;
          }
        }
      }
    }
    uint32_t fs[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) fs[kk][r] = pack_bf16(P[8 * kk + 2 * r], P[8 * kk + 2 * r + 1]);

    // dQ += dS.K (B = the K tile read MN-major)
    fence_regs(dQ);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::rs(dQ, fs[kk], KT::mnmajor(k_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dQ);
  }

  bf16* dq = static_cast<bf16*>(a.dq) + (n / a.H) * a.sdq_b + (n % a.H) * a.sdq_h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = row0 + 8 * i;
    if (qr >= a.Lq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (l & 3), x = 4 * j + 2 * i;
      *reinterpret_cast<uint32_t*>(dq + qr * a.sdq_l + col) = pack_bf16(dQ[x], dQ[x + 1]);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a, int N, cudaStream_t stream) {
  using C = Cfg<D>;
  static int dkdv_set[FDT_MAX_DEVICES], dq_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(dkdv_kernel_sm90<D>, C::dkdv_bytes, dkdv_set);
  if (err != cudaSuccess) return err;
  err = smem_attr_once(dq_kernel_sm90<D>, C::dq_bytes, dq_set);
  if (err != cudaSuccess) return err;
  dkdv_kernel_sm90<D><<<dim3(N, (a.Lk + C::BKV - 1) / C::BKV), NTW, C::dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel_sm90<D><<<dim3(N, (a.Lq + C::BQB - 1) / C::BQB), NTW, C::dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: the FMA kernels

constexpr int BQ = 64;   // q rows per tile
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads: 4 warps x 16 rows

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <int D>
struct Tile {
  // rows get one pad element (conflict-free column walks)
  static constexpr int QS = D + 1;    // q/k/v/dO row stride
  static constexpr int PS = BK + 1;   // pt/ds row stride
  static constexpr int SS = BK + 4;   // s/dp row stride
  static constexpr int AS = D + 4;    // accumulator stride
  static constexpr size_t op = align128((size_t)64 * QS * sizeof(float));   // one operand tile
  static constexpr size_t pt = align128((size_t)BQ * PS * sizeof(float));   // pt or ds tile
  static constexpr size_t sc = align128((size_t)BQ * SS * sizeof(float));
  static constexpr size_t acc = align128((size_t)64 * AS * sizeof(float));
  static constexpr size_t vec = align128((size_t)64 * sizeof(float));
  // dkdv: K, V, Q, dO | pt, ds | s, dp | dK, dV | lse, lse_lo, delta, bias
  static constexpr size_t dkdv_bytes = 4 * op + 2 * pt + 2 * sc + 2 * acc + 4 * vec;
  // dq: Q, dO, K, V | ds | s, dp | dQ | lse, lse_lo, delta, bias
  static constexpr size_t dq_bytes = 4 * op + pt + 2 * sc + acc + 4 * vec;
};

// Out[16 rows of this warp][BK] = A[rows] . B[BK rows]^T
template <int D>
__device__ __forceinline__ void rows_dot(const float* A, const float* B, float* Out, int warp,
                                         int lane) {
  using L = Tile<D>;
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float b0 = B[lane * L::QS + d];
    const float b1 = B[(lane + 32) * L::QS + d];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float x = A[(16 * warp + r) * L::QS + d];
      acc[r][0] = fmaf(x, b0, acc[r][0]);
      acc[r][1] = fmaf(x, b1, acc[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    Out[(16 * warp + r) * L::SS + lane] = acc[r][0];
    Out[(16 * warp + r) * L::SS + lane + 32] = acc[r][1];
  }
}

// Acc[16 rows of this warp][D] += P[rows][64] . B[64][D]     (trans false)
// Acc[16 key rows of this warp][D] += sum_q P[q][key] . B[q][D]  (P^T . B)
template <int D, bool kTrans>
__device__ __forceinline__ void acc_prod(const float* P, const float* B, float* Acc, int warp,
                                         int lane) {
  using L = Tile<D>;
  constexpr int TD = (D + 31) / 32;
  float acc[16][TD];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int d = lane + 32 * t;
      acc[r][t] = d < D ? Acc[(16 * warp + r) * L::AS + d] : 0.f;
    }
  for (int c = 0; c < 64; ++c) {
    float bv[TD];
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int d = lane + 32 * t;
      bv[t] = d < D ? B[c * L::QS + d] : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float p = kTrans ? P[c * L::PS + 16 * warp + r] : P[(16 * warp + r) * L::PS + c];
#pragma unroll
      for (int t = 0; t < TD; ++t) acc[r][t] = fmaf(p, bv[t], acc[r][t]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < TD; ++t) {
      const int d = lane + 32 * t;
      if (d < D) Acc[(16 * warp + r) * L::AS + d] = acc[r][t];
    }
}

// rows [r0, r0+64) of a (b, h) slice into a shared tile; rows past n are 0
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long sl, int r0,
                                          int n, int tid) {
  using L = Tile<D>;
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, g = r0 + r;
    dst[r * L::QS + d] = g < n ? src[g * sl + d] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float* src, long long sl, int r0,
                                           int n, int tid) {
  using L = Tile<D>;
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, d = i % D, g = r0 + r;
    if (g < n) dst[g * sl + d] = src[r * L::AS + d];
  }
}

// The elementwise phase of one (q tile, k tile): thread pair (row, half)
// owns 32 columns of q row `row` (a row of its own warp).  Writes ds and,
// when Pt is given, pt.
template <int D>
__device__ __forceinline__ void grad_scores(const Args& a, int n, int q0, int k0,
                                            const float* Ss, const float* dPs,
                                            const float* lse_s, const float* lo_s,
                                            const float* dl_s, const float* bias_s, float* Pt,
                                            float* dS, int tid) {
  using L = Tile<D>;
  const int row = tid >> 1, half = tid & 1;
  const float lse_r = lse_s[row], lo_r = lo_s[row], dl = dl_s[row];
  const uint32_t hq = a.dropout ? fmix32(head_hash(a, n) ^ (uint32_t)(q0 + row)) : 0u;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const int c = half * 32 + j;
    const float s = Ss[row * L::SS + c] * a.scale + bias_s[c];
    const float p = expf((s - lse_r) - lo_r);
    float dp = dPs[row * L::SS + c];
    float pt = p;
    if (a.dropout) {
      const float keep = fmix32(hq ^ (uint32_t)(k0 + c)) < a.thresh ? a.keep_scale : 0.f;
      pt = p * keep;
      dp = dp * keep;
    }
    const float ds = p * (dp - dl) * a.scale;
    if (Pt) Pt[row * L::PS + c] = pt;
    dS[row * L::PS + c] = ds;
  }
}

__device__ __forceinline__ void load_stats(const Args& a, int n, int q0, float* lse_s,
                                           float* lo_s, float* dl_s, int tid) {
  if (tid < BQ) {
    const int qr = q0 + tid;
    const bool ok = qr < a.Lq;
    // rows past Lq get lse = +inf, so p = 0 and they add nothing
    lse_s[tid] = ok ? a.lse[(long long)n * a.Lq + qr] : pos_inf();
    lo_s[tid] = ok && a.lse_lo ? a.lse_lo[(long long)n * a.Lq + qr] : 0.f;
    dl_s[tid] = ok ? a.delta[(long long)n * a.Lq + qr] : 0.f;
  }
}

__device__ __forceinline__ void load_bias(const Args& a, const float* bias_row, int k0,
                                          float* bias_s, int tid) {
  if (tid < BK) {
    const int kc = k0 + tid;
    // keys past Lk carry bias -inf and drop out of every row
    bias_s[tid] = kc < a.Lk ? (bias_row ? bias_row[kc] : 0.f) : neg_inf();
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const Args a) {
  using L = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* Ks = reinterpret_cast<float*>(p); p += L::op;
  float* Vs = reinterpret_cast<float*>(p); p += L::op;
  float* Qs = reinterpret_cast<float*>(p); p += L::op;
  float* dOs = reinterpret_cast<float*>(p); p += L::op;
  float* Pt = reinterpret_cast<float*>(p); p += L::pt;
  float* dS = reinterpret_cast<float*>(p); p += L::pt;
  float* Ss = reinterpret_cast<float*>(p); p += L::sc;
  float* dPs = reinterpret_cast<float*>(p); p += L::sc;
  float* dKa = reinterpret_cast<float*>(p); p += L::acc;
  float* dVa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p); p += L::vec;
  float* lo_s = reinterpret_cast<float*>(p); p += L::vec;
  float* dl_s = reinterpret_cast<float*>(p); p += L::vec;
  float* bias_s = reinterpret_cast<float*>(p);

  const int n = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int b = n / a.H, h = n % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;
  const float* dout = static_cast<const float*>(a.dout) + b * a.so_b + h * a.so_h;

  load_rows<D>(Ks, k, a.sk_l, k0, a.Lk, tid);
  load_rows<D>(Vs, v, a.sv_l, k0, a.Lk, tid);
  load_bias(a, a.bias ? a.bias + (long long)b * a.Lk : nullptr, k0, bias_s, tid);
  for (int i = tid; i < 64 * L::AS; i += NT) dKa[i] = dVa[i] = 0.f;

  for (int q0 = 0; q0 < a.Lq; q0 += BQ) {
    __syncthreads();  // the previous q tile's products are done with Q/dO/pt/ds
    load_rows<D>(Qs, q, a.sq_l, q0, a.Lq, tid);
    load_rows<D>(dOs, dout, a.so_l, q0, a.Lq, tid);
    load_stats(a, n, q0, lse_s, lo_s, dl_s, tid);
    __syncthreads();
    rows_dot<D>(Qs, Ks, Ss, warp, lane);    // s  (this warp's q rows)
    rows_dot<D>(dOs, Vs, dPs, warp, lane);  // dp (this warp's q rows)
    __syncwarp();
    grad_scores<D>(a, n, q0, k0, Ss, dPs, lse_s, lo_s, dl_s, bias_s, Pt, dS, tid);
    __syncthreads();  // the transposed products read every warp's rows
    acc_prod<D, true>(Pt, dOs, dVa, warp, lane);    // dv += pt^T dO
    acc_prod<D, true>(dS, Qs, dKa, warp, lane);     // dk += ds^T q
  }
  __syncthreads();
  float* dk = static_cast<float*>(a.dk) + b * a.sdk_b + h * a.sdk_h;
  float* dv = static_cast<float*>(a.dv) + b * a.sdv_b + h * a.sdv_h;
  store_rows<D>(dk, dKa, a.sdk_l, k0, a.Lk, tid);
  store_rows<D>(dv, dVa, a.sdv_l, k0, a.Lk, tid);
}

template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(const Args a) {
  using L = Tile<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  float* Qs = reinterpret_cast<float*>(p); p += L::op;
  float* dOs = reinterpret_cast<float*>(p); p += L::op;
  float* Ks = reinterpret_cast<float*>(p); p += L::op;
  float* Vs = reinterpret_cast<float*>(p); p += L::op;
  float* dS = reinterpret_cast<float*>(p); p += L::pt;
  float* Ss = reinterpret_cast<float*>(p); p += L::sc;
  float* dPs = reinterpret_cast<float*>(p); p += L::sc;
  float* dQa = reinterpret_cast<float*>(p); p += L::acc;
  float* lse_s = reinterpret_cast<float*>(p); p += L::vec;
  float* lo_s = reinterpret_cast<float*>(p); p += L::vec;
  float* dl_s = reinterpret_cast<float*>(p); p += L::vec;
  float* bias_s = reinterpret_cast<float*>(p);

  const int n = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int b = n / a.H, h = n % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* q = static_cast<const float*>(a.q) + b * a.sq_b + h * a.sq_h;
  const float* k = static_cast<const float*>(a.k) + b * a.sk_b + h * a.sk_h;
  const float* v = static_cast<const float*>(a.v) + b * a.sv_b + h * a.sv_h;
  const float* dout = static_cast<const float*>(a.dout) + b * a.so_b + h * a.so_h;
  const float* bias_row = a.bias ? a.bias + (long long)b * a.Lk : nullptr;

  load_rows<D>(Qs, q, a.sq_l, q0, a.Lq, tid);
  load_rows<D>(dOs, dout, a.so_l, q0, a.Lq, tid);
  load_stats(a, n, q0, lse_s, lo_s, dl_s, tid);
  for (int i = tid; i < 64 * L::AS; i += NT) dQa[i] = 0.f;

  for (int k0 = 0; k0 < a.Lk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, k, a.sk_l, k0, a.Lk, tid);
    load_rows<D>(Vs, v, a.sv_l, k0, a.Lk, tid);
    load_bias(a, bias_row, k0, bias_s, tid);
    __syncthreads();
    rows_dot<D>(Qs, Ks, Ss, warp, lane);
    rows_dot<D>(dOs, Vs, dPs, warp, lane);
    __syncwarp();
    grad_scores<D>(a, n, q0, k0, Ss, dPs, lse_s, lo_s, dl_s, bias_s, nullptr, dS, tid);
    __syncwarp();
    acc_prod<D, false>(dS, Ks, dQa, warp, lane);  // dq += ds k (this warp's rows)
  }
  __syncthreads();
  float* dq = static_cast<float*>(a.dq) + b * a.sdq_b + h * a.sdq_h;
  store_rows<D>(dq, dQa, a.sdq_l, q0, a.Lq, tid);
}

template <int D>
cudaError_t launch_f32(const Args& a, int N, cudaStream_t stream) {
  using L = Tile<D>;
  static int dkdv_set[FDT_MAX_DEVICES], dq_set[FDT_MAX_DEVICES];
  cudaError_t err = smem_attr_once(dkdv_kernel<D>, (int)L::dkdv_bytes, dkdv_set);
  if (err != cudaSuccess) return err;
  err = smem_attr_once(dq_kernel<D>, (int)L::dq_bytes, dq_set);
  if (err != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(N, (a.Lk + BK - 1) / BK), NT, L::dkdv_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<dim3(N, (a.Lq + BQ - 1) / BQ), NT, L::dq_bytes, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// Largest head dim the backward takes for dtype (0 = fp32, 1 = bf16): the
// fp32 dkdv kernel's shared memory (K, V, Q, dO tiles plus two fp32
// accumulators) outgrows a block's 227 KB at D = 128.
int fdt_flash_bwd_max_head_dim(int dtype) { return dtype == 1 ? 128 : 64; }

// Dynamic shared memory of the bf16 kernels at head dim D (kernel 0: dkdv,
// 1: dq), or 0 for a head dim they do not take.
int fdt_flash_bwd_smem_bytes(int D, int kernel) {
  switch (D) {
    case 16: return kernel ? Cfg<16>::dq_bytes : Cfg<16>::dkdv_bytes;
    case 32: return kernel ? Cfg<32>::dq_bytes : Cfg<32>::dkdv_bytes;
    case 64: return kernel ? Cfg<64>::dq_bytes : Cfg<64>::dkdv_bytes;
    case 128: return kernel ? Cfg<128>::dq_bytes : Cfg<128>::dkdv_bytes;
    default: return 0;
  }
}

// seed: the dropout seed, a u32 on the device (null without dropout).
// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; lse, lse_lo
// (or null) and delta are contiguous [B*H, Lq] fp32; bias is [B, Lk] fp32
// or null.  bf16 tensors must have 16-byte-aligned bases and (b, h, l)
// strides that are multiples of 8 (16-byte cp.async rows).
// Launches the dkdv kernel, then the dq kernel, on `stream`.
int fdt_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* lse_lo, const void* delta, const void* bias,
                  void* dq, void* dk,
                  void* dv, int dtype, int B, int H, int Lq, int Lk, int D, long long sq_b,
                  long long sq_h, long long sq_l, long long sk_b, long long sk_h,
                  long long sk_l, long long sv_b, long long sv_h, long long sv_l,
                  long long so_b, long long so_h, long long so_l, long long sdq_b,
                  long long sdq_h, long long sdq_l, long long sdk_b, long long sdk_h,
                  long long sdk_l, long long sdv_b, long long sdv_h, long long sdv_l,
                  float scale, int dropout, const void* seed, unsigned int b0,
                  unsigned int h0, int h_glob, unsigned int thresh, float keep_scale,
                  void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.lse_lo = static_cast<const float*>(lse_lo);
  a.delta = static_cast<const float*>(delta);
  a.bias = static_cast<const float*>(bias);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.sq_b = sq_b; a.sq_h = sq_h; a.sq_l = sq_l;
  a.sk_b = sk_b; a.sk_h = sk_h; a.sk_l = sk_l;
  a.sv_b = sv_b; a.sv_h = sv_h; a.sv_l = sv_l;
  a.so_b = so_b; a.so_h = so_h; a.so_l = so_l;
  a.sdq_b = sdq_b; a.sdq_h = sdq_h; a.sdq_l = sdq_l;
  a.sdk_b = sdk_b; a.sdk_h = sdk_h; a.sdk_l = sdk_l;
  a.sdv_b = sdv_b; a.sdv_h = sdv_h; a.sdv_l = sdv_l;
  a.H = H;
  a.Lq = Lq;
  a.Lk = Lk;
  a.scale = scale;
  a.dropout = dropout;
  a.seed = static_cast<const uint32_t*>(seed);
  a.b0 = b0;
  a.h0 = h0;
  a.h_glob = h_glob;
  a.thresh = thresh;
  a.keep_scale = keep_scale;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || (dropout && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  if (D > fdt_flash_bwd_max_head_dim(dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const long long strides[] = {sq_b, sq_h, sq_l, sk_b, sk_h, sk_l, sv_b, sv_h, sv_l,
                                 so_b, so_h, so_l, sdq_b, sdq_h, sdq_l, sdk_b, sdk_h,
                                 sdk_l, sdv_b, sdv_h, sdv_l};
    for (long long st : strides)
      if (st % 8) return (int)cudaErrorMisalignedAddress;
    const void* ptrs[] = {q, k, v, dout, dq, dk, dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
    switch (D) {
      case 16: return (int)launch_bf16<16>(a, B * H, s);
      case 32: return (int)launch_bf16<32>(a, B * H, s);
      case 64: return (int)launch_bf16<64>(a, B * H, s);
      case 128: return (int)launch_bf16<128>(a, B * H, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return (int)launch_f32<16>(a, B * H, s);
    case 32: return (int)launch_f32<32>(a, B * H, s);
    case 64: return (int)launch_f32<64>(a, B * H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fdt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
