// Flash attention backward on Hopper's tensor cores (sm_90a), bf16: the dq
// and dk/dv kernels, CUDA C++ with a plain C interface (bound with ctypes
// from kernels/flash_attention.py). The fp32 route stays on the CUDA-core
// kernels of flash_bwd.cu: wgmma would read fp32 operands as TF32.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_dq_kernel` (:145,
// launched at :236) and `_dkv_kernel` (:182, launched at :254). The
// arithmetic is theirs: s = (q.k) * scale*LOG2E in fp32 from bf16 operands,
// causal/ragged entries give p = 0, p = exp2(s - lse) against the saved
// log2-domain LSE, dp = dO.v in fp32, ds = p * (dp - delta) * scale rounded
// to bf16, dV += round(p)^T.dO, dK += ds^T.q, dQ += ds.k, fp32 sums, bf16
// outputs. delta = rowsum(dO*O) comes from the wrapper.
//
// What bounds it on the H100: operations. At B16 S2048 H16 D128 causal the
// bound is 0.4171 ms for dq (3 products of S*S/2*D per head) and 0.5561 ms
// for dk/dv (4 products) at 989 TFLOP/s; the bytes moved are ~100x fewer.
// So every product runs on the tensor cores:
//  * wgmma m64nNk16, bf16 operands, fp32 accumulators in registers; one
//    consumer warpgroup (128 threads) per block owns 64 rows;
//  * tiles arrive by TMA (cp.async.bulk.tensor, box 64 rows x 64 features,
//    128-byte swizzle, completion on an mbarrier) into a 2-stage ring: the
//    block's first thread issues tile t+1 before the warpgroup computes on
//    tile t. Rows past S arrive as zeros (TMA's out-of-bounds fill) and are
//    masked in registers;
//  * the scores and dP come from shared memory with both operands K-major
//    (features contiguous); P and dS never leave registers: the fp32
//    accumulator fragment of an m64n64 product, packed to bf16 pairs, is
//    the register A operand of the next product, whose B (K, Q or dO as
//    [rows x features]) is MN-major, read with wgmma's transpose flag.
//
//  * dq: one block per (b*h, 64-row query tile), heaviest causal tiles
//    launched first; Q and dO load once, K/V tiles stream up to the
//    diagonal: S = Q K^T and dP = dO V^T, then dQ += dS K.
//  * dk/dv: one block per (b, KV head, 64-key tile); K and V load once, the
//    loop runs over the H/Hkv query heads of the group and, for each, over
//    the query tiles from the diagonal on: S^T = K Q^T and dP^T = V dO^T,
//    then dV += P^T dO and dK += dS^T Q. GQA's sum lands in the same
//    registers. Neither kernel uses atomics: both are deterministic.
//
// q/k/v may be column slices of the fused qkv projection: each gets a 4-d
// tensor map (features, heads, sequence, batch) over its own strides, which
// the wrapper checks are 16-byte multiples. The tensor-map encoder is
// looked up at run time (cuTensorMapEncodeTiled's entry point), so the
// build needs no -lcuda. These building blocks (mbarriers, TMA, wgmma,
// fences, tensor maps) are in sm90.cuh, shared with flash_fwd_sm90.cu.

#include "sm90.cuh"

namespace {

constexpr int BARS = 3 * 8;    // three mbarriers at the end of the tiles

template <int D> constexpr size_t smem_bytes() {
  return 6 * tile_bytes<D>() + BARS + 1024;  // + slack for 1024-alignment
}

// ---- dq -----------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int S,
    int H, int Hkv, float scale, float scale_log2, int causal) {
  constexpr int T = tile_bytes<D>(), KS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = base + T;
  auto sK = [&](int s) { return base + (2 + 2 * s) * T; };
  auto sV = [&](int s) { return base + (3 + 2 * s) * T; };
  const uint32_t bar = base + 6 * T;  // [0] Q/dO, [1 + s] K/V stage s

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4,
            t4 = tid % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / (H / Hkv);
  const int kv_end = causal ? min(S, q0 + BR) : S;
  const int nkt = (kv_end + BR - 1) / BR;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * T);
    load_tile<D>(&tm_q, sQ, bar, h, q0, b);
    load_tile<D>(&tm_do, sdO, bar, h, q0, b);
    mbar_expect_tx(bar + 8, 2 * T);
    load_tile<D>(&tm_k, sK(0), bar + 8, hk, 0, b);
    load_tile<D>(&tm_v, sV(0), bar + 8, hk, 0, b);
  }

  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse_r[i] = row < S ? lse[(long long)bh * S + row] : 0.f;
    delta_r[i] = row < S ? delta[(long long)bh * S + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar, 0);
  for (int it = 0; it < nkt; ++it) {
    const int s = it & 1;
    if (tid == 0 && it + 1 < nkt) {  // stage s^1 was released last iteration
      const uint32_t nb = bar + 8 * (2 - s);
      mbar_expect_tx(nb, 2 * T);
      load_tile<D>(&tm_k, sK(s ^ 1), nb, hk, (it + 1) * BR, b);
      load_tile<D>(&tm_v, sV(s ^ 1), nb, hk, (it + 1) * BR, b);
    }
    mbar_wait(bar + 8 * (1 + s), (it >> 1) & 1);

    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, desc_k(sQ, kk), desc_k(sK(s), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, desc_k(sdO, kk), desc_k(sV(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

    const int k0 = it * BR;
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int i = (idx >> 1) & 1, row = r0 + 8 * i;
      const int col = k0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
      const bool valid = row < S && col < S && (!causal || row >= col);
      sc[idx] = valid ? exp2f(sc[idx] * scale_log2 - lse_r[i]) : 0.f;
    }
    wgmma_wait<0>();
    fence_acc(dp);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx)
      dp[idx] = sc[idx] * (dp[idx] - delta_r[(idx >> 1) & 1]) * scale;
    uint32_t ds[4][4];
    to_frag(dp, ds);
    fence_frag(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc, ds[kk], desc_mn(sK(s), kk));  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every warp is done with stage s
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < S)
        *reinterpret_cast<uint32_t*>(
            dq + (((long long)b * S + row) * H + h) * D + 8 * j + 2 * t4) =
            pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
}

// ---- dk/dv --------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int S, int H, int Hkv, float scale,
    float scale_log2, int causal) {
  constexpr int T = tile_bytes<D>(), KS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base, sV = base + T;
  auto sQ = [&](int s) { return base + (2 + 2 * s) * T; };
  auto sdO = [&](int s) { return base + (3 + 2 * s) * T; };
  const uint32_t bar = base + 6 * T;  // [0] K/V, [1 + s] Q/dO stage s

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4,
            t4 = tid % 4;
  const int kt = blockIdx.x, k0 = kt * BR;
  const int bkv = blockIdx.y, b = bkv / Hkv, hk = bkv % Hkv, rep = H / Hkv;
  // causal: query tiles that end before this key tile contribute nothing
  const int qt_lo = causal ? kt : 0;
  const int nq = (S + BR - 1) / BR - qt_lo, total = rep * nq;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * T);
    load_tile<D>(&tm_k, sK, bar, hk, k0, b);
    load_tile<D>(&tm_v, sV, bar, hk, k0, b);
    mbar_expect_tx(bar + 8, 2 * T);
    load_tile<D>(&tm_q, sQ(0), bar + 8, hk * rep, qt_lo * BR, b);
    load_tile<D>(&tm_do, sdO(0), bar + 8, hk * rep, qt_lo * BR, b);
  }

  const int kr0 = k0 + 16 * warp + g;  // this thread's keys: kr0, kr0 + 8
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(bar, 0);
  for (int it = 0; it < total; ++it) {
    const int s = it & 1;
    const int hh = it / nq, q0 = (qt_lo + it - hh * nq) * BR;
    const long long bh = (long long)b * H + hk * rep + hh;
    if (tid == 0 && it + 1 < total) {  // stage s^1 was released last iteration
      const int hn = (it + 1) / nq, qn = (qt_lo + it + 1 - hn * nq) * BR;
      const uint32_t nb = bar + 8 * (2 - s);
      mbar_expect_tx(nb, 2 * T);
      load_tile<D>(&tm_q, sQ(s ^ 1), nb, hk * rep + hn, qn, b);
      load_tile<D>(&tm_do, sdO(s ^ 1), nb, hk * rep + hn, qn, b);
    }
    // the LSE and delta of this thread's 16 query columns
    float lse_c[16], dl_c[16];
#pragma unroll
    for (int ci = 0; ci < 16; ++ci) {
      const int col = q0 + 8 * (ci >> 1) + 2 * t4 + (ci & 1);
      lse_c[ci] = col < S ? lse[bh * S + col] : 0.f;
      dl_c[ci] = col < S ? delta[bh * S + col] : 0.f;
    }
    mbar_wait(bar + 8 * (1 + s), (it >> 1) & 1);

    float sc[32], dp[32];  // S^T and dP^T: key rows x query columns
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, desc_k(sK, kk), desc_k(sQ(s), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(dp, desc_k(sV, kk), desc_k(sdO(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(sc);

#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int key = kr0 + 8 * ((idx >> 1) & 1);
      const int ci = 2 * (idx >> 2) + (idx & 1), col = q0 + 8 * (idx >> 2)
                                                         + 2 * t4 + (idx & 1);
      const bool valid = col < S && key < S && (!causal || col >= key);
      sc[idx] = valid ? exp2f(sc[idx] * scale_log2 - lse_c[ci]) : 0.f;
    }
    uint32_t pf[4][4];
    to_frag(sc, pf);
    fence_frag(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc_dv, pf[kk], desc_mn(sdO(s), kk));  // dV += P^T dO
    wgmma_commit();
    wgmma_wait<1>();  // dP^T is done; dV may still run
    fence_acc(dp);
#pragma unroll
    for (int idx = 0; idx < 32; ++idx)
      dp[idx] = sc[idx] * (dp[idx] - dl_c[2 * (idx >> 2) + (idx & 1)]) * scale;
    uint32_t ds[4][4];
    to_frag(dp, ds);
    fence_frag(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc_dk, ds[kk], desc_mn(sQ(s), kk));  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc_dv);
    fence_acc(acc_dk);
    __syncthreads();  // every warp is done with stage s
  }

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = kr0 + 8 * i;
      if (row < S) {
        const long long off =
            (((long long)b * S + row) * Hkv + hk) * D + 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(acc_dk[4 * j + 2 * i], acc_dk[4 * j + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(acc_dv[4 * j + 2 * i], acc_dv[4 * j + 2 * i + 1]);
      }
    }
}

// ---- host side ----------------------------------------------------------
struct Maps {
  CUtensorMap q, k, v, dout;
};

bool make_maps(Maps* m, const void* q, const void* k, const void* v,
               const void* dout, int B, int S, int H, int Hkv, int D,
               long long q_sb, long long q_ss, long long k_sb, long long k_ss,
               long long v_sb, long long v_ss) {
  const long long o_ss = (long long)H * D;
  return make_map(&m->q, q, B, S, H, D, q_sb, q_ss) &&
         make_map(&m->k, k, B, S, Hkv, D, k_sb, k_ss) &&
         make_map(&m->v, v, B, S, Hkv, D, v_sb, v_ss) &&
         make_map(&m->dout, dout, B, S, H, D, S * o_ss, o_ss);
}

template <int D>
cudaError_t launch_dq(const Maps& m, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int Hkv, float scale,
                      float scale_log2, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BR - 1) / BR, B * H);
  flash_bwd_dq_sm90_kernel<D><<<grid, NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, S, H, Hkv, scale, scale_log2, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Maps& m, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int Hkv,
                       float scale, float scale_log2, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BR - 1) / BR, B * Hkv);
  flash_bwd_dkv_sm90_kernel<D><<<grid, NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, H, Hkv, scale, scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. q/k/v: [B, S, H(kv), D] with the given batch/seq strides
// (elements, 16-byte multiples; 16-byte aligned bases), packed heads and
// unit feature stride; dout: [B, S, H, D] contiguous; lse/delta: [B*H, S]
// fp32 (lse in the log2 domain). dq: [B, S, H, D] contiguous. Returns the
// CUDA error code (cudaErrorInvalidValue when a tensor map is refused or D
// is not 64 or 128).
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int B, int S,
                                 int H, int Hkv, int D, long long q_sb,
                                 long long q_ss, long long k_sb,
                                 long long k_ss, long long v_sb,
                                 long long v_ss, float scale,
                                 float scale_log2, int causal, void* stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, S, H, Hkv, D, q_sb, q_ss, k_sb, k_ss,
                 v_sb, v_ss))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return (int)launch_dq<64>(m, lse, delta, dq, B, S, H, Hkv, scale,
                              scale_log2, causal, s);
  if (D == 128)
    return (int)launch_dq<128>(m, lse, delta, dq, B, S, H, Hkv, scale,
                               scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_sm90; dk/dv: [B, S, Hkv, D] contiguous, summed over the
// H/Hkv query heads of each KV head.
extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int B, int S, int H, int Hkv, int D,
                                  long long q_sb, long long q_ss,
                                  long long k_sb, long long k_ss,
                                  long long v_sb, long long v_ss, float scale,
                                  float scale_log2, int causal, void* stream) {
  Maps m;
  if (!make_maps(&m, q, k, v, dout, B, S, H, Hkv, D, q_sb, q_ss, k_sb, k_ss,
                 v_sb, v_ss))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return (int)launch_dkv<64>(m, lse, delta, dk, dv, B, S, H, Hkv, scale,
                               scale_log2, causal, s);
  if (D == 128)
    return (int)launch_dkv<128>(m, lse, delta, dk, dv, B, S, H, Hkv, scale,
                                scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}
