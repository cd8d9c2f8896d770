// Flash attention forward on Hopper's tensor cores (sm_90a), bf16: CUDA
// C++ with a plain C interface (bound with ctypes from
// kernels/flash_attention.py). The fp32 route stays on the CUDA-core kernel
// of flash_fwd.cu: wgmma would read fp32 operands as TF32.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (:44,
// launched by `_fwd` at :111). The arithmetic is its own: s = (q.k) *
// scale*LOG2E in fp32 from bf16 operands, causal entries and keys past S
// masked to NEG_INF, the online max m and sum l kept in the exp2 domain, P
// rounded to bf16 against the running max before P.V, fp32 sums, a row sum
// of 0 divided by 1. O is written in q's dtype as [B, S, H, D], the
// log2-domain LSE m + log2(l) as [B*H, S] fp32: exactly what flash_fwd.cu
// emits, so the backward and save_flash take the outputs unchanged.
//
// What bounds it on the H100: operations. At B16 S2048 H16 D128 causal the
// two products are 4*D*pairs*B*H = 275 GFLOP, 0.2781 ms at 989 TFLOP/s,
// against 0.54 GB of inputs and outputs (0.16 ms at 3.35 TB/s). So both
// products run on the tensor cores, on the design of flash_bwd_sm90.cu's
// dq kernel (the forward is dq less one product):
//  * one block per (b*h, 64-row query tile), one warpgroup (128 threads),
//    heaviest causal tiles launched first; two blocks per SM (80 KB of
//    shared memory each at D 128), so one block's softmax runs under the
//    other's products;
//  * Q loads once by TMA; K and V tiles of 64 keys stream by TMA into a
//    2-stage mbarrier ring: the block's first thread issues tile t+1
//    before the warpgroup computes on tile t. The causal loop stops at the
//    diagonal tile. Rows and keys past S arrive as zeros (TMA's
//    out-of-bounds fill); the keys are masked in the scores (a zero key
//    scores 0, not NEG_INF), the rows are not stored;
//  * S = Q K^T by wgmma m64n64k16 with both operands K-major from shared
//    memory; the softmax runs on the accumulator fragment in registers
//    (each thread holds 2 rows x 16 columns; a row's max and sum are taken
//    across the 4 threads of a quad), and O is rescaled by
//    exp2(m_old - m_new) before the next product is issued;
//  * O += P V by wgmma m64nDk16 with P packed to bf16 pairs as the
//    register A operand and V read MN-major with the transpose flag.
// No split over keys and no atomics: two calls are equal to the bit.
//
// q/k/v may be column slices of the fused qkv projection (4-d tensor maps
// over their own strides, which the wrapper checks are 16-byte multiples);
// GQA: query head h reads K/V head h / (H / Hkv). The Hopper building
// blocks (mbarriers, TMA, wgmma, fences, tensor maps) are in sm90.cuh.

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BARS = 3 * 8;  // three mbarriers at the end of the tiles

template <int D> constexpr size_t smem_bytes() {
  return 5 * tile_bytes<D>() + BARS + 1024;  // + slack for 1024-alignment
}

template <int D>
__global__ void __launch_bounds__(NT, 2) flash_fwd_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv, float scale_log2,
    int causal) {
  constexpr int T = tile_bytes<D>(), KS = D / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + (1 + 2 * s) * T; };
  auto sV = [&](int s) { return base + (2 + 2 * s) * T; };
  const uint32_t bar = base + 5 * T;  // [0] Q, [1 + s] K/V stage s

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
    mbar_expect_tx(bar, T);
    load_tile<D>(&tm_q, sQ, bar, h, q0, b);
    mbar_expect_tx(bar + 8, 2 * T);
    load_tile<D>(&tm_k, sK(0), bar + 8, hk, 0, b);
    load_tile<D>(&tm_v, sV(0), bar + 8, hk, 0, b);
  }

  const int r0 = q0 + 16 * warp + g;  // this thread's rows: r0 and r0 + 8
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
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

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_ss_n64(sc, desc_k(sQ, kk), desc_k(sK(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);

    // scores in the log2 domain, masked, and the new running max per row
    const int k0 = it * BR;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int i = (idx >> 1) & 1, row = r0 + 8 * i;
      const int col = k0 + 8 * (idx >> 2) + 2 * t4 + (idx & 1);
      const bool valid = col < S && (!causal || row >= col);
      sc[idx] = valid ? sc[idx] * scale_log2 : kNegInf;
      mx[i] = fmaxf(mx[i], sc[idx]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 columns: the 4 quad lanes
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
    }
#pragma unroll
    for (int idx = 0; idx < 32; ++idx) {
      const int i = (idx >> 1) & 1;
      sc[idx] = exp2f(sc[idx] - m_r[i]);
      sum[i] += sc[idx];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_r[i] = l_r[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int idx = 0; idx < D / 2; ++idx) acc[idx] *= alpha[(idx >> 1) & 1];
    uint32_t pf[4][4];
    to_frag(sc, pf);
    fence_frag(pf);
    fence_acc(acc);  // the rescaled O is in place before the product
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn(acc, pf[kk], desc_mn(sV(s), kk));  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    __syncthreads();  // every warp is done with stage s
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= S) continue;
    const float ls = l_r[i] == 0.f ? 1.f : l_r[i];
    __nv_bfloat16* orow = o + (((long long)b * S + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) =
          pack_bf16(acc[4 * j + 2 * i] / ls, acc[4 * j + 2 * i + 1] / ls);
    if (t4 == 0) lse[(long long)bh * S + row] = m_r[i] + log2f(ls);
  }
}

// ---- host side ----------------------------------------------------------
template <int D>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k,
                   const CUtensorMap& v, void* o, void* lse, int B, int S,
                   int H, int Hkv, float scale_log2, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BR - 1) / BR, B * H);
  flash_fwd_sm90_kernel<D><<<grid, NT, smem, stream>>>(
      q, k, v, (__nv_bfloat16*)o, (float*)lse, S, H, Hkv, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. q/k/v: [B, S, H(kv), D] with the given batch/seq strides
// (elements, 16-byte multiples; 16-byte aligned bases), packed heads and
// unit feature stride; o: [B, S, H, D] contiguous; lse: [B*H, S] fp32 in
// the log2 domain. Returns the CUDA error code (cudaErrorInvalidValue when
// a tensor map is refused or D is not 64 or 128).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int S, int H,
                              int Hkv, int D, long long q_sb, long long q_ss,
                              long long k_sb, long long k_ss, long long v_sb,
                              long long v_ss, float scale_log2, int causal,
                              void* stream) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, S, H, D, q_sb, q_ss) ||
      !make_map(&mk, k, B, S, Hkv, D, k_sb, k_ss) ||
      !make_map(&mv, v, B, S, Hkv, D, v_sb, v_ss))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return (int)launch<64>(mq, mk, mv, o, lse, B, S, H, Hkv, scale_log2,
                           causal, s);
  if (D == 128)
    return (int)launch<128>(mq, mk, mv, o, lse, B, S, H, Hkv, scale_log2,
                            causal, s);
  return (int)cudaErrorInvalidValue;
}
