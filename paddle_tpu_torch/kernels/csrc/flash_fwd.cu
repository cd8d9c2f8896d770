// Flash attention forward for Hopper (sm_90a), fp32: CUDA C++ with a plain
// C interface (bound with ctypes from kernels/flash_attention.py). bf16
// takes the tensor-core kernel of flash_fwd_sm90.cu; this CUDA-core kernel
// serves fp32, where wgmma would read the operands as TF32.
//
// Replaces paddle_tpu/kernels/flash_attention.py `_fwd_kernel` (launched by
// `_fwd`): blockwise causal or non-causal attention with an online softmax
// in the exp2 domain. Scores are fp32 dot products, multiplied by
// scale*LOG2E; the running max m, sum l and the accumulator are fp32; a
// row whose sum is 0 divides by 1. Emits O and the log2-domain LSE
// m + log2(l) as [B*H, S] fp32.
//
// Layout is the JAX package's [B, S, H, D] with arbitrary batch and
// sequence strides (so q/k/v can be column slices of the fused qkv
// projection) and unit head/feature strides. GQA: query head h reads K/V
// head h / (H / Hkv); no expanded K/V is materialised.
//
// What bounds it on the H100: at the prefill shapes (S up to 2048, D 128)
// the work is ~4*S*S*D*H/2 operations against ~4*S*H*D*4 bytes, so it is
// operation-bound, and in fp32 the CUDA cores' 67 TFLOP/s is the ceiling.
// This version is deliberately simple: it runs the two products on the
// CUDA cores, one block of 128 threads per (b*h, 64-row query tile). Each
// thread owns a 4x4 score tile and 4 rows x D/8 output columns in
// registers, K/V tiles are staged in shared memory once per block, and
// causal key tiles past the diagonal are skipped by the loop bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per tile
constexpr int NT = 128;  // threads per block
constexpr int RG = 16;   // row groups: thread row r = rg + RG*i
constexpr int CG = 8;    // column groups: thread col c = cg + CG*j
constexpr int RPT = BQ / RG;
constexpr int CPT = BK / CG;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int S, int H, int Hkv,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, float scale_log2, int causal) {
  static_assert(D % CG == 0, "head_dim must be a multiple of 8");
  constexpr int DPT = D / CG;
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);    // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);    // [BK][D]
  float* Ps = Vs + BK * D;          // [BQ][BK+1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const float* qb = q + b * q_sb + (long long)h * D;
  const float* kb = k + b * k_sb + (long long)hk * D;
  const float* vb = v + b * v_sb + (long long)hk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? qb[s * q_ss + d] : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  const int nkb = (kv_end + BK - 1) / BK;
  for (int t = 0; t < nkb; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, s = k0 + r;
      const bool ok = s < S;
      Ks[r * (D + 1) + d] = ok ? kb[s * k_ss + d] : 0.f;
      Vs[r * D + d] = ok ? vb[s * v_ss + d] : 0.f;
    }
    __syncthreads();

    float sc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg + RG * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = Ks[(cg + CG * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + rg + RG * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + cg + CG * j;
        const bool valid = kpos < S && (!causal || qpos >= kpos);
        sc[i][j] = valid ? sc[i][j] * scale_log2 : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the CG threads sharing a row are 8 adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = exp2f(sc[i][j] - m_new);
        psum += p;
        Ps[(rg + RG * i) * (BK + 1) + cg + CG * j] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      psum += __shfl_xor_sync(0xffffffffu, psum, 4);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg + RG * i) * (BK + 1) + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float vv = Vs[c * D + cg + CG * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  const long long o_sb = (long long)S * o_ss;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + RG * i;
    if (row >= S) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + b * o_sb + row * o_ss + (long long)h * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) orow[cg + CG * e] = acc[i][e] / ls;
    if (cg == 0) lse[(long long)bh * S + row] = m[i] + log2f(ls);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int S, int H, int Hkv, long long q_sb,
                   long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, float scale_log2,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, S, H, Hkv, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale_log2,
      causal);
  return cudaGetLastError();
}

}  // namespace

// fp32 only. q/k/v: [B, S, H(kv), D] with the given batch/seq strides
// (elements) and unit feature stride; o: [B, S, H, D] contiguous; lse:
// [B*H, S] fp32. Returns the CUDA error code (cudaErrorInvalidValue when D
// is not 64 or 128).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int H, int Hkv, int D,
                         long long q_sb, long long q_ss, long long k_sb,
                         long long k_ss, long long v_sb, long long v_ss,
                         float scale_log2, int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 64)
    return (int)launch<64>(q, k, v, o, lse, B, S, H, Hkv, q_sb, q_ss, k_sb,
                           k_ss, v_sb, v_ss, scale_log2, causal, st);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, lse, B, S, H, Hkv, q_sb, q_ss, k_sb,
                            k_ss, v_sb, v_ss, scale_log2, causal, st);
  return (int)cudaErrorInvalidValue;
}
