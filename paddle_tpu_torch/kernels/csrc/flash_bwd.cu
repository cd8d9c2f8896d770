// Flash attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes from kernels/flash_attention.py).
//
// Replaces paddle_tpu/kernels/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both launched by `_bwd`). P is recomputed from the saved
// log2-domain LSE that flash_fwd.cu emits ([B*H, S] fp32), with exactly the
// TPU kernels' arithmetic: s = (q.k) * scale*LOG2E in fp32 from the
// native-dtype operands, causal/ragged entries give p = 0,
// p = exp2(s - lse), dp = dO.v in fp32, ds = p * (dp - delta) * scale
// rounded to the operand dtype, dV += round(p)^T.dO, dK += ds^T.q,
// dQ += ds.k, fp32 accumulators, outputs in the input dtype. delta =
// rowsum(dO*O) in fp32 is computed by the wrapper, as `_bwd` computes it
// outside its kernels.
//
// Layout: q/k/v [B, S, H(kv), D] with arbitrary batch and sequence strides
// (column slices of the fused qkv projection) and packed heads; dO, dq, dk
// and dv are contiguous [B, S, H(kv), D].
//
// What bounds it on the H100: operations. Per (b, h) the backward does
// ~7*S*S*D/2 multiply-adds against ~8*S*D*2 bytes (causal), far above the
// ~295 operations per byte where memory would be the limit. This first
// version is deliberately simple, like flash_fwd.cu: both products run on
// the CUDA cores in fp32, one block of 128 threads, each thread owning a
// 4x4 score tile and 4 rows x D/8 columns of its accumulator in registers,
// tiles staged in shared memory once per block, and causal tiles past the
// diagonal skipped by the loop bounds. wgmma, TMA and warp specialisation
// are later work.
//
//  * dq: one block per (b*h, 64-row query tile); it loops over 32-key tiles
//    up to the causal diagonal (the TPU grid's sequential key axis becomes
//    this loop) and keeps dQ in registers.
//  * dk/dv: one block per (b, KV head, 64-key tile); it loops over the H/Hkv
//    query heads that share the KV head and, for each, over 32-row query
//    tiles from the diagonal to the end. GQA's sum over the group lands in
//    the same registers: no atomics and no expanded K/V.
// Neither kernel uses atomics, so both are deterministic run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int RG = 16;   // row groups: thread row r = rg + RG*i
constexpr int CG = 8;    // column groups: thread col c = cg + CG*j
constexpr int DQ_BQ = 64, DQ_BK = 32;  // dq: query rows per block, key tile
constexpr int KV_BK = 64, KV_BQ = 32;  // dkv: key rows per block, query tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the TPU kernels' `.astype(k.dtype)` on p and ds
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Strides {
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss;
};

// rows [r0, r0+R) of a [S, D] slice with sequence stride ss into a padded
// fp32 tile [R][D+1]; rows at or past S read as zero
template <typename T, int R, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss,
                                      int r0, int S) {
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int r = i / D, d = i % D, s = r0 + r;
    dst[r * (D + 1) + d] = s < S ? to_f(src[s * ss + d]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * DQ_BQ * (D + 1) + 2 * DQ_BK * (D + 1) +
                          DQ_BQ * (DQ_BK + 1) + 2 * DQ_BQ);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * KV_BK * (D + 1) + 2 * KV_BQ * (D + 1) +
                          KV_BK * (KV_BQ + 1) + 2 * KV_BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int H,
    int Hkv, Strides st, float scale, float scale_log2, int causal) {
  static_assert(D % CG == 0, "head_dim must be a multiple of 8");
  constexpr int RPT = DQ_BQ / RG, CPT = DQ_BK / CG, DPT = D / CG;
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][D+1]
  float* dOs = Qs + DQ_BQ * (D + 1);         // [BQ][D+1]
  float* Ks = dOs + DQ_BQ * (D + 1);         // [BK][D+1]
  float* Vs = Ks + DQ_BK * (D + 1);          // [BK][D+1]
  float* dSs = Vs + DQ_BK * (D + 1);         // [BQ][BK+1]
  float* lse_s = dSs + DQ_BQ * (DQ_BK + 1);  // [BQ]
  float* delta_s = lse_s + DQ_BQ;            // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * DQ_BQ;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const long long o_ss = (long long)H * D, o_sb = S * o_ss;
  const T* kb = k + b * st.k_sb + (long long)hk * D;
  const T* vb = v + b * st.v_sb + (long long)hk * D;

  stage<T, DQ_BQ, D>(Qs, q + b * st.q_sb + (long long)h * D, st.q_ss, q0, S);
  stage<T, DQ_BQ, D>(dOs, dout + b * o_sb + (long long)h * D, o_ss, q0, S);
  for (int i = tid; i < DQ_BQ; i += NT) {
    const int s = q0 + i;
    lse_s[i] = s < S ? lse[(long long)bh * S + s] : 0.f;
    delta_s[i] = s < S ? delta[(long long)bh * S + s] : 0.f;
  }

  float acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;

  const int kv_end = causal ? min(S, q0 + DQ_BQ) : S;
  const int nkb = (kv_end + DQ_BK - 1) / DQ_BK;
  for (int t = 0; t < nkb; ++t) {
    const int k0 = t * DQ_BK;
    __syncthreads();  // the previous tile's readers are done
    stage<T, DQ_BK, D>(Ks, kb, st.k_ss, k0, S);
    stage<T, DQ_BK, D>(Vs, vb, st.v_ss, k0, S);
    __syncthreads();

    float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], ov[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = Qs[(rg + RG * i) * (D + 1) + d];
        ov[i] = dOs[(rg + RG * i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = Ks[(cg + CG * j) * (D + 1) + d];
        vv[j] = Vs[(cg + CG * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg + RG * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = cg + CG * j, kpos = k0 + c;
        const bool valid = qpos < S && kpos < S && (!causal || qpos >= kpos);
        const float p = valid ? exp2f(sc[i][j] * scale_log2 - lse_s[r]) : 0.f;
        dSs[r * (DQ_BK + 1) + c] =
            round_to<T>(p * (dp[i][j] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < DQ_BK; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(rg + RG * i) * (DQ_BK + 1) + c];
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const float kk = Ks[c * (D + 1) + cg + CG * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][e] = fmaf(dsv[i], kk, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + rg + RG * i;
    if (row >= S) continue;
    T* out = dq + b * o_sb + row * o_ss + (long long)h * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) out[cg + CG * e] = from_f<T>(acc[i][e]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int H, int Hkv, Strides st, float scale, float scale_log2,
    int causal) {
  static_assert(D % CG == 0, "head_dim must be a multiple of 8");
  constexpr int RPT = KV_BK / RG, CPT = KV_BQ / CG, DPT = D / CG;
  extern __shared__ float smem[];
  float* Ks = smem;                          // [BK][D+1]
  float* Vs = Ks + KV_BK * (D + 1);          // [BK][D+1]
  float* Qs = Vs + KV_BK * (D + 1);          // [BQ][D+1]
  float* dOs = Qs + KV_BQ * (D + 1);         // [BQ][D+1]
  float* Ps = dOs + KV_BQ * (D + 1);         // [BK][BQ+1]: P^T, then dS^T
  float* lse_s = Ps + KV_BK * (KV_BQ + 1);   // [BQ]
  float* delta_s = lse_s + KV_BQ;            // [BQ]

  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * KV_BK;
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  const long long o_ss = (long long)H * D, o_sb = S * o_ss;

  stage<T, KV_BK, D>(Ks, k + b * st.k_sb + (long long)hk * D, st.k_ss, k0, S);
  stage<T, KV_BK, D>(Vs, v + b * st.v_sb + (long long)hk * D, st.v_ss, k0, S);

  float dka[RPT][DPT], dva[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int e = 0; e < DPT; ++e) dka[i][e] = dva[i][e] = 0.f;

  // causal: query tiles that end before this key tile contribute nothing
  const int qb_lo = causal ? k0 / KV_BQ : 0;
  const int nqb = (S + KV_BQ - 1) / KV_BQ;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * st.q_sb + (long long)h * D;
    const T* ob = dout + b * o_sb + (long long)h * D;
    for (int qt = qb_lo; qt < nqb; ++qt) {
      const int q0 = qt * KV_BQ;
      __syncthreads();  // the previous tile's readers are done
      stage<T, KV_BQ, D>(Qs, qb, st.q_ss, q0, S);
      stage<T, KV_BQ, D>(dOs, ob, o_ss, q0, S);
      for (int i = tid; i < KV_BQ; i += NT) {
        const int s = q0 + i;
        lse_s[i] = s < S ? lse[bh * S + s] : 0.f;
        delta_s[i] = s < S ? delta[bh * S + s] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: key rows x query columns
      float sc[RPT][CPT], dp[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RPT], vv[RPT], qv[CPT], ov[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = Ks[(rg + RG * i) * (D + 1) + d];
          vv[i] = Vs[(rg + RG * i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = Qs[(cg + CG * j) * (D + 1) + d];
          ov[j] = dOs[(cg + CG * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }

      // P^T to shared memory (rounded to dO's dtype); dS^T stays in dp
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i, kpos = k0 + r;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int c = cg + CG * j, qpos = q0 + c;
          const bool valid = qpos < S && kpos < S && (!causal || qpos >= kpos);
          const float p = valid ? exp2f(sc[i][j] * scale_log2 - lse_s[c]) : 0.f;
          dp[i][j] = round_to<T>(p * (dp[i][j] - delta_s[c]) * scale);
          Ps[r * (KV_BQ + 1) + c] = round_to<T>(p);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KV_BQ; ++c) {  // dV += P^T dO
        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = Ps[(rg + RG * i) * (KV_BQ + 1) + c];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float o = dOs[c * (D + 1) + cg + CG * e];
#pragma unroll
          for (int i = 0; i < RPT; ++i) dva[i][e] = fmaf(pv[i], o, dva[i][e]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          Ps[(rg + RG * i) * (KV_BQ + 1) + cg + CG * j] = dp[i][j];
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KV_BQ; ++c) {  // dK += dS^T Q
        float dsv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) dsv[i] = Ps[(rg + RG * i) * (KV_BQ + 1) + c];
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float qq = Qs[c * (D + 1) + cg + CG * e];
#pragma unroll
          for (int i = 0; i < RPT; ++i) dka[i][e] = fmaf(dsv[i], qq, dka[i][e]);
        }
      }
    }
  }

  const long long kv_ss = (long long)Hkv * D, kv_sb = S * kv_ss;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = k0 + rg + RG * i;
    if (row >= S) continue;
    const long long off = b * kv_sb + row * kv_ss + (long long)hk * D;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      dk[off + cg + CG * e] = from_f<T>(dka[i][e]);
      dv[off + cg + CG * e] = from_f<T>(dva[i][e]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int S, int H, int Hkv, Strides st,
                      float scale, float scale_log2, int causal,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + DQ_BQ - 1) / DQ_BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, S, H, Hkv, st, scale,
      scale_log2, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int S, int H, int Hkv,
                       Strides st, float scale, float scale_log2, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + KV_BK - 1) / KV_BK, B * Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, S, H, Hkv, st,
      scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q/k/v: [B, S, H(kv), D] with the given batch/seq strides (elements),
// packed heads and unit feature stride; dout: [B, S, H, D] contiguous;
// lse/delta: [B*H, S] fp32 (lse in the log2 domain). dq: [B, S, H, D]
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int S, int H,
                            int Hkv, int D, long long q_sb, long long q_ss,
                            long long k_sb, long long k_ss, long long v_sb,
                            long long v_ss, float scale, float scale_log2,
                            int causal, int dtype, void* stream) {
  const Strides st{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define DQ_CASE(T, DD)                                                     \
  return (int)launch_dq<T, DD>(q, k, v, dout, lse, delta, dq, B, S, H, Hkv, \
                               st, scale, scale_log2, causal, s)
  if (dtype == 0 && D == 64) DQ_CASE(float, 64);
  if (dtype == 0 && D == 128) DQ_CASE(float, 128);
  if (dtype == 1 && D == 64) DQ_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DQ_CASE(__nv_bfloat16, 128);
#undef DQ_CASE
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dk/dv: [B, S, Hkv, D] contiguous, summed over the H/Hkv
// query heads of each KV head.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int S, int H, int Hkv, int D, long long q_sb,
                             long long q_ss, long long k_sb, long long k_ss,
                             long long v_sb, long long v_ss, float scale,
                             float scale_log2, int causal, int dtype,
                             void* stream) {
  const Strides st{q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  cudaStream_t s = (cudaStream_t)stream;
#define DKV_CASE(T, DD)                                                      \
  return (int)launch_dkv<T, DD>(q, k, v, dout, lse, delta, dk, dv, B, S, H,  \
                                Hkv, st, scale, scale_log2, causal, s)
  if (dtype == 0 && D == 64) DKV_CASE(float, 64);
  if (dtype == 0 && D == 128) DKV_CASE(float, 128);
  if (dtype == 1 && D == 64) DKV_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) DKV_CASE(__nv_bfloat16, 128);
#undef DKV_CASE
  return (int)cudaErrorInvalidValue;
}
