// Fused AdamW update for Hopper (sm_90a), CUDA C++ with a plain C interface
// (bound with ctypes from kernels/fused_optim.py).
//
// Replaces paddle_tpu/kernels/fused_optim.py `_adamw_kernel` (launched by
// `fused_adamw_update`): one pass per element reads p, g, m and v at their
// native dtypes, casts them in registers, and computes
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*g*g
//   p = p*(1 - lr*wd) - lr*(m/(1-b1p)) / (sqrt(v/(1-b2p)) + eps)
// in fp32 with b1p/b2p the new powers, then writes p, m and v back in place
// in their own dtypes. The TPU's SMEM scalars become by-value floats; the
// host precomputes 1-b1, 1-b2, 1-lr*wd, 1-b1p and 1-b2p in fp32 exactly as
// the TPU kernel does. Every product and sum is rounded on its own
// (__fmul_rn/__fadd_rn: no fused multiply-add), and division and sqrt are
// IEEE-rounded, so the kernel repeats the plain PyTorch version's roundings.
//
// What bounds it on the H100: bytes. It does ~15 operations per element
// against 18 bytes moved for an fp32 master with bf16 grad and moments
// (read p 4 + g 2 + m 2 + v 2, write p 4 + m 2 + v 2). The design streams
// each tensor once: a grid-stride loop over 8-element chunks with 16-byte
// vector loads and stores when every pointer is 16-byte aligned, and a
// scalar loop for the tail (or for everything when a pointer is not).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int VEC = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, decay, omb1p, omb2p;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float m_hat = __fdiv_rn(m, h.omb1p);
  const float v_hat = __fdiv_rn(v, h.omb2p);
  const float upd = __fdiv_rn(__fmul_rn(h.lr, m_hat),
                              __fadd_rn(__fsqrt_rn(v_hat), h.eps));
  p = __fsub_rn(__fmul_rn(p, h.decay), upd);
}

// 8 consecutive elements through one (bf16) or two (fp32) 16-byte accesses
template <typename T>
__device__ __forceinline__ void load8(const T* src, float out[VEC]) {
  constexpr int NV = VEC * sizeof(T) / 16;
  uint4 raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) raw[i] = reinterpret_cast<const uint4*>(src)[i];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float in[VEC]) {
  constexpr int NV = VEC * sizeof(T) / 16;
  uint4 raw[NV];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(in[i]);
#pragma unroll
  for (int i = 0; i < NV; ++i) reinterpret_cast<uint4*>(dst)[i] = raw[i];
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(NT) fused_adamw_kernel(
    P* __restrict__ p, const G* __restrict__ g, M* __restrict__ m,
    M* __restrict__ v, long long n, long long n_chunks, Hyper h) {
  const long long stride = (long long)gridDim.x * NT;
  const long long tid = (long long)blockIdx.x * NT + threadIdx.x;
  for (long long c = tid; c < n_chunks; c += stride) {
    const long long i = c * VEC;
    float pp[VEC], gg[VEC], mm[VEC], vv[VEC];
    load8(p + i, pp);
    load8(g + i, gg);
    load8(m + i, mm);
    load8(v + i, vv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) adamw(pp[e], gg[e], mm[e], vv[e], h);
    store8(p + i, pp);
    store8(m + i, mm);
    store8(v + i, vv);
  }
  for (long long i = n_chunks * VEC + tid; i < n; i += stride) {
    float pp = to_f(p[i]), mm = to_f(m[i]), vv = to_f(v[i]);
    adamw(pp, to_f(g[i]), mm, vv, h);
    p[i] = from_f<P>(pp);
    m[i] = from_f<M>(mm);
    v[i] = from_f<M>(vv);
  }
}

template <typename P, typename G, typename M>
cudaError_t launch(void* p, const void* g, void* m, void* v, long long n,
                   const Hyper& h, cudaStream_t stream) {
  const bool aligned = ((uintptr_t)p | (uintptr_t)g | (uintptr_t)m |
                        (uintptr_t)v) % 16 == 0;
  const long long n_chunks = aligned ? n / VEC : 0;
  const long long work = n_chunks > 0 ? n_chunks : n;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work + NT - 1) / NT;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // grid-stride past that
  if (blocks < 1) blocks = 1;
  fused_adamw_kernel<P, G, M><<<(unsigned)blocks, NT, 0, stream>>>(
      (P*)p, (const G*)g, (M*)m, (M*)v, n, n_chunks, h);
  return cudaGetLastError();
}

}  // namespace

// p, g, m, v: n elements each, updated in place (g read only). Dtype codes:
// 0 = float32, 1 = bfloat16. Instantiated for p fp32/bf16; g in p's dtype,
// or bf16 under an fp32 master; m/v (one dtype) fp32/bf16. Hyperparameters
// are fp32 values computed by the caller: omb1 = 1-b1, omb2 = 1-b2,
// decay = 1 - lr*wd, omb1p = 1-b1p, omb2p = 1-b2p. Returns the CUDA error.
extern "C" int fused_adamw(void* p, const void* g, void* m, void* v,
                           long long n, int p_dtype, int g_dtype,
                           int mv_dtype, float lr, float b1, float omb1,
                           float b2, float omb2, float eps, float decay,
                           float omb1p, float omb2p, void* stream) {
  const Hyper h{lr, b1, omb1, b2, omb2, eps, decay, omb1p, omb2p};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  const int code = p_dtype * 4 + g_dtype * 2 + mv_dtype;
  switch (code) {
    case 0: return (int)launch<float, float, float>(p, g, m, v, n, h, s);
    case 1: return (int)launch<float, float, bf16>(p, g, m, v, n, h, s);
    case 2: return (int)launch<float, bf16, float>(p, g, m, v, n, h, s);
    case 3: return (int)launch<float, bf16, bf16>(p, g, m, v, n, h, s);
    case 6: return (int)launch<bf16, bf16, float>(p, g, m, v, n, h, s);
    case 7: return (int)launch<bf16, bf16, bf16>(p, g, m, v, n, h, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
