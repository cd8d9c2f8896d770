// Fused AdamW update for Hopper (sm_90a), CUDA C++ with a plain C interface
// (bound with ctypes from kernels/fused_optim.py).
//
// Replaces paddle_tpu/kernels/fused_optim.py `_adamw_kernel` (launched by
// `fused_adamw_update`). One launch updates a list of tensors of one dtype
// combination (param, grad, moments): every element reads p, g, m and v at
// their native dtypes, casts them in registers, and computes
//   m = b1*m + (1-b1)*g
//   v = b2*v + (1-b2)*g*g
//   p = p*(1 - lr*wd) - lr*(m/(1-b1p)) / (sqrt(v/(1-b2p)) + eps)
// in fp32 with b1p/b2p the new powers, then writes p, m and v back in place
// in their own dtypes, and, where the entry names one, the parameter's bf16
// copy of an fp32 master p (round to nearest). The TPU's SMEM scalars
// become a table passed by value as the kernel's parameter: per tensor its
// pointers, n, lr, 1-lr*wd, 1-b1p and 1-b2p, and per launch 1-b1, 1-b2 and
// eps, all computed on the host in fp32 exactly as the TPU kernel computes
// them. Every product and sum is rounded on its own (__fmul_rn/__fadd_rn: no
// fused multiply-add), and division and sqrt are IEEE-rounded, so the kernel
// repeats the plain PyTorch version's roundings.
//
// What bounds it on the H100: bytes. It does ~15 operations per element
// against 18 bytes moved for an fp32 master with bf16 grad and moments
// (read p 4 + g 2 + m 2 + v 2, write p 4 + m 2 + v 2), 20 with the bf16
// copy, 28 in fp32. The design:
// - each tensor is cut into chunks of CHUNK elements; a persistent grid (as
//   many blocks as fit on the SMs, fewer when there are fewer chunks) walks
//   the chunks of all tensors in order, so a list of small vectors shares a
//   few blocks and the largest tensor spreads over all of them. The grid is
//   sized so that every block takes the same number of chunks, give or
//   take one;
// - an entry whose pointers are all 16-byte aligned moves 8 elements per
//   16-byte access (one bf16 vector, two fp32 halves); the others, e.g.
//   ZeRO's slice views at odd offsets, and the last partial vector of a
//   tensor take the scalar path inside the same launch;
// - bytes in flight: each thread issues the loads of two 8-element vectors
//   before any arithmetic. g is read and p, m, v and the copy are written
//   with the streaming hint (evict first): each byte is touched once a step.
//   Loads stay in registers: a two-deep cp.async ring in shared memory
//   measured slower in every case on the H100 (PERF.md, row 6).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;     // threads a block
constexpr int VEC = 8;      // elements a vector
constexpr int UNROLL = 2;   // vectors a thread holds at once
constexpr int TILE = NT * VEC;           // elements a block takes per vector
constexpr int CHUNK = TILE * UNROLL;     // 4096 elements: a block's unit
constexpr int MAX_ENTRIES = 448;         // the table's capacity

// one tensor of the list, laid out as kernels/fused_optim.py `_ENTRY`
struct Entry {
  void* p;
  const void* g;
  void* m;
  void* v;
  __nv_bfloat16* low;  // the parameter's bf16 copy of an fp32 p, or null
  long long n;
  float lr, decay, omb1p, omb2p;
};
static_assert(sizeof(Entry) == 64, "Entry must match fused_optim._ENTRY");

struct Table {
  Entry e[MAX_ENTRIES];
  int chunk0[MAX_ENTRIES + 1];  // each entry's first chunk; chunk0[count]: all
  int count;
  float b1, omb1, b2, omb2, eps;
};
// a kernel parameter takes up to 32764 bytes from CUDA 12.1 on
static_assert(sizeof(Table) <= 32764, "table too large");

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, decay, omb1p, omb2p;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// 16-byte units of one 8-element vector of T
template <typename T>
__host__ __device__ constexpr int units() { return VEC * (int)sizeof(T) / 16; }

template <typename T, bool STREAM>
__device__ __forceinline__ void load_units(const T* src, uint4* raw) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < units<T>(); ++i) raw[i] = STREAM ? __ldcs(s + i) : s[i];
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4* raw, float out[VEC]) {
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float in[VEC]) {
  uint4 raw[units<T>()];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(in[i]);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < units<T>(); ++i) __stcs(d + i, raw[i]);
}

// one tensor's place in the launch: its pointers and constants
template <typename P, typename G, typename M>
struct Where {
  P* p;
  const G* g;
  M* m;
  M* v;
  __nv_bfloat16* low;
  long long n;
  bool vec;  // every pointer 16-byte aligned
  Hyper h;
};

template <typename P, typename G, typename M>
__device__ __forceinline__ Where<P, G, M> where(const Table& t, int e) {
  const Entry& E = t.e[e];
  Where<P, G, M> w;
  w.p = (P*)E.p;
  w.g = (const G*)E.g;
  w.m = (M*)E.m;
  w.v = (M*)E.v;
  w.low = E.low;
  w.n = E.n;
  w.vec = (((uintptr_t)E.p | (uintptr_t)E.g | (uintptr_t)E.m |
            (uintptr_t)E.v | (uintptr_t)E.low) % 16) == 0;
  w.h = Hyper{E.lr, t.b1, t.omb1, t.b2, t.omb2, t.eps, E.decay, E.omb1p,
              E.omb2p};
  return w;
}

// the elements [i, min(i + VEC, n)) one at a time: an unaligned entry, or
// the partial vector at a tensor's end
template <typename P, typename G, typename M>
__device__ __forceinline__ void scalar8(const Where<P, G, M>& w, long long i) {
  const long long end = i + VEC < w.n ? i + VEC : w.n;
  for (long long j = i; j < end; ++j) {
    float pp = to_f(w.p[j]), mm = to_f(w.m[j]), vv = to_f(w.v[j]);
    adamw(pp, to_f(w.g[j]), mm, vv, w.h);
    w.p[j] = from_f<P>(pp);
    w.m[j] = from_f<M>(mm);
    w.v[j] = from_f<M>(vv);
    if (w.low) w.low[j] = __float2bfloat16_rn(pp);
  }
}

// the update of one vector from its raw 16-byte units, stored in place
template <typename P, typename G, typename M>
__device__ __forceinline__ void update8(const Where<P, G, M>& w, long long i,
                                        const uint4* rp, const uint4* rg,
                                        const uint4* rm, const uint4* rv) {
  float pp[VEC], gg[VEC], mm[VEC], vv[VEC];
  unpack<P>(rp, pp);
  unpack<G>(rg, gg);
  unpack<M>(rm, mm);
  unpack<M>(rv, vv);
#pragma unroll
  for (int k = 0; k < VEC; ++k) adamw(pp[k], gg[k], mm[k], vv[k], w.h);
  store8(w.p + i, pp);
  store8(w.m + i, mm);
  store8(w.v + i, vv);
  if (w.low) store8(w.low + i, pp);
}

// the entry of chunk c, advancing the cursor e (chunks come in order)
__device__ __forceinline__ int entry_of(const Table& t, int c, int e) {
  while (c >= t.chunk0[e + 1]) ++e;
  return e;
}

// a block takes a chunk at a time; each thread loads its UNROLL vectors
// (all of their 16-byte units) before any arithmetic
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(NT)
fused_adamw_kernel(const __grid_constant__ Table t) {
  constexpr int UP = units<P>(), UG = units<G>(), UM = units<M>();
  const int chunks = t.chunk0[t.count];
  int e = 0;
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    e = entry_of(t, c, e);
    const Where<P, G, M> w = where<P, G, M>(t, e);
    const long long lo = (long long)(c - t.chunk0[e]) * CHUNK;
    uint4 rp[UNROLL][UP], rg[UNROLL][UG], rm[UNROLL][UM], rv[UNROLL][UM];
    bool full[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = lo + (long long)(threadIdx.x + u * NT) * VEC;
      full[u] = w.vec && i + VEC <= w.n;
      if (full[u]) {
        load_units<P, false>(w.p + i, rp[u]);
        load_units<G, true>(w.g + i, rg[u]);
        load_units<M, false>(w.m + i, rm[u]);
        load_units<M, false>(w.v + i, rv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = lo + (long long)(threadIdx.x + u * NT) * VEC;
      if (full[u])
        update8(w, i, rp[u], rg[u], rm[u], rv[u]);
      else if (i < w.n)
        scalar8(w, i);
    }
  }
}

template <typename P, typename G, typename M>
cudaError_t launch(const Entry* in, const int* chunk0, int count,
                   const float shared[5], cudaStream_t stream) {
  Table t;
  for (int i = 0; i < count; ++i) {
    t.e[i] = in[i];
    t.chunk0[i] = chunk0[i];
  }
  const int chunks = t.chunk0[count] = chunk0[count];
  t.count = count;
  t.b1 = shared[0];
  t.omb1 = shared[1];
  t.b2 = shared[2];
  t.omb2 = shared[3];
  t.eps = shared[4];
  const auto kernel = fused_adamw_kernel<P, G, M>;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  if (per_sm < 1) per_sm = 1;
  // every block takes `rounds` chunks or one fewer
  const long long most = (long long)per_sm * sms;
  const long long rounds = (chunks + most - 1) / most;
  const int grid = (int)((chunks + rounds - 1) / rounds);
  kernel<<<grid, NT, 0, stream>>>(t);
  return cudaGetLastError();
}

}  // namespace

// entries: `count` (at most MAX_ENTRIES) Entry records, one per tensor of
// one dtype combination, each n elements of p, g, m, v (and low, when not
// null) updated in place (g read only) in one launch; chunk0: count + 1
// ints, each entry's first chunk of CHUNK elements and, last, the chunks of
// all. Dtype codes: 0 = float32, 1 = bfloat16; instantiated for p fp32/bf16; g in p's dtype, or bf16 under
// an fp32 master; m/v (one dtype) fp32/bf16; low (bf16) only beside an fp32
// p. Per entry lr, decay = 1 - lr*wd, omb1p = 1-b1p, omb2p = 1-b2p; per
// launch b1, omb1 = 1-b1, b2, omb2 = 1-b2, eps: fp32 values computed by the
// caller. Returns the CUDA error.
extern "C" int fused_adamw(const void* entries, const int* chunk0,
                           int count, int p_dtype,
                           int g_dtype, int mv_dtype, float b1, float omb1,
                           float b2, float omb2, float eps, void* stream) {
  if (count < 0 || count > MAX_ENTRIES) return (int)cudaErrorInvalidValue;
  const Entry* in = (const Entry*)entries;
  if (count == 0 || chunk0[count] == 0) return (int)cudaSuccess;
  const float shared[5] = {b1, omb1, b2, omb2, eps};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  const int code = p_dtype * 4 + g_dtype * 2 + mv_dtype;
  switch (code) {
    case 0: return (int)launch<float, float, float>(in, chunk0, count, shared, s);
    case 1: return (int)launch<float, float, bf16>(in, chunk0, count, shared, s);
    case 2: return (int)launch<float, bf16, float>(in, chunk0, count, shared, s);
    case 3: return (int)launch<float, bf16, bf16>(in, chunk0, count, shared, s);
    case 6: return (int)launch<bf16, bf16, float>(in, chunk0, count, shared, s);
    case 7: return (int)launch<bf16, bf16, bf16>(in, chunk0, count, shared, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
