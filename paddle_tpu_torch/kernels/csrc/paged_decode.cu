// Ragged paged-decode attention for Hopper (sm_90a), CUDA C++ with a plain
// C interface (bound with ctypes from kernels/paged_attention.py).
//
// Replaces paddle_tpu/kernels/paged_attention.py `_decode_kernel` (launched
// by `paged_attention`): one query token per slot attends that slot's live
// KV pages only. Pools are [P, Hkv, page_size, D]; a [B, num_blocks] int32
// page table routes slot b's block i to a pool page, and -1 (unallocated)
// clamps to the reserved trash page 0. Pages 0 .. positions[b]/page_size
// are walked and the rest skipped; tokens past positions[b] are masked.
// q arrives already scaled by 1/sqrt(D) in q's dtype (the wrapper does it,
// as the TPU wrapper does). Scores are fp32 dot products times LOG2E, the
// softmax is an exp2 online softmax with fp32 stats, P is cast to v's dtype
// before P.V, and the output is in v's dtype. An empty slot (position 0,
// all-sentinel row) reads trash page 0 and yields finite output.
//
// On the TPU the table and positions were scalar-prefetch operands; here
// each block reads its slot's position and table row itself.
//
// What bounds it on the H100: bytes. Each live K/V byte is read once and
// used for ~rep multiply-adds, so the kernel is far below the ridge point.
// One block per (slot, KV head) handles that head's rep query heads, so a
// K/V page is read from device memory once for all of them (no GQA
// expansion); lanes read K/V rows with consecutive addresses. This first
// version walks pages one at a time with block-wide barriers between the
// score, softmax and P.V phases; splitting long sequences across blocks
// and keeping several pages in flight are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ positions, T* __restrict__ out, int Hq, int Hkv,
    int page_size, int num_blocks, int D) {
  extern __shared__ float smem[];
  const int rep = Hq / Hkv;
  float* qs = smem;                        // [rep][D]
  float* acc = qs + rep * D;               // [rep][D]
  float* sc = acc + rep * D;               // [rep][page_size]
  float* m = sc + rep * page_size;         // [rep]
  float* l = m + rep;                      // [rep]
  float* alpha = l + rep;                  // [rep]

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = NT / 32;
  const int pos = positions[b];
  const int live = min(pos / page_size + 1, num_blocks);
  const T* qb = q + ((long long)b * Hq + (long long)g * rep) * D;

  for (int i = tid; i < rep * D; i += NT) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < rep) {
    m[tid] = kNegInf;
    l[tid] = 0.f;
  }
  __syncthreads();

  const long long page_elems = (long long)page_size * D;
  for (int blk = 0; blk < live; ++blk) {
    const int page = max(table[(long long)b * num_blocks + blk], 0);
    const T* kp = k_pool + ((long long)page * Hkv + g) * page_elems;
    const T* vp = v_pool + ((long long)page * Hkv + g) * page_elems;

    // scores: one warp per (query head, token) pair, lanes over D
    for (int pr = warp; pr < rep * page_size; pr += nwarps) {
      const int r = pr / page_size, t = pr % page_size;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s = fmaf(qs[r * D + d], to_f(kp[t * D + d]), s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        const int tok = blk * page_size + t;
        sc[pr] = tok <= pos ? s * kLog2e : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: one thread per query head
    if (tid < rep) {
      float* row = sc + tid * page_size;
      float mx = kNegInf;
      for (int t = 0; t < page_size; ++t) mx = fmaxf(mx, row[t]);
      const float m_new = fmaxf(m[tid], mx);
      float psum = 0.f;
      for (int t = 0; t < page_size; ++t) {
        const float p = exp2f(row[t] - m_new);
        psum += p;
        row[t] = to_f(from_f<T>(p));
      }
      alpha[tid] = exp2f(m[tid] - m_new);
      l[tid] = l[tid] * alpha[tid] + psum;
      m[tid] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P.V; each thread owns fixed (head, d) entries
    for (int i = tid; i < rep * D; i += NT) {
      const int r = i / D, d = i % D;
      const float* p = sc + r * page_size;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < page_size; ++t) a = fmaf(p[t], to_f(vp[t * D + d]), a);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * Hq + (long long)g * rep) * D;
  for (int i = tid; i < rep * D; i += NT) {
    const float li = l[i / D];
    ob[i] = from_f<T>(acc[i] / (li == 0.f ? 1.f : li));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* positions, void* out, int B,
                   int Hq, int Hkv, int page_size, int num_blocks, int D,
                   cudaStream_t stream) {
  const int rep = Hq / Hkv;
  const size_t smem = sizeof(float) * (2 * rep * D + rep * page_size + 3 * rep);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k_pool, (const T*)v_pool, (const int*)table,
      (const int*)positions, (T*)out, Hq, Hkv, page_size, num_blocks, D);
  return cudaGetLastError();
}

}  // namespace

// q: [B, Hq, D] pre-scaled, contiguous; pools: [P, Hkv, page_size, D]
// contiguous; table: [B, num_blocks] int32; positions: [B] int32;
// out: [B, Hq, D]. dtype: 0 = float32, 1 = bfloat16. Returns the CUDA
// error code.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* positions, void* out, int B, int Hq,
                            int Hkv, int page_size, int num_blocks, int D,
                            int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, k_pool, v_pool, table, positions, out, B, Hq, Hkv,
                        page_size, num_blocks, D, st);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k_pool, v_pool, table, positions, out, B,
                                Hq, Hkv, page_size, num_blocks, D, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
