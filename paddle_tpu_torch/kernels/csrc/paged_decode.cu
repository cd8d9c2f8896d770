// Ragged paged-decode attention for Hopper (sm_90a), CUDA C++ with a plain
// C interface (bound with ctypes from kernels/paged_attention.py).
//
// Replaces paddle_tpu/kernels/paged_attention.py `_decode_kernel` (launched
// by `paged_attention`): one query token per slot attends that slot's live
// KV pages only. Pools are [P, Hkv, page_size, D]; a [B, num_blocks] int32
// page table routes slot b's block i to a pool page, and -1 (unallocated)
// clamps to the reserved trash page 0. Pages 0 .. positions[b]/page_size
// are live; tokens past positions[b] are masked. q arrives already scaled
// by 1/sqrt(D) in q's dtype (the wrapper does it, as the TPU wrapper does).
// Scores are fp32 dot products times LOG2E, the softmax is an exp2 online
// softmax with fp32 statistics, P is rounded to v's dtype before P.V, and
// the output is in v's dtype. An empty slot (position 0, all-sentinel row)
// reads trash page 0 and yields finite output.
//
// What bounds it on the H100: bytes. Each live K/V byte is read once and
// used for about rep multiply-adds, far below the ridge point, so the
// design keeps enough bytes in flight on all 132 SMs:
//
// 1. Split-KV. The grid is (B, Hkv * head_tiles, n_splits): a block takes
//    pages_per_split of one slot's pages for one KV head (and up to 8 of
//    its query heads, so a K/V page is read once for all of them; rep > 8
//    takes ceil(rep / 8) head tiles). A split is 64 tokens (at least one
//    page), fixed by the wrapper from the page size, so the grid never
//    depends on positions: a block whose split starts past its slot's
//    live pages exits at once.
// 2. A ring of STAGES = 4 tiles in shared memory (a tile is one page's K
//    and V for the head when it fits in 8 KB each, else a run of its
//    tokens), filled with 16-byte cp.async: three tiles are in flight
//    while one is used, and one __syncthreads per tile both publishes the
//    tile that landed and frees the one used before it. cp.async rather
//    than the bulk copy: a page run is small (4 KB at ps 16, D 128 bf16)
//    and every thread issues a few 16-byte copies, so no single thread
//    serialises the issue and no expect-tx byte count or second barrier
//    per stage is needed; the bulk copy's gain (no registers for
//    addresses) is small at this size. The split's table entries are read
//    once, up front, into shared memory.
// 3. A group of G lanes owns a token: lane i holds 16-byte chunks i, i+G,
//    ... of the row (16 lanes x 16 bytes is one D 128 bf16 row); the dot
//    product is reduced with shuffles inside the group, and all of the
//    block's query heads reuse the K chunk. The warp's groups take
//    different tokens; the softmax max is a warp reduction, so each warp
//    keeps one running max per head, and each lane accumulates P.V for its
//    own 16 bytes of features over its group's tokens. P is rounded to v's
//    dtype against the warp's running max over its tokens of the split
//    (the TPU kernel rounds against its page-running max). At the end of
//    the split the groups are summed with shuffles and the warps' partials
//    in shared memory, in a fixed order.
// 4. Each split writes fp32 (m, l, acc[D]) per query head into a workspace
//    of static size; paged_decode_combine_kernel over (Hq, B) merges a
//    slot's live splits in split order, keeps l == 0 -> 1 as the TPU
//    kernel does, and writes v's dtype. No atomics: two calls agree
//    bitwise. Nothing is read on the host, so a CUDA graph can capture the
//    call and replay it after positions and table change in place.
//
// Two instances of one template: the vector route (D * sizeof(T) a
// multiple of 16, D <= 256, 16-byte aligned pools and q) and a scalar
// route for any other shape (elements loaded one by one, one query head
// per block).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128;
constexpr int NW = NT / 32;
constexpr int STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void* q;          // [B, Hq, D], pre-scaled
  const void* k;          // [P, Hkv, ps, D]
  const void* v;
  const int* table;       // [B, nb]
  const int* positions;   // [B]
  float* ws;              // [B, Hq, n_splits, D + 2]: m, l, acc[D]
  void* out;              // [B, Hq, D]
  int B, Hq, Hkv, ps, nb, D, pps, n_splits, tile, rep, heads, head_tiles;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory: the ring (reused for the warps' partials at the end of a
// split), the block's query heads, the split's page ids
struct Layout {
  size_t q_off, pages_off, bytes;
};

__host__ __device__ inline Layout layout(int tile, int D, int R, int pps,
                                         int itemsize) {
  const size_t ring = align16((size_t)STAGES * 2 * tile * D * itemsize);
  const size_t merge = align16((size_t)NW * R * (D + 2) * sizeof(float));
  Layout L;
  L.q_off = ring > merge ? ring : merge;
  L.pages_off = L.q_off + align16((size_t)R * D * itemsize);
  L.bytes = L.pages_off + (size_t)pps * sizeof(int);
  return L;
}

// VE elements of T at p, widened to float: one 16-byte load on the vector
// route (VE * sizeof(T) == 16), VE scalar loads otherwise
template <typename T, int VE>
__device__ __forceinline__ void load_f(const T* p, float (&out)[VE]) {
  if constexpr (VE * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VE; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VE; ++i) out[i] = to_f(p[i]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Template: T the element type; VE elements per chunk (16 bytes on the
// vector route, 1 on the scalar one); C chunks per lane; R query heads per
// block (registers: R * C * VE fp32 accumulators a lane).
template <typename T, int VE, int C, int R>
__global__ void __launch_bounds__(NT) paged_decode_split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, g = blockIdx.y / p.head_tiles;
  const int h0 = (blockIdx.y % p.head_tiles) * R;  // first head in the group
  const int split = blockIdx.z;
  const int D = p.D, ps = p.ps, tile = p.tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = split * p.pps;
  const int nh = min(R, p.rep - h0);
  const Layout L = layout(tile, D, R, p.pps, sizeof(T));
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + L.q_off);
  int* pages = reinterpret_cast<int*>(smem + L.pages_off);

  // the slot's position, the split's table entries and q are read
  // together (pps <= NT), so their latencies overlap; a block whose split
  // starts past the slot's live pages then exits
  const int pos = p.positions[b];
  if (tid < p.pps && j0 + tid < p.nb)
    pages[tid] = max(p.table[(size_t)b * p.nb + j0 + tid], 0);
  const T* qg = static_cast<const T*>(p.q) +
                ((size_t)b * p.Hq + (size_t)g * p.rep + h0) * D;
  for (int i = tid; i < R * D; i += NT)
    qs[i] = i < nh * D ? qg[i] : from_f<T>(0.f);
  const int live = min(pos / ps + 1, p.nb);
  if (j0 >= live) return;
  __syncthreads();

  const int npages = min(p.pps, live - j0);
  const int tpp = (ps + tile - 1) / tile;  // tiles per page
  const int ntiles = npages * tpp;
  const int NC = D / VE;                        // chunks in a row
  const int G = min(32, 1 << (32 - __clz(NC - 1)));  // lanes per token
  const int li = lane & (G - 1);
  const int NGW = 32 / G, NG = NW * NGW;        // token groups: warp, block
  const int gi = warp * NGW + lane / G;

  const size_t stage = (size_t)2 * tile * D;

  const T* kpool = static_cast<const T*>(p.k);
  const T* vpool = static_cast<const T*>(p.v);
  auto issue = [&](int i) {  // tile i of the split into its ring stage
    const int off = (i % tpp) * tile, n = min(tile, ps - off);
    const size_t src =
        (((size_t)pages[i / tpp] * p.Hkv + g) * ps + off) * (size_t)D;
    T* dk = ring + (size_t)(i % STAGES) * stage;
    T* dv = dk + (size_t)tile * D;
    if constexpr (VE * sizeof(T) == 16) {
      const int chunks = n * D / VE;
      for (int c = tid; c < 2 * chunks; c += NT) {
        const int cc = c < chunks ? c : c - chunks;
        cp_async16((c < chunks ? dk : dv) + cc * VE,
                   (c < chunks ? kpool : vpool) + src + cc * VE);
      }
    } else {
      for (int e = tid; e < n * D; e += NT) {
        dk[e] = kpool[src + e];
        dv[e] = vpool[src + e];
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }

  float m[R], l[R], acc[R][C][VE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][c][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i landed for all; tile i - 1's stage is free
    if (i + STAGES - 1 < ntiles) issue(i + STAGES - 1);
    cp_async_commit();

    const T* sk = ring + (size_t)(i % STAGES) * stage;
    const T* sv = sk + (size_t)tile * D;
    const int off = (i % tpp) * tile, n = min(tile, ps - off);
    const int tok0 = (j0 + i / tpp) * ps + off;
    for (int t0 = 0; t0 < n; t0 += NG) {
      const int t = t0 + gi;
      const bool active = t < n, valid = active && tok0 + t <= pos;
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = li + c * G;
        if (active && ch < NC) {
          float kf[VE];
          load_f<T, VE>(sk + (size_t)t * D + ch * VE, kf);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float qf[VE];
            load_f<T, VE>(qs + r * D + ch * VE, qf);
#pragma unroll
            for (int e = 0; e < VE; ++e) part[r] = fmaf(qf[e], kf[e], part[r]);
          }
        }
      }
      float pv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = part[r];
        for (int o = G >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        s = valid ? s * kLog2e : kNegInf;
        float mx = s;
        for (int o = G; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        if (mx > m[r]) {  // warp-uniform
          const float alpha = exp2f(m[r] - mx);
          m[r] = mx;
          l[r] *= alpha;
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int e = 0; e < VE; ++e) acc[r][c][e] *= alpha;
        }
        const float pr = valid ? exp2f(s - m[r]) : 0.f;
        l[r] += pr;
        pv[r] = to_f(from_f<T>(pr));
      }
      if (valid) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ch = li + c * G;
          if (ch < NC) {
            float vf[VE];
            load_f<T, VE>(sv + (size_t)t * D + ch * VE, vf);
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int e = 0; e < VE; ++e)
                acc[r][c][e] = fmaf(pv[r], vf[e], acc[r][c][e]);
          }
        }
      }
    }
  }

  // the warp's groups share its running max: sum their partials
#pragma unroll
  for (int r = 0; r < R; ++r)
    for (int o = G; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(FULL, l[r], o);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          acc[r][c][e] += __shfl_xor_sync(FULL, acc[r][c][e], o);
    }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there
  float* wml = reinterpret_cast<float*>(smem);  // [NW][R][2]
  float* wacc = wml + NW * R * 2;               // [NW][R][D]
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = li + c * G;
        if (ch < NC)
#pragma unroll
          for (int e = 0; e < VE; ++e)
            wacc[(warp * R + r) * D + ch * VE + e] = acc[r][c][e];
      }
  }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      wml[(warp * R + r) * 2] = m[r];
      wml[(warp * R + r) * 2 + 1] = l[r];
    }
  __syncthreads();

  // merge the warps in order into this split's (m, l, acc) per head
  const size_t row = (size_t)D + 2;
  float* ws = p.ws + (((size_t)b * p.Hq + (size_t)g * p.rep + h0) *
                          p.n_splits + split) * row;
  const size_t head_stride = (size_t)p.n_splits * row;
  for (int i = tid; i < nh * (D + 1); i += NT) {
    const int r = i / (D + 1), d = i % (D + 1);  // d == D: the statistics
    float mm = kNegInf;
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wml[(w * R + r) * 2]);
    float a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float sc = exp2f(wml[(w * R + r) * 2] - mm);
      a += (d < D ? wacc[(w * R + r) * D + d] : wml[(w * R + r) * 2 + 1]) * sc;
    }
    float* wh = ws + r * head_stride;
    if (d < D) {
      wh[2 + d] = a;
    } else {
      wh[0] = mm;
      wh[1] = a;
    }
  }
}

// one block per (query head, slot): the slot's live splits in split order.
// Warp 0's lanes read the splits' statistics together and reduce them in
// a fixed order; then each thread sums its features over the splits.
template <typename T>
__global__ void __launch_bounds__(NT) paged_decode_combine_kernel(Params p) {
  extern __shared__ float scale[];  // [n_splits], then l
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int live = min(p.positions[b] / p.ps + 1, p.nb);
  const int ns = (live + p.pps - 1) / p.pps;
  const size_t row = (size_t)p.D + 2;
  const float* ws = p.ws + ((size_t)b * p.Hq + h) * p.n_splits * row;
  if (tid < 32) {
    float mm = kNegInf;
    for (int s = tid; s < ns; s += 32) mm = fmaxf(mm, ws[s * row]);
    for (int o = 16; o > 0; o >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, o));
    float ll = 0.f;
    for (int s = tid; s < ns; s += 32) {
      const float sc = exp2f(ws[s * row] - mm);
      scale[s] = sc;
      ll = fmaf(ws[s * row + 1], sc, ll);
    }
    for (int o = 16; o > 0; o >>= 1) ll += __shfl_xor_sync(FULL, ll, o);
    if (tid == 0) scale[p.n_splits] = ll == 0.f ? 1.f : ll;
  }
  __syncthreads();
  const float l = scale[p.n_splits];
  T* out = static_cast<T*>(p.out) + ((size_t)b * p.Hq + h) * p.D;
  for (int d = tid; d < p.D; d += NT) {
    float a = 0.f;
    for (int s = 0; s < ns; ++s) a = fmaf(ws[s * row + 2 + d], scale[s], a);
    out[d] = from_f<T>(a / l);
  }
}

template <typename T, int VE, int C, int R>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L = layout(p.tile, p.D, R, p.pps, sizeof(T));
  auto kern = paged_decode_split_kernel<T, VE, C, R>;
  if (L.bytes > 48 * 1024) {  // per device, so raised on every such call
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(p.B, p.Hkv * p.head_tiles, p.n_splits), NT, L.bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T>
      <<<dim3(p.Hq, p.B), NT, (p.n_splits + 1) * sizeof(float), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int VE, int C>
cudaError_t by_heads(const Params& p, cudaStream_t st) {
  switch (p.heads) {
    case 1: return launch<T, VE, C, 1>(p, st);
    case 2: return launch<T, VE, C, 2>(p, st);
    case 4: return launch<T, VE, C, 4>(p, st);
    case 8: return launch<T, VE, C, 8>(p, st);
  }
  return cudaErrorInvalidValue;
}

// chunks per lane: the row's chunks over at most 32 lanes, rounded up to a
// power of two
inline int chunks_per_lane(int nc) {
  int c = 1;
  while (c * 32 < nc) c <<= 1;
  return c;
}

template <typename T>
cudaError_t dispatch(const Params& p, bool vector, cudaStream_t st) {
  constexpr int VE = 16 / sizeof(T);
  if (vector) {
    const uintptr_t addr = (uintptr_t)p.q | (uintptr_t)p.k | (uintptr_t)p.v;
    if ((p.D * sizeof(T)) % 16 || p.D > 256 || addr % 16)
      return cudaErrorInvalidValue;
    const int c = chunks_per_lane(p.D / VE);  // 2 only for fp32 D > 128
    if (c == 1) return by_heads<T, VE, 1>(p, st);
    if constexpr (sizeof(T) == 4)
      if (c == 2) return by_heads<T, VE, 2>(p, st);
    return cudaErrorInvalidValue;
  }
  if (p.heads != 1) return cudaErrorInvalidValue;
  switch (chunks_per_lane(p.D)) {
    case 1: return launch<T, 1, 1, 1>(p, st);
    case 2: return launch<T, 1, 2, 1>(p, st);
    case 4: return launch<T, 1, 4, 1>(p, st);
    case 8: return launch<T, 1, 8, 1>(p, st);
    case 16: return launch<T, 1, 16, 1>(p, st);
    case 32: return launch<T, 1, 32, 1>(p, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, Hq, D] pre-scaled, contiguous; pools: [P, Hkv, page_size, D]
// contiguous; table: [B, num_blocks] int32; positions: [B] int32; ws:
// fp32 [B, Hq, n_splits, D + 2] with n_splits = ceil(num_blocks /
// pages_per_split); out: [B, Hq, D]. tile: tokens of a ring stage (at most
// page_size); heads: query heads per block (1, 2, 4 or 8; 1 on the scalar
// route). vector: 1 for the 16-byte route, 0 for the scalar one. dtype: 0 =
// float32, 1 = bfloat16. Launches the split kernel and the combine kernel;
// returns the CUDA error code.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* table,
                            const void* positions, void* ws, void* out, int B,
                            int Hq, int Hkv, int page_size, int num_blocks,
                            int D, int pages_per_split, int tile, int heads,
                            int vector, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv || page_size <= 0 || num_blocks <= 0 ||
      D <= 0 || D > 1024 || pages_per_split <= 0 ||
      pages_per_split > NT || tile <= 0 ||
      tile > page_size || heads <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.table = static_cast<const int*>(table);
  p.positions = static_cast<const int*>(positions);
  p.ws = static_cast<float*>(ws);
  p.out = out;
  p.B = B;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.ps = page_size;
  p.nb = num_blocks;
  p.D = D;
  p.pps = pages_per_split;
  p.n_splits = (num_blocks + pages_per_split - 1) / pages_per_split;
  p.tile = tile;
  p.rep = Hq / Hkv;
  p.heads = heads;
  p.head_tiles = (p.rep + heads - 1) / heads;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(p, vector != 0, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(p, vector != 0, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
