// LayerNorm and RMSNorm, forward and backward, for Hopper (sm_90a), CUDA C++
// with a plain C interface (bound with ctypes from kernels/norms.py).
//
// Replaces paddle_tpu/kernels/norms.py `_ln_kernel` (launched by `_ln_fwd`)
// and `_rms_kernel` (launched by `_rms_fwd`), and computes their backward
// rules `_ln_bwd_rule` and `_rms_bwd_rule`, which the JAX package leaves to
// XLA's fusion outside Pallas. Statistics are fp32 and follow the JAX
// arithmetic: LayerNorm takes the mean, then the mean of the squared
// deviations (not Welford, not E[x^2] - mean^2); RMSNorm the mean of x^2;
// both rsqrt(. + eps). The backward recomputes them from x (the JAX residuals
// are x and the weight, nothing else is saved):
//   xhat = (x - mean) * rstd          (RMSNorm: x * rstd)
//   wg   = g * w
//   dx   = (wg - mean(wg) - xhat * mean(wg * xhat)) * rstd
//                                     (RMSNorm: no mean(wg) term)
//   dw   = sum over rows of g * xhat,  db = sum over rows of g
// dx is written in x's dtype, dw and db in the weight's.
//
// What bounds both on the H100: bytes. The forward reads x and writes y
// (~8 fp32 operations per element), the backward reads x and g and writes
// dx (~15); both are far below the ~20 operations per byte where fp32
// arithmetic, not memory, would be the limit.
//
// Two routes, chosen by the wrapper from the shape, explicitly:
// * warp: one warp per row of H values, H a multiple of the 16-byte vector
//   (8 bf16 or 4 fp32) and at most 2048. Lane l owns vectors l, l+32, ...,
//   so neighbouring lanes read neighbouring addresses; the row stays in
//   registers in its own dtype (at most 64 values a lane) and the row sums
//   are warp shuffles, with no barrier. The weight and bias are read as vectors per
//   row and stay in L1/L2.
// * block: one block per row (forward) or per range of rows (backward),
//   threads striding over the row with scalar loads, the sums through
//   shared memory; the row is re-read from L1/L2 for each pass. For any H.
//
// The backward runs on a fixed grid of G blocks (as many as fit on the card
// at once, fewer when there are fewer rows); block i owns a contiguous range
// of rows. On the warp route each warp takes every WARPS-th row of the range
// and each lane adds g*xhat (and g) for its own columns into its warp's fp32
// slice of shared memory; the block then sums its warps' slices in a fixed
// order into row i of an fp32 partial buffer [G, H] (dw, then db at
// [G, H] further on), which the wrapper allocates. A lane's sums sit in
// shared memory lane-interleaved, so each access of the warp hits 32 banks.
// A second kernel sums the G partials of each column in a fixed order and
// writes dw (and db). There are no atomics: two calls give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int LN = 0, RMS = 1;
constexpr int ROUTE_WARP = 0, ROUTE_BLOCK = 1;
constexpr int WARPS = 4;          // rows in flight per block, warp route
constexpr int NT_WARP = WARPS * 32;
constexpr int NT_BLOCK = 256;     // threads per row, block route
constexpr int MAX_LANE_VALUES = 64;  // row values a lane holds
constexpr int RED_X = 32, RED_Y = 16;  // the partial-sum kernel's block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements through 16-byte (or, for 8-byte runs, 8-byte)
// accesses; the caller guarantees the alignment
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, float out[N]) {
  constexpr int BYTES = N * sizeof(T);
  using W = typename std::conditional<BYTES % 16 == 0, uint4, uint2>::type;
  constexpr int NW = BYTES / sizeof(W);
  W raw[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) raw[i] = reinterpret_cast<const W*>(src)[i];
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(e[i]);
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* dst, const float in[N]) {
  constexpr int BYTES = N * sizeof(T);
  using W = typename std::conditional<BYTES % 16 == 0, uint4, uint2>::type;
  constexpr int NW = BYTES / sizeof(W);
  W raw[NW];
  T* e = reinterpret_cast<T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f<T>(in[i]);
#pragma unroll
  for (int i = 0; i < NW; ++i) reinterpret_cast<W*>(dst)[i] = raw[i];
}

// element e of a 16-byte vector of T, as fp32: rows stay in registers in
// their own dtype (half the registers of fp32 for bf16) and are widened
// where they are used
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  return to_f(reinterpret_cast<const T*>(&v)[e]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's sum of one value per thread, the same in every thread; the
// warps' sums are added in warp order. `red` holds NT/32 floats.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// ---------------------------------------------------------------- forward
template <int NORM, typename TX, typename TW, int NV>
__global__ void __launch_bounds__(NT_WARP) norm_fwd_warp_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const TW* __restrict__ b, TX* __restrict__ y, int rows, int H,
    float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nvec = H / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * H);
  uint4 v[NV];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < nvec) {
      v[j] = xr[c];
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += elem<TX>(v[j], e);
    }
  }
  float mean = 0.f;
  if (NORM == LN) mean = warp_sum(s) / H;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = elem<TX>(v[j], e) - mean;
        q += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / H + eps);
  TX* yr = y + (long long)row * H;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < nvec) {
      float wv[VEC], out[VEC];
      load_vec<TW, VEC>(w + c * VEC, wv);
      if (NORM == LN) {
        float bv[VEC];
        load_vec<TW, VEC>(b + c * VEC, bv);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          out[e] = (elem<TX>(v[j], e) - mean) * rstd * wv[e] + bv[e];
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          out[e] = elem<TX>(v[j], e) * rstd * wv[e];
      }
      store_vec<TX, VEC>(yr + c * VEC, out);
    }
  }
}

template <int NORM, typename TX, typename TW>
__global__ void __launch_bounds__(NT_BLOCK) norm_fwd_block_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const TW* __restrict__ b, TX* __restrict__ y, int H, float eps) {
  __shared__ float red[NT_BLOCK / 32];
  const TX* xr = x + (long long)blockIdx.x * H;
  TX* yr = y + (long long)blockIdx.x * H;
  float mean = 0.f;
  if (NORM == LN) {
    float s = 0.f;
    for (int c = threadIdx.x; c < H; c += NT_BLOCK) s += to_f(xr[c]);
    mean = block_sum<NT_BLOCK>(s, red) / H;
  }
  float q = 0.f;
  for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
    const float d = to_f(xr[c]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum<NT_BLOCK>(q, red) / H + eps);
  for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
    float out = (to_f(xr[c]) - mean) * rstd * to_f(w[c]);
    if (NORM == LN) out += to_f(b[c]);
    yr[c] = from_f<TX>(out);
  }
}

// --------------------------------------------------------------- backward
template <int NORM, typename TX, typename TW, int NV>
__global__ void __launch_bounds__(NT_WARP) norm_bwd_warp_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const TX* __restrict__ g, TX* __restrict__ dx,
    float* __restrict__ partial, int rows, int H, float eps,
    int rows_per_block) {
  constexpr int VEC = 16 / sizeof(TX);
  constexpr int NACC = NORM == LN ? 2 : 1;  // dw (and db) per column
  constexpr int SLICE = NV * VEC * 32;       // one warp's sums of one kind
  extern __shared__ float acc[];             // [WARPS][NACC][SLICE]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nvec = H / VEC;
  // a lane's value e of its vector j sits at (j * VEC + e) * 32 + lane, so
  // the 32 lanes of one access hit 32 banks; a lane only ever touches its
  // own slots of its warp's slice
  float* mine = acc + warp * NACC * SLICE + lane;
#pragma unroll
  for (int i = 0; i < NV * VEC; ++i) {
    mine[i * 32] = 0.f;
    if (NORM == LN) mine[SLICE + i * 32] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0 + warp; row < r1; row += WARPS) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * H);
    const uint4* gr = reinterpret_cast<const uint4*>(g + (long long)row * H);
    uint4 xv[NV], gv[NV];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        xv[j] = xr[c];
        gv[j] = gr[c];
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += elem<TX>(xv[j], e);
      }
    }
    float mean = 0.f;
    if (NORM == LN) mean = warp_sum(s) / H;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (lane + 32 * j < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = elem<TX>(xv[j], e) - mean;
          q += d * d;
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(q) / H + eps);
    // the row's sums of wg and wg * xhat, and the columns' sums in shared
    // memory; xhat and wg are formed again below from the row kept in x's
    // dtype, which costs fewer registers than keeping them in fp32
    float swg = 0.f, swgx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        float wv[VEC];
        load_vec<TW, VEC>(w + c * VEC, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (elem<TX>(xv[j], e) - mean) * rstd;
          const float gg = elem<TX>(gv[j], e);
          const float wg = gg * wv[e];
          mine[(j * VEC + e) * 32] += gg * xh;
          if (NORM == LN) mine[SLICE + (j * VEC + e) * 32] += gg;
          swg += wg;
          swgx += wg * xh;
        }
      }
    }
    const float m_wg = NORM == LN ? warp_sum(swg) / H : 0.f;
    const float m_wgx = warp_sum(swgx) / H;
    TX* dr = dx + (long long)row * H;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = lane + 32 * j;
      if (c < nvec) {
        float wv[VEC], out[VEC];
        load_vec<TW, VEC>(w + c * VEC, wv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (elem<TX>(xv[j], e) - mean) * rstd;
          const float wg = elem<TX>(gv[j], e) * wv[e];
          out[e] = (wg - m_wg - xh * m_wgx) * rstd;
        }
        store_vec<TX, VEC>(dr + c * VEC, out);
      }
    }
  }
  __syncthreads();
  // the warps' slices, summed in warp order, into this block's partial row
  const long long G = gridDim.x;
  for (int col = threadIdx.x; col < H; col += NT_WARP) {
    const int c = col / VEC;  // the vector, then its lane and slot
    const int slot = ((c / 32) * VEC + col % VEC) * 32 + c % 32;
#pragma unroll
    for (int a = 0; a < NACC; ++a) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS; ++k) t += acc[(k * NACC + a) * SLICE + slot];
      partial[(a * G + blockIdx.x) * H + col] = t;
    }
  }
}

template <int NORM, typename TX, typename TW>
__global__ void __launch_bounds__(NT_BLOCK) norm_bwd_block_kernel(
    const TX* __restrict__ x, const TW* __restrict__ w,
    const TX* __restrict__ g, TX* __restrict__ dx,
    float* __restrict__ partial, int rows, int H, float eps,
    int rows_per_block) {
  __shared__ float red[NT_BLOCK / 32];
  const long long G = gridDim.x;
  // a thread owns columns threadIdx.x + k * NT_BLOCK of this block's
  // partial rows, so it reads back only what it wrote itself
  float* pdw = partial + (long long)blockIdx.x * H;
  float* pdb = partial + (G + blockIdx.x) * H;
  for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
    pdw[c] = 0.f;
    if (NORM == LN) pdb[c] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  for (int row = r0; row < r1; ++row) {
    const TX* xr = x + (long long)row * H;
    const TX* gr = g + (long long)row * H;
    float mean = 0.f;
    if (NORM == LN) {
      float s = 0.f;
      for (int c = threadIdx.x; c < H; c += NT_BLOCK) s += to_f(xr[c]);
      mean = block_sum<NT_BLOCK>(s, red) / H;
    }
    float q = 0.f;
    for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
      const float d = to_f(xr[c]) - mean;
      q += d * d;
    }
    const float rstd = rsqrtf(block_sum<NT_BLOCK>(q, red) / H + eps);
    float swg = 0.f, swgx = 0.f;
    for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float gg = to_f(gr[c]);
      const float wg = gg * to_f(w[c]);
      pdw[c] += gg * xh;
      if (NORM == LN) pdb[c] += gg;
      swg += wg;
      swgx += wg * xh;
    }
    const float m_wg = NORM == LN ? block_sum<NT_BLOCK>(swg, red) / H : 0.f;
    const float m_wgx = block_sum<NT_BLOCK>(swgx, red) / H;
    TX* dr = dx + (long long)row * H;
    for (int c = threadIdx.x; c < H; c += NT_BLOCK) {
      const float xh = (to_f(xr[c]) - mean) * rstd;
      const float wg = to_f(gr[c]) * to_f(w[c]);
      dr[c] = from_f<TX>((wg - m_wg - xh * m_wgx) * rstd);
    }
  }
}

// dw (blockIdx.y 0) and db (1) of each column: the G partials summed in a
// fixed order, RED_Y strided chains then a fixed tree
template <typename TW>
__global__ void __launch_bounds__(RED_X * RED_Y) norm_bwd_reduce_kernel(
    const float* __restrict__ partial, int G, int H, TW* __restrict__ dw,
    TW* __restrict__ db) {
  __shared__ float t[RED_Y][RED_X];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * RED_X + tx;
  const int a = blockIdx.y;
  float s = 0.f;
  if (c < H) {
    const float* p = partial + (long long)a * G * H + c;
    for (int k = ty; k < G; k += RED_Y) s += p[(long long)k * H];
  }
  t[ty][tx] = s;
  __syncthreads();
#pragma unroll
  for (int st = RED_Y / 2; st > 0; st >>= 1) {
    if (ty < st) t[ty][tx] += t[ty + st][tx];
    __syncthreads();
  }
  if (ty == 0 && c < H) (a == 0 ? dw : db)[c] = from_f<TW>(t[0][tx]);
}

// ------------------------------------------------------------------ launch
template <typename T> struct Tag { using type = T; };

// calls fn(integral_constant<NORM>, Tag<TX>, Tag<TW>) for the dtype codes
// (0 float32, 1 bfloat16); an unknown code is an invalid value
template <class Fn>
cudaError_t dispatch(int norm, int x_dtype, int w_dtype, Fn&& fn) {
  using N0 = std::integral_constant<int, LN>;
  using N1 = std::integral_constant<int, RMS>;
  switch ((norm << 2) | (x_dtype << 1) | w_dtype) {
    case 0: return fn(N0{}, Tag<float>{}, Tag<float>{});
    case 1: return fn(N0{}, Tag<float>{}, Tag<bf16>{});
    case 2: return fn(N0{}, Tag<bf16>{}, Tag<float>{});
    case 3: return fn(N0{}, Tag<bf16>{}, Tag<bf16>{});
    case 4: return fn(N1{}, Tag<float>{}, Tag<float>{});
    case 5: return fn(N1{}, Tag<float>{}, Tag<bf16>{});
    case 6: return fn(N1{}, Tag<bf16>{}, Tag<float>{});
    case 7: return fn(N1{}, Tag<bf16>{}, Tag<bf16>{});
    default: return cudaErrorInvalidValue;
  }
}

// calls fn(integral_constant<NV>) with the vectors a lane holds for a row of
// H, rounded up to a power of two; H must be a multiple of VEC and at most
// 32 * MAX_LANE_VALUES
template <int VEC, class Fn>
cudaError_t by_lane_vectors(int H, Fn&& fn) {
  const int need = (H / VEC + 31) / 32;
  if (H % VEC != 0 || H <= 0 || need * VEC > MAX_LANE_VALUES)
    return cudaErrorInvalidValue;
  if (need <= 1) return fn(std::integral_constant<int, 1>{});
  if (need <= 2) return fn(std::integral_constant<int, 2>{});
  if (need <= 4) return fn(std::integral_constant<int, 4>{});
  if (need <= 8) return fn(std::integral_constant<int, 8>{});
  if constexpr (16 * VEC <= MAX_LANE_VALUES) {
    if (need <= 16) return fn(std::integral_constant<int, 16>{});
  }
  return cudaErrorInvalidValue;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the warp route's backward kernel and its shared memory, with the
// attribute that allows more than 48 KB set once per kernel
template <int NORM, typename TX, typename TW, int NV>
const void* bwd_warp_kernel(size_t* smem) {
  static bool set = false;
  auto k = norm_bwd_warp_kernel<NORM, TX, TW, NV>;
  *smem = (size_t)WARPS * (NORM == LN ? 2 : 1) * NV * (16 / sizeof(TX)) * 32 *
          sizeof(float);
  if (!set) {
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         WARPS * 2 * 32 * MAX_LANE_VALUES * sizeof(float));
    set = true;
  }
  return (const void*)k;
}

// the fixed grid of the backward: as many blocks as fit on the card at once,
// and no more than the rows need
template <int NORM, typename TX, typename TW>
int bwd_grid(int rows, int H, int route) {
  int per_sm = 1;
  int rows_per = 1;
  if (route == ROUTE_WARP) {
    constexpr int VEC = 16 / sizeof(TX);
    by_lane_vectors<VEC>(H, [&](auto nv) {
      size_t smem = 0;
      const void* k = bwd_warp_kernel<NORM, TX, TW, decltype(nv)::value>(
          &smem);
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k,
                                                           NT_WARP, smem);
    });
    rows_per = WARPS;
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, norm_bwd_block_kernel<NORM, TX, TW>, NT_BLOCK, 0);
  }
  const int cap = (per_sm < 1 ? 1 : per_sm) * sm_count();
  const int need = (rows + rows_per - 1) / rows_per;
  return need < cap ? need : cap;
}

}  // namespace

// y = LayerNorm (norm 0) or RMSNorm (norm 1) of x [rows, H] over its rows,
// with weight w [H] (and bias b [H] for LayerNorm; ignored for RMSNorm).
// Dtype codes: 0 = float32, 1 = bfloat16, for x (and y) and for w (and b).
// route 0 = warp (H a multiple of 16 / sizeof(x), at most 2048, every
// pointer 16-byte aligned), 1 = block (any H). Returns the CUDA error.
extern "C" int norm_fwd(const void* x, const void* w, const void* b, void* y,
                        int rows, int H, float eps, int norm, int x_dtype,
                        int w_dtype, int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(norm, x_dtype, w_dtype, [&](auto n, auto tx, auto tw) {
    constexpr int NORM = decltype(n)::value;
    using TX = typename decltype(tx)::type;
    using TW = typename decltype(tw)::type;
    if (route == ROUTE_BLOCK) {
      norm_fwd_block_kernel<NORM, TX, TW><<<rows, NT_BLOCK, 0, s>>>(
          (const TX*)x, (const TW*)w, (const TW*)b, (TX*)y, H, eps);
      return cudaGetLastError();
    }
    if (route != ROUTE_WARP) return cudaErrorInvalidValue;
    constexpr int VEC = 16 / sizeof(TX);
    return by_lane_vectors<VEC>(H, [&](auto nv) {
      const int blocks = (rows + WARPS - 1) / WARPS;
      norm_fwd_warp_kernel<NORM, TX, TW, decltype(nv)::value>
          <<<blocks, NT_WARP, 0, s>>>((const TX*)x, (const TW*)w,
                                      (const TW*)b, (TX*)y, rows, H, eps);
      return cudaGetLastError();
    });
  });
}

// The number of blocks G of the backward for rows x H on this route: the
// wrapper allocates the fp32 partial buffer [2, G, H] (LayerNorm) or
// [G, H] (RMSNorm) for it. Returns G, or 0 for arguments no kernel takes.
extern "C" int norm_bwd_grid(int rows, int H, int norm, int x_dtype,
                             int w_dtype, int route) {
  int G = 0;
  if (rows <= 0 || H <= 0) return 0;
  dispatch(norm, x_dtype, w_dtype, [&](auto n, auto tx, auto tw) {
    G = bwd_grid<decltype(n)::value, typename decltype(tx)::type,
                 typename decltype(tw)::type>(rows, H, route);
    return cudaSuccess;
  });
  return G;
}

// dx [rows, H] (x's dtype), dw [H] (and db [H] for LayerNorm; ignored for
// RMSNorm) in w's dtype, from x, w and the output's gradient g (x's dtype),
// on G blocks (norm_bwd_grid) with the fp32 scratch `partial` of
// norm_bwd_grid's size. Codes as norm_fwd. Returns the CUDA error.
extern "C" int norm_bwd(const void* x, const void* w, const void* g, void* dx,
                        void* dw, void* db, void* partial, int rows, int H,
                        float eps, int norm, int x_dtype, int w_dtype,
                        int route, int G, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || H <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(norm, x_dtype, w_dtype, [&](auto n, auto tx, auto tw) {
    constexpr int NORM = decltype(n)::value;
    using TX = typename decltype(tx)::type;
    using TW = typename decltype(tw)::type;
    cudaError_t err;
    if (route == ROUTE_BLOCK) {
      const int rows_per = (rows + G - 1) / G;
      norm_bwd_block_kernel<NORM, TX, TW><<<G, NT_BLOCK, 0, s>>>(
          (const TX*)x, (const TW*)w, (const TX*)g, (TX*)dx, (float*)partial,
          rows, H, eps, rows_per);
      err = cudaGetLastError();
    } else if (route == ROUTE_WARP) {
      constexpr int VEC = 16 / sizeof(TX);
      err = by_lane_vectors<VEC>(H, [&](auto nv) {
        constexpr int NV = decltype(nv)::value;
        size_t smem = 0;
        bwd_warp_kernel<NORM, TX, TW, NV>(&smem);
        // whole groups of WARPS rows per block, so warp k always takes the
        // rows k, k + WARPS, ... of its block's range
        const int groups = (rows + WARPS - 1) / WARPS;
        const int rows_per = (groups + G - 1) / G * WARPS;
        norm_bwd_warp_kernel<NORM, TX, TW, NV><<<G, NT_WARP, smem, s>>>(
            (const TX*)x, (const TW*)w, (const TX*)g, (TX*)dx,
            (float*)partial, rows, H, eps, rows_per);
        return cudaGetLastError();
      });
    } else {
      return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
    const dim3 grid((H + RED_X - 1) / RED_X, NORM == LN ? 2 : 1);
    norm_bwd_reduce_kernel<TW><<<grid, dim3(RED_X, RED_Y), 0, s>>>(
        (const float*)partial, G, H, (TW*)dw, (TW*)db);
    return cudaGetLastError();
  });
}
