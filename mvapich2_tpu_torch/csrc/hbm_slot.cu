// HBM slot-segment kernels for Hopper (sm_90a): the on-card phase of a
// collective among R ranks whose buffers share one GPU's memory.
//
// K1 mv2t_slot_reduce,    replaces mvapich2_tpu/ops/pallas_hbm.py
//    mv2t_slot_reduce_ptrs fused_reduce_to_slot (Pallas body `krnl`).
//                         Reads the R rank slots and writes their sum (or
//                         mean) once. Bound: (R+1)*m bytes of device
//                         memory traffic for m bytes per slot; no
//                         arithmetic to speak of, so memory-bound.
// K2 mv2t_fused_allreduce replaces pallas_hbm.py fused_allreduce (Pallas
//                         body `krnl`). Interleaved (M, R, 128) slots in,
//                         the sum written back into every rank row.
//                         Bound: 2*R*m bytes, memory-bound.
//
// K1 has one kernel body and two addressings of rank r's element p:
//   Strided  one stacked tensor: planar (R, M, 128), interleaved
//            (M, R, 128), or a flat (R, n) (planar with row_stride 128,
//            any n); mv2t_slot_reduce.
//   ByPtr    R separate flat sources of n elements (R <= 64), their
//            addresses passed by value as the ring kernels pass RankPtrs:
//            the ranks' deposits read in place, with no staging copy;
//            mv2t_slot_reduce_ptrs.
// A thread walks a grid-stride loop over the 16-byte words of the result
// (V = 16 / sizeof(T) elements), then over the tail elements past the
// last whole word; an instance with WORDS false walks elements only (the
// wrapper picks it when a source or the output is not 16-byte aligned).
// For its position a thread loads the R rank words kGroup at a time, all
// of a group before it folds any, so R * 16 bytes (at most kGroup * 16)
// are in flight a thread; the loads take the read-only path
// (ld.global.nc): no source is written while the kernel runs. It sums in
// rank order 0..R-1 in registers and stores once. K2 walks its
// (M, R, 128) words the same way and stores R times.
//
// Accumulation: float/__half/__nv_bfloat16 in float; int32/int16/int8/
// uint8/uint16 in int32 and uint32 in uint32, cast to the slot dtype on
// store (sums wrap, as the Pallas body's output cast does). mean rounds
// the sum to the slot dtype, then multiplies it by the scale the caller
// passes and rounds again, as the Pallas body's `s * scale` does on the
// dtype's sum: the scale is the float value of 1/R, and for __half and
// __nv_bfloat16 that value rounded to the dtype (the weak-typed Python
// scalar takes the array's dtype). Integer sums take the mean of the
// 32-bit sum through float, truncated toward zero.
//
// Left for later: TMA or cp.async staging of the rank loads.
//
// Plain C interface, built by nvcc into a shared library and bound with
// ctypes (mvapich2_tpu_torch/ops/_build.py). Each entry launches on the
// stream it is given and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

template <typename T> struct Acc { using type = int32_t; };
template <> struct Acc<uint32_t> { using type = uint32_t; };
template <> struct Acc<float> { using type = float; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

template <typename T>
__device__ __forceinline__ typename Acc<T>::type to_acc(T v) {
  return static_cast<typename Acc<T>::type>(v);
}
template <> __device__ __forceinline__ float to_acc<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_acc<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_float(float v) {
  return static_cast<T>(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The stored value: the sum, or the sum rounded to T times the scale,
// rounded again (for float the first rounding changes nothing). Integer
// sums with mean go through float and truncate toward zero, then wrap to
// the slot width.
template <typename T>
__device__ __forceinline__ T finish(float acc, int mean, float scale) {
  const T s = from_float<T>(acc);
  return mean ? from_float<T>(to_acc<T>(s) * scale) : s;
}
template <typename T>
__device__ __forceinline__ T finish(int32_t acc, int mean, float scale) {
  int32_t v = mean ? static_cast<int32_t>(static_cast<float>(acc) * scale)
                   : acc;
  return static_cast<T>(v);
}
template <typename T>
__device__ __forceinline__ T finish(uint32_t acc, int mean, float scale) {
  return mean ? static_cast<T>(static_cast<float>(acc) * scale) : acc;
}

// K1's addressings: a pointer to rank r's element p.
// Strided, planar (R, M, 128): rank_stride = M*128, row_stride = 128;
// interleaved (M, R, 128): rank_stride = 128, row_stride = R*128; a flat
// (R, n): rank_stride = n, row_stride = 128. A word at p (p a multiple of
// V, which divides 128) never straddles a row.
template <typename T> struct Strided {
  const T* x;
  int64_t rank_stride, row_stride;
  __device__ const T* at(int r, int64_t p) const {
    return x + (p >> 7) * row_stride + (p & 127) + r * rank_stride;
  }
};

constexpr int kMaxSlots = 64;
struct SlotPtrs {
  const void* in[kMaxSlots];
};

template <typename T> struct ByPtr {
  SlotPtrs s;
  __device__ const T* at(int r, int64_t p) const {
    return static_cast<const T*>(s.in[r]) + p;
  }
};

constexpr int kGroup = 8;        // rank loads in flight before a fold

// Fold the R ranks' unit at p (U: uint4, a word of V elements, or T, one
// element) in rank order and store it into out + p.
template <typename T, typename U, typename Addr>
__device__ __forceinline__ void fold_at(const Addr& a, T* __restrict__ out,
                                        int R, int64_t p, int mean,
                                        float scale) {
  constexpr int W = sizeof(U) / sizeof(T);
  using A = typename Acc<T>::type;
  A acc[W];
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = A(0);
  for (int r0 = 0; r0 < R; r0 += kGroup) {
    U w[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
      if (r0 + j < R)
        w[j] = __ldg(reinterpret_cast<const U*>(a.at(r0 + j, p)));
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (r0 + j < R) {
        const T* e = reinterpret_cast<const T*>(&w[j]);
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] += to_acc<T>(e[i]);
      }
    }
  }
  U o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < W; ++i) oe[i] = finish<T>(acc[i], mean, scale);
  *reinterpret_cast<U*>(out + p) = o;
}

// K1 over n result elements: the words, then the tail elements (WORDS),
// or every element.
template <typename T, bool WORDS, typename Addr>
__global__ void slot_reduce_kernel(Addr a, T* __restrict__ out, int R,
                                   int64_t n, int mean, float scale) {
  constexpr int V = 16 / sizeof(T);
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t e0 = 0;
  if (WORDS) {
    const int64_t nw = n / V;
    for (int64_t v = tid; v < nw; v += step)
      fold_at<T, uint4>(a, out, R, v * V, mean, scale);
    e0 = nw * V;
  }
  for (int64_t e = e0 + tid; e < n; e += step)
    fold_at<T, T>(a, out, R, e, mean, scale);
}

// K2 over interleaved (M, R, 128). `out` may be `x` (in place): each
// thread reads all R rows of its own position before it writes them,
// and no two threads share a position, so neither pointer is restrict.
template <typename T>
__global__ void fused_allreduce_kernel(const T* x, T* out, int R,
                                       int64_t nvec, int mean,
                                       float scale) {
  constexpr int V = 16 / sizeof(T);
  using A = typename Acc<T>::type;
  const int64_t row_stride = static_cast<int64_t>(R) * 128;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < nvec; v += step) {
    const int64_t p = v * V;
    const int64_t base = (p >> 7) * row_stride + (p & 127);
    A acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = A(0);
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + base + r * 128);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += to_acc<T>(e[i]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < V; ++i) oe[i] = finish<T>(acc[i], mean, scale);
#pragma unroll 4
    for (int r = 0; r < R; ++r)
      *reinterpret_cast<uint4*>(out + base + r * 128) = o;
  }
}

// dtype codes shared with ops/hbm.py _DTYPE_CODES
enum DType { F32 = 0, F16 = 1, BF16 = 2, I32 = 3, I16 = 4, I8 = 5, U8 = 6,
             U16 = 7, U32 = 8 };

template <typename T, typename Addr>
void launch_reduce(const Addr& a, void* out, int R, int64_t n, int words,
                   int mean, float scale, int grid, int block,
                   cudaStream_t s) {
  if (words)
    slot_reduce_kernel<T, true, Addr><<<grid, block, 0, s>>>(
        a, static_cast<T*>(out), R, n, mean, scale);
  else
    slot_reduce_kernel<T, false, Addr><<<grid, block, 0, s>>>(
        a, static_cast<T*>(out), R, n, mean, scale);
}

template <typename T>
void launch_strided(const void* x, void* out, int R, int64_t n,
                    int64_t rank_stride, int64_t row_stride, int words,
                    int mean, float scale, int grid, int block,
                    cudaStream_t s) {
  const Strided<T> a = {static_cast<const T*>(x), rank_stride, row_stride};
  launch_reduce<T>(a, out, R, n, words, mean, scale, grid, block, s);
}

template <typename T>
void launch_ptrs(const SlotPtrs& ptrs, void* out, int R, int64_t n,
                 int words, int mean, float scale, int grid, int block,
                 cudaStream_t s) {
  const ByPtr<T> a = {ptrs};
  launch_reduce<T>(a, out, R, n, words, mean, scale, grid, block, s);
}

template <typename T>
void launch_fused(const void* x, void* out, int R, int64_t nvec, int mean,
                  float scale, int grid, int block, cudaStream_t s) {
  fused_allreduce_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, nvec, mean, scale);
}

}  // namespace

extern "C" {

// K1 over a stacked tensor x (the Strided addressing), n result elements;
// words: x, out and every rank's row are 16-byte aligned and the rows' word
// positions never straddle a row (n a multiple of V for a flat (R, n)).
int mv2t_slot_reduce(int dtype, const void* x, void* out, int R,
                     long long n, long long rank_stride,
                     long long row_stride, int words, int mean, float scale,
                     int grid, int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: launch_strided<float>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case F16: launch_strided<__half>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case BF16: launch_strided<__nv_bfloat16>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case I32: launch_strided<int32_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case I16: launch_strided<int16_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case I8: launch_strided<int8_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case U8: launch_strided<uint8_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case U16: launch_strided<uint16_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    case U32: launch_strided<uint32_t>(x, out, R, n, rank_stride, row_stride, words, mean, scale, grid, block, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 over R flat sources (the ByPtr addressing): ins, a host array of R
// device addresses of n elements each; words: every source and out
// 16-byte aligned.
int mv2t_slot_reduce_ptrs(int dtype, const void* ins, void* out, int R,
                          long long n, int words, int mean, float scale,
                          int grid, int block, void* stream) {
  if (R < 1 || R > kMaxSlots || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotPtrs ptrs = {};
  const void* const* in = static_cast<const void* const*>(ins);
  for (int r = 0; r < R; ++r) ptrs.in[r] = in[r];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: launch_ptrs<float>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case F16: launch_ptrs<__half>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case BF16: launch_ptrs<__nv_bfloat16>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case I32: launch_ptrs<int32_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case I16: launch_ptrs<int16_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case I8: launch_ptrs<int8_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case U8: launch_ptrs<uint8_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case U16: launch_ptrs<uint16_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    case U32: launch_ptrs<uint32_t>(ptrs, out, R, n, words, mean, scale, grid, block, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int mv2t_fused_allreduce(int dtype, const void* x, void* out, int R,
                         long long nvec, int mean, float scale, int grid,
                         int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: launch_fused<float>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case F16: launch_fused<__half>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case BF16: launch_fused<__nv_bfloat16>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case I32: launch_fused<int32_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case I16: launch_fused<int16_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case I8: launch_fused<int8_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case U8: launch_fused<uint8_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case U16: launch_fused<uint16_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    case U32: launch_fused<uint32_t>(x, out, R, nvec, mean, scale, grid, block, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* mv2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
