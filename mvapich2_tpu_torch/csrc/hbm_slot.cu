// HBM slot-segment kernels for Hopper (sm_90a): the on-card phase of a
// collective among R ranks whose buffers share one GPU's memory.
//
// K1 mv2t_slot_reduce     replaces mvapich2_tpu/ops/pallas_hbm.py
//                         fused_reduce_to_slot (Pallas body `krnl`).
//                         Reads the R rank slots and writes their sum (or
//                         mean) once. Bound: (R+1)*m bytes of device
//                         memory traffic for m bytes per slot; no
//                         arithmetic to speak of, so memory-bound.
// K2 mv2t_fused_allreduce replaces pallas_hbm.py fused_allreduce (Pallas
//                         body `krnl`). Interleaved (M, R, 128) slots in,
//                         the sum written back into every rank row.
//                         Bound: 2*R*m bytes, memory-bound.
//
// Design: each thread owns one 16-byte vector of consecutive lanes at a
// time and walks a grid-stride loop over the M*128/V vector positions of
// one rank row (V = 16 / sizeof(T)). For its position it loads the R
// rank vectors, sums them in rank order 0..R-1 in registers, and stores
// once (K1) or R times (K2). 128 lanes are a multiple of V for every
// dtype, so a vector never straddles a row of the (.., 128) layouts.
// The grid is a multiple of the SM count (the caller passes it).
//
// Accumulation: float/__half/__nv_bfloat16 in float; int32/int16/int8/
// uint8/uint16 in int32 and uint32 in uint32, cast to the slot dtype on
// store (sums wrap, as the Pallas body's output cast does). mean
// multiplies by the float value of 1/R that the caller passes, as the
// Pallas body does.
//
// Left for later: no TMA or cp.async pipelining of the rank loads, and
// no pointer-array read of the R deposits in place (the caller stages
// them into one stacked tensor first).
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

// The stored value: the sum, or the sum times the float scale. Integer
// sums with mean go through float and truncate toward zero, then wrap to
// the slot width.
template <typename T>
__device__ __forceinline__ T finish(float acc, int mean, float scale) {
  return from_float<T>(mean ? acc * scale : acc);
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

// K1. Output vector p (element offset p*V) is row p*V/128, lane
// p*V%128; rank r's vector sits at row*row_stride + lane + r*rank_stride.
// planar (R, M, 128): rank_stride = M*128, row_stride = 128.
// interleaved (M, R, 128): rank_stride = 128, row_stride = R*128.
template <typename T>
__global__ void slot_reduce_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, int R, int64_t nvec,
                                   int64_t rank_stride, int64_t row_stride,
                                   int mean, float scale) {
  constexpr int V = 16 / sizeof(T);
  using A = typename Acc<T>::type;
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < nvec; v += step) {
    const int64_t p = v * V;
    const T* src = x + (p >> 7) * row_stride + (p & 127);
    A acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = A(0);
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(src + r * rank_stride));
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += to_acc<T>(e[i]);
    }
    uint4 o;
    T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
    for (int i = 0; i < V; ++i) oe[i] = finish<T>(acc[i], mean, scale);
    *reinterpret_cast<uint4*>(out + p) = o;
  }
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

template <typename T>
void launch_reduce(const void* x, void* out, int R, int64_t nvec,
                   int64_t rank_stride, int64_t row_stride, int mean,
                   float scale, int grid, int block, cudaStream_t s) {
  slot_reduce_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, nvec, rank_stride,
      row_stride, mean, scale);
}

template <typename T>
void launch_fused(const void* x, void* out, int R, int64_t nvec, int mean,
                  float scale, int grid, int block, cudaStream_t s) {
  fused_allreduce_kernel<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, nvec, mean, scale);
}

}  // namespace

extern "C" {

int mv2t_slot_reduce(int dtype, const void* x, void* out, int R,
                     long long nvec, long long rank_stride,
                     long long row_stride, int mean, float scale, int grid,
                     int block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: launch_reduce<float>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case F16: launch_reduce<__half>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case BF16: launch_reduce<__nv_bfloat16>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case I32: launch_reduce<int32_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case I16: launch_reduce<int16_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case I8: launch_reduce<int8_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case U8: launch_reduce<uint8_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case U16: launch_reduce<uint16_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
    case U32: launch_reduce<uint32_t>(x, out, R, nvec, rank_stride, row_stride, mean, scale, grid, block, s); break;
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
