// Flash attention kernels for Hopper (sm_90a): the per-shard hot op of the
// sequence-parallel attention paths.
//
// K15 mv2t_flash_attention        replaces mvapich2_tpu/models/flash.py
//    flash_attention (Pallas body _flash_kernel, core _stream_blocks).
//    Normalised attention output in q's dtype.
// K16 mv2t_flash_attention_parts  replaces flash.py flash_attention_parts
//    (body _flash_parts_kernel). The unnormalised streaming parts
//    (m, num, den) in f32, block-local positions, for ring attention's
//    step merge.
//
// Both run one core, stream_blocks, as the JAX kernels share
// _stream_blocks: q cast to f32 and scaled by f32(D^-0.5) before the
// product; a walk over K/V tiles carrying each query row's running max m,
// numerator num[D] and denominator den in f32; the causal mask
// q0 + row >= k0 + col in global positions; p = 0 where s <= NEG_INF/2,
// the max taken as 0 while a row has seen no key, alpha = 0 while m is
// still NEG_INF. K15 divides num by max(den, 1e-20); K16 writes the raw
// parts. A block wholly in the queries' future gives out = 0 (K15) and
// m = NEG_INF, num = 0, den = 0 (K16).
//
// Layouts (the JAX ones, with a leading batch dim B: ranks of the stacked
// layout): q [B, T, H, D], k/v [B, Tk, H, D], out [B, T, H, D]; m and den
// [B, H, T], num [B, T, H, D]. One launch covers all B*H head rows.
//
// Translation. The Pallas kernel keeps a head's whole [Tk, D] K and V in
// VMEM (a grid step per (head, q tile), the key loop inside). That does
// not fit shared memory at this path's widths (Tk = 32768, D = 128: 16 MiB
// a head), so here K and V stream through shared memory in tiles of
// BK = 64 keys: one CTA per (head row, query tile of BQ = 64 rows), its
// Q tile resident, the running (m, num, den) of its rows in registers.
// The tile sizes are the kernel's own; the JAX block_q / block_k only
// order the f32 sums there. Causal key tiles past a query tile's last row
// are skipped (floor division, as flash.py:83-84; C's '/' truncates, so
// a negative numerator goes through floor_div). Query tiles are issued
// heaviest first (the last tile of every head row first), so the causal
// triangle's long rows do not finish last.
//
// Thread layout: 256 threads as 16 x 16 (ty, tx). For S = Q K^T a thread
// owns rows 4ty..4ty+3 and key columns 4tx..4tx+3 of the 64 x 64 score
// tile, reading Q and K transposed in shared memory ([D][BQ + 4]) as
// float4s; a row's 64 scores live on the 16 lanes of one half-warp, so
// its max and sum are four __shfl_xor_sync steps. For num += P V it owns
// the same 4 rows and D/16 head columns, interleaved so the 16 lanes read
// consecutive float4s of a V row. K and V share one buffer (K for S, then
// V for PV), so a CTA takes (2 D (BQ + 4) + BK (BQ + 4)) * 4 bytes of
// shared memory: 85 KiB at D = 128, two CTAs an SM.
//
// Arithmetic: f32 FMA on the CUDA cores, expf (not __expf), IEEE division;
// no tensor cores (TF32 would break the f32 tolerance). The dot product
// sums over d in order, P V over the tile's keys in order.
//
// Bound: operations. Each (query, key) pair the mask keeps costs 2D
// multiply-adds (4D flops); at the ring's and Ulysses' width (T = 32768,
// 16 heads of 128, causal) that is 4.4 TFLOP a call against 1 GiB of
// inputs and outputs, so the f32 rate (67 TFLOP/s on an H100 SXM) bounds
// it at 66 ms, 200 times the memory bound.
//
// Plain C interface, built by nvcc into a shared library and bound with
// ctypes (mvapich2_tpu_torch/ops/_build.py). Each entry launches on the
// stream it is given and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum DType { F32 = 0, F16 = 1, BF16 = 2 };

constexpr int BQ = 64;            // query rows of a CTA
constexpr int BK = 64;            // keys of a tile
constexpr int LDT = BQ + 4;       // row pitch of the transposed tiles
constexpr int NT = 256;           // threads: 16 x 16
constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return (2 * D * LDT + BK * LDT) * static_cast<int>(sizeof(float));
}

// Load rows [base, base + 64) of one head row of x ([., len, H, D]) into
// shared memory as f32 times `mul`: transposed (dst[d][r], pitch LDT) or
// straight (dst[r][d]). Rows past len read as 0.
template <typename T, int D, bool TRANSPOSED>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long pitch, int base,
                                          int len, float mul) {
#pragma unroll 4
  for (int e = threadIdx.x; e < 64 * D; e += NT) {
    const int r = e / D, d = e % D;
    const int t = base + r;
    const float x = t < len ? to_f32<T>(src[t * pitch + d]) * mul : 0.f;
    if (TRANSPOSED) dst[d * LDT + r] = x;
    else dst[r * D + d] = x;
  }
}

// One CTA: head row blockIdx.x (b * H + h), query tile
// nq - 1 - blockIdx.y. out (K15) or m/num/den (K16, parts != 0).
template <typename T, int D>
__global__ void __launch_bounds__(NT, D <= 128 ? 2 : 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ num_out,
             float* __restrict__ den_out, int H, int T_len, int Tk,
             long long q0, long long k0, int causal, int parts,
             float scale) {
  constexpr int CPT = D / 16;                  // head columns a thread
  constexpr int VEC = CPT < 4 ? CPT : 4;       // contiguous run of them
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][LDT]
  float* KV = Qt + D * LDT;                     // Kt [D][LDT] or V [BK][D]
  float* Pt = KV + D * LDT;                     // [BK][LDT]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = gridDim.y;
  const int qt = nq - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long pitch = static_cast<long long>(H) * D;   // token stride
  const T* qb = q + (static_cast<long long>(b) * T_len * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Tk * H + h) * D;
  const T* vb = v + (static_cast<long long>(b) * Tk * H + h) * D;
  const int qbase = qt * BQ;

  load_tile<T, D, true>(Qt, qb, pitch, qbase, T_len, scale);

  float m_acc[4], den_acc[4], num_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_acc[i] = kNegInf;
    den_acc[i] = 0.f;
#pragma unroll
    for (int u = 0; u < CPT; ++u) num_acc[i][u] = 0.f;
  }

  const int nk = (Tk + BK - 1) / BK;
  int nk_eff = nk;
  if (causal) {
    const int last_row = (qbase + BQ < T_len ? qbase + BQ : T_len) - 1;
    const long long last_q = q0 + last_row;
    const long long n = floor_div(last_q - k0, BK) + 1;
    nk_eff = n < 0 ? 0 : (n > nk ? nk : static_cast<int>(n));
  }

  for (int kt = 0; kt < nk_eff; ++kt) {
    const int kbase = kt * BK;
    __syncthreads();                 // the previous tile's V and P are read
    load_tile<T, D, true>(KV, kb, pitch, kbase, Tk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * LDT + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&KV[d * LDT + 4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + qbase + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kbase + 4 * tx + j;
        // a key past Tk does not exist: masked like a future one, it
        // leaves the max alone and gets zero weight
        const bool keep = col < Tk && (!causal || qpos >= k0 + col);
        if (!keep) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float new_m = fmaxf(m_acc[i], half_warp_max(mx));
      const float safe = new_m > kHalfNegInf ? new_m : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = s[i][j] > kHalfNegInf ? expf(s[i][j] - safe) : 0.f;
        s[i][j] = pv;
        rs += pv;
      }
      const float alpha = m_acc[i] > kHalfNegInf ? expf(m_acc[i] - safe) : 0.f;
      den_acc[i] = den_acc[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int u = 0; u < CPT; ++u) num_acc[i][u] *= alpha;
      m_acc[i] = new_m;
    }

    __syncthreads();                 // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(4 * tx + j) * LDT + 4 * ty + i] = s[i][j];
    load_tile<T, D, false>(KV, vb, pitch, kbase, Tk, 1.f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 pp = *reinterpret_cast<const float4*>(&Pt[c * LDT + 4 * ty]);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
      const float* vrow = KV + c * D;
#pragma unroll
      for (int g = 0; g < CPT / VEC; ++g) {
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 w = *reinterpret_cast<const float4*>(&vrow[g * 64 + 4 * tx]);
          vv[0] = w.x; vv[1] = w.y; vv[2] = w.z; vv[3] = w.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) vv[e] = vrow[VEC * tx + e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            num_acc[i][g * VEC + e] = fmaf(pr[i], vv[e], num_acc[i][g * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = qbase + 4 * ty + i;
    if (t >= T_len) continue;
    const long long o = ((static_cast<long long>(b) * T_len + t) * H + h) * D;
    if (parts) {
      if (tx == 0) {
        m_out[static_cast<long long>(bh) * T_len + t] = m_acc[i];
        den_out[static_cast<long long>(bh) * T_len + t] = den_acc[i];
      }
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        num_out[o + (u / VEC) * (16 * VEC) + VEC * tx + u % VEC] = num_acc[i][u];
    } else {
      const float dd = fmaxf(den_acc[i], 1e-20f);
#pragma unroll
      for (int u = 0; u < CPT; ++u)
        out[o + (u / VEC) * (16 * VEC) + VEC * tx + u % VEC] =
            from_f32<T>(num_acc[i][u] / dd);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m, float* num, float* den, int B, int H, int T_len,
                   int Tk, long long q0, long long k0, int causal, int parts,
                   float scale, cudaStream_t s) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (T_len + BQ - 1) / BQ);
  flash_kernel<T, D><<<grid, NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m, num, den, H, T_len,
      Tk, q0, k0, causal, parts, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* out, float* m, float* num, float* den, int B,
                     int H, int T_len, int Tk, long long q0, long long k0,
                     int causal, int parts, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int dtype, int D, const void* q, const void* k,
                     const void* v, void* out, float* m, float* num,
                     float* den, int B, int H, int T_len, int Tk,
                     long long q0, long long k0, int causal, int parts,
                     float scale, cudaStream_t s) {
  if (B <= 0 || H <= 0 || T_len <= 0 || Tk <= 0 ||
      (T_len + BQ - 1) / BQ > 65535)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case F32: return launch_d<float>(D, q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case F16: return launch_d<__half>(D, q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    case BF16: return launch_d<__nv_bfloat16>(D, q, k, v, out, m, num, den, B, H, T_len, Tk, q0, k0, causal, parts, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int mv2t_flash_attention(int dtype, const void* q, const void* k,
                         const void* v, void* out, int B, int H, int T,
                         int Tk, int D, long long q0, long long k0,
                         int causal, float scale, void* stream) {
  return static_cast<int>(dispatch(dtype, D, q, k, v, out, nullptr, nullptr,
                                   nullptr, B, H, T, Tk, q0, k0, causal, 0,
                                   scale, static_cast<cudaStream_t>(stream)));
}

int mv2t_flash_attention_parts(int dtype, const void* q, const void* k,
                               const void* v, void* m, void* num, void* den,
                               int B, int H, int T, int Tk, int D,
                               int causal, float scale, void* stream) {
  return static_cast<int>(dispatch(
      dtype, D, q, k, v, nullptr, static_cast<float*>(m),
      static_cast<float*>(num), static_cast<float*>(den), B, H, T, Tk, 0, 0,
      causal, 1, scale, static_cast<cudaStream_t>(stream)));
}

const char* mv2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
