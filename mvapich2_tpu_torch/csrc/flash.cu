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
// Both run one kernel, flash_kernel, as the JAX kernels share
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
// [B, H, T], num [B, T, H, D]. One launch covers all B*H head rows. The
// base pointers are 16-byte aligned (the wrapper copies a tensor that is
// not).
//
// Translation. The Pallas kernel keeps a head's whole [Tk, D] K and V in
// VMEM (a grid step per (head, q tile), the key loop inside). That does
// not fit shared memory at this path's widths (Tk = 32768, D = 128: 16 MiB
// a head), so K and V stream through shared memory in tiles of BK keys:
// one CTA per (head row, query tile of BQ rows), its Q tile resident in
// f32 (scaled), the running (m, num, den) of its rows in registers. The
// tiles are the kernel's own (Tile<D> below: BQ = 128, BK = 64 up to
// D = 128; BQ = 64, BK = 32 at D = 256, which does not fit otherwise); the
// JAX block_q / block_k only order the f32 sums there. Causal key tiles
// past a query tile's last row are skipped (floor division, as
// flash.py:83-84), a warp skips the tiles wholly in its rows' future
// (exact: such a tile leaves (m, num, den) as they are), and only the
// tiles that cross the diagonal or Tk are masked element by element.
// Query tiles are issued heaviest first (the last tile of every head row
// first), so the causal triangle's long rows do not finish last.
//
// Products: split TF32 on the tensor cores (mma.sync m16n8k8, HMMA),
// three products a multiply-add: a.b = a_small.b_big + a_big.b_small +
// a_big.b_big, about 21 bits a product where one TF32 product keeps 10.
// The tensor core reads an f32 register as TF32 by dropping its low 13
// mantissa bits, so big is x itself (truncated by the hardware) and small
// = x - trunc(x), exact in f32 and truncated in turn: two instructions
// (LOP3, FADD). cvt.rna.tf32.f32 would round both parts to nearest, but
// on sm_90 it is no instruction of its own: ptxas emits a finiteness
// test, an add, a select and a mask for each (95.9 ms against 68.0 at
// Ulysses' width on an H100, bench/flash_ablation.py; rounding big alone
// by an add and a mask, 73.4). The two small products go to an
// accumulator of their own and the big one to another, each started at
// zero for the tile: the tensor core need not round its f32 sums to
// nearest (earlier NVIDIA tensor cores truncate), so a long run into one
// accumulator could drift; across tiles num is carried on the CUDA
// cores, num = fma(num, alpha, tile sum), rounded to nearest.
//
// Fragments come out of shared memory in register order, since ptxas
// copies any fragment whose values come from two loads into a fresh
// register quad before each HMMA (in a first form of this kernel the
// moves outnumbered the HMMAs). Each warp owns 16 query rows.
// - S = Q K^T: Q sits in shared memory in fragment order (one 16-byte
//   read is one A fragment: rows g and g + 8 at d 4t + 2s and
//   4t + 2s + 1, step s of a k-step pair), and one 16-byte read of a K
//   row gives the B fragments of both steps. Key column n of an n-block
//   is key (n even ? n/2 : n/2 + 4), so the accumulator's columns
//   (2t, 2t + 1) are keys t and t + 4.
// - num = P V as num^T = V^T P^T: P^T's B fragment of n-tile n (rows
//   8n..8n+7) is the accumulator pair (c_2n, c_2n+1) as it stands, with
//   no shuffle or shared-memory trip, and V^T's A fragment is two 8-byte
//   reads, head columns (2g, 2g + 1) of key rows t and t + 4. A lane
//   then holds num^T of rows 2t, 2t + 1 (+ 8), so each key tile takes
//   their alpha from the lanes that own those rows (four shuffles).
// - Pitches (elements): K D + 4, V D + 8 (D + 24 at D = 16), Q none:
//   every f32 fragment read is free of bank conflicts (16-bit tiles see
//   at most two-way ones).
//
// Tile loads: K and V tiles go into separate buffers by cp.async (16
// bytes a copy in f32, 8 in f16/bf16, which stay 16-bit in shared memory
// and become f32 at the fragment read), in a ring of two stages: tile
// j + 1 is in flight while tile j is computed, one __syncthreads a tile.
// Rows past Tk are zero-filled by the copy's source size. Shared memory
// at D = 128 in f32: Q 64 KiB + 2 x (K 33 KiB + V 34 KiB) = 198 KiB, one
// CTA (8 warps) an SM; 255 registers, no spill (D = 256 spills a little).
//
// Arithmetic besides the products: expf (__expf saves under 1 %) and
// IEEE division, as the plain version; the
// row max and the denominator sum over the four lanes that share a row
// with __shfl_xor_sync (the denominator once, at the end).
//
// Bound: operations. Each (query, key) pair the mask keeps costs 2D
// multiply-adds (4D flops), three TF32 products each here; at Ulysses'
// width (T = 32768, 16 heads of 128, causal) that is 4.4 TFLOP a call,
// 26.7 ms at the card's 495 TFLOP/s of dense TF32 (65.6 ms for one f32
// product at 67 TFLOP/s on the CUDA cores), 80 times the memory bound.
// Measured on an H100 at Ulysses' width (bench/flash_ablation.py): of
// 68.0 ms the three HMMAs take about 38 (one product a multiply-add:
// 32.9), the splits 9.5 (without them: 58.4), the barrier 2 (66.0);
// the tile loads are hidden. With two warps a scheduler, mma.sync
// leaves the splits and the softmax little to overlap with. The kernel
// this one replaced ran the products as f32 FMA on the CUDA cores from
// 4 x 4 register tiles and reached 35 % of the f32 peak: each d step was
// two float4 shared loads for 16 FMAs, so shared memory fed half the FMA
// rate, and its transposed scalar tile loads conflicted four ways and
// overlapped nothing.
//
// Not used yet: TMA, wgmma and warp specialisation (a warpgroup's
// softmax overlapping another's products). wgmma takes tf32 operands
// from shared memory only K-major, so P V would need V^T staged in
// shared memory.
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

constexpr float kNegInf = -1e30f;
constexpr float kHalfNegInf = -5e29f;

// The kernel's tiles at head width D.
template <int D>
struct Tile {
  static constexpr int WARPS = D <= 128 ? 8 : 4;
  static constexpr int NT = 32 * WARPS;      // threads
  static constexpr int BQ = 16 * WARPS;      // query rows of a CTA
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys of a tile
  static constexpr int KB = BK / 8;          // 8-key blocks of a tile
  static constexpr int NP = D / 16;          // k-step pairs of Q K^T
  static constexpr int MT = D / 16;          // 16-column m-tiles of V^T P^T
  static constexpr int PK = D + 4;           // row pitches, elements
  static constexpr int PV = D % 32 == 16 ? D + 24 : D + 8;
};

template <typename T, int D>
constexpr int smem_bytes() {
  using C = Tile<D>;
  return C::BQ * D * 4 +
         2 * C::BK * (C::PK + C::PV) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ---- 4 or 2 elements to f32, 2 from f32 (global or shared memory) ----

__device__ __forceinline__ void ld(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void ld(const float* p, float (&x)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x; x[1] = v.y;
}
__device__ __forceinline__ float2 f2(__half2 v) { return __half22float2(v); }
__device__ __forceinline__ float2 f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}
template <typename T2, typename T>
__device__ __forceinline__ void ld16(const T* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = f2(*reinterpret_cast<const T2*>(&u.x));
  const float2 b = f2(*reinterpret_cast<const T2*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
template <typename T2, typename T>
__device__ __forceinline__ void ld16(const T* p, float (&x)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  const float2 a = f2(*reinterpret_cast<const T2*>(&u));
  x[0] = a.x; x[1] = a.y;
}
template <int W>
__device__ __forceinline__ void ld(const __half* p, float (&x)[W]) {
  ld16<__half2>(p, x);
}
template <int W>
__device__ __forceinline__ void ld(const __nv_bfloat16* p, float (&x)[W]) {
  ld16<__nv_bfloat162>(p, x);
}

template <typename T>
__device__ __forceinline__ void ld2(const T* p, float& a, float& b) {
  float x[2];
  ld(p, x);
  a = x[0];
  b = x[1];
}

__device__ __forceinline__ void st(float* p, const float (&x)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
__device__ __forceinline__ void st(__half* p, const float (&x)[2]) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(x[0], x[1]);
}
__device__ __forceinline__ void st(__nv_bfloat16* p, const float (&x)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
}

// ---- split TF32 on the tensor cores ----

// x = big + small for a TF32 operand: big is x as it is, which the
// tensor core reads as TF32 by dropping the low 13 mantissa bits
// (truncation), and small = x - trunc(x), exact in f32, which it reads
// truncated in turn: big + small keeps about 21 bits of x.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N],
                                      uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], big[i], small[i]);
}

// c += a b, one m16n8k8 TF32 product with f32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three products of split a, b: the two small ones into lo, the big
// one into hi
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(lo, as, bb);
  mma(lo, ab, bs);
  mma(hi, ab, bb);
}

// ---- asynchronous tile loads ----

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;              // 0: zero-fill
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [base, base + ROWS) of one head row of x ([., len, H, D]) into
// dst at row pitch P, four elements a copy; rows past len read as 0.
template <typename T, int D, int P, int ROWS, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long pitch, int base,
                                          int len) {
  constexpr int G = D / 4;
  static_assert(ROWS * G % NT == 0, "tile copies must divide the threads");
#pragma unroll
  for (int i = 0; i < ROWS * G / NT; ++i) {
    const int e = static_cast<int>(threadIdx.x) + i * NT;
    const int r = e / G, c = e % G;
    const bool ok = base + r < len;
    cp_async<4 * sizeof(T)>(dst + r * P + 4 * c,
                            src + (ok ? (base + r) * pitch + 4 * c : 0), ok);
  }
}

// One CTA: head row blockIdx.x (b * H + h), query tile
// nq - 1 - blockIdx.y. out (K15) or m/num/den (K16, parts != 0).
template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::NT, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ m_out, float* __restrict__ num_out,
             float* __restrict__ den_out, int H, int T_len, int Tk,
             long long q0, long long k0, int causal, int parts,
             float scale) {
  using C = Tile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, KB = C::KB, NP = C::NP;
  constexpr int MT = C::MT, NT = C::NT, PK = C::PK, PV = C::PV;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);      // [BQ * D] f32, scaled
  T* Ks = reinterpret_cast<T*>(Qs + BQ * D);        // [2][BK][PK]
  T* Vs = Ks + 2 * BK * PK;                         // [2][BK][PV]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nq = gridDim.y;
  const int qt = nq - 1 - static_cast<int>(blockIdx.y);
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long pitch = static_cast<long long>(H) * D;   // token stride
  const T* qb = q + (static_cast<long long>(b) * T_len * H + h) * D;
  const T* kb = k + (static_cast<long long>(b) * Tk * H + h) * D;
  const T* vb = v + (static_cast<long long>(b) * Tk * H + h) * D;
  const int qbase = qt * BQ;

  const int nk = (Tk + BK - 1) / BK;
  int nk_eff = nk;
  if (causal) {
    const int last_row = (qbase + BQ < T_len ? qbase + BQ : T_len) - 1;
    const long long n = floor_div(q0 + last_row - k0, BK) + 1;
    nk_eff = n < 0 ? 0 : (n > nk ? nk : static_cast<int>(n));
  }
  if (nk_eff > 0) {
    load_rows<T, D, PK, BK, NT>(Ks, kb, pitch, 0, Tk);
    load_rows<T, D, PV, BK, NT>(Vs, vb, pitch, 0, Tk);
    cp_async_commit();
  }

  // Q tile, f32 and scaled (rows past T_len zero), in fragment order:
  // for warp w, k-step pair p, step s, lane (g, t) the four values
  // (row g, d 4t + 2s), (row g + 8, d 4t + 2s), (row g, d 4t + 2s + 1),
  // (row g + 8, d 4t + 2s + 1) of the pair's 16 columns, the A fragment
  // of one m16n8k8 step as one 16-byte read
  {
    constexpr int G = D / 4;
#pragma unroll 4
    for (int i = 0; i < BQ * G / NT; ++i) {
      const int e = static_cast<int>(threadIdx.x) + i * NT;
      const int r = e / G, c = e % G;
      float x[4] = {0.f, 0.f, 0.f, 0.f};
      if (qbase + r < T_len) {
        ld(qb + (qbase + r) * pitch + 4 * c, x);
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] *= scale;
      }
      float* f = Qs + ((((r >> 4) * NP + (c >> 2)) * 2) * 32 +
                       4 * (r & 7) + (c & 3)) * 4 + ((r >> 3) & 1);
      f[0] = x[0];
      f[2] = x[1];
      f[128] = x[2];
      f[130] = x[3];
    }
  }

  // num^T of the warp's rows: m-tile i, n-tile n (rows 8n..8n+7),
  // element e: head column 16i + 2g + (e >> 1), row 8n + 2t + (e & 1)
  float o[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
  float m_acc[2] = {kNegInf, kNegInf};   // rows g, g + 8
  float den[2] = {0.f, 0.f};      // this lane's columns; summed at the end

  const int row0 = qbase + 16 * warp;               // the warp's first row
  const bool live = row0 < T_len;
  const int kperm = (g & 1) ? (g >> 1) + 4 : (g >> 1);   // S column g's key
  const float* qf = Qs + warp * NP * 256 + 4 * lane;

  for (int kt = 0; kt < nk_eff; ++kt) {
    cp_async_wait_all();
    __syncthreads();               // tile kt landed; tile kt - 1 is read
    if (kt + 1 < nk_eff) {
      const int nxt = (kt + 1) & 1;
      load_rows<T, D, PK, BK, NT>(Ks + nxt * BK * PK, kb, pitch,
                                  (kt + 1) * BK, Tk);
      load_rows<T, D, PV, BK, NT>(Vs + nxt * BK * PV, vb, pitch,
                                  (kt + 1) * BK, Tk);
      cp_async_commit();
    }
    const int kbase = kt * BK;
    if (!live || (causal && k0 + kbase > q0 + row0 + 15)) continue;
    const T* Kt = Ks + (kt & 1) * BK * PK;
    const T* Vt = Vs + (kt & 1) * BK * PV;

    // S = Q K^T: hi (big products) + lo (small ones). Element e of
    // n-block j: row g + 8 (e >> 1), key 8j + t + 4 (e & 1)
    float s[KB][4], sl[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
    const T* krow = Kt + kperm * PK + 4 * t;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float xa[4], xb[4];
      ld(qf + 256 * p, xa);               // step 0: d 4t, 4t + 1
      ld(qf + 256 * p + 128, xb);         // step 1: d 4t + 2, 4t + 3
      uint32_t a0b[4], a0s[4], a1b[4], a1s[4];
      split(xa, a0b, a0s);
      split(xb, a1b, a1s);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float y[4];
        ld(krow + 8 * j * PK + 16 * p, y);
        uint32_t yb[4], ys[4];
        split(y, yb, ys);
        const uint32_t b0b[2] = {yb[0], yb[1]}, b0s[2] = {ys[0], ys[1]};
        const uint32_t b1b[2] = {yb[2], yb[3]}, b1s[2] = {ys[2], ys[3]};
        mma3(s[j], sl[j], a0b, a0s, b0b, b0s);
        mma3(s[j], sl[j], a1b, a1s, b1b, b1s);
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
    if (kbase + BK > Tk || (causal && k0 + kbase + BK - 1 > q0 + row0)) {
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kbase + 8 * j + t + 4 * (e & 1);
          const long long qpos = q0 + row0 + g + 8 * (e >> 1);
          // a key past Tk does not exist: masked like a future one, it
          // leaves the max alone and gets zero weight
          if (col >= Tk || (causal && qpos < k0 + col)) s[j][e] = kNegInf;
        }
    }

    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float new_m = fmaxf(m_acc[r], mx);
      const float safe = new_m > kHalfNegInf ? new_m : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float ex = expf(s[j][e] - safe);
          s[j][e] = s[j][e] > kHalfNegInf ? ex : 0.f;
          rs += s[j][e];
        }
      const float ea = expf(m_acc[r] - safe);
      alpha[r] = m_acc[r] > kHalfNegInf ? ea : 0.f;
      den[r] = den[r] * alpha[r] + rs;
      m_acc[r] = new_m;
    }
    // alpha of the rows this lane holds in num^T: 8n + 2t + w
    float al[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        al[n][w] = __shfl_sync(0xffffffffu, alpha[n], 8 * t + 4 * w);

    // num^T = num^T alpha + V^T P^T. P^T's B fragment of key block j and
    // n-tile n is the accumulator pair (s[j][2n], s[j][2n + 1]): keys
    // 8j + t and 8j + t + 4 of row 8n + g. V^T's A fragment of m-tile i:
    // head columns 16i + 2g, 16i + 2g + 1 of keys 8j + t, 8j + t + 4.
    uint32_t pb[KB][4], ps[KB][4];
#pragma unroll
    for (int j = 0; j < KB; ++j) split(s[j], pb[j], ps[j]);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const T* vcol = Vt + t * PV + 16 * i + 2 * g;
      float hi[2][4], lo[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hi[n][e] = lo[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        float x[4];
        ld2(vcol + 8 * j * PV, x[0], x[1]);            // key 8j + t
        ld2(vcol + (8 * j + 4) * PV, x[2], x[3]);      // key 8j + t + 4
        uint32_t ab[4], as[4];
        split(x, ab, as);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const uint32_t bb[2] = {pb[j][2 * n], pb[j][2 * n + 1]};
          const uint32_t bs[2] = {ps[j][2 * n], ps[j][2 * n + 1]};
          mma3(hi[n], lo[n], ab, as, bb, bs);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[i][n][e] = fmaf(o[i][n][e], al[n][e & 1], hi[n][e] + lo[n][e]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
  }
  if (parts && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row < T_len) {
        m_out[static_cast<long long>(bh) * T_len + row] = m_acc[r];
        den_out[static_cast<long long>(bh) * T_len + row] = den[r];
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int row = row0 + 8 * n + 2 * t + w;
      const float dd =
          fmaxf(__shfl_sync(0xffffffffu, den[n], 8 * t + 4 * w), 1e-20f);
      if (row >= T_len) continue;
      const long long base =
          ((static_cast<long long>(b) * T_len + row) * H + h) * D + 2 * g;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float x[2] = {o[i][n][w], o[i][n][2 + w]};
        if (parts) {
          st(num_out + base + 16 * i, x);
        } else {
          x[0] = x[0] / dd;
          x[1] = x[1] / dd;
          st(out + base + 16 * i, x);
        }
      }
    }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* m, float* num, float* den, int B, int H, int T_len,
                   int Tk, long long q0, long long k0, int causal, int parts,
                   float scale, cudaStream_t s) {
  using C = Tile<D>;
  constexpr int bytes = smem_bytes<T, D>();
  static_assert(bytes <= 232448, "shared memory over the 227 KB limit");
  const int nq = (T_len + C::BQ - 1) / C::BQ;
  if (nq > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, nq);
  flash_kernel<T, D><<<grid, C::NT, bytes, s>>>(
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
  if (B <= 0 || H <= 0 || T_len <= 0 || Tk <= 0) return cudaErrorInvalidValue;
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
