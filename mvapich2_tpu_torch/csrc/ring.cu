// Ring collective kernels for Hopper (sm_90a) over p virtual ranks whose
// shards share one GPU's memory. One launch covers all p ranks.
//
// K3 ring_all_reduce_direct_kernel replaces mvapich2_tpu/ops/pallas_ici.py
//    hbm_ring_all_reduce (Pallas body _hbm_all_reduce_kernel, engine
//    _RingStreamer). The streaming ring's result, any n, in both ring
//    directions, as one direct fold in the ring's order (K6's kernel over
//    `lines` rings); sum, max, min, prod.
// K4 ring_reduce_scatter_direct_kernel replaces pallas_ici.py
//    hbm_ring_reduce_scatter (body _hbm_reduce_scatter_kernel). The
//    reduce-scatter ring's result, rank r's block r of ceil(n/p) of the
//    identity-padded fold, as K3's direct fold stored into its owner's
//    row alone.
// K5 ring_all_gather_direct_kernel replaces pallas_ici.py
//    hbm_ring_all_gather (body _hbm_all_gather_kernel). The all-gather
//    ring's result as one direct copy into every rank's row (K7's kernel
//    over `lines` rings).
//    K3, K4 and K5 take `lines`: one launch runs that many independent
//    rings of p at once, the per-axis phase of a multi-axis mesh.
// K8 remote_sendrecv_kernel      replaces pallas_ici.py remote_sendrecv
//    (body _sendrecv_kernel). src and dst swap their shards, every other
//    rank gets its own: 2*p*m bytes for m-byte shards, moved by the copy
//    engine (cp.async.bulk tiles through a ring of shared-memory stages,
//    one elected thread a block), heads and tails by the threads.
// K6 ring_all_reduce_direct_kernel replaces mvapich2_tpu/ops/pallas_ring.py
//    ring_all_reduce (body _ring_all_reduce_kernel). The resident sum
//    ring's result, n % p == 0, as one direct fold in the ring's order
//    (K3's kernel: one line, one direction, sum).
// K7 ring_all_gather_direct_kernel replaces pallas_ring.py
//    ring_all_gather (body _ring_all_gather_kernel). The resident gather
//    ring's result as one direct copy into every rank's row.
// K10 hbm_alltoallv_direct_kernel replaces
//    mvapich2_tpu/ops/pallas_alltoall.py hbm_alltoall (body
//    _hbm_alltoall_kernel). The uniform alltoall of p blocks as K11's
//    direct copy over a uniform tile table.
// K11 hbm_alltoallv_direct_kernel replaces pallas_alltoall.py
//    hbm_alltoallv (body _hbm_alltoallv_kernel). The variable-count
//    exchange under a static p x p count matrix, as one direct copy by a
//    table of tiles.
// K12 rma_copy_kernel            replaces mvapich2_tpu/ops/pallas_rma.py
//    rma_put (body _put_kernel, engine _RmaStreamer). One-sided put of
//    src[n] into the target's window row at disp, as one direct copy.
// K13 rma_copy_kernel            replaces pallas_rma.py rma_get (body
//    _get_kernel). One-sided get of n window elements at disp, the same
//    direct copy the other way.
// K9 quant_ring_all_reduce_kernel replaces mvapich2_tpu/ops/pallas_quant.py
//    quant_ring_all_reduce (body _quant_rs_kernel, engine _QuantStreamer)
//    and also performs the JAX wrapper's gather and decode of the wire:
//    each quantization block's ring chain of encodes and decoding folds
//    replayed in registers, then the owner's block encoded once,
//    decoded, and stored into every rank's row, one pass.
// K14 rma_acc_direct_kernel      replaces pallas_rma.py rma_accumulate
//    (body _acc_kernel), exact wire: MPI_SUM fold of src[n] into the
//    target's window row at disp, as one direct fold.
//    rma_acc_quant_direct_kernel is its quantized wire (K14q, _acc_kernel
//    with quant_block set): K9's codec, encode, decode and fold in
//    registers.
// K17 rma_copy_kernel            replaces mvapich2_tpu/rma/device.py
//    pallas_put (body _pallas_put_kernel). Single-shot put of src[n]
//    into the target's window row at disp: K12's direct copy, with no
//    landing buffer and no flag.
//
// Translation. No kernel here uses a landing slot or a credit. The TPU
// kernels pass data to a neighbour by remote DMA into its VMEM landing
// slots under DMA/REGULAR semaphores, because a chip reaches another
// chip's memory only that way. On one card every rank's shard is memory
// that any thread reads, so each kernel reads its sources where they lie
// and writes its outputs directly, with no flag, no wait and no barrier
// between blocks: ordinary launches, each grid at most what fits on the
// card at once. A ring's result depends only on its fold order (and, for
// K9, on where its codec rounds), which each fold replays in closed form.
//
// The direct kernels have no schedule: one pass each. K3 and K6
// (ring_all_reduce_direct_kernel) fold every block in the ring's order
// and K4 (ring_reduce_scatter_direct_kernel) runs the same fold into each
// block's owner alone, K5 and K7 (ring_all_gather_direct_kernel) copy,
// K11 and K10 (hbm_alltoallv_direct_kernel) copy by a tile table, K12,
// K13 and K17 (rma_copy_kernel) copy one range, K14 and K14q
// (rma_acc_direct_kernel, rma_acc_quant_direct_kernel) fold one range,
// K9 (quant_ring_all_reduce_kernel) folds each quantization block along
// its ring chain through the codec, and K8 (remote_sendrecv_kernel)
// copies its rows by bulk tiles.
// K17's TPU kernel stages the payload in one landing buffer under a flag
// because only the target may commit into its own HBM; here the window
// row is memory that the origin's threads store to, so a put is K12's
// copy (notes below).
//
// Arithmetic: floats fold in float and round to the dtype at every step,
// integers in 32 bits (uint32 unsigned) and wrap to the dtype, exactly as
// the JAX kernel's dtype arithmetic; max/min propagate NaN and order
// -0.0 below +0.0 as jnp.maximum/minimum do (IEEE 754-2019 maximum and
// minimum).
//
// Bound. Device-memory traffic, not arithmetic, and every direct kernel
// moves just its bound: each input read once and each output written
// once (K3-K14q and K17 below). The streaming schedule that K3 replaced
// moved about 2m + (p-1)(9m/p) a rank for an m-byte shard (an init copy,
// 5m/p a reduce-scatter step and 4m/p an all-gather step, through the
// landing slots), K4's (p-1)(5m/p) against m + m/p, and K10's 2m/p +
// (p-1)(4m/p) against 2m. K9 reads p*m_in and writes p*m_out (and its
// p*wblk*4 bytes of wire words when they are asked for), where its
// streaming ring moved 2m + (p-1)(m/p)(3 + 2/3.9) + (m/p)(1 + 1/3.9) a
// rank before the gather and the decode; its codec's division, p an
// element, stays far below the f32 rate. K14q moves 3n bytes of f32 (read src and window, write
// window): its wire words stay in registers.
//
// Spin bound: K8's wait on an mbarrier that outlasts kSpinTimeoutNs
// writes a nonzero error word into mapped host memory and ends the
// block. mv2t_ring_error reads (and clears) the word.
//
// Plain C interface, built by nvcc into a shared library and bound with
// ctypes (mvapich2_tpu_torch/ops/_build.py). Each entry launches on the
// stream it is given and returns the launch's cudaError_t.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mutex>
#include <type_traits>

namespace {

constexpr int kMaxRanks = 64;
constexpr unsigned long long kSpinTimeoutNs = 2000000000ull;
constexpr int kErrTimeout = 1;

struct RankPtrs {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

enum DType { F32 = 0, F16 = 1, BF16 = 2, I32 = 3, I16 = 4, I8 = 5, U8 = 6,
             U16 = 7, U32 = 8 };
enum Op { SUM = 0, MAX = 1, MIN = 2, PROD = 3 };

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

// Accumulators: floats in float; integers in int32, except uint32 in
// uint32, so that max and min order values above 2^31 as unsigned.
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

template <typename T> __device__ __forceinline__ T from_acc(float v) {
  return static_cast<T>(v);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T from_acc(int32_t v) {
  return static_cast<T>(v);
}
template <typename T> __device__ __forceinline__ T from_acc(uint32_t v) {
  return static_cast<T>(v);
}

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if (OP == SUM) return a + b;
  if (OP == PROD) return a * b;
  if (a != a || b != b) return a + b;          // NaN propagates
  // IEEE 754-2019 maximum/minimum, as XLA folds jnp.maximum/minimum:
  // -0.0 orders below +0.0, whichever operand holds it
  if (a == b) return (OP == MAX) == (__float_as_uint(a) >> 31 != 0) ? b : a;
  if (OP == MAX) return a > b ? a : b;
  return a < b ? a : b;
}
template <int OP>
__device__ __forceinline__ int32_t apply(int32_t a, int32_t b) {
  // unsigned: wrap-around without signed overflow
  if (OP == SUM) return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                             static_cast<uint32_t>(b));
  if (OP == PROD) return static_cast<int32_t>(static_cast<uint32_t>(a) *
                                              static_cast<uint32_t>(b));
  if (OP == MAX) return a > b ? a : b;
  return a < b ? a : b;
}
template <int OP>
__device__ __forceinline__ uint32_t apply(uint32_t a, uint32_t b) {
  if (OP == SUM) return a + b;                 // wraps
  if (OP == PROD) return a * b;
  if (OP == MAX) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP>
__device__ __forceinline__ T red(T a, T b) {
  return from_acc<T>(apply<OP>(to_acc<T>(a), to_acc<T>(b)));
}

template <typename T> struct Limits;
template <> struct Limits<int32_t> { static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX; };
template <> struct Limits<int16_t> { static constexpr int32_t lo = INT16_MIN, hi = INT16_MAX; };
template <> struct Limits<int8_t> { static constexpr int32_t lo = INT8_MIN, hi = INT8_MAX; };
template <> struct Limits<uint8_t> { static constexpr int32_t lo = 0, hi = UINT8_MAX; };
template <> struct Limits<uint16_t> { static constexpr int32_t lo = 0, hi = UINT16_MAX; };
template <> struct Limits<uint32_t> { static constexpr uint32_t lo = 0, hi = UINT32_MAX; };

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if (OP == SUM) return from_acc<T>(typename Acc<T>::type(0));
  if (OP == PROD) return from_acc<T>(typename Acc<T>::type(1));
  if constexpr (!std::is_same<typename Acc<T>::type, float>::value) {
    return from_acc<T>(OP == MAX ? Limits<T>::lo : Limits<T>::hi);
  } else {
    return from_acc<T>(OP == MAX ? -INFINITY : INFINITY);
  }
}

// ---------------------------------------------------------------------------
// the clock of K8's spin bound
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ---------------------------------------------------------------------------
// the block-scaled codec of K9 and K14's quantized wire (pallas_quant.py
// _encode_f32 / _decode_f32): a block of blk f32 values travels as
// 1 + blk/4 int32 words, the f32 scale absmax * f32(1/top) bitcast, then
// four codes a word, lowest byte first. Divisions are IEEE (__fdiv_rn),
// q8 rounds half to even (rintf), fp8 converts with round-to-nearest-even
// and saturation; the decoded value is folded with one rounding
// (__fmaf_rn), as XLA compiles the JAX kernel's acc + q * scale. Every
// operation is written as the intrinsic, so nvcc's contraction cannot
// change it.
// ---------------------------------------------------------------------------

enum Wire { Q8 = 0, FP8 = 1 };

template <int W> struct Codec;
template <> struct Codec<Q8> {
  __device__ static float inv_top() { return 1.0f / 127.0f; }
  __device__ static unsigned code(float v) {        // v = x / scale
    const float q = fminf(fmaxf(rintf(v), -127.0f), 127.0f);
    return static_cast<unsigned>(static_cast<int>(q) + 128);
  }
  __device__ static float value(unsigned c) {
    return static_cast<float>(static_cast<int>(c)) - 128.0f;
  }
};
template <> struct Codec<FP8> {
  __device__ static float inv_top() { return 1.0f / 448.0f; }
  __device__ static unsigned code(float v) {
    const float y = fminf(fmaxf(v, -448.0f), 448.0f);
    return static_cast<unsigned>(
        __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
  }
  __device__ static float value(unsigned c) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(c), __NV_E4M3)));
  }
};

// 4 consecutive floats, as one 16-byte access when aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0)
    return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// K12 and K13: the direct copy
// ---------------------------------------------------------------------------
//
// rma_copy_kernel replaces mvapich2_tpu/ops/pallas_rma.py rma_put (:398,
// its pallas_call at :415) as K12, from = src and to = the target's
// window row + disp, and rma_get (:429, pallas_call :446) as K13, from =
// the target's window row + disp and to = the origin's result.
//
// Bound: bytes. n payload bytes are read once and written once, 2n, or
// 0.040 ms for 64 MiB at 3.35 TB/s. The TPU kernels stage every chunk
// in a landing slot under chunk credits, because a remote DMA must land
// in the partner's finite VMEM and only the target may commit into its
// own HBM. Here the target's window row is memory that the origin's
// threads store to directly, so the copy is one pass: no slot, no flag,
// no wait. (The slot design moved 4n bytes behind one credit handshake
// a chunk, about 2 us each.) No block waits on another, so the launch
// is a plain one: one pass of kCopyUnroll words a thread, capped at the
// blocks that fit on the card at once, counted once per device. Bytes
// in flight hide the memory latency: each thread issues kCopyUnroll
// independent 16-byte loads before its stores. The loads take the
// read-only path (ld.global.nc), which needs `from` unchanged during the
// launch: the wrapper snapshots a source that partly overlaps the
// destination. An exact alias (from == to, a put of the target range
// onto itself) is left as it is: each word is then read and written
// back unchanged by the one thread that owns it, so no thread reads a
// word another has written. Over NVLink the same kernel takes a peer
// pointer; that form is not written yet (the port runs on one card).
//
// Split (computed by the C entry, modelled by ops/rma.py copy_plan):
// `head` elements up to to's 16-byte boundary, then nvec 16-byte words
// of `to`, then a tail of less than 16 bytes. The first threads copy
// the head and the tail element by element. When `from` is misaligned
// against `to` by s bytes (an f32 disp that is not a multiple of 4
// against an aligned src, any odd bf16 or i8 offset), word v of `to` is
// assembled from the two aligned words of `from` that hold its bytes,
// shifted by s with __funnelshift_r. So loads and stores stay 16 bytes
// wide at every element width, where an element loop would issue 1- and
// 2-byte accesses for i8 and bf16. The second word is mostly an L1 hit:
// the next thread loaded it as its first. It may reach up to 15 bytes
// past the source's last byte, inside the aligned 16-byte word that
// holds that byte, so it never leaves the allocation's page. Stores are
// plain: evict-first stores (st.global.cs) measured no faster (PERF.md).

constexpr int kCopyUnroll = 4;

// Bytes [4q + r8/8, 4q + r8/8 + 16) of the 32 bytes a:b (little-endian
// words; selects, not an indexed array, keep them in registers).
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int q, int r8) {
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned s[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    s[j] = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
  return make_uint4(__funnelshift_r(s[0], s[1], r8),
                    __funnelshift_r(s[1], s[2], r8),
                    __funnelshift_r(s[2], s[3], r8),
                    __funnelshift_r(s[3], s[4], r8));
}

// to[v] = the 16 bytes at (char*)from + 16 v + shift, for v < nvec; from
// is the aligned word that holds the body's first source byte.
template <bool SHIFTED>
__device__ void copy_words(const uint4* from, int shift, uint4* to,
                           long long nvec) {
  const long long step =
      static_cast<long long>(gridDim.x) * blockDim.x * kCopyUnroll;
  const int q = shift >> 2, r8 = (shift & 3) * 8;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x *
                            kCopyUnroll + threadIdx.x;
       base < nvec; base += step) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < nvec) {
        v[k] = __ldg(from + i);
        if constexpr (SHIFTED)
          v[k] = realign(v[k], __ldg(from + i + 1), q, r8);
      }
    }
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < nvec) to[i] = v[k];
    }
  }
}

// K12/K13 (T: an unsigned type of the element's width): to[i] = from[i]
// for i < n, cut into head, nvec words and tail as above.
template <typename T>
__global__ void __launch_bounds__(1024) rma_copy_kernel(
    const T* from, T* to, long long n, long long head, long long nvec) {
  constexpr int V = 16 / sizeof(T);
  const long long body_end = head + nvec * V;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < head) to[t] = __ldg(from + t);
  if (t < n - body_end) to[body_end + t] = __ldg(from + body_end + t);
  if (nvec == 0) return;
  const uintptr_t first = reinterpret_cast<uintptr_t>(from + head);
  const int shift = static_cast<int>(first & 15);
  const uint4* words = reinterpret_cast<const uint4*>(first - shift);
  uint4* out = reinterpret_cast<uint4*>(to + head);
  if (shift)
    copy_words<true>(words, shift, out, nvec);
  else
    copy_words<false>(words, 0, out, nvec);
}

// ---------------------------------------------------------------------------
// K14 and K14q: the direct fold
// ---------------------------------------------------------------------------
//
// rma_acc_direct_kernel replaces mvapich2_tpu/ops/pallas_rma.py
// rma_accumulate (:458, its pallas_call at :492, body _acc_kernel
// :328-391) on the exact wire: to[i] = red<T, SUM>(to[i], from[i]) for
// i < n, from = src and to = the target's window row + disp; floats fold
// in float and round once to T, integers wrap, as the JAX kernel's
// fold_buf + landing. rma_acc_quant_direct_kernel replaces the same
// kernel with quant_block set (K14q).
//
// Bound: bytes. The source and the window row are read once and the row
// written once, 3n, or 0.060 ms for 64 MiB of f32 at 3.35 TB/s. The TPU
// kernel streams src through a landing slot under chunk credits because
// only the target may fold into its own HBM; on one card the origin's
// threads read src and the row and write the row in one pass, with no
// slot, no flag and nothing to wait for. (The slot design moved 5n bytes
// behind one credit handshake a chunk.) The fold is elementwise and the
// quantization blocks are independent, so no cut changes a result.
//
// K14 is K12's loop with a fold: the same plain launch (one pass of
// kCopyUnroll words a thread, at most the blocks that fit at once), the
// same head / nvec words / tail split (ops/rma.py copy_plan models it),
// the same realignment of a source misaligned against the row; each
// thread loads its kCopyUnroll source words and window words before it
// stores. Aliasing: a source that partly overlaps the row is copied by
// the wrapper first. A source that is exactly the target range is
// passed as it is and must double the range, as the JAX kernel's
// immutable payload does: then `from` is not read-only in the launch,
// and the result is right only because every word (head and tail
// element) is read, through both pointers, by the one thread that later
// stores it, before that store. Its shift is 0, so no thread reads a
// neighbour's word.
//
// K14q: one warp a quantization block of blk values (lane i takes the
// 4-value words i, i + 32, ...): the block's absmax by a shuffle
// reduction, scale = absmax * f32(1/top), each value coded as
// Codec<W>::code(v / safe) and folded as fma(value(code), scale,
// window), the arithmetic of one encode and one decoding fold of the
// wire (one hop of K9's chain). The wire words never reach memory. A lane keeps
// its first word of source and window in registers between the two
// passes and reloads the rest (a block past 128 values); each word is
// read and written by its lane alone, so the exact alias holds here too.

// The V = 16 / sizeof(T) elements of words w and s folded pairwise,
// red<T, OP>(w[j], s[j]).
template <typename T, int OP>
__device__ __forceinline__ uint4 fold_word(uint4 w, uint4 s) {
  constexpr int V = 16 / sizeof(T);
  T a[V], b[V];
  memcpy(a, &w, 16);
  memcpy(b, &s, 16);
#pragma unroll
  for (int j = 0; j < V; ++j) a[j] = red<T, OP>(a[j], b[j]);
  memcpy(&w, a, 16);
  return w;
}

// to[v] = fold(to[v], the 16 bytes at (char*)from + 16 v + shift), for
// v < nvec; from as in copy_words.
template <typename T, bool SHIFTED>
__device__ void fold_words(const uint4* from, int shift, uint4* to,
                           long long nvec) {
  const long long step =
      static_cast<long long>(gridDim.x) * blockDim.x * kCopyUnroll;
  const int q = shift >> 2, r8 = (shift & 3) * 8;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x *
                            kCopyUnroll + threadIdx.x;
       base < nvec; base += step) {
    uint4 s[kCopyUnroll], w[kCopyUnroll];
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < nvec) {
        s[k] = __ldg(from + i);
        if constexpr (SHIFTED)
          s[k] = realign(s[k], __ldg(from + i + 1), q, r8);
        w[k] = to[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * blockDim.x;
      if (i < nvec) to[i] = fold_word<T, SUM>(w[k], s[k]);
    }
  }
}

// K14 (T: the element type): to[i] += from[i] for i < n, cut into head,
// nvec words and tail as K12.
template <typename T>
__global__ void __launch_bounds__(1024) rma_acc_direct_kernel(
    const T* from, T* to, long long n, long long head, long long nvec) {
  constexpr int V = 16 / sizeof(T);
  const long long body_end = head + nvec * V;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < head) to[t] = red<T, SUM>(to[t], from[t]);
  if (t < n - body_end)
    to[body_end + t] = red<T, SUM>(to[body_end + t], from[body_end + t]);
  if (nvec == 0) return;
  const uintptr_t first = reinterpret_cast<uintptr_t>(from + head);
  const int shift = static_cast<int>(first & 15);
  const uint4* words = reinterpret_cast<const uint4*>(first - shift);
  uint4* out = reinterpret_cast<uint4*>(to + head);
  if (shift)
    fold_words<T, true>(words, shift, out, nvec);
  else
    fold_words<T, false>(words, 0, out, nvec);
}

// The absmax of four values.
__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// One value of K14q: v coded against `safe`, decoded and folded into a.
template <int W>
__device__ __forceinline__ float quant_fold(float v, float safe, float scale,
                                            float a) {
  return __fmaf_rn(Codec<W>::value(Codec<W>::code(__fdiv_rn(v, safe))),
                   scale, a);
}

// K14q (f32): nb blocks of blk values of from folded into to, one warp a
// block; blockDim.x is a multiple of 32, blk of 4.
template <int W>
__global__ void __launch_bounds__(1024) rma_acc_quant_direct_kernel(
    const float* from, float* to, long long nb, int blk) {
  const int lane = threadIdx.x & 31;
  const int nw = blk / 4;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long k = static_cast<long long>(blockIdx.x) *
                         (blockDim.x >> 5) + (threadIdx.x >> 5);
       k < nb; k += warps) {
    const float* xb = from + k * blk;
    float* ob = to + k * blk;
    float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), w0 = x0;
    if (lane < nw) {
      x0 = load4(xb + 4 * lane);
      w0 = load4(ob + 4 * lane);
    }
    float amax = fmaxf(0.0f, absmax4(x0));
    for (int i = lane + 32; i < nw; i += 32)
      amax = fmaxf(amax, absmax4(load4(xb + 4 * i)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float scale = __fmul_rn(amax, Codec<W>::inv_top());
    const float safe = scale > 0.0f ? scale : 1.0f;
    for (int i = lane; i < nw; i += 32) {
      const float4 v = i == lane ? x0 : load4(xb + 4 * i);
      float4 a = i == lane ? w0 : load4(ob + 4 * i);
      a.x = quant_fold<W>(v.x, safe, scale, a.x);
      a.y = quant_fold<W>(v.y, safe, scale, a.y);
      a.z = quant_fold<W>(v.z, safe, scale, a.z);
      a.w = quant_fold<W>(v.w, safe, scale, a.w);
      store4(ob + 4 * i, a);
    }
  }
}

// ---------------------------------------------------------------------------
// K3, K4, K6, K7 and K5: the direct ring kernels
// ---------------------------------------------------------------------------
//
// ring_all_reduce_direct_kernel replaces mvapich2_tpu/ops/pallas_ring.py
// ring_all_reduce (:214, its pallas_call at :234, body
// _ring_all_reduce_kernel :147) as K6, and mvapich2_tpu/ops/pallas_ici.py
// hbm_ring_all_reduce (:501, pallas_call :532, body
// _hbm_all_reduce_kernel :359) as K3, over `lines` rings at once;
// ring_reduce_scatter_direct_kernel replaces pallas_ici.py
// hbm_ring_reduce_scatter (:580, pallas_call :609, body
// _hbm_reduce_scatter_kernel :399) as K4, over `lines` rings at once;
// ring_all_gather_direct_kernel replaces ring_all_gather (:114,
// pallas_call :131, body _ring_all_gather_kernel :78) as K7, and
// pallas_ici.py hbm_ring_all_gather (:545, pallas_call :566, body
// _hbm_all_gather_kernel :436) as K5, over `lines` rings at once.
//
// The TPU kernels pass one block a round to the right-hand neighbour
// through VMEM landing slots under a credit handshake (K3, K4 and K5:
// chunk by chunk, in both ring directions), because a chip reaches its
// neighbour's memory only by remote DMA. On one card every rank's shard
// is memory that any thread reads, so the rounds, the slots and the
// credits go (a handshake round cost about 6 us here: 14 rounds a K6
// call at p = 8). A gather's result does not depend on the schedule:
// every row of a ring is the concatenation of its shards. The one
// property of the ring that the result depends on is its fold order.
//
// The fold order (ops/ring.py ring_replay, the plain versions' engine,
// is the spec). The shard is cut into p blocks of nblk = ceil(n/p)
// elements, the last padded with the op's identity. In reduce-scatter
// step s (0..p-2) the clockwise lane of rank r folds the block arriving
// from r-1 into its block b = r-s-2 as red(own, incoming); rank r never
// folds its block r-1, which it sends in step 0 as it is. So block b
// starts as x[b+1] at rank b+1, rank b+1+k folds its own x[b+1+k] into
// it in step k-1, and after step p-2 it rests at rank b+p = b as
//     x[b] + (x[b-1] + (... + (x[b+2] + x[b+1]))),   ranks mod p,
// every partial rounded to T. The counter-clockwise lane mirrors with +
// (rank r folds the block from r+1 into its block r+s+2), so its part
// ends as x[b] + (x[b+1] + (... + x[b-1])). The all-gather steps only
// copy: in step s rank r stores block r-s-1 (r+s+1) from r-1 (r+1),
// which that rank holds finished, so every rank's row ends as the
// finished blocks. A block's elements [0, h), h = (nblk+1)/2, travel
// clockwise and [h, nblk) counter-clockwise when ndir == 2, else all
// clockwise (ops/ici.py _block_spans). Elementwise, then: element i of a
// ring's shards (block b = i / nblk, offset j = i - b*nblk) is
//     clockwise (ndir == 1 or j < h): acc = x[b+1][i], then
//         acc = red(x[b+k][i], acc) for k = 2..p;
//     counter-clockwise: acc = x[b-1][i], then acc = red(x[b-k][i], acc),
// ranks mod p, in T's arithmetic (f16 and bf16 round at every step, as
// the ring stores each partial; integers wrap; max and min keep the
// ring's (own, acc) operand order, which decides a NaN's payload, and
// give a zero the sign jnp.maximum/minimum give it, whatever the order).
// The fold never reads an element at or past n. K3 and K6 store acc into
// every row of the ring (the identity padding never reaches a stored
// element, so the last block is simply short); K6 is the case lines = 1,
// ndir = 1, n % p == 0, sum. K4 is the reduce-scatter alone: block b of
// the fold, which the ring leaves at rank b, is stored once, into row b
// of its line at offset j, and the p*nblk - n elements of the padded tail
// hold the op's identity folded with itself p times, which is the
// identity for every op and dtype here (0 + 0, 1 * 1, max(lo, lo),
// min(hi, hi)): K4 stores identity<T, OP>() there and reads nothing. So
// K3, K6 and K4 are one loop, direct_fold, whose store mode is a template
// argument; K4 has a kernel name of its own so that a profile tells the
// two apart. K7 and K5 load each word of each shard once and store it
// into every row of its ring. No thread waits for another, so the launch
// is a plain one: the grid min(one pass, the blocks that fit at once),
// the fit counted once per device, kernel and block size (direct_fit).
//
// A unit is a 16-byte word on the vector path (W = uint4) or one element
// (W = T). The fold takes the vector path when every input pointer and
// output row is 16-byte aligned and n, nblk and (ndir == 2) h are
// multiples of V = 16 / sizeof(T), so that no word straddles two blocks,
// the half point or the end; the gather when the shard is a multiple of
// V. Unit k of a row of line g is unit k of every shard of line g (K3,
// K6; unit u of lines*nu is unit k = u - g*nu of line g = u / nu); K4
// walks the p*per_blk units of a line's padded blocks instead (unit u of
// lines*p*per_blk is unit k = u - g*p*per_blk of line g, real below nu,
// padding from there) and stores unit k at unit k - b*per_blk of row
// g*p + b. For the gather, unit u of lines*p*mu belongs to shard s = u /
// mu = g*p + q of line g and goes to unit u - g*p*mu of the p rows of
// line g (K5; K7 is lines = 1). Neighbouring threads store to
// neighbouring words of each row. K3, K4 and K5 have no 4 MiB ceiling (a
// 64 MiB shard is 4 Mi words), so offsets are 64-bit throughout. Sources
// are read through the read-only path (ld.global.nc): the output is a
// fresh allocation that never aliases an input. The fold loads its p
// source words in groups of kFoldGroup before it folds each group: the
// loads of a group are in flight together, and p up to kMaxRanks needs no
// more than kFoldGroup words of registers.
//
// Bound: bytes. K3 and K6 read lines*p*n and write lines*p*n elements
// (K3: 0.3205 ms at 8 x 64 MiB f32; K6: 0.0003 ms at 8 x 64 KiB f32,
// 0.020 ms at 8 x 4 MiB, over 3.35 TB/s); K4 reads lines*p*n and writes
// lines*p*nblk (0.1803 ms at 8 x 64 MiB f32; 0.2404 ms as the (2, 4)
// mesh's first phase, 4 lines of 2); the (p-1) operations an element
// stay far below the f32 rate. K7 and K5 read lines*p*m and write
// lines*p*p*m (0.0014 ms at 8 x 64 KiB, 0.0113 ms at 8 x 512 KiB, 0.0225
// ms at 8 x 1 MiB). At 64 KiB K6 and K7 are bound by the launch.

constexpr int kFoldGroup = 8;

// A load through the read-only data path (ld.global.nc); W is uint4 or
// an element type.
template <typename W> __device__ __forceinline__ W ld_nc(const W* p) {
  if constexpr (sizeof(W) == 16) {
    return __ldg(p);
  } else if constexpr (sizeof(W) == 4) {
    unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    return *reinterpret_cast<W*>(&v);
  } else if constexpr (sizeof(W) == 2) {
    unsigned short v = __ldg(reinterpret_cast<const unsigned short*>(p));
    return *reinterpret_cast<W*>(&v);
  } else {
    unsigned char v = __ldg(reinterpret_cast<const unsigned char*>(p));
    return *reinterpret_cast<W*>(&v);
  }
}

// red(x, acc) over a unit: one element, or the V elements of a word.
template <typename T, int OP, typename W>
__device__ __forceinline__ W fold_unit(W x, W acc) {
  if constexpr (std::is_same<W, T>::value)
    return red<T, OP>(x, acc);
  else
    return fold_word<T, OP>(x, acc);
}

// The op's identity as a unit: one element, or V of them in a word.
template <typename T, int OP, typename W>
__device__ __forceinline__ W identity_unit() {
  if constexpr (std::is_same<W, T>::value) {
    return identity<T, OP>();
  } else {
    constexpr int V = 16 / sizeof(T);
    T e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = identity<T, OP>();
    W w;
    memcpy(&w, e, 16);
    return w;
  }
}

// K3, K6 (SCATTER false) and K4 (SCATTER true); W: T, or uint4 on the
// vector path. `lines` rings of p shards of nu units each, line-major;
// per_blk: units a block (K3's last block may be short, K4's is padded);
// half: the units of a block that fold clockwise when ndir == 2, the
// rest folding counter-clockwise.
template <typename T, typename W, int OP, bool SCATTER>
__device__ __forceinline__ void direct_fold(const RankPtrs& ptrs, int p,
                                            int lines, long long nu,
                                            long long per_blk,
                                            long long half, int ndir) {
  const long long lu = SCATTER ? p * per_blk : nu;   // units of a line
  const long long units = static_cast<long long>(lines) * lu;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    const long long g = lines == 1 ? 0 : u / lu;   // the line
    const long long k = u - g * lu;                // its unit of a row
    const int b = static_cast<int>(k / per_blk);
    const long long j = k - b * per_blk;           // its unit of block b
    const int base = static_cast<int>(g) * p;
    if (SCATTER && k >= nu) {                      // the padded tail
      static_cast<W*>(ptrs.out[base + b])[j] = identity_unit<T, OP, W>();
      continue;
    }
    // the rank step: +1 clockwise (b+1, b+2, ..., b+p), p-1 (that is,
    // -1) counter-clockwise (b-1, ..., b-p)
    const int d = ndir == 2 && j >= half ? p - 1 : 1;
    int q = b + d < p ? b + d : b + d - p;
    W acc = ld_nc(static_cast<const W*>(ptrs.in[base + q]) + k);
    for (int j0 = 2; j0 <= p; j0 += kFoldGroup) {
      W w[kFoldGroup];
#pragma unroll
      for (int i = 0; i < kFoldGroup; ++i)
        if (j0 + i <= p) {             // rank b + d*j mod p, j = j0 + i
          q = q + d < p ? q + d : q + d - p;
          w[i] = ld_nc(static_cast<const W*>(ptrs.in[base + q]) + k);
        }
#pragma unroll
      for (int i = 0; i < kFoldGroup; ++i)
        if (j0 + i <= p) acc = fold_unit<T, OP>(w[i], acc);
    }
    if constexpr (SCATTER) {
      static_cast<W*>(ptrs.out[base + b])[j] = acc;
    } else {
      for (int r = 0; r < p; ++r)
        static_cast<W*>(ptrs.out[base + r])[k] = acc;
    }
  }
}

// K3 and K6: every row of a line holds its allreduce (n elements).
template <typename T, typename W, int OP>
__global__ void __launch_bounds__(1024) ring_all_reduce_direct_kernel(
    RankPtrs ptrs, int p, int lines, long long nu, long long per_blk,
    long long half, int ndir) {
  direct_fold<T, W, OP, false>(ptrs, p, lines, nu, per_blk, half, ndir);
}

// K4: row g*p + b holds block b of line g's allreduce (nblk elements).
template <typename T, typename W, int OP>
__global__ void __launch_bounds__(1024) ring_reduce_scatter_direct_kernel(
    RankPtrs ptrs, int p, int lines, long long nu, long long per_blk,
    long long half, int ndir) {
  direct_fold<T, W, OP, true>(ptrs, p, lines, nu, per_blk, half, ndir);
}

// K7 and K5 (W: an unsigned type of the element's width, or uint4 on the
// vector path). `lines` rings of p shards of mu units each, line-major.
template <typename W>
__global__ void __launch_bounds__(1024) ring_all_gather_direct_kernel(
    RankPtrs ptrs, int p, int lines, long long mu) {
  const long long units = static_cast<long long>(lines) * p * mu;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       u < units; u += step) {
    const long long sh = u / mu;                // shard g*p + q
    const int first = static_cast<int>(sh) / p * p;   // row g*p of line g
    const W v = ld_nc(static_cast<const W*>(ptrs.in[sh]) + (u - sh * mu));
    const long long at = u - first * mu;        // unit of a row of line g
    for (int r = 0; r < p; ++r)
      static_cast<W*>(ptrs.out[first + r])[at] = v;
  }
}

// ---------------------------------------------------------------------------
// K9: the quantized allreduce as one direct pass
// ---------------------------------------------------------------------------
//
// quant_ring_all_reduce_kernel replaces mvapich2_tpu/ops/pallas_quant.py
// quant_ring_all_reduce (:377, its pallas_call at :426, body
// _quant_rs_kernel :316, engine _QuantStreamer :205), and performs the
// JAX wrapper's gather of the wire words (hbm_ring_all_gather) and their
// decode (_decode_f32, :440-444) in the same pass.
//
// The TPU kernel runs the reduce-scatter ring with the codec fused into
// every step: the sender encodes its f32 partial, the receiver decodes
// it and adds it to its own; then each rank encodes its reduced block
// once, the wire words are gathered, and every rank decodes them. The
// fold order is the one of K3's reduce-scatter (above): ring block k's
// elements in span 0 (the first (nb+1)/2 of its nb quantization blocks
// when ndir == 2, all of them when ndir == 1) start at rank k+1 and are
// folded in at k+2, ..., k+p = k; the others start at k-1 and are folded
// in at k-2, ..., k. Quantization blocks never straddle a span, and a
// hop's arithmetic (the absmax, the scale, the codes) is local to one
// quantization block. So each quantization block is an independent chain
// of p source reads and p encodes: acc = x[first], then, for each next
// rank r of the chain,
//     acc = fma(value(code(acc / safe)), scale, x[r]),
// scale = absmax(acc) * f32(1/top) and safe = scale, or 1 for a zero
// block: the arithmetic of one ring step, operation for operation (the
// codec above; K14q's quant_fold). At the owner k the chain's acc is
// encoded once (into rank k's wire output, the JAX kernel's own_wire,
// when it is asked for) and decoded, value(code) * scale with one
// rounding as _decode_f32 computes q * scale, then rounded to the input
// dtype and stored into every rank's row at the block's columns below n.
// The ring's result is that chain's, bit for bit (ops/quant.py
// quant_reduce_scatter_ref replays the ring and is the spec); its wire
// words never reach memory between hops.
// On one card every rank's shard is memory that any thread reads, so the
// landing slots, the credits and the gather go.
//
// One warp a quantization block of blk values, in a grid-stride loop over
// the p * nblk / blk blocks of the padded ring. Up to 128 values, lane i
// holds the block's four-value word i (lanes past blk/4 hold zeros, which
// change no absmax and code to zero, and still join the shuffle), and the
// warp loads the block from the chain's sources kQuantGroup at a time
// (loads in flight before their folds), through the read-only path (the
// inputs do not change during the launch): f16 is widened to f32, and
// elements at or past n read as 0 (the JAX pad) and are not loaded. A
// larger block (WIDE) keeps its partial in a scratch row of f32 instead,
// scratch + q * blk, each word read and written by its own lane. The
// stores go by 16 bytes (f32) or 8 (f16) where a row's address allows it,
// element by element elsewhere (rows of an odd n), and never at or past n.
// The allreduce asks for the rows alone; the wire outputs (the JAX
// kernel's own_wire) are written only when they are asked for, by
// quant_reduce_scatter.
//
// Bound: bytes. Each input read once and each output row written once:
// p*m_in + p*m_out, 1,073,741,824 bytes or 0.3205 ms at 8 x 64 MiB f32
// over 3.35 TB/s (p*wblk*4 more, wblk the wire words of a ring block,
// when the wire outputs are asked for). The p encodes an element (a
// division each) stay far below the f32 rate.

constexpr int kQuantGroup = 2;     // sources a lane has in flight
constexpr int kQuantNarrow = 32;   // four-value words of a register block
constexpr int kQuantMaxThreads = 512;

// Elements e .. e+3 of x as f32: one 16-byte (f32) or 8-byte (f16) load
// when vec and the quad lies below n, else element by element; elements
// at or past n are 0 and are not loaded.
template <typename T>
__device__ __forceinline__ float4 load_quad(const T* x, long long e,
                                            long long n, bool vec) {
  if (vec && e + 4 <= n) {
    if constexpr (sizeof(T) == 4) {
      return __ldg(reinterpret_cast<const float4*>(x + e));
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(x + e));
      T h[4];
      memcpy(h, &u, 8);
      return make_float4(to_acc<T>(h[0]), to_acc<T>(h[1]), to_acc<T>(h[2]),
                         to_acc<T>(h[3]));
    }
  }
  float v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    v[t] = e + t < n ? to_acc<T>(ld_nc(x + e + t)) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// y[e .. e+3] = v rounded to T, below n; one 16-byte (f32) or 8-byte
// (f16) store when the address allows it.
template <typename T>
__device__ __forceinline__ void store_quad(T* y, long long e, long long n,
                                           float4 v) {
  T h[4] = {from_acc<T>(v.x), from_acc<T>(v.y), from_acc<T>(v.z),
            from_acc<T>(v.w)};
  if (e + 4 <= n &&
      (reinterpret_cast<uintptr_t>(y + e) & (4 * sizeof(T) - 1)) == 0) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(y + e) = v;
    } else {
      uint2 u;
      memcpy(&u, h, 8);
      *reinterpret_cast<uint2*>(y + e) = u;
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (e + t < n) y[e + t] = h[t];
}

// The warp's absmax of lane values a.
__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

// A block's scale from its absmax, and the divisor of its codes.
template <int W>
__device__ __forceinline__ float2 block_scale(float amax) {
  const float scale = __fmul_rn(amax, Codec<W>::inv_top());
  return make_float2(scale, scale > 0.0f ? scale : 1.0f);
}

// One hop of the chain on a word: a coded against s, decoded and folded
// into x.
template <int W>
__device__ __forceinline__ float4 hop4(float4 a, float2 s, float4 x) {
  return make_float4(quant_fold<W>(a.x, s.y, s.x, x.x),
                     quant_fold<W>(a.y, s.y, s.x, x.y),
                     quant_fold<W>(a.z, s.y, s.x, x.z),
                     quant_fold<W>(a.w, s.y, s.x, x.w));
}

// The owner's step on word w of a block: its wire word into wb when the
// wire outputs are asked for, and its decoded values stored into every
// row when the rows are.
template <typename T, int W>
__device__ __forceinline__ void finish4(const RankPtrs& ptrs, bool rows,
                                        int p, int* wb, int w, long long e,
                                        long long n, float2 s, float4 a) {
  const unsigned c0 = Codec<W>::code(__fdiv_rn(a.x, s.y));
  const unsigned c1 = Codec<W>::code(__fdiv_rn(a.y, s.y));
  const unsigned c2 = Codec<W>::code(__fdiv_rn(a.z, s.y));
  const unsigned c3 = Codec<W>::code(__fdiv_rn(a.w, s.y));
  if (wb) wb[1 + w] = static_cast<int>(c0 | c1 << 8 | c2 << 16 | c3 << 24);
  if (!rows || e >= n) return;
  const float4 d = make_float4(__fmul_rn(Codec<W>::value(c0), s.x),
                               __fmul_rn(Codec<W>::value(c1), s.x),
                               __fmul_rn(Codec<W>::value(c2), s.x),
                               __fmul_rn(Codec<W>::value(c3), s.x));
  for (int r = 0; r < p; ++r)
    store_quad(static_cast<T*>(ptrs.out[r]), e, n, d);
}

// K9 (T: the input dtype, f32 or f16; W: the wire; WIDE: a block of more
// than 128 values, its partial in the scratch row). ptrs.in: the p shards
// of n elements; ptrs.out: the p rows of n elements of the result, or all
// null; wires + k*wblk: rank k's wire output, or wires null; nblk: the
// ring block, a multiple of blk; vec: every input 16-byte (f32) or 8-byte
// (f16) aligned.
template <typename T, int W, bool WIDE>
__global__ void __launch_bounds__(kQuantMaxThreads) quant_ring_all_reduce_kernel(
    RankPtrs ptrs, int* wires, float* scratch, int p, long long n,
    long long nblk, int blk, int ndir, int vec) {
  const int lane = threadIdx.x & 31;
  const int nw = blk / 4;
  const long long per = nblk / blk;           // quantization blocks a ring block
  const long long wblk = per * (1 + nw);
  const bool rows = ptrs.out[0] != nullptr;
  const long long warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long q = static_cast<long long>(blockIdx.x) *
                         (blockDim.x >> 5) + (threadIdx.x >> 5);
       q < p * per; q += warps) {
    const int k = static_cast<int>(q / per);  // the ring block, its owner
    const long long jb = q - k * per;         // its quantization block
    const long long e0 = k * nblk + jb * blk; // its first element
    // the rank step: +1 clockwise (k+1, ..., k+p), p-1 counter-clockwise
    const int d = ndir == 2 && jb >= (per + 1) / 2 ? p - 1 : 1;
    int src = k + d < p ? k + d : k + d - p;
    int* wb = wires ? wires + k * wblk + jb * (1 + nw) : nullptr;
    float2 s;
    if constexpr (WIDE) {
      // the partial in the scratch row; the next hop's absmax is taken
      // as each word is folded
      float* a = scratch + q * blk;
      float amax = 0.0f;
      for (int j = 0; j < p; ++j) {
        const T* x = static_cast<const T*>(ptrs.in[src]);
        if (j > 0) s = block_scale<W>(warp_max(amax));
        amax = 0.0f;
        for (int w = lane; w < nw; w += 32) {
          float4 v = load_quad(x, e0 + 4 * w, n, vec);
          if (j > 0) v = hop4<W>(load4(a + 4 * w), s, v);
          store4(a + 4 * w, v);
          amax = fmaxf(amax, absmax4(v));
        }
        src = src + d < p ? src + d : src + d - p;
      }
      s = block_scale<W>(warp_max(amax));
      if (wb && lane == 0) wb[0] = __float_as_int(s.x);
      for (int w = lane; w < nw; w += 32)
        finish4<T, W>(ptrs, rows, p, wb, w, e0 + 4 * w, n, s,
                      load4(a + 4 * w));
    } else {
      const bool live = lane < nw;
      float4 acc;
      for (int j0 = 0; j0 < p; j0 += kQuantGroup) {
        float4 x[kQuantGroup];
#pragma unroll
        for (int i = 0; i < kQuantGroup; ++i)
          if (j0 + i < p) {
            x[i] = live ? load_quad(static_cast<const T*>(ptrs.in[src]),
                                    e0 + 4 * lane, n, vec)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            src = src + d < p ? src + d : src + d - p;
          }
#pragma unroll
        for (int i = 0; i < kQuantGroup; ++i)
          if (j0 + i < p) {
            if (j0 + i == 0) {
              acc = x[i];
            } else {
              s = block_scale<W>(warp_max(absmax4(acc)));
              acc = hop4<W>(acc, s, x[i]);
            }
          }
      }
      s = block_scale<W>(warp_max(absmax4(acc)));
      if (wb && lane == 0) wb[0] = __float_as_int(s.x);
      if (live) finish4<T, W>(ptrs, rows, p, wb, lane, e0 + 4 * lane, n, s, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// K11 and K10: the direct copy by tile table
// ---------------------------------------------------------------------------
//
// hbm_alltoallv_direct_kernel replaces mvapich2_tpu/ops/pallas_alltoall.py
// hbm_alltoallv (:488, its pallas_call at :527, body _hbm_alltoallv_kernel
// :335) as K11, and hbm_alltoall (:424, pallas_call :452, body
// _hbm_alltoall_kernel :290) as K10: a uniform alltoall of blocks of c
// elements is K11's exchange with every count c and the packed
// displacements, sdispls[r][j] = j*c and rdispls[j][r] = r*c.
//
// The TPU kernels stream each (r -> j) pair through j's landing slots
// under chunk credits, in p - 1 permutation steps (K11's each padded to
// its heaviest pair), because a chip reaches another chip's memory only by
// remote DMA. On one card every rank's payload is memory that any thread
// reads, so the exchange is one copy pass: pair (r -> j) moves
// counts[r][j] elements from sdispls[r][j] of rank r's payload to
// rdispls[j][r] of rank j's output (ops/alltoall.py _copy_pairs is the
// spec; K10's is _block_transpose). No slot, no flag, no wait.
//
// The wrapper cuts every non-empty pair, the diagonal one included, into
// tiles of at most TILE_BYTES (ops/alltoall.py tile_table; built once per
// device, count matrix and displacements, cached on the card), so that a
// heavy pair spreads over many blocks and no pair waits on another. A
// table row is (source rank, source offset, destination rank, destination
// offset, length, vec), in elements. Block b copies tiles b, b + grid,
// ...; its threads copy a tile's 16-byte words with kCopyUnroll loads in
// flight before their stores. The loads take the read-only path
// (ld.global.nc): the sources are the payloads, which no output aliases.
// Receive ranges are disjoint, as MPI requires of alltoallv (the wrapper
// refuses overlapping explicit rdispls; packed ones cannot overlap), so
// no two tiles store to one element and their order does not matter.
//
// A tile takes the word path when its row's vec says that its offsets and
// length are whole 16-byte words and the launch's `vec` says that every
// payload and output pointer is 16-byte aligned (the C entry refuses a
// vector request that breaks this); else it is copied element by
// element. Every tile of the MoE dispatch is whole words, and every
// tile of K10 at a block of whole words.
//
// Bound: bytes. Each moved byte is read once and written once: 1 GiB for
// the hot MoE dispatch at 4096 tokens x 4096 f32 a rank and for K10 at 8
// x 64 MiB f32 (4096 tiles of 128 KiB), 0.3205 ms at 3.35 TB/s.

constexpr int kTileCols = 6;

// K11 and K10 (E: an unsigned type of the element's width): the ntiles
// rows of `tiles` (kTileCols int64 each) copied from ptrs.in to ptrs.out.
template <typename E>
__global__ void __launch_bounds__(1024) hbm_alltoallv_direct_kernel(
    RankPtrs ptrs, const long long* tiles, long long ntiles, int vec) {
  const long long stride = static_cast<long long>(blockDim.x) * kCopyUnroll;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long* row = tiles + t * kTileCols;
    const E* from = static_cast<const E*>(ptrs.in[__ldg(row)]) + __ldg(row + 1);
    E* to = static_cast<E*>(ptrs.out[__ldg(row + 2)]) + __ldg(row + 3);
    const long long len = __ldg(row + 4);
    if (vec && __ldg(row + 5)) {
      const long long nvec = len * static_cast<long long>(sizeof(E)) / 16;
      const uint4* f = reinterpret_cast<const uint4*>(from);
      uint4* o = reinterpret_cast<uint4*>(to);
      for (long long base = threadIdx.x; base < nvec; base += stride) {
        uint4 w[kCopyUnroll];
#pragma unroll
        for (int k = 0; k < kCopyUnroll; ++k) {
          const long long i = base + static_cast<long long>(k) * blockDim.x;
          if (i < nvec) w[k] = ld_nc(f + i);
        }
#pragma unroll
        for (int k = 0; k < kCopyUnroll; ++k) {
          const long long i = base + static_cast<long long>(k) * blockDim.x;
          if (i < nvec) o[i] = w[k];
        }
      }
    } else {
      for (long long i = threadIdx.x; i < len; i += blockDim.x)
        to[i] = ld_nc(from + i);
    }
  }
}

// ---------------------------------------------------------------------------
// K8: the exchange as a bulk-copy pipeline on the Tensor Memory Accelerator
// ---------------------------------------------------------------------------
//
// remote_sendrecv_kernel replaces mvapich2_tpu/ops/pallas_ici.py
// remote_sendrecv (:642, its pallas_call at :656, body _sendrecv_kernel):
// out[r] = in[partner of r], the partner swapping src and dst and being r
// elsewhere. On one card the TPU kernel's send/recv semaphore pair is
// stream order, and the exchange is p row copies of n elements.
//
// Bound: bytes, 2*p*m for an m-byte shard: each shard read once, each row
// written once (0.3205 ms at 8 x 64 MiB over 3.35 TB/s). A register copy
// loop keeps one or a few 16-byte loads a thread in flight and stops at
// 81-85 % of that on this card (K10/K11, K12/K13). Here the copy engine
// moves the data: one elected thread a block keeps a ring of `stages`
// shared-memory buffers of `tile` bytes busy. Each tile is a
// cp.async.bulk load (global -> shared, completing on its stage's
// mbarrier), then a cp.async.bulk store (shared -> global, in a bulk
// group of its own). Loads run `ahead` tiles before their stores, and a
// stage is loaded again only once the store that last read it has read it
// (cp.async.bulk.wait_group.read stages - ahead). The threads spend no
// registers on the data; each SM keeps up to stages * tile bytes moving.
//
// A bulk copy needs 16-byte aligned addresses and a whole number of 16
// bytes. The wrapper cuts the rows (ops/ici.py k8_plan; this kernel's
// k8_cut is the same cut). A row whose source and output share their
// offset mod 16 goes by bulk tiles from the output's first 16-byte
// boundary; its head before and its tail after it (under 16 bytes each)
// are copied by the block's threads element by element. A row whose
// offsets differ cannot be served by a bulk copy: the threads copy it
// whole, element by element (the wrapper counts those rows). The tiles of
// the bulk rows form one flat index space, row-major, `tpr` tiles a row;
// block b takes tiles b, b + grid, ... A row's last tile may be short or
// empty (an empty one arrives on its mbarrier without bytes and commits
// an empty bulk group, so every stage and group count stays in step).

constexpr int kK8MaxStages = 8;
constexpr int kK8Threads = 256;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Wait for the phase of parity `parity` of the mbarrier at `bar` to
// complete; false (after setting the error word) past the spin bound.
__device__ bool mbar_wait(unsigned bar, unsigned parity, int* err) {
  const unsigned long long t0 = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return true;
    if (global_ns() - t0 > kSpinTimeoutNs) {
      *reinterpret_cast<volatile int*>(err) = kErrTimeout;
      __threadfence_system();
      return false;
    }
  }
}

// cp.async.bulk.wait_group.read n (n < kK8MaxStages) for a runtime n
__device__ __forceinline__ void bulk_wait_read(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group.read 6;" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 7;" ::: "memory"); break;
  }
}

// A bulk row of nbytes whose output starts at `to`: the head bytes before
// the first 16-byte boundary (all of a short row) and the bytes of whole
// 16-byte words from there; the tail is the rest.
__device__ __forceinline__ void k8_cut(const void* to, long long nbytes,
                                       long long* head, long long* mid) {
  const long long h = (16 - (reinterpret_cast<uintptr_t>(to) & 15)) & 15;
  *head = min(nbytes, h);
  *mid = (nbytes - *head) & ~15LL;
}

__device__ __forceinline__ int k8_from(int r, int src, int dst) {
  return r == src ? dst : (r == dst ? src : r);
}

// The rank of the k-th set bit of mask
__device__ __forceinline__ int nth_bit(unsigned long long mask, int k) {
  for (; k > 0; --k) mask &= mask - 1;
  return __ffsll(static_cast<long long>(mask)) - 1;
}

// K8 (T: an unsigned type of the element's width): outs[r] = ins[partner
// of r]; bit r of `bulk` marks a row that goes by bulk tiles.
template <typename T>
__global__ void __launch_bounds__(kK8Threads) remote_sendrecv_kernel(
    RankPtrs ptrs, int p, long long n, int src, int dst,
    unsigned long long bulk, long long tpr, int tile, int stages, int ahead,
    int* err) {
  extern __shared__ __align__(128) unsigned char k8_buf[];
  __shared__ __align__(8) unsigned long long k8_bar[kK8MaxStages];
  const long long nbytes = n * static_cast<long long>(sizeof(T));
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long gstep = static_cast<long long>(gridDim.x) * blockDim.x;
  // the element work: every bulk row's head and tail, every other row
  for (int r = 0; r < p; ++r) {
    const T* from = static_cast<const T*>(ptrs.in[k8_from(r, src, dst)]);
    T* to = static_cast<T*>(ptrs.out[r]);
    if (bulk >> r & 1) {
      long long h, m;
      k8_cut(to, nbytes, &h, &m);
      h /= static_cast<long long>(sizeof(T));
      const long long t = h + m / static_cast<long long>(sizeof(T));
      if (gid < h) to[gid] = ld_nc(from + gid);
      if (t + gid < n) to[t + gid] = ld_nc(from + t + gid);
    } else {
      for (long long i = gid; i < n; i += gstep) to[i] = ld_nc(from + i);
    }
  }
  if (threadIdx.x != 0) return;
  // the bulk tiles, by this block's elected thread
  const long long total = static_cast<long long>(__popcll(bulk)) * tpr;
  if (blockIdx.x >= total) return;
  const long long cnt = (total - 1 - blockIdx.x) / gridDim.x + 1;
  const unsigned buf = smem_u32(k8_buf), bar = smem_u32(k8_bar);
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(bar + 8u * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  // this block's tile i: its source and output, and its bytes (0: empty)
  auto locate = [&](long long i, const char** f, char** t) -> unsigned {
    const long long g = blockIdx.x + i * gridDim.x;
    const int r = nth_bit(bulk, static_cast<int>(g / tpr));
    const long long k = g % tpr;
    char* to = static_cast<char*>(ptrs.out[r]);
    long long h, m;
    k8_cut(to, nbytes, &h, &m);
    const long long off = h + k * tile;
    *f = static_cast<const char*>(ptrs.in[k8_from(r, src, dst)]) + off;
    *t = to + off;
    return static_cast<unsigned>(
        max(0LL, min(static_cast<long long>(tile), m - k * tile)));
  };
  auto load = [&](long long i) {
    const unsigned s = static_cast<unsigned>(i % stages);
    const char* f;
    char* t;
    const unsigned bytes = locate(i, &f, &t);
    if (bytes) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar + 8u * s), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(buf + s * tile), "l"(f), "r"(bytes), "r"(bar + 8u * s)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                   :: "r"(bar + 8u * s) : "memory");
    }
  };
  for (long long i = 0; i < min(cnt, static_cast<long long>(ahead)); ++i)
    load(i);
  for (long long i = 0; i < cnt; ++i) {
    const unsigned s = static_cast<unsigned>(i % stages);
    if (!mbar_wait(bar + 8u * s, static_cast<unsigned>(i / stages) & 1u,
                   err))
      break;
    const char* f;
    char* t;
    const unsigned bytes = locate(i, &f, &t);
    if (bytes) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(t), "r"(buf + s * tile), "r"(bytes) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (i + ahead < cnt) {
      bulk_wait_read(stages - ahead);
      load(i + ahead);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

std::once_flag g_err_once;
int* g_err_host = nullptr;
int* g_err_dev = nullptr;
cudaError_t g_err_status = cudaSuccess;

// The spin-timeout word: mapped, portable host memory every launch
// writes through its device alias.
cudaError_t error_word(int** dev) {
  std::call_once(g_err_once, [] {
    g_err_status = cudaHostAlloc(reinterpret_cast<void**>(&g_err_host),
                                 sizeof(int),
                                 cudaHostAllocMapped | cudaHostAllocPortable);
    if (g_err_status == cudaSuccess) {
      *g_err_host = 0;
      g_err_status = cudaHostGetDevicePointer(
          reinterpret_cast<void**>(&g_err_dev), g_err_host, 0);
    }
  });
  *dev = g_err_dev;
  return g_err_status;
}

RankPtrs rank_ptrs(const void* ins, const void* outs, int p) {
  RankPtrs ptrs = {};
  const void* const* in = static_cast<const void* const*>(ins);
  void* const* out = static_cast<void* const*>(outs);
  for (int r = 0; r < p; ++r) {
    ptrs.in[r] = in[r];
    ptrs.out[r] = out[r];
  }
  return ptrs;
}

// K8: one ordinary launch, at most ctas_per_sm blocks an SM (fewer when
// the stages' shared memory allows fewer), stages * tile bytes of dynamic
// shared memory a block.
template <typename T>
cudaError_t launch_k8(RankPtrs ptrs, int p, long long n, int src, int dst,
                      unsigned long long bulk, long long tpr, int tile,
                      int stages, int ahead, int ctas_per_sm, int threads,
                      cudaStream_t s) {
  const void* kern = reinterpret_cast<const void*>(&remote_sendrecv_kernel<T>);
  const int smem = stages * tile;
  int *err, dev, sms, per_sm;
  cudaError_t e = error_word(&err);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  remote_sendrecv_kernel<T><<<sms * std::min(per_sm, ctas_per_sm), threads,
                              smem, s>>>(ptrs, p, n, src, dst, bulk, tpr,
                                         tile, stages, ahead, err);
  return cudaGetLastError();
}

// The direct kernels (K3-K7, K9-K14q, K17): the blocks of one kernel
// instance and block size that fit on the card at once, counted at its
// first launch on a device, then kept (room for every instance: K3 and
// K4 have 72 each).
constexpr int kMaxFits = 256;
struct DirectFit {
  int dev;
  const void* kern;
  int threads;
  int cap;
};
std::mutex g_fit_mu;
DirectFit g_fits[kMaxFits];
int g_nfits = 0;

const void* copy_kern(int esize) {
  switch (esize) {
    case 4: return reinterpret_cast<const void*>(&rma_copy_kernel<uint32_t>);
    case 2: return reinterpret_cast<const void*>(&rma_copy_kernel<uint16_t>);
    case 1: return reinterpret_cast<const void*>(&rma_copy_kernel<uint8_t>);
    default: return nullptr;
  }
}

template <typename T> const void* acc_of() {
  return reinterpret_cast<const void*>(&rma_acc_direct_kernel<T>);
}

// K14's instance for a dtype code
const void* acc_kern(int dtype) {
  switch (dtype) {
    case F32: return acc_of<float>();
    case F16: return acc_of<__half>();
    case BF16: return acc_of<__nv_bfloat16>();
    case I32: return acc_of<int32_t>();
    case I16: return acc_of<int16_t>();
    case I8: return acc_of<int8_t>();
    case U8: return acc_of<uint8_t>();
    case U16: return acc_of<uint16_t>();
    case U32: return acc_of<uint32_t>();
    default: return nullptr;
  }
}

// The blocks of kern at `threads` a block that fit on the current device
// at once: one pass of the grid-stride loop.
cudaError_t direct_fit(const void* kern, int threads, int* cap) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> hold(g_fit_mu);
  for (int i = 0; i < g_nfits; ++i)
    if (g_fits[i].dev == dev && g_fits[i].kern == kern &&
        g_fits[i].threads == threads) {
      *cap = g_fits[i].cap;
      return cudaSuccess;
    }
  int sms, per_sm;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      0);
  if (e != cudaSuccess) return e;
  *cap = std::max(1, sms * per_sm);
  if (g_nfits < kMaxFits) g_fits[g_nfits++] = {dev, kern, threads, *cap};
  return cudaSuccess;
}

bool bad_direct_threads(int threads) {
  return threads < 32 || threads > 1024 || threads % 32;
}

// The grid of a direct launch (K3-K7, K9-K14q, K17) of
// `units` units of work, `per_block` a block: one pass, at most the
// blocks of kern at `threads` that fit at once, at least one block.
cudaError_t direct_grid(const void* kern, int threads, long long units,
                        long long per_block, int* grid) {
  int cap;
  const cudaError_t e = direct_fit(kern, threads, &cap);
  if (e != cudaSuccess) return e;
  *grid = static_cast<int>(std::max(
      1ll, std::min<long long>(cap, (units + per_block - 1) / per_block)));
  return cudaSuccess;
}

// K12/K13/K17 and K14 (kern): n elements of esize bytes from `from` into
// `to`, split at to's 16-byte boundary (ops/rma.py copy_plan models the
// split). The grid is one pass of kCopyUnroll words a thread, at most
// what fits at once, at least one block (the head and tail of a range
// shorter than a word; the head and tail need 16 threads).
cudaError_t launch_direct(const void* kern, int esize, const void* from,
                          void* to, long long n, int threads,
                          cudaStream_t s) {
  if (!kern || n < 0 || bad_direct_threads(threads))
    return cudaErrorInvalidValue;
  long long head = std::min<long long>(
      n, (-reinterpret_cast<uintptr_t>(to) & 15) / esize);
  long long nvec = (n - head) * esize / 16;
  int grid;
  const cudaError_t e = direct_grid(
      kern, threads, nvec, static_cast<long long>(threads) * kCopyUnroll,
      &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&from, &to, &n, &head, &nvec};
  return cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, 0, s);
}

// K14q: n / blk blocks of blk f32 values, one warp each; the grid is one
// block per threads / 32 of them, at most what fits at once.
template <int W>
cudaError_t launch_acc_quant(const void* from, void* to, long long n,
                             int blk, int threads, cudaStream_t s) {
  const void* kern =
      reinterpret_cast<const void*>(&rma_acc_quant_direct_kernel<W>);
  long long nb = n / blk;
  int grid;
  const cudaError_t e = direct_grid(kern, threads, nb, threads / 32, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&from, &to, &nb, &blk};
  return cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, 0, s);
}

// K9: one warp a quantization block, p * nblk / blk of them; the grid is
// one block per threads / 32 of them, at most what fits at once. The
// loads take the vector path when every input is aligned to 4 elements.
template <typename T, int W>
cudaError_t launch_k9(RankPtrs ptrs, int* wires, float* scratch, int p,
                      long long n, long long nblk, int blk, int ndir,
                      int threads, cudaStream_t s) {
  const bool wide = blk / 4 > kQuantNarrow;
  if (wide && !scratch) return cudaErrorInvalidValue;
  const void* kern =
      wide ? reinterpret_cast<const void*>(&quant_ring_all_reduce_kernel<T, W, true>)
           : reinterpret_cast<const void*>(&quant_ring_all_reduce_kernel<T, W, false>);
  uintptr_t bits = 0;
  for (int r = 0; r < p; ++r) bits |= reinterpret_cast<uintptr_t>(ptrs.in[r]);
  int vec = (bits & (4 * sizeof(T) - 1)) == 0;
  long long nq = p * (nblk / blk);
  int grid;
  const cudaError_t e = direct_grid(kern, threads, nq, threads / 32, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&ptrs, &wires, &scratch, &p, &n, &nblk, &blk, &ndir, &vec};
  return cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, 0, s);
}

template <typename T>
cudaError_t launch_k9_wire(int wire, RankPtrs ptrs, int* wires,
                           float* scratch, int p, long long n,
                           long long nblk, int blk, int ndir, int threads,
                           cudaStream_t s) {
  switch (wire) {
    case Q8: return launch_k9<T, Q8>(ptrs, wires, scratch, p, n, nblk, blk, ndir, threads, s);
    case FP8: return launch_k9<T, FP8>(ptrs, wires, scratch, p, n, nblk, blk, ndir, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

// The 16-byte words that one grid-stride pass of a K12/K13 or K14 launch
// (kern) at `threads` a block moves on the current device; -1 on an
// error.
int direct_pass(const void* kern, int threads) {
  int cap;
  if (!kern || bad_direct_threads(threads) ||
      direct_fit(kern, threads, &cap) != cudaSuccess)
    return -1;
  return cap * threads * kCopyUnroll;
}

// Every one of the p input and output pointers 16-byte aligned.
bool aligned16(const RankPtrs& ptrs, int p) {
  uintptr_t bits = 0;
  for (int r = 0; r < p; ++r)
    bits |= reinterpret_cast<uintptr_t>(ptrs.in[r]) |
            reinterpret_cast<uintptr_t>(ptrs.out[r]);
  return (bits & 15) == 0;
}

// K3/K6's kernel instance, or K4's (scatter), on words (vec) or elements.
template <typename T, int OP>
const void* fold_kern(int vec, bool scatter) {
  if (scatter)
    return vec ? reinterpret_cast<const void*>(
                     &ring_reduce_scatter_direct_kernel<T, uint4, OP>)
               : reinterpret_cast<const void*>(
                     &ring_reduce_scatter_direct_kernel<T, T, OP>);
  return vec ? reinterpret_cast<const void*>(
                   &ring_all_reduce_direct_kernel<T, uint4, OP>)
             : reinterpret_cast<const void*>(
                   &ring_all_reduce_direct_kernel<T, T, OP>);
}

// K3 and K6, or K4 (scatter): lines rings of p shards of n elements,
// folded in the ring's order over blocks of ceil(n/p) (ndir 2: the second
// half of every block counter-clockwise); vec: 16-byte words, refused
// unless every pointer is 16-byte aligned and n, the block and (ndir 2)
// its half are whole words.
template <typename T, int OP>
cudaError_t launch_direct_fold(RankPtrs ptrs, int p, int lines, long long n,
                               int ndir, int vec, bool scatter, int threads,
                               cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (n < 0 || (ndir != 1 && ndir != 2) || bad_direct_threads(threads))
    return cudaErrorInvalidValue;
  const long long nblk = (n + p - 1) / p, h = (nblk + 1) / 2;
  if (vec && (n % V || nblk % V || (ndir == 2 && h % V) ||
              !aligned16(ptrs, lines * p)))
    return cudaErrorInvalidValue;
  const long long w = vec ? V : 1;                  // elements a unit
  long long nu = n / w, per_blk = nblk / w, half = h / w;
  const void* kern = fold_kern<T, OP>(vec, scatter);
  int grid;
  const cudaError_t e = direct_grid(
      kern, threads, lines * (scatter ? p * per_blk : nu), threads, &grid);
  if (e != cudaSuccess) return e;
  void* args[] = {&ptrs, &p, &lines, &nu, &per_blk, &half, &ndir};
  return cudaLaunchKernel(kern, dim3(grid), dim3(threads), args, 0, s);
}

template <typename T>
cudaError_t launch_fold_op(int op, RankPtrs ptrs, int p, int lines,
                           long long n, int ndir, int vec, bool scatter,
                           int threads, cudaStream_t s) {
  switch (op) {
    case SUM: return launch_direct_fold<T, SUM>(ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case MAX: return launch_direct_fold<T, MAX>(ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case MIN: return launch_direct_fold<T, MIN>(ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case PROD: return launch_direct_fold<T, PROD>(ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

// K3, K4 and K6 by dtype
cudaError_t launch_fold_dtype(int dtype, int op, RankPtrs ptrs, int p,
                              int lines, long long n, int ndir, int vec,
                              bool scatter, int threads, cudaStream_t s) {
  switch (dtype) {
    case F32: return launch_fold_op<float>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case F16: return launch_fold_op<__half>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case BF16: return launch_fold_op<__nv_bfloat16>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case I32: return launch_fold_op<int32_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case I16: return launch_fold_op<int16_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case I8: return launch_fold_op<int8_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case U8: return launch_fold_op<uint8_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case U16: return launch_fold_op<uint16_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    case U32: return launch_fold_op<uint32_t>(op, ptrs, p, lines, n, ndir, vec, scatter, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

// K7 and K5 (E: an unsigned type of the element's width): lines rings of
// p shards of m elements; vec: 16-byte words.
template <typename E>
cudaError_t launch_direct_gather(RankPtrs ptrs, int p, int lines,
                                 long long m, int vec, int threads,
                                 cudaStream_t s) {
  constexpr int V = 16 / sizeof(E);
  if (m < 0 || bad_direct_threads(threads) ||
      (vec && (m % V || !aligned16(ptrs, lines * p))))
    return cudaErrorInvalidValue;
  const long long mu = vec ? m / V : m;
  const void* kern =
      vec ? reinterpret_cast<const void*>(&ring_all_gather_direct_kernel<uint4>)
          : reinterpret_cast<const void*>(&ring_all_gather_direct_kernel<E>);
  int grid;
  const cudaError_t e = direct_grid(
      kern, threads, static_cast<long long>(lines) * p * mu, threads, &grid);
  if (e != cudaSuccess) return e;
  if (vec)
    ring_all_gather_direct_kernel<uint4><<<grid, threads, 0, s>>>(
        ptrs, p, lines, mu);
  else
    ring_all_gather_direct_kernel<E><<<grid, threads, 0, s>>>(ptrs, p, lines,
                                                              mu);
  return cudaGetLastError();
}

// K11 and K10 (E: an unsigned type of the element's width): ntiles rows
// of the tile table over p ranks; vec: every payload and output pointer
// 16-byte aligned, so that the rows that say so move 16-byte words. One
// block a tile, at most the blocks that fit at once.
template <typename E>
cudaError_t launch_direct_alltoallv(RankPtrs ptrs, int p,
                                    const long long* tiles, long long ntiles,
                                    int vec, int threads, cudaStream_t s) {
  if (ntiles < 0 || bad_direct_threads(threads) ||
      (vec && !aligned16(ptrs, p)))
    return cudaErrorInvalidValue;
  int grid;
  const cudaError_t e = direct_grid(
      reinterpret_cast<const void*>(&hbm_alltoallv_direct_kernel<E>),
      threads, ntiles, 1, &grid);
  if (e != cudaSuccess) return e;
  hbm_alltoallv_direct_kernel<E><<<grid, threads, 0, s>>>(ptrs, tiles,
                                                          ntiles, vec);
  return cudaGetLastError();
}

int element_size(int dtype) {
  switch (dtype) {
    case F32: case I32: case U32: return 4;
    case F16: case BF16: case I16: case U16: return 2;
    case I8: case U8: return 1;
    default: return 0;
  }
}

bool bad_ranks(int p) { return p < 1 || p > kMaxRanks; }
bool bad_lines(int p, int lines) {
  return p < 1 || lines < 1 || lines * p > kMaxRanks;
}

}  // namespace

extern "C" {

// K3: outs[g*p + r] = the allreduce of line g's shards ins[g*p .. g*p +
// p - 1] of n elements, for every rank r of every line g, folded in the
// streaming ring's order over blocks of ceil(n/p) (ndir 2: the second
// half of every block counter-clockwise); ins/outs: lines * p pointers,
// line-major (rank i of line g at g*p + i); vec: every pointer 16-byte
// aligned and n, the block and (ndir 2) its half whole 16-byte words.
int mv2t_hbm_ring_all_reduce(int dtype, int op, const void* ins,
                             const void* outs, int p, int lines, long long n,
                             int ndir, int vec, int threads, void* stream) {
  if (bad_lines(p, lines)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fold_dtype(
      dtype, op, rank_ptrs(ins, outs, lines * p), p, lines, n, ndir, vec,
      false, threads, static_cast<cudaStream_t>(stream)));
}

// K4: outs[g*p + b] = block b (of ceil(n/p) elements) of line g's
// allreduce, folded as K3 folds it, the padded tail of the last block
// holding the op's identity; the arguments as K3's, outs being the
// lines * p output blocks.
int mv2t_hbm_ring_reduce_scatter(int dtype, int op, const void* ins,
                                 const void* outs, int p, int lines,
                                 long long n, int ndir, int vec, int threads,
                                 void* stream) {
  if (bad_lines(p, lines)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fold_dtype(
      dtype, op, rank_ptrs(ins, outs, lines * p), p, lines, n, ndir, vec,
      true, threads, static_cast<cudaStream_t>(stream)));
}

// K5: outs[g*p + r] = the p shards ins[g*p .. g*p + p - 1] of len
// elements, concatenated, for every rank r of every line g; vec: every
// pointer 16-byte aligned and len a multiple of 16 bytes.
int mv2t_hbm_ring_all_gather(int dtype, const void* ins, const void* outs,
                             int p, int lines, long long len, int vec,
                             int threads, void* stream) {
  if (bad_lines(p, lines)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, lines * p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_size(dtype)) {
    case 4: return static_cast<int>(launch_direct_gather<uint32_t>(ptrs, p, lines, len, vec, threads, s));
    case 2: return static_cast<int>(launch_direct_gather<uint16_t>(ptrs, p, lines, len, vec, threads, s));
    case 1: return static_cast<int>(launch_direct_gather<uint8_t>(ptrs, p, lines, len, vec, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8: outs[r] = ins[partner of r] for the p ranks, esize-byte elements.
// Bit r of bulk: row r goes by bulk tiles (its source and output agree mod
// 16 bytes), tpr tiles of tile bytes a row, enough for its whole 16-byte
// words; stages buffers a block, loads ahead of their stores by ahead.
int mv2t_remote_sendrecv(int esize, const void* ins, const void* outs, int p,
                         long long n, int src, int dst,
                         unsigned long long bulk, long long tpr, int tile,
                         int stages, int ahead, int ctas_per_sm, int threads,
                         void* stream) {
  if (bad_ranks(p) || src < 0 || src >= p || dst < 0 || dst >= p || n < 0 ||
      tile < 16 || tile % 16 || stages < 1 || stages > kK8MaxStages ||
      ahead < 1 || ahead > stages || ctas_per_sm < 1 || tpr < 0 ||
      tpr * tile < (n * esize & ~15LL) || threads < 32 ||
      threads > kK8Threads || (p < 64 && bulk >> p))
    return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  for (int r = 0; r < p; ++r) {
    const int from = r == src ? dst : (r == dst ? src : r);
    if ((bulk >> r & 1) &&
        ((reinterpret_cast<uintptr_t>(ptrs.in[from]) ^
          reinterpret_cast<uintptr_t>(ptrs.out[r])) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (esize) {
    case 4: return static_cast<int>(launch_k8<uint32_t>(ptrs, p, n, src, dst, bulk, tpr, tile, stages, ahead, ctas_per_sm, threads, s));
    case 2: return static_cast<int>(launch_k8<uint16_t>(ptrs, p, n, src, dst, bulk, tpr, tile, stages, ahead, ctas_per_sm, threads, s));
    case 1: return static_cast<int>(launch_k8<uint8_t>(ptrs, p, n, src, dst, bulk, tpr, tile, stages, ahead, ctas_per_sm, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9: ins[r] the p input shards (f32 or f16) of n elements; outs[r]
// rank r's result row of n elements in the input dtype, or outs NULL;
// wires the p wire outputs of nblk/blk*(1+blk/4) words each, or NULL
// (one of outs and wires at least); scratch p*nblk f32 for a block of
// more than 128 values, else unused; nblk a multiple of blk of at least
// ceil(n/p); wire 0 = q8, 1 = fp8; ndir 1 or 2.
int mv2t_quant_ring_all_reduce(int dtype, int wire, const void* ins,
                               const void* outs, void* wires, void* scratch,
                               int p, long long n, long long nblk, int blk,
                               int ndir, int threads, void* stream) {
  if (bad_ranks(p) || blk < 4 || blk % 4 || n < 0 || nblk < 0 ||
      nblk % blk || nblk * p < n || (ndir != 1 && ndir != 2) ||
      (!outs && !wires) || bad_direct_threads(threads) ||
      threads > kQuantMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  RankPtrs ptrs = {};
  const void* const* in = static_cast<const void* const*>(ins);
  for (int r = 0; r < p; ++r) ptrs.in[r] = in[r];
  if (outs) ptrs = rank_ptrs(ins, outs, p);
  int* w = static_cast<int*>(wires);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return static_cast<int>(launch_k9_wire<float>(wire, ptrs, w, sc, p, n, nblk, blk, ndir, threads, s));
    case F16: return static_cast<int>(launch_k9_wire<__half>(wire, ptrs, w, sc, p, n, nblk, blk, ndir, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K6: outs[r] = the sum of the p shards ins[.] of p * len elements, in
// the ring's fold order, for every rank r; vec: every pointer 16-byte
// aligned and len a multiple of 16 bytes. K3's fold on one line, one
// direction.
int mv2t_ring_all_reduce(int dtype, const void* ins, const void* outs,
                         int p, long long len, int vec, int threads,
                         void* stream) {
  if (bad_ranks(p) || len < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_fold_dtype(
      dtype, SUM, rank_ptrs(ins, outs, p), p, 1, p * len, 1, vec, false,
      threads, static_cast<cudaStream_t>(stream)));
}

// K7: outs[r] = the p shards ins[.] of len elements, concatenated, for
// every rank r; vec: every pointer 16-byte aligned and len a multiple of
// 16 bytes.
int mv2t_ring_all_gather(int dtype, const void* ins, const void* outs,
                         int p, long long len, int vec, int threads,
                         void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_size(dtype)) {
    case 4: return static_cast<int>(launch_direct_gather<uint32_t>(ptrs, p, 1, len, vec, threads, s));
    case 2: return static_cast<int>(launch_direct_gather<uint16_t>(ptrs, p, 1, len, vec, threads, s));
    case 1: return static_cast<int>(launch_direct_gather<uint8_t>(ptrs, p, 1, len, vec, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K11 and K10: tiles is the [ntiles][6] int64 tile table on the card
// (source rank, source offset, destination rank, destination offset,
// length, whole 16-byte words), every rank index below p; vec: every one
// of the p payload and output pointers 16-byte aligned.
int mv2t_hbm_alltoallv(int dtype, const void* ins, const void* outs, int p,
                       const void* tiles, long long ntiles, int vec,
                       int threads, void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  const long long* tb = static_cast<const long long*>(tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_size(dtype)) {
    case 4: return static_cast<int>(launch_direct_alltoallv<uint32_t>(ptrs, p, tb, ntiles, vec, threads, s));
    case 2: return static_cast<int>(launch_direct_alltoallv<uint16_t>(ptrs, p, tb, ntiles, vec, threads, s));
    case 1: return static_cast<int>(launch_direct_alltoallv<uint8_t>(ptrs, p, tb, ntiles, vec, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K12: src[n] into win (the target's window row) at disp. esize: the
// element size in bytes (1, 2 or 4).
int mv2t_rma_put(int esize, const void* src, void* win, long long disp,
                 long long n, int threads, void* stream) {
  return static_cast<int>(launch_direct(
      copy_kern(esize), esize, src, static_cast<char*>(win) + disp * esize,
      n, threads, static_cast<cudaStream_t>(stream)));
}

// K13: n elements of win (the target's window row) at disp into out;
// the arguments as K12's.
int mv2t_rma_get(int esize, const void* win, long long disp, void* out,
                 long long n, int threads, void* stream) {
  return static_cast<int>(launch_direct(
      copy_kern(esize), esize, static_cast<const char*>(win) + disp * esize,
      out, n, threads, static_cast<cudaStream_t>(stream)));
}

// The 16-byte words of one grid-stride pass of K12/K13 for esize-byte
// elements at `threads` a block on the current device; -1 on an error.
int mv2t_rma_copy_pass(int esize, int threads) {
  return direct_pass(copy_kern(esize), threads);
}

// K14: win (the target's window row)[disp + i] += src[i] for i < n, in
// the dtype's arithmetic; one plain launch.
int mv2t_rma_accumulate(int dtype, const void* src, void* win,
                        long long disp, long long n, int threads,
                        void* stream) {
  const int es = element_size(dtype);
  return static_cast<int>(launch_direct(
      acc_kern(dtype), es, src, static_cast<char*>(win) + disp * es, n,
      threads, static_cast<cudaStream_t>(stream)));
}

// The 16-byte words of one grid-stride pass of K14 for a dtype code at
// `threads` a block on the current device; -1 on an error.
int mv2t_rma_accumulate_pass(int dtype, int threads) {
  return direct_pass(acc_kern(dtype), threads);
}

// K14, quantized wire: win (an f32 window row)[disp + i] +=
// decode(encode(src[i])) in blocks of blk; n a multiple of blk, blk of 4.
int mv2t_rma_accumulate_quant(int wire, const void* src, void* win,
                              long long disp, long long n, int blk,
                              int threads, void* stream) {
  if (blk < 4 || blk % 4 || n < 0 || n % blk || bad_direct_threads(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  float* to = static_cast<float*>(win) + disp;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case Q8: return static_cast<int>(launch_acc_quant<Q8>(src, to, n, blk, threads, s));
    case FP8: return static_cast<int>(launch_acc_quant<FP8>(src, to, n, blk, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The spin-timeout word (0: none since the last clear); clear != 0 resets
// it.
int mv2t_ring_error(int clear) {
  int* dev;
  if (error_word(&dev) != cudaSuccess) return 0;
  const int code = *reinterpret_cast<volatile int*>(g_err_host);
  if (clear) *reinterpret_cast<volatile int*>(g_err_host) = 0;
  return code;
}

const char* mv2t_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
