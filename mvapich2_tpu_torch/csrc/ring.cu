// Ring collective kernels for Hopper (sm_90a) over p virtual ranks whose
// shards share one GPU's memory. One launch covers all p ranks.
//
// K3 hbm_ring_all_reduce_kernel  replaces mvapich2_tpu/ops/pallas_ici.py
//    hbm_ring_all_reduce (Pallas body _hbm_all_reduce_kernel, engine
//    _RingStreamer). Chunked streaming reduce-scatter then all-gather
//    over p blocks of nblk elements, the shard padded with the op's
//    identity; sum, max, min, prod.
// K5 hbm_ring_all_gather_kernel  replaces pallas_ici.py hbm_ring_all_gather
//    (body _hbm_all_gather_kernel). The all-gather ring alone.
// K6 ring_all_reduce_kernel      replaces mvapich2_tpu/ops/pallas_ring.py
//    ring_all_reduce (body _ring_all_reduce_kernel). Resident sum ring,
//    2 landing slots per rank, n % p == 0.
// K7 ring_all_gather_kernel      replaces pallas_ring.py ring_all_gather
//    (body _ring_all_gather_kernel). Resident gather ring, 2 slots.
//
// Translation. A TPU remote DMA into the neighbour's VMEM slot becomes a
// store into the downstream rank's landing slot in global memory
// (slots[rank][dir][slot][chunk]); a DMA/REGULAR semaphore becomes a u32
// counter in global memory, written by exactly one block with
// st.release.gpu after a __syncthreads (so the whole block's stores are
// ordered before it) and read by thread 0 of the waiting block with
// ld.acquire.gpu before a __syncthreads. Counters only grow within a
// launch, so "wait for credit k" is "wait until counter >= k"; the
// wrapper zeroes them, stream-ordered, before each launch. Mosaic's
// collective_id becomes the separate slot and counter buffers the
// wrapper allocates per launch. Landing slots are read with ld.global.cg
// (L2), since another SM wrote them.
//
// Parallelism. Each (rank, direction) lane gets B blocks; block b runs
// its own sub-ring over share b of every chunk (or of the block, for
// K6/K7), with its own counters, against block b of its neighbours'
// lanes. B independent credit chains, no barrier inside a lane. Every
// block must be resident at once (a block spinning on a credit would
// otherwise wait for a peer that never gets an SM), so the entries
// launch cooperatively, after lowering B to what fits on the card.
//
// Schedule (K3/K5): the JAX one. Reduce-scatter step s: the clockwise
// lane of rank r sends its partial of block r-s-1 to r+1 and folds the
// block arriving from r-1 into its block r-s-2 as red(own, incoming);
// the counter-clockwise lane mirrors with +. All-gather step s: send
// block r-s, store the arriving block r-s-1. Each step streams the
// lane's span of the block (first half clockwise, second half counter-
// clockwise when ndir == 2) in chunks: issue chunk c, then drain chunk
// c-1. One global chunk counter g per lane picks the slot (g mod depth);
// the sender writes chunk g only once the receiver has consumed chunk
// g-depth (the credit), the receiver reads it once the sender has
// published g+1 (the data flag). The TPU kernel's exit barrier (wait for
// the last credits) is not needed: the launch boundary orders every
// store before the next launch.
//
// Arithmetic: floats fold in float and round to the dtype at every step,
// integers in 32 bits and wrap to the dtype, exactly as the JAX kernel's
// dtype arithmetic; max/min propagate NaN as jnp.maximum does.
//
// Bound. Device-memory traffic, not arithmetic: per rank K3 moves about
// 2m (init copy) + (p-1)(5m/p) (reduce-scatter: read own, write slot,
// read slot and own, write own) + (p-1)(4m/p) (all-gather) bytes for an
// m-byte shard, against 2m for "read every input once, write every
// output once". The landing slots (p*ndir*depth*chunk elements) are
// small enough to stay in the 50 MB L2.
//
// Spin bound: a wait that outlasts kSpinTimeoutNs writes a nonzero error
// word into mapped host memory and ends the block; the other blocks then
// time out too. mv2t_ring_error reads (and clears) the word.
//
// Plain C interface, built by nvcc into a shared library and bound with
// ctypes (mvapich2_tpu_torch/ops/_build.py). Each entry launches on the
// stream it is given and returns the launch's cudaError_t.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

enum DType { F32 = 0, F16 = 1, BF16 = 2, I32 = 3, I16 = 4, I8 = 5, U8 = 6 };
enum Op { SUM = 0, MAX = 1, MIN = 2, PROD = 3 };

// ---------------------------------------------------------------------------
// arithmetic
// ---------------------------------------------------------------------------

template <typename T> struct Acc { using type = int32_t; };
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

template <int OP>
__device__ __forceinline__ float apply(float a, float b) {
  if (OP == SUM) return a + b;
  if (OP == PROD) return a * b;
  if (a != a || b != b) return a + b;          // NaN propagates
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

template <typename T, int OP>
__device__ __forceinline__ T red(T a, T b) {
  return from_acc<T>(apply<OP>(to_acc<T>(a), to_acc<T>(b)));
}

template <typename T> struct Limits;
template <> struct Limits<int32_t> { static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX; };
template <> struct Limits<int16_t> { static constexpr int32_t lo = INT16_MIN, hi = INT16_MAX; };
template <> struct Limits<int8_t> { static constexpr int32_t lo = INT8_MIN, hi = INT8_MAX; };
template <> struct Limits<uint8_t> { static constexpr int32_t lo = 0, hi = UINT8_MAX; };

template <typename T, int OP>
__device__ __forceinline__ T identity() {
  if (OP == SUM) return from_acc<T>(typename Acc<T>::type(0));
  if (OP == PROD) return from_acc<T>(typename Acc<T>::type(1));
  if constexpr (sizeof(typename Acc<T>::type) == 4 &&
                !std::is_same<typename Acc<T>::type, float>::value) {
    return from_acc<T>(OP == MAX ? Limits<T>::lo : Limits<T>::hi);
  } else {
    return from_acc<T>(OP == MAX ? -INFINITY : INFINITY);
  }
}

// ---------------------------------------------------------------------------
// memory and synchronization primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A load through L2 only (the line may have been written by another SM).
template <typename T> __device__ __forceinline__ T ld_cg(const T* p) {
  if constexpr (sizeof(T) == 16) {
    return __ldcg(p);
  } else if constexpr (sizeof(T) == 4) {
    unsigned v = __ldcg(reinterpret_cast<const unsigned*>(p));
    return *reinterpret_cast<T*>(&v);
  } else if constexpr (sizeof(T) == 2) {
    unsigned short v = __ldcg(reinterpret_cast<const unsigned short*>(p));
    return *reinterpret_cast<T*>(&v);
  } else {
    unsigned char v = __ldcg(reinterpret_cast<const unsigned char*>(p));
    return *reinterpret_cast<T*>(&v);
  }
}

// The whole block waits until *flag >= target. Thread 0 spins with
// acquire loads; false (after setting the error word) if the spin
// outlasted the bound.
__device__ bool block_wait(const unsigned* flag, unsigned target, int* err) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    ok = 1;
    if (ld_acquire(flag) < target) {
      const unsigned long long t0 = global_ns();
      while (ld_acquire(flag) < target) {
        if (global_ns() - t0 > kSpinTimeoutNs) {
          *reinterpret_cast<volatile int*>(err) = kErrTimeout;
          __threadfence_system();
          ok = 0;
          break;
        }
      }
    }
  }
  __syncthreads();
  const bool got = ok;
  __syncthreads();
  return got;
}

// Publish: every thread's stores so far, then *flag = value (release).
__device__ __forceinline__ void block_signal(unsigned* flag, unsigned value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, value);
  }
}

// ---------------------------------------------------------------------------
// block-wide element loops. With vec, cnt is a multiple of V = 16 /
// sizeof(T) and every pointer is 16-byte aligned: 16-byte accesses.
// ---------------------------------------------------------------------------

// dst[i] = src[i]; src read through L2 when it is a landing slot.
template <typename T>
__device__ void copy_range(T* dst, const T* src, long long cnt, int vec,
                           bool slot_src) {
  if (vec) {
    const long long nv = cnt / (16 / sizeof(T));
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      d[i] = slot_src ? ld_cg(s + i) : s[i];
  } else {
    for (long long i = threadIdx.x; i < cnt; i += blockDim.x)
      dst[i] = slot_src ? ld_cg(src + i) : src[i];
  }
}

// dst[i] = red(dst[i], slot[i])
template <typename T, int OP>
__device__ void fold_range(T* dst, const T* slot, long long cnt, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = cnt / V;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(slot);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 a = d[i];
      const uint4 b = ld_cg(s + i);
      T* ae = reinterpret_cast<T*>(&a);
      const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int k = 0; k < V; ++k) ae[k] = red<T, OP>(ae[k], be[k]);
      d[i] = a;
    }
  } else {
    for (long long i = threadIdx.x; i < cnt; i += blockDim.x)
      dst[i] = red<T, OP>(dst[i], ld_cg(slot + i));
  }
}

// dst[i] = x[start + i] for start + i < n, else the op identity (the
// padded tail of the last block).
template <typename T, int OP>
__device__ void init_range(T* dst, const T* x, long long start,
                           long long cnt, long long n, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const long long nv = cnt / V;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      const long long e = start + i * V;
      if (e + V <= n) {
        reinterpret_cast<uint4*>(dst)[i] =
            *reinterpret_cast<const uint4*>(x + e);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          dst[i * V + k] = e + k < n ? x[e + k] : identity<T, OP>();
      }
    }
  } else {
    for (long long i = threadIdx.x; i < cnt; i += blockDim.x)
      dst[i] = start + i < n ? x[start + i] : identity<T, OP>();
  }
}

// Share b of B of a chunk of sz elements, cut as a full chunk of `full`
// elements is cut (in units of `align`, then clamped to sz): so block b
// owns the same slice of a landing slot for every chunk, short last
// chunks included, and no two blocks' credit chains guard one address.
__device__ __forceinline__ void share(long long sz, long long full, int b,
                                      int B, int align, long long* s0,
                                      long long* s1) {
  const long long units = (full + align - 1) / align;
  const long long per = (units + B - 1) / B * align;
  *s0 = min(sz, b * per);
  *s1 = min(sz, *s0 + per);
}

__device__ __forceinline__ int mod(int a, int p) { return ((a % p) + p) % p; }

// ---------------------------------------------------------------------------
// the streaming engine of K3 and K5 (one block's view of one lane)
// ---------------------------------------------------------------------------

template <typename T>
struct Lane {
  int p, r, d, ndir, b, B, depth, vec;
  long long chunk, lo, hi;       // chunk elements; this direction's span
  T* o;                          // this rank's output (its working buffer)
  T* slots;                      // [p][ndir][depth][chunk]
  unsigned* landed;              // [p][ndir][B]: chunks landed in a lane
  unsigned* consumed;            // [p][ndir][B]: chunks a lane consumed
  int* err;
  unsigned g_issue, g_drain;     // the lane's global chunk counters

  __device__ int align() const { return vec ? 16 / int(sizeof(T)) : 1; }
  __device__ int dst() const { return d == 0 ? mod(r + 1, p) : mod(r - 1, p); }
  __device__ long long flag(int rank) const {
    return (static_cast<long long>(rank) * ndir + d) * B + b;
  }
  __device__ T* slot_ptr(int rank, unsigned g) const {
    return slots + ((static_cast<long long>(rank) * ndir + d) * depth +
                    g % depth) * chunk;
  }

  // front half: credit, then store share of chunk (off, sz) of block
  // offset sb_off into the downstream rank's slot, then publish it
  __device__ bool issue(long long sb_off, long long off, long long sz) {
    long long s0, s1;
    share(sz, chunk, b, B, align(), &s0, &s1);
    const int to = dst();
    const unsigned g = g_issue;
    if (g >= static_cast<unsigned>(depth) &&
        !block_wait(consumed + flag(to), g - depth + 1, err))
      return false;
    copy_range(slot_ptr(to, g) + s0, o + sb_off + off + s0, s1 - s0, vec,
               false);
    block_signal(landed + flag(to), g + 1);
    g_issue = g + 1;
    return true;
  }

  // back half: wait for the chunk from upstream, fold it into (or store
  // it at) block offset rb_off, then return the slot's credit
  template <int OP>
  __device__ bool drain(long long rb_off, long long off, long long sz,
                        bool fold) {
    long long s0, s1;
    share(sz, chunk, b, B, align(), &s0, &s1);
    const unsigned g = g_drain;
    if (!block_wait(landed + flag(r), g + 1, err)) return false;
    T* mine = o + rb_off + off + s0;
    const T* src = slot_ptr(r, g) + s0;
    if (fold)
      fold_range<T, OP>(mine, src, s1 - s0, vec);
    else
      copy_range(mine, src, s1 - s0, vec, true);
    block_signal(consumed + flag(r), g + 1);
    g_drain = g + 1;
    return true;
  }

  // one ring step: every chunk of the span, issue c then drain c-1
  template <int OP>
  __device__ bool step(long long sb_off, long long rb_off, bool fold) {
    const long long nc = (hi - lo + chunk - 1) / chunk;
    for (long long c = 0; c <= nc; ++c) {
      if (c < nc) {
        const long long off = lo + c * chunk;
        if (!issue(sb_off, off, min(chunk, hi - off))) return false;
      }
      if (c >= 1) {
        const long long off = lo + (c - 1) * chunk;
        if (!drain<OP>(rb_off, off, min(chunk, hi - off), fold))
          return false;
      }
    }
    return true;
  }
};

template <typename T>
__device__ Lane<T> make_lane(int p, long long nblk, long long chunk,
                             int depth, int ndir, int B, T* slots,
                             unsigned* landed, unsigned* consumed, int vec,
                             int* err, void* out) {
  Lane<T> L;
  L.b = blockIdx.x % B;
  const int lane = blockIdx.x / B;
  L.d = lane % ndir;
  L.r = lane / ndir;
  L.p = p; L.ndir = ndir; L.B = B; L.depth = depth; L.vec = vec;
  L.chunk = chunk;
  const long long h = (nblk + 1) / 2;
  L.lo = (ndir == 1 || L.d == 0) ? 0 : h;
  L.hi = (ndir == 1 || L.d == 1) ? nblk : h;
  L.o = static_cast<T*>(out);
  L.slots = slots; L.landed = landed; L.consumed = consumed; L.err = err;
  L.g_issue = 0; L.g_drain = 0;
  return L;
}

// K3
template <typename T, int OP>
__global__ void hbm_ring_all_reduce_kernel(
    RankPtrs ptrs, int p, long long n, long long nblk, long long chunk,
    int depth, int ndir, int B, T* slots, unsigned* landed,
    unsigned* consumed, int vec, int* err) {
  const int lane_rank = (blockIdx.x / B) / ndir;
  Lane<T> L = make_lane<T>(p, nblk, chunk, depth, ndir, B, slots, landed,
                           consumed, vec, err, ptrs.out[lane_rank]);
  const T* x = static_cast<const T*>(ptrs.in[L.r]);
  // o = x padded with the identity, this block's share of every chunk of
  // its span of every block (the only elements it ever touches)
  for (int k = 0; k < p; ++k)
    for (long long off = L.lo; off < L.hi; off += chunk) {
      long long s0, s1;
      share(min(chunk, L.hi - off), chunk, L.b, B, L.align(), &s0, &s1);
      const long long e = k * nblk + off + s0;
      init_range<T, OP>(L.o + e, x, e, s1 - s0, n, vec);
    }
  __syncthreads();
  const int r = L.r;
  for (int s = 0; s < p - 1; ++s) {             // reduce-scatter
    const int sb = L.d == 0 ? mod(r - s - 1, p) : mod(r + s + 1, p);
    const int rb = L.d == 0 ? mod(r - s - 2, p) : mod(r + s + 2, p);
    if (!L.template step<OP>(sb * nblk, rb * nblk, true)) return;
  }
  for (int s = 0; s < p - 1; ++s) {             // all-gather
    const int sb = L.d == 0 ? mod(r - s, p) : mod(r + s, p);
    const int rb = L.d == 0 ? mod(r - s - 1, p) : mod(r + s + 1, p);
    if (!L.template step<OP>(sb * nblk, rb * nblk, false)) return;
  }
}

// K5 (T: an unsigned type of the element's width; pure data movement)
template <typename T>
__global__ void hbm_ring_all_gather_kernel(
    RankPtrs ptrs, int p, long long m, long long chunk, int depth,
    int ndir, int B, T* slots, unsigned* landed, unsigned* consumed,
    int vec, int* err) {
  const int lane_rank = (blockIdx.x / B) / ndir;
  Lane<T> L = make_lane<T>(p, m, chunk, depth, ndir, B, slots, landed,
                           consumed, vec, err, ptrs.out[lane_rank]);
  const T* x = static_cast<const T*>(ptrs.in[L.r]);
  const int r = L.r;
  for (long long off = L.lo; off < L.hi; off += chunk) {  // my block
    long long s0, s1;
    share(min(chunk, L.hi - off), chunk, L.b, B, L.align(), &s0, &s1);
    copy_range(L.o + r * m + off + s0, x + off + s0, s1 - s0, vec, false);
  }
  __syncthreads();
  for (int s = 0; s < p - 1; ++s) {
    const int sb = L.d == 0 ? mod(r - s, p) : mod(r + s, p);
    const int rb = L.d == 0 ? mod(r - s - 1, p) : mod(r + s + 1, p);
    if (!L.template step<SUM>(sb * m, rb * m, false)) return;
  }
}

// ---------------------------------------------------------------------------
// the resident ring of K6 and K7: 2 slots per rank, the JAX kernels'
// two-neighbour credit handshake (each round a rank grants one credit to
// each neighbour and takes one from each)
// ---------------------------------------------------------------------------

template <typename T>
struct Resident {
  int p, r, b, B, left, right;
  long long len;                 // elements per slot (block or shard)
  T* slots;                      // [p][2][len]
  unsigned* landed;              // [p][B]: rounds landed from the left
  unsigned* from_left;           // [p][B]: credits granted by the left
  unsigned* from_right;          // [p][B]: credits granted by the right
  int* err;
  unsigned granted, taken;

  __device__ void init(int p_, long long len_, int B_, T* slots_,
                       unsigned* flags, int* err_) {
    p = p_; len = len_; B = B_; slots = slots_; err = err_;
    b = blockIdx.x % B;
    r = blockIdx.x / B;
    left = mod(r - 1, p);
    right = mod(r + 1, p);
    landed = flags;
    from_left = flags + p * B;
    from_right = flags + 2 * p * B;
    granted = 0;
    taken = 0;
  }
  __device__ T* slot(int rank, int k) const {
    return slots + (static_cast<long long>(rank) * 2 + k) * len;
  }
  // I am my left neighbour's right: bump its FROM_RIGHT, and vice versa
  __device__ void grant() {
    __syncthreads();
    ++granted;
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(from_right + left * B + b, granted);
      st_release(from_left + right * B + b, granted);
    }
  }
  __device__ bool take() {
    ++taken;
    return block_wait(from_left + r * B + b, taken, err) &&
           block_wait(from_right + r * B + b, taken, err);
  }
};

// K6
template <typename T>
__global__ void ring_all_reduce_kernel(RankPtrs ptrs, int p, long long blk,
                                       int B, T* slots, unsigned* flags,
                                       int vec, int* err) {
  Resident<T> R;
  R.init(p, blk, B, slots, flags, err);
  const int r = R.r;
  const T* x = static_cast<const T*>(ptrs.in[r]);
  T* o = static_cast<T*>(ptrs.out[r]);
  long long s0, s1;
  share(blk, blk, R.b, B, vec ? 16 / int(sizeof(T)) : 1, &s0, &s1);
  R.grant();
  for (int k = 0; k < p; ++k)
    copy_range(o + k * blk + s0, x + k * blk + s0, s1 - s0, vec, false);
  // rounds 0..p-2 reduce-scatter, p-1..2p-3 all-gather; the slot parity
  // runs on across the two phases
  for (int k = 0; k < 2 * p - 2; ++k) {
    const bool rs = k < p - 1;
    const int s = rs ? k : k - (p - 1);
    const int send_blk = rs ? mod(r - s - 1, p) : mod(r - s, p);
    const int recv_blk = rs ? mod(r - s - 2, p) : mod(r - s - 1, p);
    const int slot = (k + 1) % 2;
    if (!R.take()) return;
    copy_range(R.slot(R.right, slot) + s0, o + send_blk * blk + s0,
               s1 - s0, vec, false);
    block_signal(R.landed + R.right * B + R.b, k + 1);
    if (!block_wait(R.landed + r * B + R.b, k + 1, err)) return;
    if (rs)
      fold_range<T, SUM>(o + recv_blk * blk + s0, R.slot(r, slot) + s0,
                         s1 - s0, vec);
    else
      copy_range(o + recv_blk * blk + s0, R.slot(r, slot) + s0, s1 - s0,
                 vec, true);
    R.grant();
  }
  R.take();   // the final grants: the JAX kernel's exit barrier
}

// K7 (T: an unsigned type of the element's width)
template <typename T>
__global__ void ring_all_gather_kernel(RankPtrs ptrs, int p, long long m,
                                       int B, T* slots, unsigned* flags,
                                       int vec, int* err) {
  Resident<T> R;
  R.init(p, m, B, slots, flags, err);
  const int r = R.r;
  const T* x = static_cast<const T*>(ptrs.in[r]);
  T* o = static_cast<T*>(ptrs.out[r]);
  long long s0, s1;
  share(m, m, R.b, B, vec ? 16 / int(sizeof(T)) : 1, &s0, &s1);
  R.grant();
  copy_range(o + r * m + s0, x + s0, s1 - s0, vec, false);
  for (int s = 0; s < p - 1; ++s) {
    if (!R.take()) return;
    // forward what arrived last round (round 0: my own shard)
    const T* src = s == 0 ? x + s0 : R.slot(r, s % 2) + s0;
    copy_range(R.slot(R.right, (s + 1) % 2) + s0, src, s1 - s0, vec,
               s != 0);
    block_signal(R.landed + R.right * B + R.b, s + 1);
    if (!block_wait(R.landed + r * B + R.b, s + 1, err)) return;
    copy_range(o + mod(r - s - 1, p) * m + s0, R.slot(r, (s + 1) % 2) + s0,
               s1 - s0, vec, true);
    R.grant();
  }
  R.take();
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

// Blocks per lane that fit on the card at once for `lanes` lanes, at most
// `ctas`; cudaErrorCooperativeLaunchTooLarge if not even one does.
cudaError_t fit_ctas(const void* kernel, int lanes, int ctas, int threads,
                     int* B) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, 0);
  if (e != cudaSuccess) return e;
  *B = std::min(ctas, per_sm * sms / lanes);
  return *B >= 1 ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, int OP>
cudaError_t launch_k3(RankPtrs ptrs, int p, long long n, long long nblk,
                      long long chunk, int depth, int ndir, void* slots,
                      unsigned* flags, int ctas, int vec, int threads,
                      cudaStream_t s) {
  const void* kern =
      reinterpret_cast<const void*>(&hbm_ring_all_reduce_kernel<T, OP>);
  int B, *err;
  cudaError_t e = error_word(&err);
  if (e == cudaSuccess) e = fit_ctas(kern, p * ndir, ctas, threads, &B);
  if (e != cudaSuccess) return e;
  T* sl = static_cast<T*>(slots);
  unsigned* landed = flags;
  unsigned* consumed = flags + static_cast<long long>(p) * ndir * ctas;
  void* args[] = {&ptrs, &p, &n, &nblk, &chunk, &depth, &ndir, &B,
                  &sl, &landed, &consumed, &vec, &err};
  return cudaLaunchCooperativeKernel(kern, dim3(p * ndir * B),
                                     dim3(threads), args, 0, s);
}

template <typename T>
cudaError_t launch_k3_op(int op, RankPtrs ptrs, int p, long long n,
                         long long nblk, long long chunk, int depth,
                         int ndir, void* slots, unsigned* flags, int ctas,
                         int vec, int threads, cudaStream_t s) {
  switch (op) {
    case SUM: return launch_k3<T, SUM>(ptrs, p, n, nblk, chunk, depth, ndir, slots, flags, ctas, vec, threads, s);
    case MAX: return launch_k3<T, MAX>(ptrs, p, n, nblk, chunk, depth, ndir, slots, flags, ctas, vec, threads, s);
    case MIN: return launch_k3<T, MIN>(ptrs, p, n, nblk, chunk, depth, ndir, slots, flags, ctas, vec, threads, s);
    case PROD: return launch_k3<T, PROD>(ptrs, p, n, nblk, chunk, depth, ndir, slots, flags, ctas, vec, threads, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_k5(RankPtrs ptrs, int p, long long m, long long chunk,
                      int depth, int ndir, void* slots, unsigned* flags,
                      int ctas, int vec, int threads, cudaStream_t s) {
  const void* kern =
      reinterpret_cast<const void*>(&hbm_ring_all_gather_kernel<T>);
  int B, *err;
  cudaError_t e = error_word(&err);
  if (e == cudaSuccess) e = fit_ctas(kern, p * ndir, ctas, threads, &B);
  if (e != cudaSuccess) return e;
  T* sl = static_cast<T*>(slots);
  unsigned* landed = flags;
  unsigned* consumed = flags + static_cast<long long>(p) * ndir * ctas;
  void* args[] = {&ptrs, &p, &m, &chunk, &depth, &ndir, &B, &sl, &landed,
                  &consumed, &vec, &err};
  return cudaLaunchCooperativeKernel(kern, dim3(p * ndir * B),
                                     dim3(threads), args, 0, s);
}

// K6 and K7 share the launch: (ptrs, p, len, B, slots, flags, vec, err).
// The flag layout is [3][p][B] for the B the launch runs with.
template <typename T>
cudaError_t launch_resident(const void* kern, RankPtrs ptrs, int p,
                            long long len, void* slots, unsigned* flags,
                            int ctas, int vec, int threads, cudaStream_t s) {
  int B, *err;
  cudaError_t e = error_word(&err);
  if (e == cudaSuccess) e = fit_ctas(kern, p, ctas, threads, &B);
  if (e != cudaSuccess) return e;
  T* sl = static_cast<T*>(slots);
  void* args[] = {&ptrs, &p, &len, &B, &sl, &flags, &vec, &err};
  return cudaLaunchCooperativeKernel(kern, dim3(p * B), dim3(threads), args,
                                     0, s);
}

template <typename T>
cudaError_t launch_k6(RankPtrs ptrs, int p, long long blk, void* slots,
                      unsigned* flags, int ctas, int vec, int threads,
                      cudaStream_t s) {
  return launch_resident<T>(
      reinterpret_cast<const void*>(&ring_all_reduce_kernel<T>), ptrs, p,
      blk, slots, flags, ctas, vec, threads, s);
}

template <typename T>
cudaError_t launch_k7(RankPtrs ptrs, int p, long long m, void* slots,
                      unsigned* flags, int ctas, int vec, int threads,
                      cudaStream_t s) {
  return launch_resident<T>(
      reinterpret_cast<const void*>(&ring_all_gather_kernel<T>), ptrs, p, m,
      slots, flags, ctas, vec, threads, s);
}

int element_size(int dtype) {
  switch (dtype) {
    case F32: case I32: return 4;
    case F16: case BF16: case I16: return 2;
    case I8: case U8: return 1;
    default: return 0;
  }
}

bool bad_ranks(int p) { return p < 1 || p > kMaxRanks; }

}  // namespace

extern "C" {

int mv2t_hbm_ring_all_reduce(int dtype, int op, const void* ins,
                             const void* outs, int p, long long n,
                             long long nblk, long long chunk, int depth,
                             int ndir, void* slots, void* flags, int ctas,
                             int vec, int threads, void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  unsigned* fl = static_cast<unsigned*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case F32: e = launch_k3_op<float>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case F16: e = launch_k3_op<__half>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case BF16: e = launch_k3_op<__nv_bfloat16>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case I32: e = launch_k3_op<int32_t>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case I16: e = launch_k3_op<int16_t>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case I8: e = launch_k3_op<int8_t>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    case U8: e = launch_k3_op<uint8_t>(op, ptrs, p, n, nblk, chunk, depth, ndir, slots, fl, ctas, vec, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

int mv2t_hbm_ring_all_gather(int dtype, const void* ins, const void* outs,
                             int p, long long m, long long chunk, int depth,
                             int ndir, void* slots, void* flags, int ctas,
                             int vec, int threads, void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  unsigned* fl = static_cast<unsigned*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_size(dtype)) {
    case 4: return static_cast<int>(launch_k5<uint32_t>(ptrs, p, m, chunk, depth, ndir, slots, fl, ctas, vec, threads, s));
    case 2: return static_cast<int>(launch_k5<uint16_t>(ptrs, p, m, chunk, depth, ndir, slots, fl, ctas, vec, threads, s));
    case 1: return static_cast<int>(launch_k5<uint8_t>(ptrs, p, m, chunk, depth, ndir, slots, fl, ctas, vec, threads, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int mv2t_ring_all_reduce(int dtype, const void* ins, const void* outs,
                         int p, long long blk, void* slots, void* flags,
                         int ctas, int vec, int threads, void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  unsigned* fl = static_cast<unsigned*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (dtype) {
    case F32: e = launch_k6<float>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case F16: e = launch_k6<__half>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case BF16: e = launch_k6<__nv_bfloat16>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case I32: e = launch_k6<int32_t>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case I16: e = launch_k6<int16_t>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case I8: e = launch_k6<int8_t>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    case U8: e = launch_k6<uint8_t>(ptrs, p, blk, slots, fl, ctas, vec, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

int mv2t_ring_all_gather(int dtype, const void* ins, const void* outs,
                         int p, long long m, void* slots, void* flags,
                         int ctas, int vec, int threads, void* stream) {
  if (bad_ranks(p)) return static_cast<int>(cudaErrorInvalidValue);
  const RankPtrs ptrs = rank_ptrs(ins, outs, p);
  unsigned* fl = static_cast<unsigned*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_size(dtype)) {
    case 4: return static_cast<int>(launch_k7<uint32_t>(ptrs, p, m, slots, fl, ctas, vec, threads, s));
    case 2: return static_cast<int>(launch_k7<uint16_t>(ptrs, p, m, slots, fl, ctas, vec, threads, s));
    case 1: return static_cast<int>(launch_k7<uint8_t>(ptrs, p, m, slots, fl, ctas, vec, threads, s));
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
