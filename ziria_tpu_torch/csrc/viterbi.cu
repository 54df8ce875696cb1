// K=7 soft-decision Viterbi decoder kernels for Hopper (sm_90a).
//
// Bound from Python with ctypes (plain C entry points at the bottom;
// ziria_tpu_torch/ops/viterbi_cuda.py and ziria_tpu_torch/ops/viterbi_fused.py
// are the wrappers). Every kernel replaces one Pallas kernel of
// ziria_tpu/ops/viterbi_pallas.py:
//
//   acs_kernel<F32, 2>       _acs_kernel                    (:332)
//   acs_kernel<F32, 4>       _acs_kernel_r4                 (:369)
//   acs_kernel<I16, 2>       _acs_kernel_i16                (:402)
//   acs_kernel<I16, 4>       _acs_kernel_i16_r4 (:498), an instance of
//                            _make_acs_kernel_int_lut (:447)
//   acs_kernel<I8, 2>        _acs_kernel_i8 (:500), the same
//   acs_kernel<I8, 4>        _acs_kernel_i8_r4 (:501), the same
//   traceback_kernel<T>      _make_traceback_kernel(unroll) (:517; also the
//                            instances at :1006 and :1326), T = float or int
//   fused_acs_mixed_kernel<R> _make_mixed_fused_acs_kernel(n_sym_p, R) (:1174)
//   fused_acs_rate_kernel<R>  _make_fused_acs_kernel(spb, n_dbps, norm, R) (:893)
//
// Layouts (B frames, Tp trellis steps):
//   llr      (B, Tp, 2) float32, or int16 for the integer metrics (quantized
//            soft values, |q| <= 127 for int16 and <= 15 for int8)
//   sym      (B, n_sym, 96) float32: equalized data subcarriers, 2c + I/Q
//   gain     (B, 48) float32: |H|^2 of each data subcarrier
//   table    (2 * n_dbps) int4 {src, lev, amp, valid} per depunctured slot
//            of one symbol (ops/viterbi_fused.front_tables); the bank is
//            (8, 432) of them, row r = rate RATE_MBPS_ORDER[r]
//   dec      (B, Tp) uint64: bit s of word t = survivor bit of state s at
//            step t -- the Pallas kernel's (8, 128) uint8 planes, byte i
//            bit j = state 8i+j, read little-endian
//   metrics  (B, 64) float32, or int32 for the integer metrics
//   bits     (B, Tp) uint8: decoded bits
//
// What bounds them: each frame is a serial chain of dependent
// add-compare-select steps, with only B independent chains. The bytes
// (LLRs or symbols in, decisions out) would take well under 0.1 ms at
// 3.35 TB/s; the chain's latency takes far longer. Every design here
// keeps one chain per warp and the whole 64-state metric vector in
// registers, so a step costs a handful of shuffles, fused multiply-adds
// and ballots. Radix 4 takes two steps per iteration with four shuffles
// where two radix-2 steps take eight, and the integer metrics take exact
// integer multiply-adds; neither shortens the chain much (PERF.md).
//
// Every ACS kernel shortens the chain itself, exactly. A batch pads
// every frame with erasures (zero soft pairs) up to a common Tp: 110,592
// steps on the 1000-byte mixed-rate batch, of which at most 8,208 carry
// bits. Once every later pair is zero, a candidate is fma(+-1, 0, m) =
// m, so each metric becomes the max of its two predecessors, and since
// the K=7 trellis joins every state to every state in 6 steps, all 64
// metrics are equal 6 steps later and the renorm makes them m - m = +0.
// From a renorm that leaves all 64 metrics +0.0 (bitwise; integer 0)
// with only +0 pairs after it, every candidate is +0 + +-0 = +0 (round
// to nearest), every decision word 0 and the final metrics +0: the full
// sweep's output, which the kernel writes without running it; a -0.0,
// NaN or inf metric simply never stops early. acs_kernel learns "only
// zero pairs after it" from the data (three warps scan the frame
// backward while the fourth runs the chain), so no caller can make the
// shortcut wrong. The fused kernels know it from the frame's bit count:
// their front makes every pair at or past it a literal +0, whatever the
// symbols hold. One chain routine (acs_chain) serves all of them; what
// differs is where its pairs come from. acs_kernel's chain stages each
// 64-step block itself, one block ahead, by coalesced loads; the fused
// kernels' three other warps compute each renorm stage's depunctured
// pairs into shared memory one stage ahead, so the front's dependent
// loads never sit on the chain. Either way the decision words collect
// in shared memory and leave as coalesced stores. traceback_kernel cuts
// its chain into segments (see there). The windowed decode runs
// acs_kernel over B * ceil(T / window) shorter lanes, most of which stop
// at their first renorm.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kRenorm = 64;          // ACS steps between renorms (Pallas UNROLL)
constexpr int kSub = 12;             // fused front sub-block: gcd of all n_dbps
constexpr int kMixedRenorm = 72;     // mixed fused cadence (Pallas MIXED_UNROLL)
constexpr int kMaxCadence = 216;     // longest fused renorm stage (54 Mbps)
constexpr int kBankSlots = 2 * 216;  // slots per rate row of the bank
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAcsThreads = 128;     // ACS block: the chain and its helpers
constexpr int kScanThreads = kAcsThreads - 32;  // warps 1-3: scan or front
constexpr int kScanUnroll = 16;      // loads in flight per scanning thread
constexpr int kTailUnknown = 0x7fffffff;  // a step not published yet
constexpr int kChunk = 256;          // traceback steps staged at a time
constexpr int kTbWarps = 16;         // traceback block, at most
constexpr int kMaxSegments = 2048;   // traceback segments a frame, at most

using u64 = unsigned long long;

__constant__ int kG0[7] = {1, 0, 1, 1, 0, 1, 1};   // 133 octal
__constant__ int kG1[7] = {1, 1, 1, 1, 0, 0, 1};   // 171 octal

// +-1 coefficient of output bit `g` on the edge into `state` whose
// predecessor has low bit `d`: encoder window [b, s5..s0] with
// b = state >> 5 and s = ((state & 31) << 1) | d (ops/viterbi._edge_tables).
__device__ float edge_coeff(int state, int d, const int* g) {
  const int s = ((state & 31) << 1) | d;
  int acc = g[0] * (state >> 5);
  for (int i = 0; i < 6; ++i) acc += g[i + 1] * ((s >> (5 - i)) & 1);
  return (acc & 1) ? 1.0f : -1.0f;
}

// Float32 metrics. A candidate is (m + a*la) + b*lb rounded add by add,
// as the reference evaluates it. a and b are +-1, so a*la is exact and
// fma(a, la, m) rounds m + a*la once, exactly as the add does: two
// fused multiply-adds give the reference's bits in half the
// instructions of a multiply and an add each.
struct F32 {
  using T = float;
  using In = float2;
  using Step = float2;
  struct Edge { float a, b; };
  static constexpr float kStart = kNeg;  // every state but 0
  static constexpr bool kWordsFirst = true;  // see acs_chain

  __device__ __forceinline__ static Edge edge(int state, int d) {
    return {edge_coeff(state, d, kG0), edge_coeff(state, d, kG1)};
  }
  __device__ __forceinline__ static Step step(In l) { return l; }
  __device__ __forceinline__ static T cand(T m, Edge e, Step l) {
    return __fmaf_rn(e.b, l.y, __fmaf_rn(e.a, l.x, m));
  }
  __device__ __forceinline__ static T vmax(T a, T b) { return fmaxf(a, b); }
  __device__ __forceinline__ static T settle(T m, T mx) {
    return __fsub_rn(m, mx);
  }
  // a pair that is not an erasure: some bit besides the two signs set
  __device__ __forceinline__ static bool live(In l) {
    return ((__float_as_uint(l.x) | __float_as_uint(l.y)) << 1) != 0u;
  }
  __device__ __forceinline__ static bool plus_zero(T m) {
    return __float_as_uint(m) == 0u;
  }
};

// Saturating integer metrics on quantized soft pairs (the int16 and int8
// disciplines of _acs_kernel_i16 and _make_acs_kernel_int_lut): int32
// arithmetic between renorms, exact; at each renorm the max is
// subtracted and every metric clamped into [Lo, Hi]. The Pallas LUT
// kernels gather each state's branch metric from the step's 4-value
// combo table {la+lb, la-lb, -la+lb, -la-lb} with one-hot MXU dots; the
// entry at an edge's sign pattern is a*la + b*lb with the edge's +-1
// coefficients, which two integer multiply-adds compute exactly (and
// fewer instructions than selecting it).
template <int Lo, int Hi>
struct Int {
  using T = int;
  using In = short2;
  using Step = int2;
  struct Edge { int a, b; };
  static constexpr int kStart = Lo;
  static constexpr bool kWordsFirst = false;  // see acs_chain

  __device__ __forceinline__ static Edge edge(int state, int d) {
    return {(int)edge_coeff(state, d, kG0), (int)edge_coeff(state, d, kG1)};
  }
  __device__ __forceinline__ static Step step(In l) {
    return make_int2(l.x, l.y);
  }
  __device__ __forceinline__ static T cand(T m, Edge e, Step l) {
    return m + e.a * l.x + e.b * l.y;
  }
  __device__ __forceinline__ static T vmax(T a, T b) { return max(a, b); }
  __device__ __forceinline__ static T settle(T m, T mx) {
    return min(max(m - mx, Lo), Hi);
  }
  __device__ __forceinline__ static bool live(In l) {
    return (l.x | l.y) != 0;
  }
  __device__ __forceinline__ static bool plus_zero(T m) { return m == 0; }
};

using I16 = Int<-32768, 32767>;
using I8 = Int<-128, 127>;

// One warp per frame. Lane l holds the metrics of states l and l + 32.
//
// Radix 2: both states have predecessors 2l and 2l + 1 (mod 64), which
// live in lane (2l) & 31 and (2l + 1) & 31 -- in the low half for
// l < 16, the high half otherwise.
//
// Radix 4 (two steps as one butterfly, _acs_pair_r4_f32): both states
// have the same four grand-predecessors 4 * (l & 15) + j, j = (d2 << 1)
// | d1, and the same step-1 edges (into the intermediate state
// u = ((l & 31) << 1) | d2), so the step-1 candidates are computed once
// for the two. Grand-predecessor j lives in lane 4 * (l & 7) + j, in
// the high register when l & 8. Shuffle k sends, from lane s, the low
// register when (s & 3) == k and the high one otherwise; a lane that
// wants low registers reads lane 4 * (l & 7) + k and gets j = k, one
// that wants high registers reads 4 * (l & 7) + (k ^ 1) and gets
// j = k ^ 1. Four shuffles a pair instead of eight.
template <class M>
struct Lane {
  typename M::Edge lo[2], hi[2];  // radix 2 and radix-4 step 2: by d
  typename M::Edge s1[4];         // radix-4 step 1: by j
  int src_e, src_o, quad, mine, u_src, u_bit;
  bool from_lo, quad_hi;

  __device__ explicit Lane(int lane)
      : src_e((2 * lane) & 31), src_o((2 * lane + 1) & 31),
        quad(4 * (lane & 7)), mine(lane & 3), u_src(lane >> 1),
        u_bit(lane & 1), from_lo(lane < 16), quad_hi((lane & 8) != 0) {
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      lo[d] = M::edge(lane, d);
      hi[d] = M::edge(lane + 32, d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s1[j] = M::edge((lane << 1) | (j >> 1), j & 1);
  }
};

// One trellis step on the step value `l`: updates the lane's two
// metrics and returns the step's 64-bit decision word (on every lane).
// A decision takes predecessor-low-bit 1 only when strictly larger.
template <class M>
__device__ __forceinline__ u64 acs_step(const Lane<M>& c, typename M::T& m_lo,
                                        typename M::T& m_hi,
                                        const typename M::Step& l) {
  using T = typename M::T;
  const T e_lo = __shfl_sync(kFull, m_lo, c.src_e);
  const T e_hi = __shfl_sync(kFull, m_hi, c.src_e);
  const T o_lo = __shfl_sync(kFull, m_lo, c.src_o);
  const T o_hi = __shfl_sync(kFull, m_hi, c.src_o);
  const T ev = c.from_lo ? e_lo : e_hi;   // metric of pred 2l
  const T od = c.from_lo ? o_lo : o_hi;   // metric of pred 2l+1
  const T c0l = M::cand(ev, c.lo[0], l), c1l = M::cand(od, c.lo[1], l);
  const T c0h = M::cand(ev, c.hi[0], l), c1h = M::cand(od, c.hi[1], l);
  const bool d_lo = c1l > c0l, d_hi = c1h > c0h;
  m_lo = d_lo ? c1l : c0l;
  m_hi = d_hi ? c1h : c0h;
  const unsigned w_lo = __ballot_sync(kFull, d_lo);
  const unsigned w_hi = __ballot_sync(kFull, d_hi);
  return (u64)w_lo | ((u64)w_hi << 32);
}

// Two trellis steps (values l1, l2) as one radix-4 butterfly, equal
// bit for bit to two acs_step calls: p[j] is the radix-2 step-1
// candidate of intermediate state u = 2 * (t & 31) + d2 from
// predecessor low bit d1, in the same rounding order; m01 and m23 are
// that step's metrics of u for d2 = 0 and 1, and step 2 is the radix-2
// step on them. The step-1 word belongs to the intermediate states:
// lane l's comparisons are the bits of u = 2l (d2 = 0) and u = 2l + 1;
// lane l fetches those of u = l and u = l + 32 (from lanes l >> 1 and
// 16 + (l >> 1)) by shuffle and two ballots give the word. Writes both
// words to w1, w2.
template <class M>
__device__ __forceinline__ void acs_pair(const Lane<M>& c, typename M::T& m_lo,
                                         typename M::T& m_hi,
                                         const typename M::Step& l1,
                                         const typename M::Step& l2, u64& w1,
                                         u64& w2) {
  using T = typename M::T;
  T r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T send = c.mine == k ? m_lo : m_hi;
    r[k] = __shfl_sync(kFull, send, c.quad + (c.quad_hi ? (k ^ 1) : k));
  }
  T p[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p[j] = M::cand(c.quad_hi ? r[j ^ 1] : r[j], c.s1[j], l1);
  const bool a = p[1] > p[0], b = p[3] > p[2];
  const T m01 = a ? p[1] : p[0];
  const T m23 = b ? p[3] : p[2];
  const T c0l = M::cand(m01, c.lo[0], l2), c1l = M::cand(m23, c.lo[1], l2);
  const T c0h = M::cand(m01, c.hi[0], l2), c1h = M::cand(m23, c.hi[1], l2);
  const bool d_lo = c1l > c0l, d_hi = c1h > c0h;
  m_lo = d_lo ? c1l : c0l;
  m_hi = d_hi ? c1h : c0h;
  const int ab = (int)a | ((int)b << 1);
  const int u_lo = __shfl_sync(kFull, ab, c.u_src) >> c.u_bit;
  const int u_hi = __shfl_sync(kFull, ab, c.u_src + 16) >> c.u_bit;
  const unsigned v_lo = __ballot_sync(kFull, u_lo & 1);
  const unsigned v_hi = __ballot_sync(kFull, u_hi & 1);
  const unsigned w_lo = __ballot_sync(kFull, d_lo);
  const unsigned w_hi = __ballot_sync(kFull, d_hi);
  w1 = (u64)v_lo | ((u64)v_hi << 32);
  w2 = (u64)w_lo | ((u64)w_hi << 32);
}

// Both words of a pair in one 16-byte store (p is 16-byte aligned: the
// pair starts at an even step of a frame whose length is even).
__device__ __forceinline__ void store_pair(u64* p, u64 w1, u64 w2) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(w1, w2);
}

// Subtract the max of all 64 metrics (and, for the integer metrics,
// clamp to the rails), as the Pallas kernels do once per grid block.
template <class M>
__device__ __forceinline__ void renorm(typename M::T& m_lo,
                                       typename M::T& m_hi) {
  typename M::T mx = M::vmax(m_lo, m_hi);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = M::vmax(mx, __shfl_xor_sync(kFull, mx, off));
  m_lo = M::settle(m_lo, mx);
  m_hi = M::settle(m_hi, mx);
}

// Warps 1-3 of an ACS block: the frame's last step whose pair is not an
// erasure, found by scanning backward from Tp in rounds of kScanThreads
// * kScanUnroll steps (neighbouring threads read neighbouring steps),
// published in *tail with one store (-1 for an all-erasure frame).
// `hit` is the three warps' meeting point, -1 at the start.
__device__ __forceinline__ void scan_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kScanThreads) : "memory");
}

template <class M>
__device__ void scan_tail(const typename M::In* __restrict__ x, int Tp,
                          int tid, int* hit, volatile int* tail) {
  constexpr int kSpan = kScanThreads * kScanUnroll;
  int found = -1;
  for (int end = Tp; end > 0; end -= kSpan) {
    // all loads first, unconditional (a step before 0 reads step 0 and
    // is ignored), so that they are in flight together
    typename M::In v[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      v[u] = x[max(end - 1 - (u * kScanThreads + tid), 0)];
    int last = -1;
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int t = end - 1 - (u * kScanThreads + tid);
      if (t >= 0 && M::live(v[u])) last = max(last, t);
    }
    last = __reduce_max_sync(kFull, last);
    if ((tid & 31) == 0 && last >= 0) atomicMax(hit, last);
    scan_barrier();
    found = *(volatile int*)hit;
    scan_barrier();                 // every thread has read it before more
    if (found >= 0) break;          // atomics of a next round
  }
  if (tid == 0) *tail = found;
}

// `N` trellis steps, fully unrolled, on the step values x[0..N) from
// shared memory, radix 2 (one step an iteration) or 4 (a pair); lane 0
// leaves each step's decision word in w[0..N). Fully unrolled: with a
// partial unroll nvcc guarded every shuffle and ballot with a divergence
// branch, and the radix-2 sweep ran 12 times slower.
template <class M, int Radix, int N>
__device__ __forceinline__ void sweep(const Lane<M>& c, typename M::T& m_lo,
                                      typename M::T& m_hi,
                                      const typename M::In* x, u64* w) {
  if constexpr (Radix == 2) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const u64 d = acs_step(c, m_lo, m_hi, M::step(x[j]));
      if (threadIdx.x == 0) w[j] = d;
    }
  } else {
    static_assert(N % 2 == 0, "a radix-4 sweep takes whole pairs");
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      u64 w1, w2;
      acs_pair(c, m_lo, m_hi, M::step(x[j]), M::step(x[j + 1]), w1, w2);
      if (threadIdx.x == 0) store_pair(w + j, w1, w2);
    }
  }
}

// Warp 0 of an ACS block: the sweep of one frame, one renorm stage
// (`feed.cadence()` steps, a multiple of Feed::kUnroll) at a time. Each
// stage takes its pairs from shared memory and leaves its decision words
// there (`feed` says where, and stores them); after each renorm the warp
// stops if the stage ended past the frame's live pairs (`feed.past`) and
// all 64 metrics are +0 (see the top of the file), or at Tp. Returns the
// step where the sweep ended. The chain's speed hangs on where the
// stage's words leave (PERF.md): before the renorm for float32 metrics
// (M::kWordsFirst) and after it for the integer ones, the order nvcc
// schedules fastest for each; after the stop vote, the integer chains
// ran far slower.
template <class M, int Radix, class Feed>
__device__ int acs_chain(Feed& feed, typename M::T* __restrict__ met,
                         int Tp) {
  using T = typename M::T;
  const int lane = threadIdx.x;
  const Lane<M> c(lane);
  T m_lo = lane == 0 ? T(0) : M::kStart;
  T m_hi = M::kStart;
  const int cadence = feed.cadence();
  int t0 = 0;
  for (;;) {
    const typename M::In* x = feed.pairs(t0);
    u64* w = feed.words();
#pragma unroll 1
    for (int j = 0; j < cadence; j += Feed::kUnroll)
      sweep<M, Radix, Feed::kUnroll>(c, m_lo, m_hi, x + j, w + j);
    if constexpr (M::kWordsFirst) feed.swept(t0);
    renorm<M>(m_lo, m_hi);
    if constexpr (!M::kWordsFirst) feed.swept(t0);
    const int t1 = t0 + cadence;
    const bool stop =
        t1 >= Tp || __all_sync(kFull, feed.past(t1) && M::plus_zero(m_lo) &&
                                          M::plus_zero(m_hi));
    feed.finish(t1, stop);
    t0 = t1;
    if (stop) break;
  }
  met[lane] = m_lo;
  met[lane + 32] = m_hi;
  return t0;
}

// acs_kernel's feed: the chain stages each 64-step block's pairs itself
// (loaded, coalesced, while the block before ran) and stores the block's
// 64 decision words as one 512-byte store. A block ends past the live
// pairs once the scan has published a last live step before its end.
template <class M>
struct StagedFeed {
  using In = typename M::In;
  static constexpr int kUnroll = kRenorm;  // steps a sweep
  const In* __restrict__ x;
  u64* __restrict__ out;
  In* s_x;
  u64* s_w;
  const volatile int* tail;
  int Tp, lane, last;
  In p_lo, p_hi;

  __device__ StagedFeed(const In* x_, u64* out_, In* s_x_, u64* s_w_,
                        const volatile int* tail_, int Tp_)
      : x(x_), out(out_), s_x(s_x_), s_w(s_w_), tail(tail_), Tp(Tp_),
        lane(threadIdx.x), last(kTailUnknown), p_lo(x_[threadIdx.x]),
        p_hi(x_[threadIdx.x + 32]) {}
  __device__ static constexpr int cadence() { return kRenorm; }
  __device__ const In* pairs(int t0) {
    __syncwarp();                   // the block before has read s_x, s_w
    s_x[lane] = p_lo;
    s_x[lane + 32] = p_hi;
    __syncwarp();
    if (t0 + kRenorm < Tp) {
      p_lo = x[t0 + kRenorm + lane];
      p_hi = x[t0 + kRenorm + lane + 32];
    }
    last = *tail;
    return s_x;
  }
  __device__ u64* words() const { return s_w; }
  __device__ bool past(int t1) const { return t1 > last; }
  __device__ void swept(int t0) {
    __syncwarp();
    reinterpret_cast<ulonglong2*>(out + t0)[lane] =
        reinterpret_cast<const ulonglong2*>(s_w)[lane];
  }
  __device__ void finish(int, bool) {}
};

// All kAcsThreads threads of a block meet here (named barrier 2).
__device__ __forceinline__ void block_barrier() {
  asm volatile("bar.sync 2, %0;" ::"n"(kAcsThreads) : "memory");
}

// The zero decision words from `stop` (a multiple of an even cadence:
// 16-byte aligned) to Tp, by every thread of the block.
__device__ __forceinline__ void zero_tail(u64* __restrict__ out, int stop,
                                          int Tp) {
  ulonglong2* __restrict__ zero = reinterpret_cast<ulonglong2*>(out + stop);
  for (int i = threadIdx.x; i < (Tp - stop) / 2; i += kAcsThreads)
    zero[i] = make_ulonglong2(0ull, 0ull);
}

// The ACS sweep of one frame per block of 4 warps: warp 0 runs the
// chain, warps 1-3 scan for the erasure tail; then all four write the
// zero decision words from the chain's stop to Tp. Bound: the serial
// chain up to the stop, about 8,300 steps a frame on the mixed-rate
// batch; the tail's bytes (scan and fill) take tens of microseconds
// beside it. `stops` (may be null) gets each frame's stop step.
template <class M, int Radix>
__global__ void __launch_bounds__(kAcsThreads)
acs_kernel(const typename M::In* __restrict__ llr, u64* __restrict__ dec,
           typename M::T* __restrict__ metrics, int* __restrict__ stops,
           int Tp) {
  __shared__ __align__(16) u64 s_w[kRenorm];
  __shared__ __align__(16) typename M::In s_x[kRenorm];
  __shared__ int s_hit, s_tail, s_stop;
  const int frame = blockIdx.x;
  const typename M::In* __restrict__ x = llr + (size_t)frame * Tp;
  u64* __restrict__ out = dec + (size_t)frame * Tp;
  if (threadIdx.x == 0) {
    s_hit = -1;
    s_tail = kTailUnknown;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    StagedFeed<M> feed(x, out, s_x, s_w, &s_tail, Tp);
    const int stop = acs_chain<M, Radix>(
        feed, metrics + (size_t)frame * kStates, Tp);
    if (threadIdx.x == 0) s_stop = stop;
  } else {
    scan_tail<M>(x, Tp, threadIdx.x - 32, &s_hit, &s_tail);
  }
  __syncthreads();
  const int stop = s_stop;          // a multiple of 64
  zero_tail(out, stop, Tp);
  if (stops != nullptr && threadIdx.x == 0) stops[frame] = stop;
}

// The fused front end of one frame: the LLR of depunctured slot `parity`
// of trellis step s. Arithmetic in the order of the reference's demap():
// x * norm, the level formula, then (f * g) * valid, and an exact +0 at
// or past the frame's bit count. The _rn intrinsics keep nvcc from
// contracting any of it into an FMA.
struct Front {
  const float* __restrict__ sym;    // (n_sym, 96)
  const float* __restrict__ gain;   // (48)
  const int4* __restrict__ table;   // (2 * n_dbps) slot rows of the rate
  int n_dbps, nbits, n_sym;
  float norm;

  __device__ __forceinline__ float slot(int s, int parity) const {
    // a symbol read past n_sym clamps, as viterbi_pallas.py:1232 does;
    // every such step lies past nbits and masks to 0
    const int k = min(s / n_dbps, n_sym - 1);
    const int4 e = __ldg(table + 2 * (s % n_dbps) + parity);
    const float xs = __fmul_rn(__ldg(sym + (size_t)k * 96 + e.x), norm);
    const float ax = fabsf(xs);
    const float f = e.y == 0   ? xs
                    : e.y == 1 ? __fsub_rn((float)e.z, ax)
                               : __fsub_rn(2.0f, fabsf(__fsub_rn(ax, 4.0f)));
    const float llr =
        __fmul_rn(__fmul_rn(f, __ldg(gain + (e.x >> 1))), (float)e.w);
    return s < nbits ? llr : 0.0f;
  }

  // Thread `tid` of warps 1-3: its slots of the stage at t0 (`cadence`
  // steps, 2 slots a step) into dst, as float2 pairs, two slots at a
  // time with their loads in flight together (an index past the stage
  // clamps to its last slot). The stage before takes the chain at
  // least 72 steps, far longer than these few rounds of loads.
  __device__ __forceinline__ void stage(float* dst, int t0, int cadence,
                                        int tid) const {
    const int n = 2 * cadence;
#pragma unroll 1
    for (int p = tid; p < n; p += 2 * kScanThreads) {
      const int q = min(p + kScanThreads, n - 1);
      const float v = slot(t0 + (p >> 1), p & 1);
      const float w = slot(t0 + (q >> 1), q & 1);
      dst[p] = v;
      if (p + kScanThreads < n) dst[q] = w;
    }
  }
};

// The fused kernels' feed, on the chain's side: stage k's pairs and
// words live in buffer k & 1, filled and drained by warps 1-3
// (fused_helpers); chain and helpers meet once per stage, after which
// the chain reads the stage the helpers just wrote, and they write the
// one it just read. A stage ends past the live pairs once it ends at or
// past the frame's bit count. The chain publishes its stop in *s_stop
// before the stage's barrier, so the helpers leave with it.
struct FrontFeed {
  static constexpr int kUnroll = kSub;
  float2 (*s_x)[kMaxCadence];
  u64 (*s_w)[kMaxCadence];
  int* s_stop;
  int cadence_, nbits, k;

  __device__ int cadence() const { return cadence_; }
  __device__ const float2* pairs(int) const { return s_x[k & 1]; }
  __device__ u64* words() const { return s_w[k & 1]; }
  __device__ bool past(int t1) const { return t1 >= nbits; }
  __device__ void swept(int) {}
  __device__ void finish(int t1, bool stop) {
    if (stop && threadIdx.x == 0) *s_stop = t1;
    block_barrier();
    ++k;
  }
};

// Warps 1-3 of a fused block: stage 0's pairs before the chain starts,
// then during stage k the words of stage k - 1 out (coalesced 16-byte
// stores) and the pairs of stage k + 1 in, until the chain's stop.
__device__ __forceinline__ void fused_helpers(
    const Front& fr, float2 (*s_x)[kMaxCadence], u64 (*s_w)[kMaxCadence],
    const volatile int* s_stop, u64* __restrict__ out, int Tp, int cadence) {
  const int tid = threadIdx.x - 32;
  auto drain = [&](int k) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(s_w[k & 1]);
    ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + k * cadence);
    for (int i = tid; i < cadence / 2; i += kScanThreads) dst[i] = src[i];
  };
  fr.stage(reinterpret_cast<float*>(s_x[0]), 0, cadence, tid);
  block_barrier();
  for (int k = 0;; ++k) {
    const int t1 = (k + 1) * cadence;
    if (k > 0) drain(k - 1);
    if (t1 < Tp)
      fr.stage(reinterpret_cast<float*>(s_x[(k + 1) & 1]), t1, cadence, tid);
    block_barrier();
    if (*s_stop == t1) {
      drain(k);
      return;
    }
  }
}

// The fused decode of one frame per block of 4 warps: warps 1-3 compute
// the depunctured soft pairs of each renorm stage (`cadence` steps, a
// multiple of kSub, at most kMaxCadence; Tp a multiple of it) one stage
// ahead and store the decision words one stage behind, while warp 0 runs
// the chain; the chain stops after the first renorm at or past the
// frame's bit count that leaves every metric +0, and all four warps
// write the zero words from there to Tp. Bound: the chain up to the
// stop, as acs_kernel (the front's ~8 float operations and three loads
// a slot run beside it). `stops` (may be null) gets the stop step.
template <int Radix>
__device__ __forceinline__ void fused_acs_block(const Front& fr, int Tp,
                                                int cadence,
                                                u64* __restrict__ out,
                                                float* __restrict__ met,
                                                int* __restrict__ stop_out) {
  __shared__ __align__(16) float2 s_x[2][kMaxCadence];
  __shared__ __align__(16) u64 s_w[2][kMaxCadence];
  __shared__ int s_stop;
  if (threadIdx.x == 0) s_stop = kTailUnknown;
  __syncthreads();
  if (threadIdx.x < 32) {
    FrontFeed feed{s_x, s_w, &s_stop, cadence, fr.nbits, 0};
    block_barrier();                // stage 0's pairs are in
    acs_chain<F32, Radix>(feed, met, Tp);
  } else {
    fused_helpers(fr, s_x, s_w, &s_stop, out, Tp, cadence);
  }
  const int stop = *(volatile int*)&s_stop;  // set before the last barrier
  zero_tail(out, stop, Tp);
  if (stop_out != nullptr && threadIdx.x == 0) *stop_out = stop;
}

// Replaces _make_mixed_fused_acs_kernel (viterbi_pallas.py:1174).
// Mixed-rate batch: frame f runs at rate ridx[f] (block-uniform, so a
// block reads only its own row of the bank), over the bucket-maximal
// trellis Tp = n_sym * 216, renormalizing every 72 steps.
template <int Radix>
__global__ void __launch_bounds__(kAcsThreads)
fused_acs_mixed_kernel(const float* __restrict__ sym,
                       const float* __restrict__ gain,
                       const int* __restrict__ nbits,
                       const int* __restrict__ ridx,
                       const int4* __restrict__ bank,
                       const int* __restrict__ ndbps,
                       const float* __restrict__ norms, u64* __restrict__ dec,
                       float* __restrict__ metrics, int* __restrict__ stops,
                       int n_sym, int Tp) {
  const int f = blockIdx.x;
  const int r = __ldg(ridx + f);
  const Front fr{sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48,
                 bank + (size_t)r * kBankSlots, __ldg(ndbps + r),
                 __ldg(nbits + f), n_sym, __ldg(norms + r)};
  fused_acs_block<Radix>(fr, Tp, kMixedRenorm, dec + (size_t)f * Tp,
                         metrics + (size_t)f * kStates,
                         stops == nullptr ? nullptr : stops + f);
}

// Replaces _make_fused_acs_kernel (viterbi_pallas.py:893).
// Known-rate batch: every frame at the rate of `table`, Tp = n_sym *
// n_dbps with n_sym a multiple of spb, renormalizing every spb * n_dbps
// steps (`cadence`).
template <int Radix>
__global__ void __launch_bounds__(kAcsThreads)
fused_acs_rate_kernel(const float* __restrict__ sym,
                      const float* __restrict__ gain,
                      const int* __restrict__ nbits,
                      const int4* __restrict__ table, int n_dbps, float norm,
                      u64* __restrict__ dec, float* __restrict__ metrics,
                      int* __restrict__ stops, int n_sym, int Tp,
                      int cadence) {
  const int f = blockIdx.x;
  const Front fr{sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48, table,
                 n_dbps, __ldg(nbits + f), n_sym, norm};
  fused_acs_block<Radix>(fr, Tp, cadence, dec + (size_t)f * Tp,
                         metrics + (size_t)f * kStates,
                         stops == nullptr ? nullptr : stops + f);
}

// One traceback step back over decision word w: the predecessor of
// state s, ((s & 31) << 1) | (survivor bit of s).
__device__ __forceinline__ int tb_step(int s, u64 w) {
  return ((s & 31) << 1) | (int)((w >> s) & 1ull);
}

// Where state s arrives after n steps back over all-zero words: every
// step shifts in a 0, so after 6 steps every state is 0.
__device__ __forceinline__ int tb_zero(int s, int n) {
  return n >= 6 ? 0 : (s << n) & 63;
}

// The words of steps [a, a + n) of a frame (n <= kChunk), 8 a lane,
// neighbouring lanes on neighbouring words; 0 past n.
__device__ __forceinline__ void load_chunk(const u64* __restrict__ d, int a,
                                           int n, int lane, u64 (&w)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = i * 32 + lane;
    w[i] = k < n ? d[a + k] : 0ull;
  }
}

__device__ __forceinline__ bool chunk_live(const u64 (&w)[8]) {
  u64 any = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) any |= w[i];
  return __any_sync(kFull, any != 0ull);
}

// Segment-parallel traceback, one block of up to 16 warps per frame.
// One step's decision word maps each state to its predecessor, and these
// maps compose exactly, so the walk from the first argmax of the final
// metrics (float32 or int32) splits into three phases over segments of
// `seg_len` steps (a multiple of kChunk, staged kChunk words at a time):
//   1. each warp takes segments warp, warp + nw, ... and, for every end
//      state (two a lane), walks back to the state before the segment:
//      a 64-byte map in shared memory. An all-zero chunk needs no walk
//      (tb_zero), which is what the ACS kernel's zero tail costs here:
//      its read, issued one chunk ahead;
//   2. one thread composes the maps backward from the argmax, giving
//      every segment's end state;
//   3. each warp walks its segments again from those end states, lane 0
//      writing the bits to shared memory, the warp storing them
//      coalesced; an all-zero chunk's bits follow from its end state.
// Bound: the bytes of the decision words, read once in phase 1 (phase 3
// reads again only the chunks that are not all zero).
template <typename T>
__global__ void __launch_bounds__(kTbWarps * 32)
traceback_kernel(const u64* __restrict__ dec, const T* __restrict__ metrics,
                 uint8_t* __restrict__ bits, int Tp, int seg_len) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nseg = (Tp + seg_len - 1) / seg_len;
  const int nchunk = seg_len / kChunk;
  u64* s_w = reinterpret_cast<u64*>(smem) + warp * kChunk;
  uint8_t* s_bits = smem + nw * kChunk * 8 + warp * kChunk;
  uint8_t* s_map = smem + nw * kChunk * 9;       // (nseg, 64)
  uint8_t* s_end = s_map + nseg * kStates;       // (nseg)
  uint8_t* s_live = s_end + nseg;                // (nseg)
  const u64* __restrict__ d = dec + (size_t)blockIdx.x * Tp;
  uint8_t* __restrict__ out = bits + (size_t)blockIdx.x * Tp;

  // 1. this warp's items: its segments, each chunk by chunk from its end
  const int items = (warp < nseg ? (nseg - 1 - warp) / nw + 1 : 0) * nchunk;
  auto start = [&](int q) {
    return (warp + q / nchunk * nw) * seg_len +
           (nchunk - 1 - q % nchunk) * kChunk;
  };
  u64 w[8];
  if (items > 0) {
    const int a = start(0);
    load_chunk(d, a, min(Tp - a, kChunk), lane, w);
  }
  int e_lo = lane, e_hi = lane + 32;
  bool seg_live = false;
  for (int q = 0; q < items; ++q) {
    const int a = start(q), n = max(min(Tp - a, kChunk), 0);
    const bool live = chunk_live(w);
    if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s_w[i * 32 + lane] = w[i];
    }
    __syncwarp();
    if (q + 1 < items) {            // the next chunk, in flight meanwhile
      const int a1 = start(q + 1);
      load_chunk(d, a1, max(min(Tp - a1, kChunk), 0), lane, w);
    }
    if (live) {
#pragma unroll 8
      for (int t = n - 1; t >= 0; --t) {
        const u64 v = s_w[t];
        e_lo = tb_step(e_lo, v);
        e_hi = tb_step(e_hi, v);
      }
    } else {
      e_lo = tb_zero(e_lo, n);
      e_hi = tb_zero(e_hi, n);
    }
    seg_live |= live;
    __syncwarp();
    if (q % nchunk == nchunk - 1) {  // the segment's first chunk: its map
      const int seg = warp + q / nchunk * nw;
      s_map[seg * kStates + lane] = (uint8_t)e_lo;
      s_map[seg * kStates + lane + 32] = (uint8_t)e_hi;
      if (lane == 0) s_live[seg] = seg_live;
      e_lo = lane;
      e_hi = lane + 32;
      seg_live = false;
    }
  }
  __syncthreads();

  // 2. the end state of every segment, from the first argmax
  if (threadIdx.x == 0) {
    const T* m = metrics + (size_t)blockIdx.x * kStates;
    int s = 0;
    T best = m[0];
#pragma unroll
    for (int k = 1; k < kStates; ++k)
      if (m[k] > best) { best = m[k]; s = k; }
    for (int seg = nseg - 1; seg >= 0; --seg) {
      s_end[seg] = (uint8_t)s;
      s = s_live[seg] ? s_map[seg * kStates + s]
                      : tb_zero(s, min(seg_len, Tp - seg * seg_len));
    }
  }
  __syncthreads();

  // 3. the bits of each segment, walked again from its end state
  for (int seg = warp; seg < nseg; seg += nw) {
    int s = s_end[seg];
    const bool seg_has = s_live[seg];
    for (int c = nchunk - 1; c >= 0; --c) {
      const int a = seg * seg_len + c * kChunk;
      const int n = min(Tp - a, kChunk);
      if (n <= 0) continue;
      bool live = false;
      if (seg_has) {
        load_chunk(d, a, n, lane, w);
        live = chunk_live(w);
      }
      if (!live) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = i * 32 + lane, back = n - 1 - k;
          if (k < n)
            out[a + k] = back < 6 ? (uint8_t)((s >> (5 - back)) & 1) : 0;
        }
        s = tb_zero(s, n);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) s_w[i * 32 + lane] = w[i];
      __syncwarp();
      if (lane == 0) {
#pragma unroll 8
        for (int t = n - 1; t >= 0; --t) {
          s_bits[t] = (uint8_t)(s >> 5);
          s = tb_step(s, s_w[t]);
        }
      }
      s = __shfl_sync(kFull, s, 0);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = i * 32 + lane;
        if (k < n) out[a + k] = s_bits[k];
      }
      __syncwarp();
    }
  }
}

template <class M, int Radix>
cudaError_t launch_acs(const void* llr, void* dec, void* metrics, void* stops,
                       int B, int Tp, cudaStream_t stream) {
  acs_kernel<M, Radix><<<B, kAcsThreads, 0, stream>>>(
      (const typename M::In*)llr, (u64*)dec, (typename M::T*)metrics,
      (int*)stops, Tp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_traceback(const void* dec, const void* metrics,
                             void* bits, int B, int Tp, cudaStream_t stream) {
  // segments of kChunk steps, or whole multiples of it past kMaxSegments
  const int chunks = (Tp + kChunk - 1) / kChunk;
  const int seg_len = kChunk * ((chunks + kMaxSegments - 1) / kMaxSegments);
  const int nseg = (Tp + seg_len - 1) / seg_len;
  const int nw = min(kTbWarps, nseg);
  const size_t smem = (size_t)nw * kChunk * 9 + (size_t)nseg * (kStates + 2);
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  traceback_kernel<T><<<B, nw * 32, smem, stream>>>(
      (const u64*)dec, (const T*)metrics, (uint8_t*)bits, Tp, seg_len);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's
// cudaGetLastError() (0 = cudaSuccess); it never synchronizes.

// metric: 0 float32 (llr float32, metrics float32), 1 int16, 2 int8
// (llr int16, metrics int32); radix 2 or 4; Tp a multiple of 64; dec
// 16-byte aligned; stops null or (B,) int32, each frame's stop step.
int ziria_acs(const void* llr, void* dec, void* metrics, void* stops, int B,
              int Tp, int metric, int radix, int device, void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % kRenorm || ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool r4 = radix == 4;
  if (radix != 2 && !r4) return (int)cudaErrorInvalidValue;
  switch (metric) {
    case 0:
      err = r4 ? launch_acs<F32, 4>(llr, dec, metrics, stops, B, Tp, s)
               : launch_acs<F32, 2>(llr, dec, metrics, stops, B, Tp, s);
      break;
    case 1:
      err = r4 ? launch_acs<I16, 4>(llr, dec, metrics, stops, B, Tp, s)
               : launch_acs<I16, 2>(llr, dec, metrics, stops, B, Tp, s);
      break;
    case 2:
      err = r4 ? launch_acs<I8, 4>(llr, dec, metrics, stops, B, Tp, s)
               : launch_acs<I8, 2>(llr, dec, metrics, stops, B, Tp, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// int_metrics: 0 float32 metrics, 1 int32.
int ziria_traceback(const void* dec, const void* metrics, void* bits, int B,
                    int Tp, int int_metrics, int device, void* stream) {
  if (B <= 0 || Tp <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(int_metrics
                   ? launch_traceback<int>(dec, metrics, bits, B, Tp, s)
                   : launch_traceback<float>(dec, metrics, bits, B, Tp, s));
}

// Both fused entry points: stops null or (B,) int32, each frame's stop
// step (a multiple of the cadence, Tp for a full sweep); dec 16-byte
// aligned. A cadence is a multiple of kSub, so even, and every stop and
// Tp * 8 bytes are multiples of 16: the zero tail's stores are aligned.
static_assert(kSub % 2 == 0 && kMixedRenorm % kSub == 0 &&
                  kMaxCadence % kSub == 0,
              "fused cadences must be even multiples of the sub-block");

// ridx (B,) int32 in [0, 8); bank (8, 432, 4) int32; ndbps (8,) int32;
// norms (8,) float32; Tp = n_sym * 216; radix 2 or 4.
int ziria_fused_acs_mixed(const void* sym, const void* gain, const void* nbits,
                          const void* ridx, const void* bank,
                          const void* ndbps, const void* norms, void* dec,
                          void* metrics, void* stops, int B, int n_sym,
                          int Tp, int radix, int device, void* stream) {
  if (B <= 0 || n_sym <= 0 || Tp != n_sym * 216 ||
      (radix != 2 && radix != 4) || ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = radix == 4 ? fused_acs_mixed_kernel<4>
                           : fused_acs_mixed_kernel<2>;
  kernel<<<B, kAcsThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int*)ridx, (const int4*)bank, (const int*)ndbps,
      (const float*)norms, (u64*)dec, (float*)metrics, (int*)stops, n_sym,
      Tp);
  return (int)cudaGetLastError();
}

// table (2 * n_dbps, 4) int32, 16-byte aligned; Tp = n_sym * n_dbps, a
// multiple of `cadence`, itself a multiple of 12 and at most 216; radix
// 2 or 4.
int ziria_fused_acs_rate(const void* sym, const void* gain, const void* nbits,
                         const void* table, void* dec, void* metrics,
                         void* stops, int n_dbps, float norm, int B,
                         int n_sym, int Tp, int cadence, int radix,
                         int device, void* stream) {
  if (B <= 0 || n_sym <= 0 || n_dbps <= 0 || n_dbps % kSub ||
      Tp != n_sym * n_dbps || cadence <= 0 || cadence % kSub ||
      cadence > kMaxCadence || Tp % cadence || ((uintptr_t)table & 15) ||
      (radix != 2 && radix != 4) || ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = radix == 4 ? fused_acs_rate_kernel<4>
                           : fused_acs_rate_kernel<2>;
  kernel<<<B, kAcsThreads, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int4*)table, n_dbps, norm, (u64*)dec, (float*)metrics,
      (int*)stops, n_sym, Tp, cadence);
  return (int)cudaGetLastError();
}

}  // extern "C"
