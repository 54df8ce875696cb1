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
// What bounds them: each frame is a serial chain of Tp dependent
// add-compare-select steps (110,592 on the 1000-byte mixed-rate batch),
// with only B independent chains. The bytes (LLRs or symbols in,
// decisions out) would take well under 0.1 ms at 3.35 TB/s; the chain's
// latency takes milliseconds. This first design keeps one chain per warp
// and the whole 64-state metric vector in registers, so a step costs a
// handful of shuffles, adds and ballots and touches memory only for its
// inputs and its 8-byte decision word. Radix 4 takes two steps per
// iteration with four shuffles where two radix-2 steps take eight, and
// the integer metrics take exact integer multiply-adds; neither
// shortens the chain much (PERF.md). Many shorter chains do: the
// windowed decode runs this kernel over B * ceil(T / window) lanes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kRenorm = 64;          // ACS steps between renorms (Pallas UNROLL)
constexpr int kSub = 12;             // fused front sub-block: gcd of all n_dbps
constexpr int kMixedRenorm = 72;     // mixed fused cadence (Pallas MIXED_UNROLL)
constexpr int kBankSlots = 2 * 216;  // slots per rate row of the bank
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

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

// The ACS sweep of one frame per warp: radix 2 (one step an iteration)
// or 4 (a pair), renorm every 64 steps. Bound: the frame's serial chain
// (see the top of the file).
template <class M, int Radix>
__global__ void __launch_bounds__(32)
acs_kernel(const typename M::In* __restrict__ llr, u64* __restrict__ dec,
           typename M::T* __restrict__ metrics, int Tp) {
  using T = typename M::T;
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  const Lane<M> c(lane);
  T m_lo = lane == 0 ? T(0) : M::kStart;
  T m_hi = M::kStart;
  const typename M::In* __restrict__ x = llr + (size_t)frame * Tp;
  u64* __restrict__ out = dec + (size_t)frame * Tp;

  // the 64 steps between renorms fully unrolled: with a partial unroll
  // nvcc guarded every shuffle and ballot with a divergence branch, and
  // the radix-2 sweep ran 12 times slower
  for (int t0 = 0; t0 < Tp; t0 += kRenorm) {
    if constexpr (Radix == 2) {
#pragma unroll
      for (int j = 0; j < kRenorm; ++j) {
        const u64 w = acs_step(c, m_lo, m_hi, M::step(x[t0 + j]));  // broadcast
        if (lane == 0) out[t0 + j] = w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRenorm; j += 2) {
        u64 w1, w2;
        acs_pair(c, m_lo, m_hi, M::step(x[t0 + j]), M::step(x[t0 + j + 1]),
                 w1, w2);
        if (lane == 0) store_pair(out + t0 + j, w1, w2);
      }
    }
    renorm<M>(m_lo, m_hi);                       // once per 64 steps
  }
  metrics[(size_t)frame * kStates + lane] = m_lo;
  metrics[(size_t)frame * kStates + lane + 32] = m_hi;
}

// The LLR of one depunctured slot of the fused front end: slot `lane`
// (< 2 * kSub) of the sub-block starting at step s0. Arithmetic in the
// order of the reference's demap(): x * norm, the level formula, then
// (f * g) * valid, and an exact 0 at or past the frame's bit count.
// The _rn intrinsics keep nvcc from contracting any of it into an FMA.
__device__ __forceinline__ float front_slot(const float* __restrict__ sym,
                                            const float* __restrict__ gain,
                                            const int4* __restrict__ table,
                                            int n_dbps, float norm, int nbits,
                                            int n_sym, int s0, int lane) {
  // a symbol read past n_sym clamps, as viterbi_pallas.py:1232 does;
  // every such step lies past nbits and masks to 0
  const int k = min(s0 / n_dbps, n_sym - 1);
  const int4 e = __ldg(table + 2 * (s0 % n_dbps) + lane);
  const float xs = __fmul_rn(__ldg(sym + (size_t)k * 96 + e.x), norm);
  const float ax = fabsf(xs);
  const float f = e.y == 0   ? xs
                  : e.y == 1 ? __fsub_rn((float)e.z, ax)
                             : __fsub_rn(2.0f, fabsf(__fsub_rn(ax, 4.0f)));
  const float llr =
      __fmul_rn(__fmul_rn(f, __ldg(gain + (e.x >> 1))), (float)e.w);
  return s0 + (lane >> 1) < nbits ? llr : 0.0f;
}

// The fused decode of one frame (one warp): per 12-step sub-block,
// lanes 0-23 each compute one slot's LLR in a register, and ACS step jj
// takes its pair from lanes 2jj and 2jj + 1 by shuffle (a radix-4 pair
// jj its four values from lanes 4jj..4jj + 3), so the LLRs never reach
// memory. Renorm at the end of every `cadence` steps (Tp is a multiple
// of it, it a multiple of kSub; a sub-block holds six whole pairs).
template <int Radix>
__device__ __forceinline__ void fused_acs_frame(
    const float* __restrict__ sym, const float* __restrict__ gain,
    const int4* __restrict__ table, int n_dbps, float norm, int nbits,
    int n_sym, int Tp, int cadence, u64* __restrict__ dec,
    float* __restrict__ metrics) {
  const int lane = threadIdx.x;
  const Lane<F32> c(lane);
  float m_lo = lane == 0 ? 0.0f : kNeg;
  float m_hi = kNeg;
  for (int t0 = 0; t0 < Tp; t0 += cadence) {
    for (int s0 = t0; s0 < t0 + cadence; s0 += kSub) {
      const float llr =
          lane < 2 * kSub
              ? front_slot(sym, gain, table, n_dbps, norm, nbits, n_sym, s0,
                           lane)
              : 0.0f;
      if constexpr (Radix == 2) {
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float2 l = make_float2(__shfl_sync(kFull, llr, 2 * jj),
                                       __shfl_sync(kFull, llr, 2 * jj + 1));
          const u64 w = acs_step(c, m_lo, m_hi, l);
          if (lane == 0) dec[s0 + jj] = w;
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < kSub / 2; ++jj) {
          const float2 l1 = make_float2(__shfl_sync(kFull, llr, 4 * jj),
                                        __shfl_sync(kFull, llr, 4 * jj + 1));
          const float2 l2 = make_float2(__shfl_sync(kFull, llr, 4 * jj + 2),
                                        __shfl_sync(kFull, llr, 4 * jj + 3));
          u64 w1, w2;
          acs_pair(c, m_lo, m_hi, l1, l2, w1, w2);
          if (lane == 0) store_pair(dec + s0 + 2 * jj, w1, w2);
        }
      }
    }
    renorm<F32>(m_lo, m_hi);
  }
  metrics[lane] = m_lo;
  metrics[lane + 32] = m_hi;
}

// Replaces _make_mixed_fused_acs_kernel (viterbi_pallas.py:1174).
// Mixed-rate batch: frame f runs at rate ridx[f] (warp-uniform, so a
// warp reads only its own row of the bank), over the bucket-maximal
// trellis Tp = n_sym * 216, renormalizing every 72 steps. Bound: the
// frame's serial ACS chain, as acs_kernel; the front's loads and
// ~8 float operations a slot run on lanes 0-23 once per 12 steps.
template <int Radix>
__global__ void __launch_bounds__(32)
fused_acs_mixed_kernel(const float* __restrict__ sym,
                       const float* __restrict__ gain,
                       const int* __restrict__ nbits,
                       const int* __restrict__ ridx,
                       const int4* __restrict__ bank,
                       const int* __restrict__ ndbps,
                       const float* __restrict__ norms, u64* __restrict__ dec,
                       float* __restrict__ metrics, int n_sym, int Tp) {
  const int f = blockIdx.x;
  const int r = __ldg(ridx + f);
  fused_acs_frame<Radix>(sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48,
                         bank + (size_t)r * kBankSlots, __ldg(ndbps + r),
                         __ldg(norms + r), __ldg(nbits + f), n_sym, Tp,
                         kMixedRenorm, dec + (size_t)f * Tp,
                         metrics + (size_t)f * kStates);
}

// Replaces _make_fused_acs_kernel (viterbi_pallas.py:893).
// Known-rate batch: every frame at the rate of `table`, Tp = n_sym *
// n_dbps with n_sym a multiple of spb, renormalizing every spb * n_dbps
// steps (`cadence`). Bound: as fused_acs_mixed_kernel.
template <int Radix>
__global__ void __launch_bounds__(32)
fused_acs_rate_kernel(const float* __restrict__ sym,
                      const float* __restrict__ gain,
                      const int* __restrict__ nbits,
                      const int4* __restrict__ table, int n_dbps, float norm,
                      u64* __restrict__ dec, float* __restrict__ metrics,
                      int n_sym, int Tp, int cadence) {
  const int f = blockIdx.x;
  fused_acs_frame<Radix>(sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48,
                         table, n_dbps, norm, __ldg(nbits + f), n_sym, Tp,
                         cadence, dec + (size_t)f * Tp,
                         metrics + (size_t)f * kStates);
}

// One thread per frame: start at the first argmax of the final metrics
// (float32 or int32); per step, backward, emit state >> 5, read the
// survivor bit d of the current state and move to ((state & 31) << 1) | d.
template <typename T>
__global__ void traceback_kernel(const u64* __restrict__ dec,
                                 const T* __restrict__ metrics,
                                 uint8_t* __restrict__ bits, int B, int Tp) {
  const int frame = blockIdx.x * blockDim.x + threadIdx.x;
  if (frame >= B) return;
  const T* m = metrics + (size_t)frame * kStates;
  int state = 0;
  T best = m[0];
  for (int s = 1; s < kStates; ++s)
    if (m[s] > best) { best = m[s]; state = s; }
  const u64* d = dec + (size_t)frame * Tp;
  uint8_t* out = bits + (size_t)frame * Tp;
#pragma unroll 16
  for (int t = Tp - 1; t >= 0; --t) {
    const u64 w = d[t];
    out[t] = (uint8_t)(state >> 5);
    state = ((state & 31) << 1) | (int)((w >> state) & 1ull);
  }
}

template <class M, int Radix>
cudaError_t launch_acs(const void* llr, void* dec, void* metrics, int B,
                       int Tp, cudaStream_t stream) {
  acs_kernel<M, Radix><<<B, 32, 0, stream>>>(
      (const typename M::In*)llr, (u64*)dec, (typename M::T*)metrics, Tp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's
// cudaGetLastError() (0 = cudaSuccess); it never synchronizes.

// metric: 0 float32 (llr float32, metrics float32), 1 int16, 2 int8
// (llr int16, metrics int32); radix 2 or 4; Tp a multiple of 64; dec
// 16-byte aligned.
int ziria_acs(const void* llr, void* dec, void* metrics, int B, int Tp,
              int metric, int radix, int device, void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % kRenorm || ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const bool r4 = radix == 4;
  if (radix != 2 && !r4) return (int)cudaErrorInvalidValue;
  switch (metric) {
    case 0:
      err = r4 ? launch_acs<F32, 4>(llr, dec, metrics, B, Tp, s)
               : launch_acs<F32, 2>(llr, dec, metrics, B, Tp, s);
      break;
    case 1:
      err = r4 ? launch_acs<I16, 4>(llr, dec, metrics, B, Tp, s)
               : launch_acs<I16, 2>(llr, dec, metrics, B, Tp, s);
      break;
    case 2:
      err = r4 ? launch_acs<I8, 4>(llr, dec, metrics, B, Tp, s)
               : launch_acs<I8, 2>(llr, dec, metrics, B, Tp, s);
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
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (int_metrics)
    traceback_kernel<int><<<blocks, threads, 0, s>>>(
        (const u64*)dec, (const int*)metrics, (uint8_t*)bits, B, Tp);
  else
    traceback_kernel<float><<<blocks, threads, 0, s>>>(
        (const u64*)dec, (const float*)metrics, (uint8_t*)bits, B, Tp);
  return (int)cudaGetLastError();
}

// ridx (B,) int32 in [0, 8); bank (8, 432, 4) int32; ndbps (8,) int32;
// norms (8,) float32; Tp = n_sym * 216; radix 2 or 4.
int ziria_fused_acs_mixed(const void* sym, const void* gain, const void* nbits,
                          const void* ridx, const void* bank,
                          const void* ndbps, const void* norms, void* dec,
                          void* metrics, int B, int n_sym, int Tp, int radix,
                          int device, void* stream) {
  if (B <= 0 || n_sym <= 0 || Tp != n_sym * 216 ||
      (radix != 2 && radix != 4) || ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = radix == 4 ? fused_acs_mixed_kernel<4>
                           : fused_acs_mixed_kernel<2>;
  kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int*)ridx, (const int4*)bank, (const int*)ndbps,
      (const float*)norms, (u64*)dec, (float*)metrics, n_sym, Tp);
  return (int)cudaGetLastError();
}

// table (2 * n_dbps, 4) int32, 16-byte aligned; Tp = n_sym * n_dbps, a
// multiple of `cadence`, itself a multiple of 12; radix 2 or 4.
int ziria_fused_acs_rate(const void* sym, const void* gain, const void* nbits,
                         const void* table, void* dec, void* metrics,
                         int n_dbps, float norm, int B, int n_sym, int Tp,
                         int cadence, int radix, int device, void* stream) {
  if (B <= 0 || n_sym <= 0 || n_dbps <= 0 || n_dbps % kSub ||
      Tp != n_sym * n_dbps || cadence <= 0 || cadence % kSub ||
      Tp % cadence || ((uintptr_t)table & 15) || (radix != 2 && radix != 4) ||
      ((uintptr_t)dec & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto kernel = radix == 4 ? fused_acs_rate_kernel<4>
                           : fused_acs_rate_kernel<2>;
  kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int4*)table, n_dbps, norm, (u64*)dec, (float*)metrics, n_sym,
      Tp, cadence);
  return (int)cudaGetLastError();
}

}  // extern "C"
