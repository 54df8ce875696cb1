// K=7 soft-decision Viterbi decoder kernels for Hopper (sm_90a).
//
// Four kernels, bound from Python with ctypes (plain C entry points at
// the bottom; ziria_tpu_torch/ops/viterbi_cuda.py and
// ziria_tpu_torch/ops/viterbi_fused.py are the wrappers):
//
//   acs_f32_kernel         replaces _acs_kernel        (ziria_tpu/ops/viterbi_pallas.py:332)
//   traceback_kernel       replaces _make_traceback_kernel(unroll) (viterbi_pallas.py:517;
//                          also the instances at :1006 and :1326)
//   fused_acs_mixed_kernel replaces _make_mixed_fused_acs_kernel (viterbi_pallas.py:1174)
//   fused_acs_rate_kernel  replaces _make_fused_acs_kernel       (viterbi_pallas.py:893)
//
// Layouts (B frames, Tp trellis steps):
//   llr      (B, Tp, 2) float32: the (A, B) soft pair of each step
//   sym      (B, n_sym, 96) float32: equalized data subcarriers, 2c + I/Q
//   gain     (B, 48) float32: |H|^2 of each data subcarrier
//   table    (2 * n_dbps) int4 {src, lev, amp, valid} per depunctured slot
//            of one symbol (ops/viterbi_fused.front_tables); the bank is
//            (8, 432) of them, row r = rate RATE_MBPS_ORDER[r]
//   dec      (B, Tp) uint64: bit s of word t = survivor bit of state s at
//            step t -- the Pallas kernel's (8, 128) uint8 planes, byte i
//            bit j = state 8i+j, read little-endian
//   metrics  (B, 64) float32: final path metrics
//   bits     (B, Tp) uint8: decoded bits
//
// What bounds them: each frame is a serial chain of Tp dependent
// add-compare-select steps (110,592 on the 1000-byte mixed-rate batch),
// with only B independent chains. The bytes (LLRs or symbols in,
// decisions out) would take well under 0.1 ms at 3.35 TB/s; the chain's
// latency takes milliseconds. This first design keeps one chain per warp
// and the whole 64-state metric vector in registers, so a step costs a
// handful of shuffles, adds and ballots and touches memory only for its
// inputs and its 8-byte decision word.

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

// One ACS candidate, (m + a*la) + b*lb rounded add by add as the
// reference evaluates it (a, b are +-1, so the products are exact).
__device__ __forceinline__ float cand(float m, float a, float b, float2 l) {
  return __fadd_rn(__fadd_rn(m, a * l.x), b * l.y);
}

// One warp per frame. Lane l holds the metrics of states l and l + 32;
// both have predecessors 2l and 2l + 1 (mod 64), which live in lane
// (2l) & 31 and (2l + 1) & 31 -- in the low half for l < 16, the high
// half otherwise. AcsLane holds a lane's edge coefficients and sources.
struct AcsLane {
  float a0l, b0l, a1l, b1l, a0h, b0h, a1h, b1h;
  int src_e, src_o;
  bool from_lo;

  __device__ explicit AcsLane(int lane)
      : a0l(edge_coeff(lane, 0, kG0)), b0l(edge_coeff(lane, 0, kG1)),
        a1l(edge_coeff(lane, 1, kG0)), b1l(edge_coeff(lane, 1, kG1)),
        a0h(edge_coeff(lane + 32, 0, kG0)), b0h(edge_coeff(lane + 32, 0, kG1)),
        a1h(edge_coeff(lane + 32, 1, kG0)), b1h(edge_coeff(lane + 32, 1, kG1)),
        src_e((2 * lane) & 31), src_o((2 * lane + 1) & 31),
        from_lo(lane < 16) {}
};

// One trellis step on the soft pair `l`: updates the lane's two
// metrics and returns the step's 64-bit decision word (on every lane).
// A decision takes predecessor-low-bit 1 only when strictly larger.
__device__ __forceinline__ unsigned long long acs_step(const AcsLane& c,
                                                       float& m_lo,
                                                       float& m_hi,
                                                       float2 l) {
  const float e_lo = __shfl_sync(kFull, m_lo, c.src_e);
  const float e_hi = __shfl_sync(kFull, m_hi, c.src_e);
  const float o_lo = __shfl_sync(kFull, m_lo, c.src_o);
  const float o_hi = __shfl_sync(kFull, m_hi, c.src_o);
  const float ev = c.from_lo ? e_lo : e_hi;   // metric of pred 2l
  const float od = c.from_lo ? o_lo : o_hi;   // metric of pred 2l+1
  const float c0l = cand(ev, c.a0l, c.b0l, l), c1l = cand(od, c.a1l, c.b1l, l);
  const float c0h = cand(ev, c.a0h, c.b0h, l), c1h = cand(od, c.a1h, c.b1h, l);
  const bool d_lo = c1l > c0l, d_hi = c1h > c0h;
  m_lo = d_lo ? c1l : c0l;
  m_hi = d_hi ? c1h : c0h;
  const unsigned w_lo = __ballot_sync(kFull, d_lo);
  const unsigned w_hi = __ballot_sync(kFull, d_hi);
  return (unsigned long long)w_lo | ((unsigned long long)w_hi << 32);
}

// Subtract the max of all 64 metrics, as the Pallas kernels do once per
// grid block.
__device__ __forceinline__ void renorm(float& m_lo, float& m_hi) {
  float mx = fmaxf(m_lo, m_hi);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  m_lo = __fsub_rn(m_lo, mx);
  m_hi = __fsub_rn(m_hi, mx);
}

__global__ void __launch_bounds__(32)
acs_f32_kernel(const float2* __restrict__ llr,
               unsigned long long* __restrict__ dec,
               float* __restrict__ metrics, int Tp) {
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  const AcsLane c(lane);
  float m_lo = lane == 0 ? 0.0f : kNeg;
  float m_hi = kNeg;
  const float2* x = llr + (size_t)frame * Tp;
  unsigned long long* out = dec + (size_t)frame * Tp;

  for (int t0 = 0; t0 < Tp; t0 += kRenorm) {
#pragma unroll 8
    for (int j = 0; j < kRenorm; ++j) {
      const float2 l = x[t0 + j];               // same address: broadcast
      const unsigned long long w = acs_step(c, m_lo, m_hi, l);
      if (lane == 0) out[t0 + j] = w;
    }
    renorm(m_lo, m_hi);                         // once per 64 steps
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
// takes its pair from lanes 2jj and 2jj + 1 by shuffle, so the LLRs
// never reach memory. Renorm at the end of every `cadence` steps
// (Tp is a multiple of it, it a multiple of kSub).
__device__ __forceinline__ void fused_acs_frame(
    const float* __restrict__ sym, const float* __restrict__ gain,
    const int4* __restrict__ table, int n_dbps, float norm, int nbits,
    int n_sym, int Tp, int cadence, unsigned long long* __restrict__ dec,
    float* __restrict__ metrics) {
  const int lane = threadIdx.x;
  const AcsLane c(lane);
  float m_lo = lane == 0 ? 0.0f : kNeg;
  float m_hi = kNeg;
  for (int t0 = 0; t0 < Tp; t0 += cadence) {
    for (int s0 = t0; s0 < t0 + cadence; s0 += kSub) {
      const float llr =
          lane < 2 * kSub
              ? front_slot(sym, gain, table, n_dbps, norm, nbits, n_sym, s0,
                           lane)
              : 0.0f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float2 l = make_float2(__shfl_sync(kFull, llr, 2 * jj),
                                     __shfl_sync(kFull, llr, 2 * jj + 1));
        const unsigned long long w = acs_step(c, m_lo, m_hi, l);
        if (lane == 0) dec[s0 + jj] = w;
      }
    }
    renorm(m_lo, m_hi);
  }
  metrics[lane] = m_lo;
  metrics[lane + 32] = m_hi;
}

// Replaces _make_mixed_fused_acs_kernel (viterbi_pallas.py:1174), radix 2.
// Mixed-rate batch: frame f runs at rate ridx[f] (warp-uniform, so a
// warp reads only its own row of the bank), over the bucket-maximal
// trellis Tp = n_sym * 216, renormalizing every 72 steps. Bound: the
// frame's serial ACS chain, as acs_f32_kernel; the front's loads and
// ~8 float operations a slot run on lanes 0-23 once per 12 steps.
__global__ void __launch_bounds__(32)
fused_acs_mixed_kernel(const float* __restrict__ sym,
                       const float* __restrict__ gain,
                       const int* __restrict__ nbits,
                       const int* __restrict__ ridx,
                       const int4* __restrict__ bank,
                       const int* __restrict__ ndbps,
                       const float* __restrict__ norms,
                       unsigned long long* __restrict__ dec,
                       float* __restrict__ metrics, int n_sym, int Tp) {
  const int f = blockIdx.x;
  const int r = __ldg(ridx + f);
  fused_acs_frame(sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48,
                  bank + (size_t)r * kBankSlots, __ldg(ndbps + r),
                  __ldg(norms + r), __ldg(nbits + f), n_sym, Tp, kMixedRenorm,
                  dec + (size_t)f * Tp, metrics + (size_t)f * kStates);
}

// Replaces _make_fused_acs_kernel (viterbi_pallas.py:893), radix 2.
// Known-rate batch: every frame at the rate of `table`, Tp = n_sym *
// n_dbps with n_sym a multiple of spb, renormalizing every spb * n_dbps
// steps (`cadence`). Bound: as fused_acs_mixed_kernel.
__global__ void __launch_bounds__(32)
fused_acs_rate_kernel(const float* __restrict__ sym,
                      const float* __restrict__ gain,
                      const int* __restrict__ nbits,
                      const int4* __restrict__ table, int n_dbps, float norm,
                      unsigned long long* __restrict__ dec,
                      float* __restrict__ metrics, int n_sym, int Tp,
                      int cadence) {
  const int f = blockIdx.x;
  fused_acs_frame(sym + (size_t)f * n_sym * 96, gain + (size_t)f * 48, table,
                  n_dbps, norm, __ldg(nbits + f), n_sym, Tp, cadence,
                  dec + (size_t)f * Tp, metrics + (size_t)f * kStates);
}

// One thread per frame: start at the first argmax of the final
// metrics; per step, backward, emit state >> 5, read the survivor bit
// d of the current state and move to ((state & 31) << 1) | d.
__global__ void traceback_kernel(const unsigned long long* __restrict__ dec,
                                 const float* __restrict__ metrics,
                                 uint8_t* __restrict__ bits, int B, int Tp) {
  const int frame = blockIdx.x * blockDim.x + threadIdx.x;
  if (frame >= B) return;
  const float* m = metrics + (size_t)frame * kStates;
  int state = 0;
  float best = m[0];
  for (int s = 1; s < kStates; ++s)
    if (m[s] > best) { best = m[s]; state = s; }
  const unsigned long long* d = dec + (size_t)frame * Tp;
  uint8_t* out = bits + (size_t)frame * Tp;
#pragma unroll 16
  for (int t = Tp - 1; t >= 0; --t) {
    const unsigned long long w = d[t];
    out[t] = (uint8_t)(state >> 5);
    state = ((state & 31) << 1) | (int)((w >> state) & 1ull);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the launch's
// cudaGetLastError() (0 = cudaSuccess); it never synchronizes.
int ziria_acs_f32(const void* llr, void* dec, void* metrics, int B, int Tp,
                  int device, void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % kRenorm) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  acs_f32_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float2*)llr, (unsigned long long*)dec, (float*)metrics, Tp);
  return (int)cudaGetLastError();
}

int ziria_traceback(const void* dec, const void* metrics, void* bits, int B,
                    int Tp, int device, void* stream) {
  if (B <= 0 || Tp <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32;
  traceback_kernel<<<(B + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const unsigned long long*)dec, (const float*)metrics, (uint8_t*)bits,
      B, Tp);
  return (int)cudaGetLastError();
}

// ridx (B,) int32 in [0, 8); bank (8, 432, 4) int32; ndbps (8,) int32;
// norms (8,) float32; Tp = n_sym * 216.
int ziria_fused_acs_mixed(const void* sym, const void* gain, const void* nbits,
                          const void* ridx, const void* bank,
                          const void* ndbps, const void* norms, void* dec,
                          void* metrics, int B, int n_sym, int Tp, int device,
                          void* stream) {
  if (B <= 0 || n_sym <= 0 || Tp != n_sym * 216)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fused_acs_mixed_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int*)ridx, (const int4*)bank, (const int*)ndbps,
      (const float*)norms, (unsigned long long*)dec, (float*)metrics, n_sym,
      Tp);
  return (int)cudaGetLastError();
}

// table (2 * n_dbps, 4) int32, 16-byte aligned; Tp = n_sym * n_dbps, a
// multiple of `cadence`, itself a multiple of 12.
int ziria_fused_acs_rate(const void* sym, const void* gain, const void* nbits,
                         const void* table, void* dec, void* metrics,
                         int n_dbps, float norm, int B, int n_sym, int Tp,
                         int cadence, int device, void* stream) {
  if (B <= 0 || n_sym <= 0 || n_dbps <= 0 || n_dbps % kSub ||
      Tp != n_sym * n_dbps || cadence <= 0 || cadence % kSub ||
      Tp % cadence || ((uintptr_t)table & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fused_acs_rate_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      (const float*)sym, (const float*)gain, (const int*)nbits,
      (const int4*)table, n_dbps, norm, (unsigned long long*)dec,
      (float*)metrics, n_sym, Tp, cadence);
  return (int)cudaGetLastError();
}

}  // extern "C"
