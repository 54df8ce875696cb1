// K=7 soft-decision Viterbi decoder kernels for Hopper (sm_90a).
//
// Two kernels, bound from Python with ctypes (plain C entry points at
// the bottom; ziria_tpu_torch/ops/viterbi_cuda.py is the wrapper):
//
//   acs_f32_kernel   replaces _acs_kernel        (ziria_tpu/ops/viterbi_pallas.py:332)
//   traceback_kernel replaces _make_traceback_kernel(UNROLL) (viterbi_pallas.py:517)
//
// Layouts (B frames, Tp trellis steps, Tp a multiple of 64):
//   llr      (B, Tp, 2) float32: the (A, B) soft pair of each step
//   dec      (B, Tp) uint64: bit s of word t = survivor bit of state s at
//            step t -- the Pallas kernel's (8, 128) uint8 planes, byte i
//            bit j = state 8i+j, read little-endian
//   metrics  (B, 64) float32: final path metrics
//   bits     (B, Tp) uint8: decoded bits
//
// What bounds them: each frame is a serial chain of Tp dependent
// add-compare-select steps (110,592 on the 1000-byte mixed-rate batch),
// with only B independent chains. The bytes (LLRs in, decisions out)
// would take well under 0.1 ms at 3.35 TB/s; the chain's latency takes
// milliseconds. This first design keeps one chain per warp and the whole
// 64-state metric vector in registers, so a step costs a handful of
// shuffles, adds and ballots and touches memory only for its 8-byte LLR
// pair and its 8-byte decision word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kRenorm = 64;          // steps between renorms (Pallas UNROLL)
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
// half otherwise.
__global__ void __launch_bounds__(32)
acs_f32_kernel(const float2* __restrict__ llr,
               unsigned long long* __restrict__ dec,
               float* __restrict__ metrics, int Tp) {
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  const int lo = lane, hi = lane + 32;
  const float a0l = edge_coeff(lo, 0, kG0), b0l = edge_coeff(lo, 0, kG1);
  const float a1l = edge_coeff(lo, 1, kG0), b1l = edge_coeff(lo, 1, kG1);
  const float a0h = edge_coeff(hi, 0, kG0), b0h = edge_coeff(hi, 0, kG1);
  const float a1h = edge_coeff(hi, 1, kG0), b1h = edge_coeff(hi, 1, kG1);
  const int src_e = (2 * lane) & 31, src_o = (2 * lane + 1) & 31;
  const bool from_lo = lane < 16;

  float m_lo = lane == 0 ? 0.0f : kNeg;
  float m_hi = kNeg;
  const float2* x = llr + (size_t)frame * Tp;
  unsigned long long* out = dec + (size_t)frame * Tp;

  for (int t0 = 0; t0 < Tp; t0 += kRenorm) {
#pragma unroll 8
    for (int j = 0; j < kRenorm; ++j) {
      const float2 l = x[t0 + j];               // same address: broadcast
      const float e_lo = __shfl_sync(kFull, m_lo, src_e);
      const float e_hi = __shfl_sync(kFull, m_hi, src_e);
      const float o_lo = __shfl_sync(kFull, m_lo, src_o);
      const float o_hi = __shfl_sync(kFull, m_hi, src_o);
      const float ev = from_lo ? e_lo : e_hi;   // metric of pred 2l
      const float od = from_lo ? o_lo : o_hi;   // metric of pred 2l+1
      const float c0l = cand(ev, a0l, b0l, l), c1l = cand(od, a1l, b1l, l);
      const float c0h = cand(ev, a0h, b0h, l), c1h = cand(od, a1h, b1h, l);
      const bool d_lo = c1l > c0l, d_hi = c1h > c0h;
      m_lo = d_lo ? c1l : c0l;
      m_hi = d_hi ? c1h : c0h;
      const unsigned w_lo = __ballot_sync(kFull, d_lo);
      const unsigned w_hi = __ballot_sync(kFull, d_hi);
      if (lane == 0)
        out[t0 + j] = (unsigned long long)w_lo |
                      ((unsigned long long)w_hi << 32);
    }
    // renorm once per 64 steps, as the Pallas kernel does per block
    float mx = fmaxf(m_lo, m_hi);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    m_lo = __fsub_rn(m_lo, mx);
    m_hi = __fsub_rn(m_hi, mx);
  }
  metrics[(size_t)frame * kStates + lo] = m_lo;
  metrics[(size_t)frame * kStates + hi] = m_hi;
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

}  // extern "C"
