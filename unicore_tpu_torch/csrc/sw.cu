// Smith-Waterman forward pass (gapped and ungapped) for Hopper, sm_90a.
//
// Replaces the TPU kernel unicore_tpu/ops/sw.py::_sw_kernel (launched by
// sw_forward_pallas).  For each (query, target) pair it returns the best
// local-alignment score and its end cell (best, qend, tend), with ties
// resolved row-major (lowest row, then lowest column), bit-identical to
// the plain versions in unicore_tpu_torch/ops/sw.py.
//
// What bounds it on this card: operations, not bytes.  A pair reads
// (2*Lq + 2*Lt) codes and writes 12 bytes, but its DP does about 14 scalar
// operations on each of its Lq*Lt cells (6 for the ungapped mode), so the
// floor is the card's scalar instruction rate.  What holds this simple design
// below that floor is latency: the recurrence is serial along the query
// rows, and within a row the windowed prefix max (query-gap E) is a
// log-step scan across the columns, each step a round trip through shared
// memory and a block barrier.
//
// What the design does about it:
//   * one thread block per pair (blocks run in any order, nothing carries
//     over between them); enough pairs per launch (16-512) keep several
//     blocks resident on each of the 132 SMs, so one block's barrier
//     stalls are hidden by another's work;
//   * threads across the target columns, strided (column j = c*T + tid,
//     c < C), so every shared-memory access of the scan and of the
//     diagonal hand-over is free of bank conflicts; the query rows are a
//     loop inside the block;
//   * scores are built in-kernel from the codes and the two 21x21
//     matrices held in shared memory (pre-multiplied by their weights):
//     no (B, Lq, Lt) score tensor is ever written to device memory;
//   * DP state (H, F, per-column best and its row) lives in registers;
//     query rows beyond qlen are skipped, target columns beyond tlen
//     score NEG exactly as in the plain version;
//   * the ungapped mode (a compile-time flag) has no scan: one barrier
//     per row, with the previous row's H double-buffered by row parity.
//
// Arithmetic: float32 in the plain version's operation order, compiled
// with -fmad=false so no multiply-add is contracted, which keeps every
// result bit-identical to it (and to unicore_tpu's sw_forward_xla) for
// any inputs.  The windowed prefix max repeats the JAX log steps
// d = 1, 2, 4, ... < scan_limit, so E looks back across the smallest
// power of two >= gap_window (the whole row when gap_window is 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NA = 21;
constexpr float NEG = -1e9f;
constexpr int MAX_THREADS = 256;
constexpr int MAX_C = 16;  // columns per thread: Lt <= MAX_THREADS * MAX_C

struct Args {
  const int* qa;
  const int* qs;
  const int* ta;
  const int* ts;
  const int* qlen;
  const int* tlen;
  const int* qc;  // (B, Lq) per-query-row score correction, or null
  const float* saa;  // (21, 21)
  const float* s3d;  // (21, 21)
  float go, ge, w_aa, w_3di;
  int B, Lq, Lt, scan_limit;
  float* best;
  int* qend;
  int* tend;
};

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  return v;
}

__device__ __forceinline__ int block_min(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = min(v, red[w]);
  return v;
}

template <int C, bool UNGAPPED, bool BIAS>
__global__ void __launch_bounds__(MAX_THREADS) sw_forward_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float red_f[MAX_THREADS / 32];
  __shared__ int red_i[MAX_THREADS / 32];

  const int T = blockDim.x;
  const int W = T * C;  // columns held by the block, >= Lt
  float* mat_aa = smem;               // w_aa * saa
  float* mat_3d = mat_aa + NA * NA;   // w_3di * s3d
  float* hbuf = mat_3d + NA * NA;     // 2 x W: previous row's H, by row parity
  float* sbuf = hbuf + 2 * W;         // 2 x W: ping-pong buffers of the row scan

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int Lq = a.Lq, Lt = a.Lt;
  const int ql = min(a.qlen[b], Lq);
  const int tl = min(a.tlen[b], Lt);
  const float go = a.go, ge = a.ge;

  for (int k = tid; k < NA * NA; k += T) {
    mat_aa[k] = a.w_aa * a.saa[k];
    mat_3d[k] = a.w_3di * a.s3d[k];
  }
  for (int k = tid; k < 2 * W; k += T) hbuf[k] = 0.f;

  int ca[C], cs[C], br[C];
  float h[C], f[C], bb[C], jge[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * T + tid;
    const bool valid = j < tl;
    ca[c] = valid ? a.ta[(size_t)b * Lt + j] : -1;  // -1 marks a masked column
    cs[c] = valid ? a.ts[(size_t)b * Lt + j] : 0;
    h[c] = 0.f;
    f[c] = NEG;
    bb[c] = 0.f;
    br[c] = 0;
    jge[c] = (float)j * ge;
  }
  __syncthreads();

  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;

  for (int i = 0; i < ql; ++i) {
    const float* hprev = hbuf + ((i + 1) & 1) * W;
    float* hcur = hbuf + (i & 1) * W;
    const float* ra = mat_aa + __ldg(qa_b + i) * NA;
    const float* rs = mat_3d + __ldg(qs_b + i) * NA;
    const double qci = BIAS ? (double)__ldg(qc_b + i) : 0.0;
    float h0[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      float s = NEG;
      if (ca[c] >= 0) {
        s = ra[ca[c]] + rs[cs[c]];
        if (BIAS) s = (float)((double)s + qci);
      }
      const float diag = (j == 0) ? 0.f : hprev[j - 1];
      if (UNGAPPED) {
        const float H = fmaxf(0.f, diag + s);
        h[c] = H;
        if (j < Lt && H > bb[c]) { bb[c] = H; br[c] = i; }
        hcur[j] = H;
      } else {
        const float Fv = fmaxf(h[c] - go, f[c] - ge);
        f[c] = Fv;
        const float H0 = fmaxf(0.f, fmaxf(diag + s, Fv));
        h0[c] = H0;
        sbuf[j] = H0 + jge[c];
      }
    }
    __syncthreads();
    if (UNGAPPED) continue;

    // windowed inclusive prefix max of H0[k] + k*ge, log steps as in JAX
    float* src = sbuf;
    float* dst = sbuf + W;
    for (int d = 1; d < a.scan_limit; d <<= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = c * T + tid;
        float v = src[j];
        if (j >= d) v = fmaxf(v, src[j - d]);
        dst[j] = v;
      }
      __syncthreads();
      float* tmp = src; src = dst; dst = tmp;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      const float pexc = (j == 0) ? NEG : src[j - 1];
      const float E = pexc - go + ge - jge[c];
      const float H = fmaxf(h0[c], E);
      h[c] = H;
      if (j < Lt && H > bb[c]) { bb[c] = H; br[c] = i; }
      hcur[j] = H;
    }
    __syncthreads();
  }

  // best over the per-column bests, then the lowest (row * Lt + col)
  // among the cells holding it: row-major ties, as in the plain version
  float m = NEG;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c * T + tid < Lt) m = fmaxf(m, bb[c]);
  m = block_max(m, red_f);
  int key = 0x7fffffff;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * T + tid;
    if (j < Lt && bb[c] >= m) key = min(key, br[c] * Lt + j);
  }
  key = block_min(key, red_i);
  if (tid == 0) {
    a.best[b] = m;
    a.qend[b] = key / Lt;
    a.tend[b] = key % Lt;
  }
}

template <int C, bool UNGAPPED, bool BIAS>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t smem = (2 * NA * NA + 4 * (size_t)threads * C) * sizeof(float);
  auto kernel = sw_forward_kernel<C, UNGAPPED, BIAS>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.B, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(const Args& a, int threads, bool ungapped, cudaStream_t stream) {
  const bool bias = a.qc != nullptr;
  if (ungapped)
    return bias ? launch<C, true, true>(a, threads, stream)
                : launch<C, true, false>(a, threads, stream);
  return bias ? launch<C, false, true>(a, threads, stream)
              : launch<C, false, false>(a, threads, stream);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int sw_forward_launch(
    const int* qa, const int* qs, const int* ta, const int* ts,
    const int* qlen, const int* tlen, const int* qc,
    const float* saa, const float* s3d,
    float go, float ge, float w_aa, float w_3di,
    int B, int Lq, int Lt, int scan_limit, int ungapped,
    float* best, int* qend, int* tend, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lq <= 0 || Lt <= 0 || Lt > MAX_THREADS * MAX_C) return (int)cudaErrorInvalidValue;
  const int threads = Lt >= MAX_THREADS ? MAX_THREADS : ((Lt + 31) / 32) * 32;
  const int need = (Lt + threads - 1) / threads;
  int C = 1;
  while (C < need) C <<= 1;
  Args a{qa, qs, ta, ts, qlen, tlen, qc, saa, s3d, go, ge, w_aa, w_3di,
         B, Lq, Lt, scan_limit, best, qend, tend};
  cudaStream_t st = (cudaStream_t)stream;
  const bool ug = ungapped != 0;
  cudaError_t e;
  switch (C) {
    case 1: e = launch_c<1>(a, threads, ug, st); break;
    case 2: e = launch_c<2>(a, threads, ug, st); break;
    case 4: e = launch_c<4>(a, threads, ug, st); break;
    case 8: e = launch_c<8>(a, threads, ug, st); break;
    case 16: e = launch_c<16>(a, threads, ug, st); break;
    default: e = cudaErrorInvalidValue;
  }
  return (int)e;
}

// Largest target width the kernel takes.
extern "C" int sw_forward_max_lt() { return MAX_THREADS * MAX_C; }
