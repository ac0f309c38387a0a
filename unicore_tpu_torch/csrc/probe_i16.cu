// Probes of int16 arithmetic on Hopper, sm_90a: one operation per build.
//
// Replaces the probe kernel of scripts/probe_i16.py (its pallas_call at
// :44, one kernel per operation, each compiled in its own process): there
// the question was which int16 vector operations the TPU's compiler takes;
// here it is whether nvcc builds each int16 operation that the int16 SW
// instance (csrc/sw.cu, DpI16) could use, and whether the card computes
// it as numpy's wrapping int16 arithmetic does.  scripts/torch_probe_i16.py
// builds this file once per operation with -DPROBE_OP=k (k indexes its
// PROBES), launches each build in a process of its own and checks the
// result.
//
// o = op(x, y[, z]) on 16 x 128 int16:
//   0-6  the JAX probe's operations, one thread an element: max, subtract,
//        add, roll by one column (o[r][c] = x[r][c-1 mod 128]), select,
//        the cast from int32, the compare turned into a 0/1 int16 plus x;
//   7-11 the packed int16x2 forms, one thread a pair of elements (element
//        2k in the low half of word k): __vmaxs2, __vadd2, __vsub2, and
//        Hopper's DPX __viaddmax_s16x2 (max(x + y, z)) and __vimax3_s16x2.
//
// What bounds it: nothing worth measuring, 4 KB read per operand and 4 KB
// written; the time reported is that of one launch, about a launch's
// latency.

#include <cuda_runtime.h>

#ifndef PROBE_OP
#error "build with -DPROBE_OP=<index into scripts/torch_probe_i16.py's PROBES>"
#endif

namespace {

constexpr int ROWS = 16, COLS = 128, N = ROWS * COLS;

__global__ void probe_kernel(const short* x, const short* y, const short* z, short* o) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
#if PROBE_OP < 7
  if (t >= N) return;
  const short a = x[t], b = y[t];
  short v;
#if PROBE_OP == 0
  v = a > b ? a : b;
#elif PROBE_OP == 1
  v = (short)(a - b);
#elif PROBE_OP == 2
  v = (short)(a + b);
#elif PROBE_OP == 3
  v = x[(t / COLS) * COLS + (t % COLS + COLS - 1) % COLS];
#elif PROBE_OP == 4
  v = a > 0 ? a : b;
#elif PROBE_OP == 5
  v = (short)((int)a + 1);
#elif PROBE_OP == 6
  v = (short)((a > b ? (short)1 : (short)0) + a);
#else
#error "unknown PROBE_OP"
#endif
  o[t] = v;
#else
  if (t >= N / 2) return;
  const unsigned a = reinterpret_cast<const unsigned*>(x)[t];
  const unsigned b = reinterpret_cast<const unsigned*>(y)[t];
  const unsigned c = reinterpret_cast<const unsigned*>(z)[t];
  unsigned v;
#if PROBE_OP == 7
  v = __vmaxs2(a, b);
#elif PROBE_OP == 8
  v = __vadd2(a, b);
#elif PROBE_OP == 9
  v = __vsub2(a, b);
#elif PROBE_OP == 10
  v = __viaddmax_s16x2(a, b, c);
#elif PROBE_OP == 11
  v = __vimax3_s16x2(a, b, c);
#else
#error "unknown PROBE_OP"
#endif
  (void)c;
  reinterpret_cast<unsigned*>(o)[t] = v;
#endif
}

}  // namespace

// Copy x, y and z (host, N int16 each) to the card, launch once, copy the
// result to o (host), then time `reps` launches with CUDA events into *ms
// (per launch).  Returns the first cudaError_t met (0 = success).
extern "C" int probe_i16_run(const short* x, const short* y, const short* z, short* o,
                             int reps, float* ms) {
  short* d = nullptr;
  cudaError_t e = cudaMalloc(&d, 4 * N * sizeof(short));
  if (e != cudaSuccess) return (int)e;
  short *dx = d, *dy = d + N, *dz = d + 2 * N, *dout = d + 3 * N;
  cudaEvent_t t0 = nullptr, t1 = nullptr;
  const int threads = 128, blocks = (N + threads - 1) / threads;
  do {
    if ((e = cudaMemcpy(dx, x, N * sizeof(short), cudaMemcpyHostToDevice)) != cudaSuccess) break;
    if ((e = cudaMemcpy(dy, y, N * sizeof(short), cudaMemcpyHostToDevice)) != cudaSuccess) break;
    if ((e = cudaMemcpy(dz, z, N * sizeof(short), cudaMemcpyHostToDevice)) != cudaSuccess) break;
    if ((e = cudaMemset(dout, 0, N * sizeof(short))) != cudaSuccess) break;
    probe_kernel<<<blocks, threads>>>(dx, dy, dz, dout);
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    if ((e = cudaDeviceSynchronize()) != cudaSuccess) break;
    if ((e = cudaMemcpy(o, dout, N * sizeof(short), cudaMemcpyDeviceToHost)) != cudaSuccess) break;
    if ((e = cudaEventCreate(&t0)) != cudaSuccess) break;
    if ((e = cudaEventCreate(&t1)) != cudaSuccess) break;
    cudaEventRecord(t0);
    for (int r = 0; r < reps; ++r) probe_kernel<<<blocks, threads>>>(dx, dy, dz, dout);
    cudaEventRecord(t1);
    if ((e = cudaEventSynchronize(t1)) != cudaSuccess) break;
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    float total = 0.f;
    if ((e = cudaEventElapsedTime(&total, t0, t1)) != cudaSuccess) break;
    *ms = reps > 0 ? total / reps : 0.f;
  } while (false);
  if (t0) cudaEventDestroy(t0);
  if (t1) cudaEventDestroy(t1);
  cudaFree(d);
  return (int)e;
}
