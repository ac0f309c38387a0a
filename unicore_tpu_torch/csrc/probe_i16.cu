// Probes of int16 arithmetic on Hopper, sm_90a: one operation per build.
//
// Replaces the probe kernel of scripts/probe_i16.py (its pallas_call at
// :44, one kernel per operation, each compiled in its own process): there
// the question was which int16 vector operations the TPU's compiler takes;
// here it is whether nvcc builds each int16 operation that the int16 SW
// instance (csrc/sw.cu, sw_i16_kernel) uses, and whether the card computes
// it as numpy's wrapping int16 arithmetic does.  scripts/torch_probe_i16.py
// builds this file once per operation with -DPROBE_OP=k (k indexes its
// PROBES), launches each build in a process of its own and checks the
// result.
//
// o = op(x, y[, z]) on 16 x 128 int16:
//   0-6  the JAX probe's operations, one thread an element: max, subtract,
//        add, roll by one column (o[r][c] = x[r][c-1 mod 128]), select,
//        the cast from int32, the compare turned into a 0/1 int16 plus x;
//   7-19 the packed int16x2 forms, one thread a pair of elements (element
//        2k in the low half of word k): __vmaxs2, __vadd2, __vsub2, and
//        Hopper's DPX __viaddmax_s16x2 (max(x + y, z)) and __vimax3_s16x2;
//        then the forms sw_i16_kernel adds: __viaddmax_s16x2_relu
//        (max(x + y, z, 0)), __vmins2, __viaddmax_s16x2 with z = -32768
//        (its wrapping add), __byte_perm with its four selectors (the
//        seam's rotation, a hi half into the lo half, two lo halves packed,
//        the halves swapped), and __viaddmin_s16x2_relu (max(min(x + y,
//        z), 0)).
//
// What bounds it: nothing worth measuring, 4 KB read per operand and 4 KB
// written; the time reported is that of one launch, about a launch's
// latency.  probe_i16_rate measures instead how many of a packed form's
// instructions an SM issues a cycle (rate_kernel): no published table gives
// the DPX forms' rate, and chip_smoke.py's int16 bound counts instructions
// at the rate measured here.

#include <cuda_runtime.h>

#ifndef PROBE_OP
#error "build with -DPROBE_OP=<index into scripts/torch_probe_i16.py's PROBES>"
#endif

namespace {

constexpr int ROWS = 16, COLS = 128, N = ROWS * COLS;

#if PROBE_OP >= 7
// the packed probe's operation on words a, b, c
__device__ __forceinline__ unsigned packed_op(unsigned a, unsigned b, unsigned c) {
  (void)c;
#if PROBE_OP == 7
  return __vmaxs2(a, b);
#elif PROBE_OP == 8
  return __vadd2(a, b);
#elif PROBE_OP == 9
  return __vsub2(a, b);
#elif PROBE_OP == 10
  return __viaddmax_s16x2(a, b, c);
#elif PROBE_OP == 11
  return __vimax3_s16x2(a, b, c);
#elif PROBE_OP == 12
  return __viaddmax_s16x2_relu(a, b, c);
#elif PROBE_OP == 13
  return __vmins2(a, b);
#elif PROBE_OP == 14
  return __viaddmax_s16x2(a, b, 0x80008000u);
#elif PROBE_OP == 15
  return __byte_perm(a, b, 0x1054u);
#elif PROBE_OP == 16
  return __byte_perm(a, b, 0x7632u);
#elif PROBE_OP == 17
  return __byte_perm(a, b, 0x5410u);
#elif PROBE_OP == 18
  return __byte_perm(a, b, 0x1032u);
#elif PROBE_OP == 19
  return __viaddmin_s16x2_relu(a, b, c);
#else
#error "unknown PROBE_OP"
#endif
}

// The packed operation's issue rate: each of a block's threads runs CHAINS
// chains of the operation ITERS times (word i takes op(acc[i], acc[i+1],
// c), so no chain folds and seven of eight are independent in a step),
// then stores one word; thread 0 counts the block's cycles (clock64).  One
// block of 1,024 threads an SM (RATE_SMEM of shared memory keeps a second
// off it): warp-instructions an SM a cycle = 32 * ITERS * CHAINS / cycles.
constexpr int CHAINS = 8, ITERS = 4096;
constexpr int RATE_SMEM = 120 * 1024;

__global__ void rate_kernel(const unsigned* x, unsigned* o, long long* cycles) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc[i] = x[(t * CHAINS + i) % (N / 2)];
  const unsigned c = x[t % (N / 2)] ^ 0x00ff00ffu;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 4
  for (int k = 0; k < ITERS; ++k) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) acc[i] = packed_op(acc[i], acc[(i + 1) % CHAINS], c);
  }
  __syncthreads();
  const long long t1 = clock64();
  unsigned v = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) v ^= acc[i];
  o[t] = v;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
#endif

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
  reinterpret_cast<unsigned*>(o)[t] = packed_op(a, b, c);
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

// The packed probe's issue rate (rate_kernel, one block of 1,024 threads on
// each SM): *rate gets the warp-instructions an SM issues a cycle, from the
// slowest block's cycles (-1 for the JAX probe's operations, which are not
// packed).  Returns the first cudaError_t met (0 = success).
extern "C" int probe_i16_rate(const short* x, float* rate) {
#if PROBE_OP < 7
  (void)x;
  *rate = -1.f;
  return 0;
#else
  int sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(rate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RATE_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int threads = 1024, words = sms * threads;
  unsigned* d = nullptr;
  e = cudaMalloc(&d, (N / 2 + words) * sizeof(unsigned) + sms * sizeof(long long));
  if (e != cudaSuccess) return (int)e;
  unsigned *dx = d, *dout = d + N / 2;
  long long* dcyc = reinterpret_cast<long long*>(dout + words);
  long long* cyc = new long long[sms];
  do {
    if ((e = cudaMemcpy(dx, x, N * sizeof(short), cudaMemcpyHostToDevice)) != cudaSuccess) break;
    for (int rep = 0; rep < 2; ++rep) rate_kernel<<<sms, threads, RATE_SMEM>>>(dx, dout, dcyc);  // the first warms up
    if ((e = cudaGetLastError()) != cudaSuccess) break;
    if ((e = cudaMemcpy(cyc, dcyc, sms * sizeof(long long), cudaMemcpyDeviceToHost)) != cudaSuccess) break;
    long long most = 1;
    for (int i = 0; i < sms; ++i) most = cyc[i] > most ? cyc[i] : most;
    *rate = (float)((double)(threads / 32) * ITERS * CHAINS / (double)most);
  } while (false);
  delete[] cyc;
  cudaFree(d);
  return (int)e;
#endif
}
