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
// operations on each of its Lq*Lt cells (6 for the ungapped mode).  The
// recurrence is serial along the query rows, and in the gapped mode each
// row also needs a windowed prefix max across the columns (the query-gap
// E), so what keeps a kernel from that floor is the latency of each row:
// barriers, shared-memory round trips and dependent loads.
//
// What the design does about it:
//   * a warp per pair up to Lt = 32*C columns, G = ceil(Lt / (32*C)) warps
//     above that (C = columns per lane, 4, 8 or 16 by Lt and mode, see
//     dispatch); one block per pair, so the pair's row count is uniform in
//     its block and every shuffle runs without a divergence check; a pair that
//     reaches its last row leaves, and another takes its SM's place;
//   * lane t owns the contiguous columns [t*C, t*C + C) of its warp and
//     keeps H, F, the per-column best and its row in registers; the
//     diagonal H[i-1][j-1] is a register, or one __shfl_up_sync from lane
//     t-1 for the lane's first column;
//   * the windowed prefix max runs in registers and shuffles.  A window of
//     m = S/C lanes, 2 <= m <= 16 (every C at the engine's window of 64),
//     takes a serial prefix and suffix in the lane, a windowed max of the
//     lane totals across lanes, and the suffix of lane t - m fetched by
//     one shuffle per column (van Herk/Gil-Werman in lanes).  Any other
//     span takes the plain version's log steps d = 1, 2, 4, ... < S,
//     inside the lane and then by whole lanes.  Max is exact, so any cover
//     of the plain version's window gives the same bits;
//   * a pair of G > 1 warps syncs only its own warps, once per row, with a
//     named barrier: before it each warp publishes its total, its suffix
//     maxima where a later warp's window reaches them, and what the next
//     warp needs to recompute the H at its left edge (the next row's
//     diagonal), in a buffer double-buffered by row parity; the ungapped
//     mode publishes only its last column's H;
//   * query row data runs ahead of the DP: a row's codes and bias are
//     loaded two rows ahead, and its scores are built one row ahead, from
//     the codes and the two 21x21 matrices held in shared memory
//     (pre-multiplied by their weights), each a gather at a per-column
//     byte offset plus the row's; so no global load and no gather waits
//     between two rows, and the next row's score work fills the current
//     row's scan latency.
//
// Arithmetic: float32 in the plain version's operation order, compiled
// with -fmad=false so no multiply-add is contracted, which keeps every
// result bit-identical to it (and to unicore_tpu's sw_forward_xla) for
// any inputs.  The E window is the plain version's: columns
// [j - span + 1, j] of H0 + j*ge, span = the smallest power of two
// >= scan_limit (scan_limit = Lt when gap_window is 0, which covers the
// whole row), NEG before column 0.  The bias add (float)((double)s + q)
// is done as s + (float)q when |q| <= 2^24: q is then exact in float32,
// and rounding the exact sum to float64 (53 bits >= 2*24 + 1) and then to
// float32 gives the float32 sum rounded once (Figueroa, "When is double
// rounding innocuous?", 1995); larger |q| keep the float64 add.
//
// Rows past qlen score NEG.  The ungapped mode skips them: there
// H = max(0, H_diag + NEG) never exceeds an earlier H.  The gapped mode
// skips them where that is exact too (exact_dp): both weighted matrices
// hold integers, go and ge are integers >= 0, and
// qlen * (max|aa| + max|3di| + max|qc|) + Lt*ge + go + ge < 2^24, so every
// value on the non-negative side of the DP is an exact integer and no
// rounding can lift an F or E above the H it comes from.  Elsewhere it
// runs all Lq rows, as the plain version does.  Columns in [tlen, Lt)
// score NEG but carry E and F, as in the plain version.
//
// The int16 instance (sw_forward_i16_launch; the DpI16 policy below)
// replaces the same kernel's dp_dtype="i16" mode, and is bit-identical to
// unicore_tpu_torch/ops/sw.py::sw_forward_i16 on build_scores_i16's
// scores.  It is the same kernel on another number type: H, F, E and the
// per-column best are int16 values held sign-extended in 32-bit
// registers, every add and subtract is truncated to int16 (JAX's int16
// ops wrap), F starts at and the E window's outside is -20000, and the
// gapped mode caps H at 30000.  A cell's score is gathered from two
// (22, 22) float32 tables each block builds as ops/sw.py::i16_tables does
// (the matrix with a pad row and column of -pad_v, times its weight in
// float32, rounded to bfloat16), plus the bias rounded to bfloat16; the
// float32 sum is rounded to bfloat16 and converted to int16 toward zero,
// saturating, as XLA converts.  Columns past tlen take the pad code, and
// so do rows past qlen, which are skipped where go >= 0 and ge >= 0 and
// always in the ungapped mode: there every H of such a row is at most a
// value of an earlier row at or left of its column (F and E lose go or
// ge, a diagonal loses the pad sentinel, and no value wraps, H being in
// [0, 30000] gapped and t <= 30000 + Lt*ge), so it cannot reach the best
// before an earlier cell does.  The window's outside enters exactly
// where the plain version's log steps bring it in: E[j] reads
// max(window, -20000) for j < S.  What bounds it: the wrapper's contract
// (ops/sw.py::i16_contract: Lt*ge + 30150 < 32767, Lq < 32768, integer
// gaps and weights) and Lt <= MAX_LT; on the card, operations again:
// the function needs 17 a gapped cell (8 ungapped), the float32 count
// plus the score's bfloat16 rounding and conversion and the cap, which
// packed int16x2 ops would issue at the FP32 lanes' rate; this instance
// issues about 24 (11), a sign-extending wrap after each int16 add and
// subtract among them, on the INT32 lanes at half that rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NA = 21;
constexpr float NEG = -1e9f;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 16;
constexpr int MAX_PAIR_WARPS = 8;  // Lt <= MAX_PAIR_WARPS * WARP * MAX_C
constexpr int MAX_LT = MAX_PAIR_WARPS * WARP * MAX_C;
constexpr int PAD = NA;           // int16 instance: code past a pair's length
constexpr int NEG_I16 = -20000;   // int16 instance: F's start, the window's outside
constexpr int H_CAP = 30000;      // int16 instance: the gapped mode's cap on H

// The DP's number type and operations.  DpF32: the plain version's
// float32.  DpI16: int16 values held sign-extended in an int, each add and
// subtract truncated to int16.  none() lies below every value of the DP:
// the max of an empty window.
struct DpF32 {
  using T = float;
  static constexpr bool INT16 = false;
  __device__ static T none() { return NEG; }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T sub(T a, T b) { return a - b; }
  __device__ static T mx(T a, T b) { return fmaxf(a, b); }
};
struct DpI16 {
  using T = int;
  static constexpr bool INT16 = true;
  __device__ static T none() { return -32769; }
  __device__ static T add(T a, T b) { return (int)(short)(a + b); }
  __device__ static T sub(T a, T b) { return (int)(short)(a - b); }
  __device__ static T mx(T a, T b) { return max(a, b); }
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// float32 -> int16 toward zero, saturating (XLA's convert)
__device__ __forceinline__ int to_i16(float x) {
  return min(max(__float2int_rz(x), -32768), 32767);
}

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
  int B, Lq, Lt;
  int S;  // E window span: a power of two; >= Lt covers the whole row
  int G;  // warps per pair
  float* best;
  int* qend;
  int* tend;
  int pad_v;  // int16 instance: the pad row and column's -value (ops/sw.py::i16_pad_value)
};

__device__ __forceinline__ void pair_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

template <class D>
__device__ __forceinline__ typename D::T warp_max(typename D::T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = D::mx(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Layout of one warp's record in a pair's row buffer (gapped mode).
constexpr int R_TOT = 0;   // max over the warp's H0 + j*ge
constexpr int R_H0 = 1;    // H0 of the warp's last column
constexpr int R_PW = 2;    // in-warp windowed prefix at its second-last column
constexpr int R_SUF = 3;   // suffix maxima, [c * 32 + lane]

// Max of H0 + j*ge over columns [max(0, k), e_v) where e_v = v * W, the
// part of a window that lies in warps before v (k < e_v); `pref` is the
// max of the totals of warps 0 .. v-1.
template <class D, int C>
__device__ __forceinline__ typename D::T incoming(const typename D::T* rp, int rec, int k, int v,
                                                  typename D::T pref) {
  constexpr int W = WARP * C;
  if (k <= 0) return pref;
  const int v2 = k / W, off = k - v2 * W;
  typename D::T x = rp[v2 * rec + R_SUF + (off % C) * WARP + off / C];
  for (int u = v2 + 1; u < v; ++u) x = D::mx(x, rp[u * rec + R_TOT]);
  return x;
}

// One log step of the windowed max inside the lane: P[c] = max(P[c], P[c-S]),
// the columns left of the lane from lane - 1 (none() left of the warp).
template <class D, int C, int S>
__device__ __forceinline__ void lane_step(typename D::T (&P)[C], int lane) {
  typename D::T from[S];
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const typename D::T v = __shfl_up_sync(FULL, P[C - S + c], 1);
    from[c] = lane == 0 ? D::none() : v;
  }
#pragma unroll
  for (int c = C - 1; c >= S; --c) P[c] = D::mx(P[c], P[c - S]);
#pragma unroll
  for (int c = 0; c < S; ++c) P[c] = D::mx(P[c], from[c]);
}

// One block per pair, G = blockDim.x / 32 warps (MULTI: G > 1).  LANES:
// the gap window spans 2 to 16 lanes (C < S < 32*C, every C at the
// engine's window of 64), taken van Herk/Gil-Werman style; any other span
// takes the plain version's log steps.  D: DpF32 or DpI16.
template <class D, int C, bool UNGAPPED, bool BIAS, bool MULTI, bool LANES>
__global__ void __launch_bounds__(MAX_PAIR_WARPS * WARP) sw_forward_kernel(Args a) {
  using T = typename D::T;
  constexpr bool I16 = D::INT16;
  constexpr int NT = I16 ? NA + 1 : NA;  // the matrices' rows (int16: a pad row)
  constexpr int W = WARP * C;  // columns of one warp
  extern __shared__ float smem[];
  __shared__ T red_f[MAX_PAIR_WARPS];
  __shared__ unsigned long long red_k[MAX_PAIR_WARPS];

  const int S = a.S, Lq = a.Lq, Lt = a.Lt;
  const int G = MULTI ? a.G : 1;
  const T go = (T)a.go, ge = (T)a.ge;
  const int lane = threadIdx.x & (WARP - 1);
  const int w = MULTI ? (int)(threadIdx.x / WARP) : 0;
  const int b = blockIdx.x;
  const int rec = UNGAPPED ? 1 : R_SUF + W;
  float* mat_aa = smem;               // w_aa * saa
  float* mat_3d = mat_aa + NT * NT;   // w_3di * s3d
  T* xbuf = reinterpret_cast<T*>(mat_3d + NT * NT);  // [parity][warp] records (MULTI)

  for (int k = threadIdx.x; k < NT * NT; k += blockDim.x) {
    if constexpr (I16) {  // a pad row and column, weighted and rounded to bfloat16
      const int r = k / NT, c = k % NT;
      const bool pad = r == PAD || c == PAD;
      mat_aa[k] = bf16_round((pad ? -(float)a.pad_v : a.saa[r * NA + c]) * a.w_aa);
      mat_3d[k] = bf16_round((pad ? -(float)a.pad_v : a.s3d[r * NA + c]) * a.w_3di);
    } else {
      mat_aa[k] = a.w_aa * a.saa[k];
      mat_3d[k] = a.w_3di * a.s3d[k];
    }
  }
  __syncthreads();

  const int ql = max(0, min(a.qlen[b], Lq));
  const int tl = min(a.tlen[b], Lt);
  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;

  // exact_dp (gapped): every value on the non-negative side of the DP is
  // an exact integer below 2^24 (see the note at the top), so rows past
  // qlen can be skipped.  The int16 instance skips them where its note
  // says.
  int nrows = Lq;
  if constexpr (I16) {
    nrows = UNGAPPED || (go >= 0 && ge >= 0) ? ql : Lq;
  } else {
    bool integral = true;
    float amax = 0.f, smax = 0.f;
    for (int k = lane; k < NA * NA; k += WARP) {
      const float x = mat_aa[k], y = mat_3d[k];
      integral = integral && x == rintf(x) && y == rintf(y);
      amax = fmaxf(amax, fabsf(x));
      smax = fmaxf(smax, fabsf(y));
    }
    double qmax = 0.0;
    if (BIAS)
      for (int r = lane; r < ql; r += WARP) qmax = fmax(qmax, fabs((double)qc_b[r]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
      smax = fmaxf(smax, __shfl_xor_sync(FULL, smax, o));
      qmax = fmax(qmax, __shfl_xor_sync(FULL, qmax, o));
    }
    integral = __all_sync(FULL, integral);
    const bool exact_dp = integral && go >= 0.f && ge >= 0.f && go == rintf(go) && ge == rintf(ge)
                          && (double)ql * ((double)amax + (double)smax + qmax) + (double)Lt * ge
                             + (double)go + (double)ge < 16777216.0;
    // the ungapped mode skips rows past qlen always (see the note at the top)
    nrows = UNGAPPED || exact_dp ? ql : Lq;
  }

  const int e_w = w * W;          // the warp's first column
  const int j0 = e_w + lane * C;  // the lane's first column
  const int vlim = tl - j0;       // columns c < vlim of the lane are < tlen
  // byte offsets of each column's entries in the two matrices: a gather is
  // this plus the row's offset (masked columns hold code 0, int16: PAD)
  constexpr int MASKED = I16 ? PAD : 0;
  int oa[C], os[C], br[C];
  T h[C], f[C], bb[C], jge[C];
  T eoff[C];  // int16: jge + (go - ge), E = Pexc - eoff
  const T gmg = I16 ? D::sub(go, ge) : T(0);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const bool valid = j < tl;
    oa[c] = (valid ? a.ta[(size_t)b * Lt + j] : MASKED) * 4;
    os[c] = (valid ? a.ts[(size_t)b * Lt + j] : MASKED) * 4 + NT * NT * 4;
    h[c] = T(0);
    f[c] = I16 ? T(NEG_I16) : T(NEG);
    bb[c] = T(0);
    br[c] = 0;
    if constexpr (I16) {
      jge[c] = (int)(short)(j * (int)ge);
      eoff[c] = D::add(jge[c], gmg);
    } else {
      jge[c] = (float)j * ge;
    }
  }
  T jge_edge;  // int16: the eoff of column e_w - 1
  if constexpr (I16)
    jge_edge = D::add((int)(short)((e_w - 1) * (int)ge), gmg);
  else
    jge_edge = (float)(e_w - 1) * ge;
  T edge_h = T(0);  // H[i-1][e_w - 1]; 0 for the first row and column
  const char* sbase = reinterpret_cast<const char*>(smem);

  // Scores of row r: a gather at each column's byte offset plus the
  // row's (every gather is in bounds, so the loads issue together), the
  // bias in float32, NEG past tlen and past qlen (a select).  fix_big
  // redoes a row whose |q| > 2^24 with the float64 add.  int16: the pad
  // codes mask, and the sum goes through bfloat16 to int16.
  auto score = [&](int r, int ca_, int cs_, int q_, T (&out)[C]) {
    const int ra = ca_ * (NT * 4), rs = cs_ * (NT * 4);
    if constexpr (I16) {
      const float qb = BIAS ? bf16_round((float)q_) : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float x = *reinterpret_cast<const float*>(sbase + oa[c] + ra)
                  + *reinterpret_cast<const float*>(sbase + os[c] + rs);
        if (BIAS) x = x + qb;
        out[c] = to_i16(bf16_round(x));
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        out[c] = *reinterpret_cast<const float*>(sbase + oa[c] + ra)
                 + *reinterpret_cast<const float*>(sbase + os[c] + rs);
      if (BIAS) {
        const float qf = (float)q_;
#pragma unroll
        for (int c = 0; c < C; ++c) out[c] = out[c] + qf;
      }
      const int vl = r < ql ? vlim : 0;
#pragma unroll
      for (int c = 0; c < C; ++c) out[c] = c < vl ? out[c] : NEG;
    }
  };
  auto fix_big = [&](int r, int ca_, int cs_, int q_, T (&out)[C]) {
    if constexpr (!I16) {
      if (BIAS && (q_ < -(1 << 24) || q_ > (1 << 24))) {
        const int ra = ca_ * (NA * 4), rs = cs_ * (NA * 4), vl = r < ql ? vlim : 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float x = *reinterpret_cast<const float*>(sbase + oa[c] + ra)
                          + *reinterpret_cast<const float*>(sbase + os[c] + rs);
          out[c] = c < vl ? (float)((double)x + (double)q_) : NEG;
        }
      }
    }
  };
  // a row's codes (clamped into the query: rows past qlen are masked;
  // int16: they take the pad code and no bias)
  auto load = [&](int r, int& ca_, int& cs_, int& q_) {
    if constexpr (I16) {
      const bool v = r < ql;
      ca_ = v ? qa_b[r] : PAD;
      cs_ = v ? qs_b[r] : PAD;
      if (BIAS) q_ = v ? qc_b[r] : 0;
    } else {
      r = max(0, min(r, ql - 1));
      ca_ = qa_b[r];
      cs_ = qs_b[r];
      if (BIAS) q_ = qc_b[r];
    }
  };
  // the codes run two rows ahead of the DP and the scores one, so neither a
  // global load nor a gather waits between two rows
  int ca0 = 0, cs0 = 0, q0 = 0, ca1 = 0, cs1 = 0, q1 = 0;
  load(0, ca0, cs0, q0);
  load(1, ca1, cs1, q1);
  T sc[C];
  score(0, ca0, cs0, q0, sc);
  fix_big(0, ca0, cs0, q0, sc);

  for (int i = 0; i < nrows; ++i) {
    T sn[C];
    const int can = ca1, csn = cs1, qn = q1;
    score(i + 1, can, csn, qn, sn);
    load(i + 2, ca1, cs1, q1);
    T hl = __shfl_up_sync(FULL, h[C - 1], 1);
    if (lane == 0) hl = edge_h;

    if (UNGAPPED) {
#pragma unroll
      for (int c = C - 1; c >= 0; --c) {
        const T H = D::mx(T(0), D::add(c ? h[c - 1] : hl, sc[c]));
        const bool up = H > bb[c];
        bb[c] = up ? H : bb[c];
        br[c] = up ? i : br[c];
        h[c] = H;
      }
      if (MULTI) {
        T* r = xbuf + ((i & 1) * G + w) * rec;
        if (lane == WARP - 1) r[0] = h[C - 1];
        pair_sync(1, WARP * G);
        if (w > 0) edge_h = xbuf[((i & 1) * G + w - 1) * rec];
      }
      fix_big(i + 1, can, csn, qn, sn);
#pragma unroll
      for (int c = 0; c < C; ++c) sc[c] = sn[c];
      continue;
    }

    T H0[C], P[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T Fv = D::mx(D::sub(h[c], go), D::sub(f[c], ge));
      f[c] = Fv;
      H0[c] = D::mx(T(0), D::mx(D::add(c ? h[c - 1] : hl, sc[c]), Fv));
      P[c] = D::add(H0[c], jge[c]);
    }

    // suffix maxima of H0 + j*ge inside the lane: for the lane scan below
    // and for the warps to the right
    T suf[C];
    suf[C - 1] = P[C - 1];
#pragma unroll
    for (int c = C - 2; c >= 0; --c) suf[c] = D::mx(suf[c + 1], P[c]);

    // in-warp windowed inclusive prefix max over [max(e_w, j - S + 1), j]
    if (LANES) {
      // a window of m = S/C lanes: the lane's own prefix, the totals of
      // lanes t-m+1 .. t-1, and the suffix of lane t-m from column c+1
      const int m = S / C;
#pragma unroll
      for (int c = 1; c < C; ++c) P[c] = D::mx(P[c - 1], P[c]);
      T win = P[C - 1];  // becomes the max of the totals of lanes t-m/2+1 .. t
#pragma unroll
      for (int k = 1; k < WARP / 4; k <<= 1) {  // m <= 16
        const T o = __shfl_up_sync(FULL, win, k);
        if (k < (m >> 1) && lane >= k) win = D::mx(win, o);
      }
      const T m1 = __shfl_up_sync(FULL, win, 1);
      const T m2 = __shfl_up_sync(FULL, win, m >> 1);
      T mid = lane >= 1 ? m1 : D::none();
      if (lane >= (m >> 1)) mid = D::mx(mid, m2);
#pragma unroll
      for (int c = 0; c < C - 1; ++c) {
        const T x = __shfl_up_sync(FULL, suf[c + 1], m);
        P[c] = D::mx(D::mx(P[c], mid), lane >= m ? x : D::none());
      }
      P[C - 1] = D::mx(P[C - 1], mid);
    } else {
      // the plain version's log steps d = 1, 2, 4, ... < S: inside the lane
      // below C columns, then by d whole lanes (d*C columns)
      if (S > 1) lane_step<D, C, 1>(P, lane);
      if (S > 2) lane_step<D, C, 2>(P, lane);
      if (C > 4 && S > 4) lane_step<D, C, (C > 4 ? 4 : 1)>(P, lane);
      if (C > 8 && S > 8) lane_step<D, C, (C > 8 ? 8 : 1)>(P, lane);
      for (int d = 1; d * C < S && d < WARP; d <<= 1) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T v = __shfl_up_sync(FULL, P[c], d);
          if (lane >= d) P[c] = D::mx(P[c], v);
        }
      }
    }

    T* rp = xbuf + (i & 1) * G * rec;  // this row's records
    if (MULTI) {
      T* r = rp + w * rec;
      if (!LANES && S >= W) {  // windows shorter than a warp never read totals
        const T tot = warp_max<D>(suf[0]);
        if (lane == 0) r[R_TOT] = tot;
      }
      if (lane == WARP - 1) { r[R_H0] = H0[C - 1]; r[R_PW] = P[C - 2]; }
      if (w < G - 1 && e_w + S < Lt) {
        // suffix maxima to the warp's end, where a later warp's window
        // (k = j - S for its columns j < Lt) starts
        T y = suf[0];
#pragma unroll
        for (int k = 1; k < WARP; k <<= 1) {
          const T o = __shfl_down_sync(FULL, y, k);
          if (lane + k < WARP) y = D::mx(y, o);
        }
        T ex = __shfl_down_sync(FULL, y, 1);
        if (lane == WARP - 1) ex = D::none();
        if (j0 + C - 1 + S >= e_w + W && j0 + S < Lt) {
#pragma unroll
          for (int c = 0; c < C; ++c) r[R_SUF + c * WARP + lane] = D::mx(suf[c], ex);
        }
      }
      pair_sync(1, WARP * G);
    }

    // exclusive prefix: Pexc[j] = P[j - 1], with the part of the window
    // that lies in earlier warps
    T pe[C];
    {
      const T up = __shfl_up_sync(FULL, P[C - 1], 1);
      pe[0] = lane == 0 ? D::none() : up;
#pragma unroll
      for (int c = 1; c < C; ++c) pe[c] = P[c - 1];
    }
    if (MULTI && w > 0 && j0 - S < e_w) {
      if (!LANES && S <= C) {
        // only lane 0's first S columns look left of the warp, and
        // only into warp w-1 (k > 0: no total is read)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int k = j0 + c - S;
          if (k < e_w) pe[c] = D::mx(pe[c], incoming<D, C>(rp, rec, k, w, D::none()));
        }
      } else {
        // S is a multiple of C: the lane's columns k = j0 - S + c are the
        // C columns of one lane of an earlier warp (or all left of column 0)
        const int k0 = j0 - S;
        const int v2 = k0 < 0 ? -1 : k0 / W;
        T t = D::none();  // totals of the warps between
        for (int v = v2 + 1; v < w; ++v) t = D::mx(t, rp[v * rec + R_TOT]);
        if (k0 < 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) pe[c] = D::mx(pe[c], t);
        } else {
          const T* src = rp + v2 * rec + R_SUF + (k0 - v2 * W) / C;
#pragma unroll
          for (int c = 0; c < C; ++c) pe[c] = D::mx(pe[c], D::mx(src[c * WARP], t));
        }
      }
    }

#pragma unroll
    for (int c = 0; c < C; ++c) {
      T E, H;
      if constexpr (I16) {
        // the window reaches left of column 0, where the log steps fill -20000
        const T p = j0 + c < S ? max(pe[c], NEG_I16) : pe[c];
        E = D::sub(p, eoff[c]);
        H = min(max(H0[c], E), H_CAP);
      } else {
        E = pe[c] - go + ge - jge[c];
        H = fmaxf(H0[c], E);
      }
      const bool up = H > bb[c];
      bb[c] = up ? H : bb[c];
      br[c] = up ? i : br[c];
      h[c] = H;
    }

    if (MULTI && w > 0) {
      // H[i][e_w - 1], the next row's diagonal at the warp's left edge,
      // recomputed from what warp w-1 published (same operations)
      const T* rq = rp + (w - 1) * rec;
      T in = D::none();
      const int k = e_w - 1 - S;
      if (!LANES && k < e_w - W) {  // the window passes warp w-1 (S >= W)
        T pref = D::none();
        for (int v = 0; v < w - 1; ++v) pref = D::mx(pref, rp[v * rec + R_TOT]);
        in = incoming<D, C>(rp, rec, k, w - 1, pref);
      }
      if constexpr (I16) {
        T p = max(rq[R_PW], in);
        if (e_w - 1 < S) p = max(p, NEG_I16);
        edge_h = min(max(rq[R_H0], D::sub(p, jge_edge)), H_CAP);
      } else {
        const float E = fmaxf(rq[R_PW], in) - go + ge - jge_edge;
        edge_h = fmaxf(rq[R_H0], E);
      }
    }
    fix_big(i + 1, can, csn, qn, sn);
#pragma unroll
    for (int c = 0; c < C; ++c) sc[c] = sn[c];
  }

  // best over the per-column bests, then the lowest (row, col) among the
  // cells holding it: row-major ties, as in the plain version
  T m = D::none();
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (j0 + c < Lt) m = D::mx(m, bb[c]);
  m = warp_max<D>(m);
  if (MULTI) {
    if (lane == 0) red_f[w] = m;
    pair_sync(1, WARP * G);
    for (int v = 0; v < G; ++v) m = D::mx(m, red_f[v]);
  }
  unsigned long long key = ~0ull;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    if (j < Lt && bb[c] >= m) {
      const unsigned long long kk = (unsigned long long)br[c] << 32 | (unsigned)j;
      key = kk < key ? kk : key;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, key, o);
    key = x < key ? x : key;
  }
  if (MULTI) {
    if (lane == 0) red_k[w] = key;
    pair_sync(1, WARP * G);
    for (int v = 0; v < G; ++v) key = red_k[v] < key ? red_k[v] : key;
  }
  if (w == 0 && lane == 0) {
    a.best[b] = (float)m;
    a.qend[b] = (int)(key >> 32);
    a.tend[b] = (int)(key & 0xffffffffu);
  }
}

template <class D, int C, bool UNGAPPED, bool BIAS, bool MULTI>
cudaError_t launch(Args a, cudaStream_t stream) {
  constexpr int NT = D::INT16 ? NA + 1 : NA;
  static_assert(sizeof(typename D::T) == sizeof(float), "records share the float buffer");
  a.G = (a.Lt + WARP * C - 1) / (WARP * C);
  const int rec = UNGAPPED ? 1 : R_SUF + WARP * C;
  const size_t smem = (2 * NT * NT + (MULTI ? (size_t)2 * a.G * rec : 0)) * sizeof(float);
  auto kernel = sw_forward_kernel<D, C, UNGAPPED, BIAS, MULTI, false>;
  if constexpr (!UNGAPPED)
    if (a.S > C && a.S < WARP * C) kernel = sw_forward_kernel<D, C, UNGAPPED, BIAS, MULTI, true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, WARP * a.G, smem, stream>>>(a);
  return cudaGetLastError();
}

// Columns per lane (C) by target width and mode: the fastest of 4, 8 and
// 16 at the main path's widths (PERF.md, scripts/torch_sw_bench.py).  A
// pair takes ceil(Lt / (32*C)) warps; only the (C, multi-warp) pairs named
// here are compiled.  The int16 instance takes the same table.
template <class D, bool BIAS>
cudaError_t dispatch(const Args& a, bool ungapped, cudaStream_t st) {
  if (ungapped) {
    if (a.Lt <= 128) return launch<D, 4, true, BIAS, false>(a, st);
    if (a.Lt <= 256) return launch<D, 4, true, BIAS, true>(a, st);
    if (a.Lt <= 2048) return launch<D, 8, true, BIAS, true>(a, st);
    return launch<D, 16, true, BIAS, true>(a, st);
  }
  if (a.Lt <= 128) return launch<D, 4, false, BIAS, false>(a, st);
  if (a.Lt <= 256) return launch<D, 8, false, BIAS, false>(a, st);
  if (a.Lt <= 512) return launch<D, 16, false, BIAS, false>(a, st);
  return launch<D, 16, false, BIAS, true>(a, st);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The windowed prefix max spans the smallest power of two >= scan_limit
// (the JAX log steps d = 1, 2, 4, ... < scan_limit).
extern "C" int sw_forward_launch(
    const int* qa, const int* qs, const int* ta, const int* ts,
    const int* qlen, const int* tlen, const int* qc,
    const float* saa, const float* s3d,
    float go, float ge, float w_aa, float w_3di,
    int B, int Lq, int Lt, int scan_limit, int ungapped,
    float* best, int* qend, int* tend, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lq <= 0 || Lt <= 0 || Lt > MAX_LT) return (int)cudaErrorInvalidValue;
  int S = 1;
  while (S < scan_limit && S < Lt) S <<= 1;
  const Args a{qa, qs, ta, ts, qlen, tlen, qc, saa, s3d, go, ge, w_aa, w_3di,
               B, Lq, Lt, S, 0, best, qend, tend};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = qc != nullptr ? dispatch<DpF32, true>(a, ungapped != 0, st)
                                      : dispatch<DpF32, false>(a, ungapped != 0, st);
  return (int)e;
}

// The int16 instance (dp_dtype="i16"): go and ge are integers, and pad_v
// is ops/sw.py::i16_pad_value(w_aa, w_3di).  The wrapper has checked the
// int16 contract (ops/sw.py::i16_contract).
extern "C" int sw_forward_i16_launch(
    const int* qa, const int* qs, const int* ta, const int* ts,
    const int* qlen, const int* tlen, const int* qc,
    const float* saa, const float* s3d, int go, int ge, float w_aa, float w_3di, int pad_v,
    int B, int Lq, int Lt, int scan_limit, int ungapped,
    float* best, int* qend, int* tend, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lq <= 0 || Lt <= 0 || Lt > MAX_LT) return (int)cudaErrorInvalidValue;
  int S = 1;
  while (S < scan_limit && S < Lt) S <<= 1;
  const Args a{qa, qs, ta, ts, qlen, tlen, qc, saa, s3d, (float)go, (float)ge, w_aa, w_3di,
               B, Lq, Lt, S, 0, best, qend, tend, pad_v};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = qc != nullptr ? dispatch<DpI16, true>(a, ungapped != 0, st)
                                      : dispatch<DpI16, false>(a, ungapped != 0, st);
  return (int)e;
}

// Largest target width the kernel takes.
extern "C" int sw_forward_max_lt() { return MAX_LT; }
