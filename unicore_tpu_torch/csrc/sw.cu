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
// The int16 instance (sw_forward_i16_launch, the kernel sw_i16_kernel)
// replaces the same Pallas kernel's dp_dtype="i16" mode and is
// bit-identical to unicore_tpu_torch/ops/sw.py::sw_forward_i16 on
// build_scores_i16's scores: H, F, E and the best are int16, every add
// and subtract wraps (JAX's int16 ops do), F starts at and the E window's
// outside is -20000, and the gapped mode caps H at 30000.  It is a kernel
// of its own, built on the packed int16x2 forms that
// scripts/torch_probe_i16.py holds against numpy's wrapping arithmetic on
// the card (__viaddmax_s16x2[_relu], __viaddmin_s16x2_relu, __vimax3_s16x2,
// __vmaxs2, __vmins2, __byte_perm): every DP operation does two cells.
//
//   * Layout: a warp owns a block of 2W columns, W = 32*C (C words a lane,
//     2, 4 or 8, see dispatch_i16), the block folded in two: word c of
//     lane t holds column e + t*C + c in its lo half and that column + W in
//     its hi half (e: the block's first column).  So the lo halves of lanes
//     0..31 and then their hi halves are the block's columns in order, 64
//     "virtual lanes" of C columns.  A word's left neighbour column is the
//     same half of word c-1, and for word 0 the same half of lane t-1's
//     last word; lane 0's hi half continues lane 31's lo half (the seam).
//     One shuffle and one __byte_perm (rot below) move every word by k
//     virtual lanes, the seam included, for the diagonal, the scans and the
//     exclusive shift; nothing else crosses the seam.
//   * F = max(H - go, F - ge), H0 = max(diag + s, F, 0) and t = H0 + j*ge
//     take four packed operations a word; E and H = min(max(H0, E), 30000)
//     two, with E = Pexc - (j*ge + go - ge) as one add of its negation.
//   * The windowed prefix max of t over [j - S + 1, j] (S: the plain
//     version's log-step span) runs on virtual lanes: S >= 2W, a plain
//     prefix (serial in the lane, six rotations across the block); C <= S
//     <= W, van Herk/Gil-Werman with a window of m = S/C virtual lanes;
//     S < C, the log steps inside the lane.  Max is exact, so any cover of
//     the window gives the plain version's bits.  -20000 enters where the
//     log steps bring it in: Pexc[j] for j < S.
//   * A pair of G > 1 warps (G = ceil(Lt / 2W), at most 8) syncs its warps
//     once a row with a named barrier, after each warp publishes, in a
//     buffer double-buffered by row parity, what later warps read: the
//     suffix maxima of its block where their windows start, its total, and
//     its last column's H0 and windowed prefix, from which the next warp
//     recomputes H at its left edge (the next row's diagonal) with the same
//     operations; the ungapped mode publishes its last column's H.
//   * The best: a lane keeps its largest H, the row that first reached it
//     and that row's words (a max over its words, a compare and selects a
//     row, no branch); the lowest column holding it is found at the end,
//     and the pair takes the lowest (row, column) among the lanes holding
//     the largest: the plain version's row-major tie rule.
//   * The score: each block builds the (22, 22) tables as ops/sw.py::
//     i16_tables does (a pad row and column of -pad_v, times the weight in
//     float32, rounded to bfloat16), and converts each cell as XLA does:
//     the float32 sum rounded to bfloat16, then to int16 toward zero,
//     saturating.  A row's codes and bias come a chunk of 32 rows ahead
//     (one row a lane, handed out by shuffles), its constants derived once
//     a chunk.
//   * Who scores: a gapped pair of one warp has a second warp that scores
//     its rows into a ring of RING rows in shared memory (named barriers,
//     full and empty a slot), so the DP warp's row is the DP alone.  It
//     takes a fast score for a row whose cells all sum to integers of at
//     most 256 in magnitude (integral tables, the codes below 21, max|aa| +
//     max|3di| + |bias| <= 256; bfloat16 holds every such integer, so the
//     plain version's rounding and conversion leave it as it is): four int
//     gathers, two adds and a __byte_perm a word, and one value for the
//     row's columns past tlen.  Otherwise each DP warp scores its own words
//     a row ahead: an ungapped pair all its rows fast where every row
//     allows it (a vote over the rows before the first), other pairs per
//     cell (gapped pairs of several warps timed faster so: PERF.md).  The
//     row loop is unrolled by two, so two rows' independent work
//     interleaves.
//   * Rows past qlen take the pad code and no bias, and are skipped where
//     go >= 0 and ge >= 0 and always in the ungapped mode: there every H
//     of such a row is below a value of an earlier row at or left of its
//     column (F and E lose go or ge, a diagonal loses the pad sentinel, no
//     value wraps), so it cannot reach the best before an earlier cell does.
//     Columns at or past Lt hold -32768 (ungapped: 0) after each row.
//
// What bounds it: the wrapper's contract (ops/sw.py::i16_contract:
// Lt*ge + 30150 < 32767, Lq < 32768, integer gaps and weights) and Lt <=
// MAX_LT; on the card, instructions (chip_smoke.py's i16_bound): per word
// of two cells 9.5 packed int16x2 and DPX forms gapped (1.5 ungapped) at
// the 2 an SM a cycle that scripts/torch_probe_i16.py measures, and the
// score's 7 (integer cells of at most 256) at the issue limit of 4.  What
// sets the time is a row's latency: one warp a scheduler at the engine's
// batches, a serial chain through the window's rotations and, with G > 1
// warps, the barrier and the records' round trip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NA = 21;
constexpr float NEG = -1e9f;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_C = 16;
constexpr int MAX_PAIR_WARPS = 8;  // Lt <= MAX_PAIR_WARPS * WARP * MAX_C
constexpr int MAX_LT = MAX_PAIR_WARPS * WARP * MAX_C;
// The DP's number type and operations: the plain version's float32.
// none() lies below every value of the DP: the max of an empty window.
struct DpF32 {
  using T = float;
  __device__ static T none() { return NEG; }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T sub(T a, T b) { return a - b; }
  __device__ static T mx(T a, T b) { return fmaxf(a, b); }
};

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
// takes the plain version's log steps.  D: DpF32.
template <class D, int C, bool UNGAPPED, bool BIAS, bool MULTI, bool LANES>
__global__ void __launch_bounds__(MAX_PAIR_WARPS * WARP) sw_forward_kernel(Args a) {
  using T = typename D::T;
  constexpr int NT = NA;  // the matrices' rows
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
    mat_aa[k] = a.w_aa * a.saa[k];
    mat_3d[k] = a.w_3di * a.s3d[k];
  }
  __syncthreads();

  const int ql = max(0, min(a.qlen[b], Lq));
  const int tl = min(a.tlen[b], Lt);
  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;

  // exact_dp (gapped): every value on the non-negative side of the DP is
  // an exact integer below 2^24 (see the note at the top), so rows past
  // qlen can be skipped
  int nrows = Lq;
  {
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
  // this plus the row's offset (masked columns hold code 0)
  int oa[C], os[C], br[C];
  T h[C], f[C], bb[C], jge[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const bool valid = j < tl;
    oa[c] = (valid ? a.ta[(size_t)b * Lt + j] : 0) * 4;
    os[c] = (valid ? a.ts[(size_t)b * Lt + j] : 0) * 4 + NT * NT * 4;
    h[c] = T(0);
    f[c] = T(NEG);
    bb[c] = T(0);
    br[c] = 0;
    jge[c] = (float)j * ge;
  }
  const T jge_edge = (float)(e_w - 1) * ge;
  T edge_h = T(0);  // H[i-1][e_w - 1]; 0 for the first row and column
  const char* sbase = reinterpret_cast<const char*>(smem);

  // Scores of row r: a gather at each column's byte offset plus the
  // row's (every gather is in bounds, so the loads issue together), the
  // bias in float32, NEG past tlen and past qlen (a select).  fix_big
  // redoes a row whose |q| > 2^24 with the float64 add.
  auto score = [&](int r, int ca_, int cs_, int q_, T (&out)[C]) {
    const int ra = ca_ * (NT * 4), rs = cs_ * (NT * 4);
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
  };
  auto fix_big = [&](int r, int ca_, int cs_, int q_, T (&out)[C]) {
    if (BIAS && (q_ < -(1 << 24) || q_ > (1 << 24))) {
      const int ra = ca_ * (NA * 4), rs = cs_ * (NA * 4), vl = r < ql ? vlim : 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float x = *reinterpret_cast<const float*>(sbase + oa[c] + ra)
                        + *reinterpret_cast<const float*>(sbase + os[c] + rs);
        out[c] = c < vl ? (float)((double)x + (double)q_) : NEG;
      }
    }
  };
  // a row's codes (clamped into the query: rows past qlen are masked)
  auto load = [&](int r, int& ca_, int& cs_, int& q_) {
    r = max(0, min(r, ql - 1));
    ca_ = qa_b[r];
    cs_ = qs_b[r];
    if (BIAS) q_ = qc_b[r];
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
      const T E = pe[c] - go + ge - jge[c];
      const T H = fmaxf(H0[c], E);
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
      const float E = fmaxf(rq[R_PW], in) - go + ge - jge_edge;
      edge_h = fmaxf(rq[R_H0], E);
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
  constexpr int NT = NA;
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
// here are compiled.
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

// ---------------------------------------------------------------------------
// The int16 instance: two int16 columns to a 32-bit word (see the note at
// the top)
// ---------------------------------------------------------------------------

constexpr int PAD = NA;                  // code of a position past a pair's length
constexpr int NT16 = NA + 1;             // the int16 tables' rows: a pad row and column
constexpr int NN16 = NT16 * NT16;
constexpr int NEG_I16 = -20000;          // F's start, the window's outside
constexpr int H_CAP = 30000;             // the gapped mode's cap on H
constexpr int FAST_MAX = 256;            // bfloat16 holds every integer of at most this magnitude
constexpr unsigned NONE2 = 0x80008000u;  // -32768 in both halves: the identity of max
// __byte_perm(x, y, sel) selectors: x as it is; x's lo half into the hi
// half and y's lo half into the lo half; x's hi half into the lo half and
// y's hi half into the hi half; x's lo half and then y's; the halves swapped
constexpr unsigned SEL_ID = 0x3210u, SEL_ROT = 0x1054u, SEL_HI2LO = 0x7632u,
                   SEL_LOS = 0x5410u, SEL_SWAP = 0x1032u;
constexpr int I16_FULL = 0, I16_LANES = 1, I16_STEPS = 2;  // the windowed max's modes
constexpr int RING = 4;  // gapped one-warp pairs: rows of scores the scoring warp runs ahead

struct I16Args {
  const int* qa;
  const int* qs;
  const int* ta;
  const int* ts;
  const int* qlen;
  const int* tlen;
  const int* qc;  // (B, Lq) per-query-row score correction, or null
  const float* saa;  // (21, 21)
  const float* s3d;  // (21, 21)
  int go, ge;
  float w_aa, w_3di;
  int pad_v;  // the pad row and column's -value (ops/sw.py::i16_pad_value)
  int B, Lq, Lt;
  int S;  // E window span: a power of two; >= Lt covers the whole row
  int G;  // warps per pair
  float* best;
  int* qend;
  int* tend;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// float32 -> int16 toward zero, saturating (XLA's convert)
__device__ __forceinline__ int to_i16(float x) {
  return min(max(__float2int_rz(x), -32768), 32767);
}

__device__ __forceinline__ unsigned pk(int lo, int hi) {
  return ((unsigned)lo & 0xffffu) | ((unsigned)hi << 16);
}
__device__ __forceinline__ unsigned bc(int v) { return ((unsigned)v & 0xffffu) * 0x10001u; }
__device__ __forceinline__ int lo16(unsigned x) { return (int)(short)(x & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned x) { return (int)x >> 16; }
// per half: max, max of three, min, max(a + b, c), max(a + b, c, 0),
// max(min(a + b, c), 0), a + b (adds wrap; -32768 is the identity of max)
__device__ __forceinline__ unsigned vmax(unsigned a, unsigned b) { return __vmaxs2(a, b); }
__device__ __forceinline__ unsigned vmax3(unsigned a, unsigned b, unsigned c) {
  return __vimax3_s16x2(a, b, c);
}
__device__ __forceinline__ unsigned vmin(unsigned a, unsigned b) { return __vmins2(a, b); }
__device__ __forceinline__ unsigned vaddmax(unsigned a, unsigned b, unsigned c) {
  return __viaddmax_s16x2(a, b, c);
}
__device__ __forceinline__ unsigned vaddmax0(unsigned a, unsigned b, unsigned c) {
  return __viaddmax_s16x2_relu(a, b, c);
}
__device__ __forceinline__ unsigned vaddmin0(unsigned a, unsigned b, unsigned c) {
  return __viaddmin_s16x2_relu(a, b, c);
}
__device__ __forceinline__ unsigned vadd(unsigned a, unsigned b) { return __viaddmax_s16x2(a, b, NONE2); }
__device__ __forceinline__ unsigned hi2lo(unsigned x) { return __byte_perm(x, NONE2, SEL_HI2LO); }

__device__ __forceinline__ void pair_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(nthreads) : "memory");
}

// C words at p (16-byte aligned for C >= 4, 8-byte for C = 2)
template <int C>
__device__ __forceinline__ void store_words(unsigned* p, const unsigned (&v)[C]) {
  if constexpr (C == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<uint4*>(p + c) = make_uint4(v[c], v[c + 1], v[c + 2], v[c + 3]);
  }
}
template <int C>
__device__ __forceinline__ void load_words(const unsigned* p, unsigned (&v)[C]) {
  if constexpr (C == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + c);
      v[c] = x.x;
      v[c + 1] = x.y;
      v[c + 2] = x.z;
      v[c + 3] = x.w;
    }
  }
}

// Each lane's words moved right by k virtual lanes (1 <= k <= 32): lane t
// takes lane t-k's word, and a lane t < k takes lane t-k+32's lo half into
// its hi half (the seam) and `fill`'s lo half into its lo half (left of the
// block).  rot_at takes the source lane src = (t - k) & 31 and sel =
// rot_sel(k, lane), both fixed for a k; rot folds them where k is.
__device__ __forceinline__ unsigned rot_sel(int k, int lane) { return lane >= k ? SEL_ID : SEL_ROT; }
__device__ __forceinline__ unsigned rot_at(unsigned x, int src, unsigned sel, unsigned fill) {
  return __byte_perm(__shfl_sync(FULL, x, src), fill, sel);
}
__device__ __forceinline__ unsigned rot(unsigned x, int k, unsigned fill, int lane) {
  const unsigned v = k >= WARP ? x : __shfl_sync(FULL, x, (lane - k) & (WARP - 1));
  return __byte_perm(v, fill, rot_sel(k, lane));
}

// One log step of the windowed max inside the lane: P[c] = max(P[c], P[c-D]),
// the words left of the lane from virtual lane - 1
template <int C, int D>
__device__ __forceinline__ void lane_step16(unsigned (&P)[C], int lane) {
  unsigned from[D];
#pragma unroll
  for (int c = 0; c < D; ++c) from[c] = rot(P[C - D + c], 1, NONE2, lane);
#pragma unroll
  for (int c = C - 1; c >= D; --c) P[c] = vmax(P[c], P[c - D]);
#pragma unroll
  for (int c = 0; c < D; ++c) P[c] = vmax(P[c], from[c]);
}

// One block per pair, C words a lane: a warp holds 2*32*C columns.  MULTI:
// G = blockDim.x / 32 > 1 warps run the DP, each scoring its own columns
// a row ahead; so does the one warp of an ungapped pair.  A gapped pair of
// one warp (SPLIT) has a second warp that scores the rows into a ring of
// RING rows in shared memory ahead of it (named barriers: full and empty
// per slot), so the DP warp's row is the DP alone.  MODE:
// the windowed max's (I16_FULL: S >= 2W; I16_LANES: C <= S <= W;
// I16_STEPS: S < C), fixed at compile time, so a row's code is one block
// of straight-line code (the barrier and records aside).
template <int C, bool UNGAPPED, bool BIAS, bool MULTI, int MODE>
__global__ void __launch_bounds__(MAX_PAIR_WARPS * WARP) sw_i16_kernel(I16Args a) {
  constexpr int W = WARP * C;  // columns of one half of a warp's block
  constexpr bool SPLIT = !MULTI && !UNGAPPED;  // a scoring warp beside the DP warp
  constexpr bool FASTABLE = SPLIT || UNGAPPED;  // a fast score is taken where rows allow it
  extern __shared__ float smem[];
  __shared__ int red_m[MAX_PAIR_WARPS];
  __shared__ unsigned long long red_k[MAX_PAIR_WARPS];
  __shared__ int tab_max[2];

  const int S = a.S, Lq = a.Lq, Lt = a.Lt;
  const int G = MULTI ? a.G : 1;
  const int lane = threadIdx.x & (WARP - 1);
  const int w = MULTI ? (int)(threadIdx.x / WARP) : 0;
  const int b = blockIdx.x;
  const int rec = UNGAPPED ? 1 : R_SUF + W;
  float* ftab = smem;                                             // [aa | 3di], float
  int* itab = reinterpret_cast<int*>(smem + 2 * NN16);            // the same, as ints
  unsigned* xbuf = reinterpret_cast<unsigned*>(smem + 4 * NN16);  // [parity][warp] records (MULTI)

  const int ql = max(0, min(a.qlen[b], Lq));
  const int tl = min(a.tlen[b], Lt);
  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;
  const int* ta_b = a.ta + (size_t)b * Lt;
  const int* ts_b = a.ts + (size_t)b * Lt;
  const int go = a.go, ge = a.ge;

  // a row's codes and bias; rows past qlen take the pad code and no bias
  auto load = [&](int r, int& ca_, int& cs_, int& q_) {
    const bool v = r < ql;
    ca_ = v ? qa_b[r] : PAD;
    cs_ = v ? qs_b[r] : PAD;
    q_ = BIAS && v ? qc_b[r] : 0;
  };
  // the first chunk of row data (see derive), in flight while the tables are built
  int ca_0 = 0, cs_0 = 0, q_0 = 0;
  load(lane, ca_0, cs_0, q_0);
  const int e = w * 2 * W;      // the warp's first column
  const int j0 = e + lane * C;  // the lane's lo columns j0 .. j0 + C - 1; hi: + W
  // the columns' codes, loaded together (clamped into the row) while the
  // tables are built
  int tcode[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jl = min(j0 + c, Lt - 1), jh = min(j0 + c + W, Lt - 1);
    tcode[c][0] = ta_b[jl];
    tcode[c][1] = ts_b[jl];
    tcode[c][2] = ta_b[jh];
    tcode[c][3] = ts_b[jh];
  }

  if (threadIdx.x == 0) tab_max[0] = tab_max[1] = 0;
  __syncthreads();
  bool ok = FASTABLE;  // the fast score's block-wide conditions
  int amax = 0, smax = 0;
  for (int k0 = threadIdx.x; k0 < NN16; k0 += 4 * blockDim.x) {
    float mx[4], my[4];  // four entries' loads in flight together
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * blockDim.x, r = k / NT16, c = k % NT16;
      const bool in = k < NN16 && r != PAD && c != PAD;
      mx[u] = in ? a.saa[r * NA + c] : -(float)a.pad_v;
      my[u] = in ? a.s3d[r * NA + c] : -(float)a.pad_v;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + u * blockDim.x, r = k / NT16, c = k % NT16;
      if (k >= NN16) break;
      const float x = bf16_round(mx[u] * a.w_aa), y = bf16_round(my[u] * a.w_3di);
      ftab[k] = x;
      ftab[NN16 + k] = y;
      if (!FASTABLE) continue;
      itab[k] = __float2int_rz(x);
      itab[NN16 + k] = __float2int_rz(y);
      if (r != PAD && c != PAD) {
        ok = ok && x == rintf(x) && y == rintf(y);
        amax = max(amax, (int)fminf(fabsf(x), 65536.f));
        smax = max(smax, (int)fminf(fabsf(y), 65536.f));
      }
    }
  }
  if (amax) atomicMax(&tab_max[0], amax);
  if (smax) atomicMax(&tab_max[1], smax);


  // byte offsets of each half's entries in the tables (a gather is this plus
  // the row's offset; columns past tlen hold the pad code); capw: the cap
  // on H, -32768 (ungapped: a min of -32768 under the max with 0) at or
  // past Lt, so those columns never reach the best and feed only columns
  // past Lt
  int oal[C], osl[C], oah[C], osh[C];
  unsigned jge[C], neoff[C], padm[C], capw[C];
  const int capv = UNGAPPED ? 32767 : H_CAP;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int jl = j0 + c, jh = jl + W;
    const bool vl = jl < tl, vh = jh < tl;
    const int al = vl ? tcode[c][0] : PAD, sl = vl ? tcode[c][1] : PAD;
    const int ah = vh ? tcode[c][2] : PAD, sh = vh ? tcode[c][3] : PAD;
    ok = ok && (!vl || (al < NA && sl < NA)) && (!vh || (ah < NA && sh < NA));
    oal[c] = al * 4;
    osl[c] = sl * 4 + NN16 * 4;
    oah[c] = ah * 4;
    osh[c] = sh * 4 + NN16 * 4;
    jge[c] = pk(jl * ge, jh * ge);
    neoff[c] = pk(-(jl * ge + go - ge), -(jh * ge + go - ge));  // -(j*ge + (go - ge))
    padm[c] = (vl ? 0u : 0xffffu) | (vh ? 0u : 0xffff0000u);
    capw[c] = pk(jl < Lt ? capv : -32768, jh < Lt ? capv : -32768);
  }
  __syncthreads();
  const float fast_q = (float)(FAST_MAX - tab_max[0] - tab_max[1]);  // largest |bias| of a fast row
  const int nrows = UNGAPPED || (go >= 0 && ge >= 0) ? ql : Lq;
  // the fast score where the tables and target codes allow it (ok) and the
  // row does: its codes below 21 and its |bias| at most fast_q
  ok = __syncthreads_and(ok);

  const int m = S / C;  // the window in virtual lanes (I16_LANES)
  const unsigned ngo = bc(-go), nge = bc(-ge);
  // the window's outside (-20000) enters Pexc[j] for j < S: a warp's every
  // column (I16_FULL, S a multiple of 2W), the lo halves of lanes t < m of
  // warp 0 (I16_LANES) or lane 0's first S words (I16_STEPS)
  const unsigned fill_full = e < S ? bc(NEG_I16) : NONE2;
  const unsigned fill_lanes = w == 0 && lane < m ? pk(NEG_I16, -32768) : NONE2;
  const unsigned fill_steps = w == 0 && lane == 0 ? pk(NEG_I16, -32768) : NONE2;
  // the rotations' source lanes and selectors
  const int src1 = (lane - 1) & (WARP - 1);
  const unsigned sel1 = rot_sel(1, lane);
  const int mh = max(m >> 1, 1);
  const int srch = (lane - mh) & (WARP - 1), srcm = (lane - m) & (WARP - 1);
  const unsigned selh = rot_sel(mh, lane), selm = rot_sel(m, lane);
  const char* fbase = reinterpret_cast<const char*>(smem);
  const char* ibase = fbase + 2 * NN16 * 4;

  // Row data, 32 rows at a time, row base + t in lane t: the codes' table
  // offsets (ra | rs << 16), the bias (the float's bits; FASTABLE: also
  // as an int for the fast score, with the row's fast score past tlen and
  // whether the row allows the fast score); derived once a chunk from
  // codes loaded a chunk ahead, so no load waits.
  unsigned r_off = 0u, r_q = 0u, r_qf = 0u, r_pad = 0u;
  bool r_fast = false;
  auto derive = [&](int ca_, int cs_, int q_) {
    r_off = (unsigned)(ca_ * (NT16 * 4)) | (unsigned)(cs_ * (NT16 * 4)) << 16;
    const float qb = BIAS ? bf16_round((float)q_) : 0.f;
    r_qf = __float_as_uint(qb);
    if constexpr (FASTABLE) {
      r_fast = ok && ca_ < NA && cs_ < NA && fabsf(qb) <= fast_q;
      r_q = BIAS ? (unsigned)(int)fminf(fmaxf(qb, -65536.f), 65536.f) : 0u;
      const int pa = min(ca_, PAD) * NT16 + PAD, ps = NN16 + min(cs_, PAD) * NT16 + PAD;
      float xp = ftab[pa] + ftab[ps];
      if (BIAS) xp = xp + qb;
      r_pad = bc(to_i16(bf16_round(xp)));
    }
  };
  // Scores of row r (its data in lane r & 31), two columns a word.  Fast:
  // int gathers and adds, exact (see the note at the top), and one value
  // past tlen; else the float32 sum through bfloat16 to int16, per cell.
  auto score = [&](auto fast_tag, int r, unsigned (&out)[C]) {
    constexpr bool FAST = decltype(fast_tag)::value;
    const unsigned off = __shfl_sync(FULL, r_off, r & (WARP - 1));
    const int ra = off & 0xffffu, rs = off >> 16;
    if constexpr (FAST) {
      const int qi = (int)__shfl_sync(FULL, r_q, r & (WARP - 1));
      const unsigned padw = __shfl_sync(FULL, r_pad, r & (WARP - 1));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int lo = *reinterpret_cast<const int*>(ibase + oal[c] + ra)
                       + *reinterpret_cast<const int*>(ibase + osl[c] + rs) + qi;
        const int hi = *reinterpret_cast<const int*>(ibase + oah[c] + ra)
                       + *reinterpret_cast<const int*>(ibase + osh[c] + rs) + qi;
        const unsigned s2 = __byte_perm((unsigned)lo, (unsigned)hi, SEL_LOS);
        out[c] = (s2 & ~padm[c]) | (padw & padm[c]);
      }
    } else {
      const float qb = __uint_as_float(__shfl_sync(FULL, r_qf, r & (WARP - 1)));
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float xl = *reinterpret_cast<const float*>(fbase + oal[c] + ra)
                   + *reinterpret_cast<const float*>(fbase + osl[c] + rs);
        float xh = *reinterpret_cast<const float*>(fbase + oah[c] + ra)
                   + *reinterpret_cast<const float*>(fbase + osh[c] + rs);
        if (BIAS) {
          xl = xl + qb;
          xh = xh + qb;
        }
        out[c] = pk(to_i16(bf16_round(xl)), to_i16(bf16_round(xh)));
      }
    }
  };
  unsigned* ring = xbuf;  // SPLIT: [RING][WARP][C] words of scores
  // the scoring warp (SPLIT): rows 0 .. nrows (the DP reads a row ahead),
  // each row's score fast where the row allows it
  auto produce = [&]() {
    int ca_n = ca_0, cs_n = cs_0, q_n = q_0;  // the next chunk's codes
    derive(ca_n, cs_n, q_n);
    load(WARP + lane, ca_n, cs_n, q_n);
    for (int r = 0; r <= nrows; ++r) {
      if (r > 0 && (r & (WARP - 1)) == 0) {
        derive(ca_n, cs_n, q_n);
        load(r + WARP + lane, ca_n, cs_n, q_n);
      }
      const int slot = r & (RING - 1);
      if (r >= RING) pair_sync(1 + RING + slot, 2 * WARP);  // empty: the DP warp has row r - RING
      unsigned v[C];
      if (__shfl_sync(FULL, (int)r_fast, r & (WARP - 1)))
        score(std::true_type{}, r, v);
      else
        score(std::false_type{}, r, v);
      store_words<C>(ring + (slot * WARP + lane) * C, v);
      pair_arrive(1 + slot, 2 * WARP);  // full
    }
    for (int r = max(nrows + 1 - RING, 0); r <= nrows; ++r) pair_sync(1 + RING + (r & (RING - 1)), 2 * WARP);
  };

  // the lane's best: its largest H, first reached in row lrow, whose words
  // are kept in hb (the lowest column holding it is found at the end)
  int lbest = 0, lrow = 0;
  unsigned hb[C];

  // The DP over the pair's rows, its scores the scoring warp's (SPLIT) or
  // its own: fast (FAST) or per cell
  auto rows = [&](auto fast_tag) {
    unsigned h[C], f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      h[c] = 0u;
      f[c] = bc(NEG_I16);
      hb[c] = 0u;
    }
    // the scores run a row ahead of the DP (the row data a chunk ahead of
    // the scores; SPLIT: the scoring warp up to RING rows ahead), so
    // neither a global load nor a gather waits
    auto fetch = [&](int r, unsigned (&out)[C]) {  // SPLIT: row r from the ring
      pair_sync(1 + (r & (RING - 1)), 2 * WARP);   // full
      load_words<C>(ring + ((r & (RING - 1)) * WARP + lane) * C, out);
    };
    auto release = [&](int r) { pair_arrive(1 + RING + (r & (RING - 1)), 2 * WARP); };  // empty
    int ca_n = ca_0, cs_n = cs_0, q_n = q_0;  // the next chunk's codes
    unsigned sc[C];
    if constexpr (SPLIT) {
      fetch(0, sc);
    } else {
      derive(ca_n, cs_n, q_n);
      load(WARP + lane, ca_n, cs_n, q_n);
      score(fast_tag, 0, sc);
    }
    unsigned edge_w = 0u;  // lo half: H[i-1][e - 1], the diagonal left of the warp

#pragma unroll 2  // two rows' independent work interleaves
    for (int i = 0; i < nrows; ++i) {
      unsigned sn[C];
      if constexpr (SPLIT) {
        fetch(i + 1, sn);
      } else {
        if (((i + 1) & (WARP - 1)) == 0) {  // the next chunk
          derive(ca_n, cs_n, q_n);
          load(i + 1 + WARP + lane, ca_n, cs_n, q_n);
        }
        score(fast_tag, i + 1, sn);
      }
      const unsigned hl = rot_at(h[C - 1], src1, sel1, edge_w);

      if constexpr (UNGAPPED) {
#pragma unroll
        for (int c = C - 1; c >= 0; --c) h[c] = vaddmin0(c ? h[c - 1] : hl, sc[c], capw[c]);
      } else {
        unsigned H0[C], P[C], suf[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const unsigned Fv = vaddmax(f[c], nge, vadd(h[c], ngo));
          f[c] = Fv;
          H0[c] = vaddmax0(c ? h[c - 1] : hl, sc[c], Fv);
          P[c] = vadd(H0[c], jge[c]);
        }
        // suffix maxima inside the lane: for the window's far end and for the
        // warps to the right
        const bool pub = MULTI && w < G - 1;
        if (MODE == I16_LANES || pub) {
          suf[C - 1] = P[C - 1];
#pragma unroll
          for (int c = C - 2; c >= 0; --c) suf[c] = vmax(suf[c + 1], P[c]);
        }

        // in-block windowed inclusive prefix max over [max(e, j - S + 1), j]
        if constexpr (MODE == I16_FULL) {
#pragma unroll
          for (int c = 1; c < C; ++c) P[c] = vmax(P[c - 1], P[c]);
          unsigned tot = P[C - 1];
#pragma unroll
          for (int k = 1; k <= WARP; k <<= 1) tot = vmax(tot, rot(tot, k, NONE2, lane));
          const unsigned ex = rot_at(tot, src1, sel1, NONE2);
#pragma unroll
          for (int c = 0; c < C; ++c) P[c] = vmax(P[c], ex);
        } else if constexpr (MODE == I16_LANES) {
          // the lane's own prefix, the totals of virtual lanes u-m+1 .. u-1,
          // and the suffix of virtual lane u-m from word c+1
#pragma unroll
          for (int c = 1; c < C; ++c) P[c] = vmax(P[c - 1], P[c]);
          unsigned win = P[C - 1];  // becomes the max of the totals of lanes u-m/2+1 .. u
#pragma unroll
          for (int k = 1; k < WARP / 2; k <<= 1)  // m/2 <= 16
            if (k < (m >> 1)) win = vmax(win, rot(win, k, NONE2, lane));
          const unsigned mid = m >= 2 ? vmax(rot_at(win, src1, sel1, NONE2), rot_at(win, srch, selh, NONE2))
                                      : NONE2;
#pragma unroll
          for (int c = 0; c < C - 1; ++c) P[c] = vmax3(P[c], mid, rot_at(suf[c + 1], srcm, selm, NONE2));
          P[C - 1] = vmax(P[C - 1], mid);
        } else {
          // the plain version's log steps d = 1, 2, ... < S < C inside the lane
          if (S > 1) lane_step16<C, 1>(P, lane);
          if (C > 4 && S > 2) lane_step16<C, (C > 4 ? 2 : 1)>(P, lane);
          if (C > 8 && S > 4) lane_step16<C, (C > 8 ? 4 : 1)>(P, lane);
        }

        unsigned* rp = xbuf + (i & 1) * G * rec;  // this row's records
        if (MULTI) {
          unsigned* r = rp + w * rec;
          if (lane == WARP - 1) {  // hi halves: the block's last and second-last columns
            r[R_H0] = H0[C - 1];
            r[R_PW] = P[C - 2];
          }
          if (pub) {
            // suffix maxima of each half to the lane 31 end, then of the block
            unsigned y = suf[0];
#pragma unroll
            for (int k = 1; k < WARP; k <<= 1) {
              const unsigned o = __shfl_down_sync(FULL, y, k);
              if (lane + k < WARP) y = vmax(y, o);
            }
            unsigned ex = __shfl_down_sync(FULL, y, 1);
            if (lane == WARP - 1) ex = NONE2;
            if constexpr (MODE == I16_FULL) {
              // a window of S >= 2W: a later warp reads whole blocks and totals
              const unsigned top = __shfl_sync(FULL, y, 0);
              if (lane == 0) r[R_TOT] = vmax(top, __byte_perm(top, 0u, SEL_SWAP));
              const unsigned hit = hi2lo(top);  // the hi half's total, in the lo half
#pragma unroll
              for (int c = 0; c < C; ++c) r[R_SUF + c * WARP + lane] = vmax3(suf[c], ex, hit);
            } else if (lane >= WARP - (MODE == I16_LANES ? m : 1)) {
              // S <= W: the next warp's window reaches the hi halves of the last m lanes
#pragma unroll
              for (int c = 0; c < C; ++c) r[R_SUF + c * WARP + lane] = vmax(suf[c], ex);
            }
          }
          pair_sync(1, WARP * G);
        }

        // exclusive prefix: Pexc[j] = P[j - 1], with the part of the window
        // that lies in earlier warps and the outside's -20000
        unsigned pe[C];
        pe[0] = rot_at(P[C - 1], src1, sel1, NONE2);
#pragma unroll
        for (int c = 1; c < C; ++c) pe[c] = P[c - 1];
        if (MULTI && w > 0) {
          if constexpr (MODE == I16_FULL) {
            // column j - S lies in warp v2 at this word's place
            const int v2 = w - S / (2 * W);
            unsigned t = NONE2;  // totals of the warps between
            for (int v = max(v2 + 1, 0); v < w; ++v) t = vmax(t, rp[v * rec + R_TOT]);
            if (v2 >= 0) {
              const unsigned* src = rp + v2 * rec + R_SUF + lane;
#pragma unroll
              for (int c = 0; c < C; ++c) pe[c] = vmax3(pe[c], src[c * WARP], t);
            } else {
#pragma unroll
              for (int c = 0; c < C; ++c) pe[c] = vmax(pe[c], t);
            }
          } else if constexpr (MODE == I16_LANES) {
            if (lane < m) {  // lo columns j < e + S: from warp w-1's lane 32-m+t, hi half
              const unsigned* src = rp + (w - 1) * rec + R_SUF + (WARP - m + lane);
#pragma unroll
              for (int c = 0; c < C; ++c) pe[c] = vmax(pe[c], hi2lo(src[c * WARP]));
            }
          } else if (lane == 0) {  // columns e .. e+S-1: from warp w-1's last S columns
            const unsigned* src = rp + (w - 1) * rec + R_SUF + WARP - 1;
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (c < S) pe[c] = vmax(pe[c], hi2lo(src[(C - S + c) * WARP]));
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const unsigned fill = MODE == I16_FULL    ? fill_full
                                : MODE == I16_LANES ? fill_lanes
                                : c < S             ? fill_steps
                                                    : NONE2;
          h[c] = vmin(vaddmax(vmax(pe[c], fill), neoff[c], H0[c]), capw[c]);
        }

        if (MULTI && w > 0) {
          // H[i][e - 1], the next row's diagonal at the warp's left edge,
          // recomputed from what warp w-1 published (same operations)
          const unsigned* rq = rp + (w - 1) * rec;
          int p = hi16(rq[R_PW]);
          if constexpr (MODE == I16_FULL) {
            const int v2 = w - 1 - S / (2 * W);
            for (int v = max(v2 + 1, 0); v < w - 1; ++v) p = max(p, lo16(rp[v * rec + R_TOT]));
            if (v2 >= 0) p = max(p, hi16(rp[v2 * rec + R_SUF + (C - 1) * WARP + WARP - 1]));
          }
          if (e - 1 < S) p = max(p, NEG_I16);
          const int E = (int)(short)(p - ((e - 1) * ge + go - ge));
          edge_w = (unsigned)min(max(hi16(rq[R_H0]), E), H_CAP) & 0xffffu;
        }
      }

      // the lane's best so far
      unsigned mw = h[0];
#pragma unroll
      for (int c = 1; c + 1 < C; c += 2) mw = vmax3(mw, h[c], h[c + 1]);
      if (C % 2 == 0) mw = vmax(mw, h[C - 1]);
      const int ms = max(lo16(mw), hi16(mw));
      const bool up = ms > lbest;
      lbest = up ? ms : lbest;
      lrow = up ? i : lrow;
#pragma unroll
      for (int c = 0; c < C; ++c) hb[c] = up ? h[c] : hb[c];

      if (UNGAPPED && MULTI) {
        unsigned* r = xbuf + (i & 1) * G;
        if (lane == WARP - 1) r[w] = h[C - 1];
        pair_sync(1, WARP * G);
        if (w > 0) edge_w = hi2lo(r[w - 1]);
      }
      if constexpr (SPLIT) release(i);
#pragma unroll
      for (int c = 0; c < C; ++c) sc[c] = sn[c];
    }
    if constexpr (SPLIT) release(nrows);
  };
  if constexpr (SPLIT) {
    if (threadIdx.x >= WARP) {  // the scoring warp
      produce();
      return;
    }
    rows(std::false_type{});
  } else if constexpr (UNGAPPED) {
    // the fast score where every row allows it (the same vote in each warp)
    bool all_fast = ok;
    for (int r = lane; r < nrows && all_fast; r += WARP) {
      int ca_, cs_, q_;
      load(r, ca_, cs_, q_);
      all_fast = ca_ < NA && cs_ < NA && fabsf(BIAS ? bf16_round((float)q_) : 0.f) <= fast_q;
    }
    if (__all_sync(FULL, all_fast))
      rows(std::true_type{});
    else
      rows(std::false_type{});
  } else {
    rows(std::false_type{});
  }

  // the largest H, then the lowest (row, col) among the lanes holding it
  // (in row lrow, the lowest column of the lane holding lbest: lo halves
  // first)
  const bool valid = j0 < Lt;
  int mx = __reduce_max_sync(FULL, valid ? lbest : -32768);
  if (MULTI) {
    if (lane == 0) red_m[w] = mx;
    pair_sync(1, WARP * G);
    for (int v = 0; v < G; ++v) mx = max(mx, red_m[v]);
  }
  int lcol = j0;
#pragma unroll
  for (int c = C - 1; c >= 0; --c)
    if (hi16(hb[c]) == lbest) lcol = j0 + W + c;
#pragma unroll
  for (int c = C - 1; c >= 0; --c)
    if (lo16(hb[c]) == lbest) lcol = j0 + c;
  unsigned long long key =
      valid && lbest >= mx ? (unsigned long long)lrow << 32 | (unsigned)lcol : ~0ull;
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
    a.best[b] = (float)mx;
    a.qend[b] = (int)(key >> 32);
    a.tend[b] = (int)(key & 0xffffffffu);
  }
}

template <int C, bool UNGAPPED, bool BIAS, bool MULTI, int MODE>
cudaError_t launch_i16(I16Args a, cudaStream_t stream) {
  a.G = (a.Lt + 2 * WARP * C - 1) / (2 * WARP * C);
  const int rec = UNGAPPED ? 1 : R_SUF + WARP * C;
  const size_t smem =
      (4 * NN16 + (MULTI ? (size_t)2 * a.G * rec : UNGAPPED ? 0 : (size_t)RING * WARP * C)) * sizeof(float);
  auto kernel = sw_i16_kernel<C, UNGAPPED, BIAS, MULTI, MODE>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, MULTI ? WARP * a.G : UNGAPPED ? WARP : 2 * WARP, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C, bool UNGAPPED, bool BIAS, bool MULTI>
cudaError_t launch_i16_mode(const I16Args& a, cudaStream_t st) {
  if constexpr (UNGAPPED) {
    return launch_i16<C, true, BIAS, MULTI, I16_FULL>(a, st);
  } else {
    if (a.S >= 2 * WARP * C) return launch_i16<C, false, BIAS, MULTI, I16_FULL>(a, st);
    if (a.S >= C) return launch_i16<C, false, BIAS, MULTI, I16_LANES>(a, st);
    return launch_i16<C, false, BIAS, MULTI, I16_STEPS>(a, st);
  }
}

// Words a lane (C) by target width and mode, a pair taking ceil(Lt / 64C)
// warps (one up to 64C columns): the fastest of 2, 4 and 8 at I16_SHAPES
// (the sweep in PERF.md: scripts/torch_sw_bench.py --dp-dtype i16 --sweep
// times copies of this file with this table replaced).  Only the (C,
// multi-warp) pairs named here are compiled.
template <bool BIAS>
cudaError_t dispatch_i16(const I16Args& a, bool ungapped, cudaStream_t st) {
  if (ungapped) {
    if (a.Lt <= 128) return launch_i16_mode<2, true, BIAS, false>(a, st);
    if (a.Lt <= 1024) return launch_i16_mode<2, true, BIAS, true>(a, st);
    return launch_i16_mode<8, true, BIAS, true>(a, st);
  }
  if (a.Lt <= 128) return launch_i16_mode<2, false, BIAS, false>(a, st);
  if (a.Lt <= 256) return launch_i16_mode<4, false, BIAS, false>(a, st);
  if (a.Lt <= 1024) return launch_i16_mode<2, false, BIAS, true>(a, st);
  return launch_i16_mode<8, false, BIAS, true>(a, st);
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
  const I16Args a{qa, qs, ta, ts, qlen, tlen, qc, saa, s3d, go, ge, w_aa, w_3di, pad_v,
                  B, Lq, Lt, S, 0, best, qend, tend};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = qc != nullptr ? dispatch_i16<true>(a, ungapped != 0, st)
                                      : dispatch_i16<false>(a, ungapped != 0, st);
  return (int)e;
}

// Largest target width the kernel takes.
extern "C" int sw_forward_max_lt() { return MAX_LT; }
