// Banded Smith-Waterman forward pass (gapped and ungapped) for Hopper, sm_90a.
//
// Replaces the XLA program of unicore_tpu/ops/banded.py::sw_forward_banded
// (a lax.scan over the DP rows; the port's plain version is the row loop of
// unicore_tpu_torch/ops/banded.py::sw_forward_banded).  For each pair it
// returns the best local-alignment score on a band of W diagonals around
// the seed diagonal d0 and its end cell (best, qend, tend), bit-identical to
// the plain version on every input.
//
// Band coordinates: cell (i, k) is matrix cell (i, j), j = i + d0 + k - W/2.
// The diagonal predecessor (i-1, j-1) is column k of the previous row, the
// up predecessor (i-1, j) is column k+1 (NEG past the band's last column),
// and the query gap E is a windowed prefix max across the row, left to
// right, exactly as in ops/sw.py::_prefix_max.
//
// What bounds it on this card: the latency of a row.  A pair reads 2*Lq +
// 2*Lt codes and writes 12 bytes, and does about 14 scalar operations on
// each of its qlen*W band cells (6 ungapped): a launch's operations would
// take tens of microseconds at the card's scalar rate.  But a pair's rows
// are serial, each gapped row ends in a chain of dependent shuffles (the
// prefix max across the row), and a launch holds only 8-512 pairs, too few
// to give every scheduler of 132 SMs other work while a row waits.  So the
// time per row, not the work, sets the pace.
//
// What the design does about it:
//   * a pair is spread over G warps, G >= 4 at every W the engine sends
//     (128-2,048), so that each of its SM's four schedulers holds one of
//     its warps, with few columns a lane (C = 1-4 there; 8 and 16 for the
//     widest bands).  Lane t of warp w owns the band columns [k0, k0 + C),
//     k0 = (32*w + t)*C, with H, F, the per-column best and its first row
//     in registers.
//     The diagonal predecessor is the same register; "up" is the next
//     register, one __shfl_down_sync for the lane's last column, and for a
//     warp's last lane a value it recomputes from what the next warp
//     published (below).  A block is one pair, so the block's barrier
//     counts only that pair's warps.  The table (W class -> C) was chosen
//     on the card by chip_smoke.py phase 3e's sweep;
//   * the codes are staged in shared memory: before its first row a pair
//     copies the query codes of up to STAGE_ROWS + 1 rows and every target
//     code its band reaches in them, one byte a code ((aa, 3di) side by
//     side, clamped to [0, Lt) as the plain version's gather is), and the
//     bias qc in int32 beside them; a pair of more rows refills the window
//     between two barriers every STAGE_ROWS rows.  No device-memory load is
//     left in the row loop.  The scores of row i+1 (gathers from the two
//     weighted 21x21 matrices in shared memory) are formed during row i;
//   * the E window: S = the smallest power of two >= min(W, gap_window)
//     (W when gap_window is 0) covers exactly the plain version's log steps,
//     and Pexc[k] = max(prefix[k-1], suffix[k-S]) over segments of S columns
//     aligned at multiples of S (van Herk/Gil-Werman; max is exact, so any
//     cover of the window gives the same bits), plus NEG where the window
//     reaches left of column 0.  Segments inside a lane are scanned in
//     registers, segments of 2-32 lanes with log-step shuffles, segments of
//     whole warps through each warp's total in shared memory;
//   * in the gapped mode a pair's warps meet once per row at their barrier:
//     before it each warp publishes its last column's prefix (its total for
//     segments of whole warps), the suffix maxima a later warp's window
//     reaches, and its first column's H0 and F; after it the warp's last
//     lane recomputes the next warp's first H (same operations, same bits),
//     which the next row's "up" needs.  The records are double-buffered by
//     row parity.  The ungapped mode has no term across columns: its warps
//     meet only to refill the staged codes.
//
// Arithmetic: float32 in the plain version's operation order, compiled
// with -fmad=false: the score w_aa*saa + w_3di*s3d (the products held in
// shared memory), the bias as s + (float)qc in float32, NEG = -1e9 in place
// of the score of a cell outside [0, tlen) x [0, qlen), jge = (float)k * ge,
// E = ((Pexc - go) + ge) - jge.  Ties: the per-column best keeps the first
// row that reached it, and the end cell is the lowest (row, column) among
// the maxima: the plain version's first strictly larger row maximum and its
// lowest argmax.
//
// Rows past qlen score NEG.  The ungapped mode stops at qlen: there
// H = max(0, H + NEG) never exceeds an earlier H.  The gapped mode stops there
// only where that is exact (exact_dp): both weighted matrices hold integers,
// go and ge are integers >= 0 and qlen*(max|aa| + max|3di| + max|qc|)
// + W*ge + go + ge < 2^24, so every value on the non-negative side of the DP
// is an exact integer and no F or E of a later row can pass the best.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NA = 21;
constexpr float NEG = -1e9f;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_W = 8192;
constexpr int STAGE_ROWS = 2048;    // query rows whose codes are staged at a time
constexpr int MAT_BYTES = 3536;     // the two weighted matrices, 2*21*21 floats, padded to 16 bytes
constexpr int SMEM_LIMIT = 232448;  // shared memory a block can use

struct Args {
  const int* qa;
  const int* qs;
  const int* ta;
  const int* ts;
  const int* qlen;
  const int* tlen;
  const int* d0;
  const int* qc;      // (B, Lq) per-query-row score correction, or null
  const float* saa;   // (21, 21)
  const float* s3d;   // (21, 21)
  float go, ge, w_aa, w_3di;
  int B, Lq, Lt, W;
  int S;  // E window span: a power of two
  int R;  // rows staged at a time: min(Lq, STAGE_ROWS)
  float* best;
  int* qend;
  int* tend;
};

// A warp's record in a pair's row buffer (gapped mode, G > 1 or S <= C).
constexpr int R_LAST = 0;  // prefix max at the warp's last column (its total for whole-warp segments)
constexpr int R_H0F = 1;   // H0 of the warp's first column
constexpr int R_FF = 2;    // F of the warp's first column
constexpr int R_SUF = 4;   // suffix maxima within the segment, [c * 32 + lane]

// Byte offsets of the pair's region of shared memory (after the matrices):
// the end reduction's keys and maxima, the row records, the staged bias,
// query codes and target codes.
struct Layout {
  int red_k, red_f, xbuf, qcw, qw, tw, bytes;
};

__host__ __device__ inline Layout layout(int G, int C, int R, bool use_buf, bool bias) {
  Layout l;
  int o = 0;
  l.red_k = o;
  o += 8 * G;
  l.red_f = o;
  o += 4 * G;
  l.xbuf = o;
  o += use_buf ? 4 * 2 * G * (R_SUF + WARP * C) : 0;
  l.qcw = o;
  o += bias ? 4 * (R + 1) : 0;
  l.qw = o;
  o += 2 * (R + 1);
  l.tw = o;
  o += 2 * (R + G * WARP * C);
  l.bytes = (o + 15) & ~15;
  return l;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Suffix max (within its segment) of band column `col`, from the records.
template <int C>
__device__ __forceinline__ float suf_at(const float* rp, int rec, int col) {
  constexpr int WW = WARP * C;
  return rp[(col / WW) * rec + R_SUF + (col % C) * WARP + (col / C) % WARP];
}

// E-window modes (gapped): segments of S columns inside a lane, across m
// = S/C lanes of a warp, or of gs = S/(32*C) whole warps.
constexpr int INLANE = 0, LANES = 1, WARPS = 2;

template <int C, bool UNGAPPED, bool BIAS, int MODE, int MAXT>
__global__ void __launch_bounds__(MAXT) banded_kernel(Args a) {
  constexpr int WW = WARP * C;  // columns of one warp
  extern __shared__ __align__(16) unsigned char smem[];

  const int Lq = a.Lq, Lt = a.Lt, W = a.W, S = a.S, R = a.R;
  const int G = (W + WW - 1) / WW;
  const int nt = G * WARP;  // threads of the pair: the block
  const int t = threadIdx.x;
  const int lane = t & (WARP - 1);
  const int w = t / WARP;
  const int b = blockIdx.x;
  const float go = a.go, ge = a.ge;
  const int rec = R_SUF + WW;

  float* mat = reinterpret_cast<float*>(smem);  // [0, 441) w_aa * saa, [441, 882) w_3di * s3d
  for (int k = t; k < NA * NA; k += nt) {
    mat[k] = a.w_aa * a.saa[k];
    mat[NA * NA + k] = a.w_3di * a.s3d[k];
  }
  __syncthreads();

  constexpr bool inlane = MODE == INLANE, lanes = MODE == LANES, warps = MODE == WARPS;
  const int m = inlane ? 1 : (warps ? WARP : S / C);
  const int gs = warps ? S / WW : 1;  // a power of two: & (gs - 1) in place of % gs
  const bool use_buf = !UNGAPPED && (G > 1 || inlane);

  const Layout L = layout(G, C, R, use_buf, BIAS);
  unsigned char* base = smem + MAT_BYTES;
  unsigned long long* red_k = reinterpret_cast<unsigned long long*>(base + L.red_k);
  float* red_f = reinterpret_cast<float*>(base + L.red_f);
  float* xbuf = reinterpret_cast<float*>(base + L.xbuf);  // [parity][warp] records
  int* qcw = reinterpret_cast<int*>(base + L.qcw);         // staged qc, [row - r0]
  uchar2* qw = reinterpret_cast<uchar2*>(base + L.qw);     // staged (aa, 3di) of the query, [row - r0]
  uchar2* tw = reinterpret_cast<uchar2*>(base + L.tw);     // staged (aa, 3di) of the target, [j - (r0 + d0 - W/2)]

  const int tlen = a.tlen[b], d0 = a.d0[b];
  const int ql = max(0, min(a.qlen[b], Lq));
  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;
  const int* ta_b = a.ta + (size_t)b * Lt;
  const int* ts_b = a.ts + (size_t)b * Lt;

  // the codes of rows [r0, r0 + R] and of the target columns their band reaches
  auto stage = [&](int r0) {
    for (int e = t; e <= R; e += nt) {
      const int r = min(r0 + e, Lq - 1);
      qw[e] = make_uchar2((unsigned char)qa_b[r], (unsigned char)qs_b[r]);
      if (BIAS) qcw[e] = qc_b[r];
    }
    const int wlo = r0 + d0 - W / 2;
    for (int e = t; e < R + G * WW; e += nt) {
      const int j = min(max(wlo + e, 0), Lt - 1);
      tw[e] = make_uchar2((unsigned char)ta_b[j], (unsigned char)ts_b[j]);
    }
  };
  stage(0);

  int nrows = ql;
  bool integral = true;
  float amax = 0.f, smax = 0.f;
  if (!UNGAPPED) {
    // exact_dp (see the note at the top): the matrices' part in every warp
    // alike, max|qc| over the pair's threads
    for (int k = lane; k < NA * NA; k += WARP) {
      const float x = mat[k], y = mat[NA * NA + k];
      integral = integral && x == rintf(x) && y == rintf(y);
      amax = fmaxf(amax, fabsf(x));
      smax = fmaxf(smax, fabsf(y));
    }
    double qmax = 0.0;
    if (BIAS)
      for (int r = t; r < ql; r += nt) qmax = fmax(qmax, fabs((double)qc_b[r]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
      smax = fmaxf(smax, __shfl_xor_sync(FULL, smax, o));
      qmax = fmax(qmax, __shfl_xor_sync(FULL, qmax, o));
    }
    integral = __all_sync(FULL, integral);
    if (lane == 0) red_k[w] = (unsigned long long)__double_as_longlong(qmax);
  }
  __syncthreads();  // the staged codes and the warps' max|qc|
  if (!UNGAPPED) {
    double qmax = 0.0;
    for (int v = 0; v < G; ++v) qmax = fmax(qmax, __longlong_as_double((long long)red_k[v]));
    const bool exact_dp = integral && go >= 0.f && ge >= 0.f && go == rintf(go) && ge == rintf(ge)
                          && (double)ql * ((double)amax + (double)smax + qmax) + (double)W * ge
                             + (double)go + (double)ge < 16777216.0;
    if (!exact_dp) nrows = Lq;
  }

  const int k0 = w * WW + lane * C;   // the lane's first band column
  const int jbase = d0 - W / 2 + k0;  // its target column at row 0
  float h[C], f[C], bb[C], jge[C];
  int br[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h[c] = 0.f;
    f[c] = NEG;
    bb[c] = 0.f;
    br[c] = 0;
    jge[c] = (float)(k0 + c) * ge;
  }
  // the scores of row i, whose codes are at li = i - r0 of the window
  auto scores = [&](int i, int li, float (&s)[C]) {
    const uchar2 q = qw[li];
    const float* ma = mat + q.x * NA;
    const float* ms = mat + NA * NA + q.y * NA;
    const bool rowv = i < ql;
    const float qf = BIAS ? (float)qcw[li] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uchar2 tc = tw[li + k0 + c];
      float x = ma[tc.x] + ms[tc.y];
      if (BIAS) x = x + qf;
      const int j = i + jbase + c;
      s[c] = rowv && j >= 0 && j < tlen ? x : NEG;
    }
  };
  float s[C];
  scores(0, 0, s);
  float hr = 0.f, fr = NEG;  // H, F of the previous row at column k0 + C (a warp's last lane)
  int r0 = 0;

  for (int i = 0; i < nrows; ++i) {
    if (i - r0 == R) {
      // every warp of the pair is past its last read of the window
      __syncthreads();
      r0 = i;
      stage(r0);
      __syncthreads();
    }
    // the next row's scores: formed here, or in the warps mode after the
    // row (where the card measured that faster)
    float sn[C];
    if (!warps) scores(i + 1, i + 1 - r0, sn);

    if (UNGAPPED) {
      // every diagonal is its own Kadane chain: a column of the band
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float H = fmaxf(0.f, h[c] + s[c]);
        const bool up = H > bb[c];
        bb[c] = up ? H : bb[c];
        br[c] = up ? i : br[c];
        h[c] = H;
      }
    } else {
      float hn = __shfl_down_sync(FULL, h[0], 1), fn = __shfl_down_sync(FULL, f[0], 1);
      if (lane == WARP - 1) {
        hn = hr;
        fn = fr;
      }
      float F[C], H0[C], P[C], U[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const bool in = k0 + c + 1 < W;
        const float hu = in ? (c < C - 1 ? h[c + 1] : hn) : NEG;
        const float fu = in ? (c < C - 1 ? f[c + 1] : fn) : NEG;
        F[c] = fmaxf(hu - go, fu - ge);
        H0[c] = fmaxf(0.f, fmaxf(h[c] + s[c], F[c]));
        P[c] = H0[c] + jge[c];
      }
      // segmented suffix (U) and prefix (P) maxima of H0 + j*ge
      U[C - 1] = P[C - 1];
#pragma unroll
      for (int c = C - 2; c >= 0; --c)
        U[c] = inlane && ((c + 1) & (S - 1)) == 0 ? P[c] : fmaxf(U[c + 1], P[c]);
#pragma unroll
      for (int c = 1; c < C; ++c)
        if (!(inlane && (c & (S - 1)) == 0)) P[c] = fmaxf(P[c - 1], P[c]);
      if (!inlane) {
        const int pos = lane & (m - 1);
        float v = P[C - 1], u = U[0];
        // five rounds in every mode: past m they change nothing, and a
        // branch on m costs more on the card than the rounds
#pragma unroll
        for (int d = 1; d < WARP; d <<= 1) {
          const float o = __shfl_up_sync(FULL, v, d);
          const float o2 = __shfl_down_sync(FULL, u, d);
          v = pos >= d ? fmaxf(v, o) : v;
          u = pos + d < m ? fmaxf(u, o2) : u;
        }
        const float ex = __shfl_up_sync(FULL, v, 1);
        const float exs = __shfl_down_sync(FULL, u, 1);
        if (pos > 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) P[c] = fmaxf(P[c], ex);
        }
        if (pos < m - 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) U[c] = fmaxf(U[c], exs);
        }
      }

      float* rp = xbuf + (i & 1) * G * rec;  // this row's records
      if (use_buf) {
        float* r = rp + w * rec;
        if (lane == WARP - 1) r[R_LAST] = P[C - 1];
        if (lane == 0) {
          r[R_H0F] = H0[0];
          r[R_FF] = F[0];
        }
        // in the lanes mode only the last m lanes are read across warps
        if (!lanes || lane >= WARP - m) {
#pragma unroll
          for (int c = 0; c < C; ++c) r[R_SUF + c * WARP + lane] = U[c];
        }
        __syncthreads();
      }

      // whole-warp segments: the totals of the earlier warps of the segment
      if (warps && G > 1) {
        const int s0 = w & ~(gs - 1);
        if (s0 < w) {
          float tot = rp[s0 * rec + R_LAST];
          for (int v = s0 + 1; v < w; ++v) tot = fmaxf(tot, rp[v * rec + R_LAST]);
#pragma unroll
          for (int c = 0; c < C; ++c) P[c] = fmaxf(P[c], tot);
        }
      }
      // prefix at column k0 - 1: lane 0 of a warp w > 0 takes warp w-1's
      // (every lane reads it: one broadcast, no divergent branch)
      float pl = __shfl_up_sync(FULL, P[C - 1], 1);
      if (use_buf && w > 0) {
        float prev = rp[(w - 1) * rec + R_LAST];
        if (warps)
          for (int v = (w - 1) & ~(gs - 1); v < w - 1; ++v) prev = fmaxf(prev, rp[v * rec + R_LAST]);
        pl = lane == 0 ? prev : pl;
      }
      // suffix at column k - S (read only where k >= S)
      float q2[C];
      if (lanes) {
#pragma unroll
        for (int c = 0; c < C; ++c) q2[c] = __shfl_up_sync(FULL, U[c], m);
        if (w > 0) {
          const float* prev = rp + (w - 1) * rec + R_SUF + WARP - m + (lane < m ? lane : 0);
#pragma unroll
          for (int c = 0; c < C; ++c) q2[c] = lane < m ? prev[c * WARP] : q2[c];
        }
      } else if (warps) {
        const int v = w - gs;
        if (v >= 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) q2[c] = rp[v * rec + R_SUF + c * WARP + lane];
          const int vend = (v | (gs - 1));
          if (vend > v) {
            float tot = rp[(v + 1) * rec + R_LAST];
            for (int u = v + 2; u <= vend; ++u) tot = fmaxf(tot, rp[u * rec + R_LAST]);
#pragma unroll
            for (int c = 0; c < C; ++c) q2[c] = fmaxf(q2[c], tot);
          }
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) q2[c] = NEG;  // every k < S
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int col = k0 + c - S;
          q2[c] = col >= 0 ? suf_at<C>(rp, rec, col) : NEG;
        }
      }

#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = k0 + c;
        const float pp = c ? P[c - 1] : pl;
        const float pe = k == 0 ? NEG : fmaxf(pp, k < S ? NEG : q2[c]);
        const float E = ((pe - go) + ge) - jge[c];
        const float H = fmaxf(H0[c], E);
        const bool up = H > bb[c];
        bb[c] = up ? H : bb[c];
        br[c] = up ? i : br[c];
        h[c] = H;
        f[c] = F[c];
      }

      if (G > 1 && w < G - 1) {
        // H of the next warp's first column e in this row, from its
        // records (the operations it does itself): the next row's "up".
        // Every lane computes it from its own P[C-1]; the last lane's is
        // the one used.
        const int e = (w + 1) * WW;
        float q = NEG;
        if (e >= S) {
          const int col = e - S;
          if (warps && gs == 1) {
            q = __shfl_sync(FULL, U[0], 0);  // col is the warp's first column
          } else {
            q = suf_at<C>(rp, rec, col);
            if (warps) {
              const int v = col / WW;
              for (int u = v + 1; u <= (v | (gs - 1)); ++u) q = fmaxf(q, rp[u * rec + R_LAST]);
            }
          }
        }
        const float E = ((fmaxf(P[C - 1], q) - go) + ge) - (float)e * ge;
        hr = fmaxf(rp[(w + 1) * rec + R_H0F], E);
        fr = rp[(w + 1) * rec + R_FF];
      }
    }
    if (warps) scores(i + 1, i + 1 - r0, sn);
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = sn[c];
  }

  // best over the band's columns, then the lowest (row, column) holding it
  float mx = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (k0 + c < W) mx = fmaxf(mx, bb[c]);
  mx = warp_max(mx);
  if (lane == 0) red_f[w] = mx;
  __syncthreads();
  for (int v = 0; v < G; ++v) mx = fmaxf(mx, red_f[v]);
  unsigned long long key = ~0ull;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = k0 + c;
    if (k < W && bb[c] >= mx) {
      const unsigned long long kk = (unsigned long long)(unsigned)br[c] << 32 | (unsigned)k;
      key = kk < key ? kk : key;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, key, o);
    key = x < key ? x : key;
  }
  if (lane == 0) red_k[w] = key;
  __syncthreads();
  if (t == 0) {
    for (int v = 0; v < G; ++v) key = red_k[v] < key ? red_k[v] : key;
    const int bi = (int)(key >> 32), bk = (int)(key & 0xffffffffu);
    a.best[b] = mx;
    a.qend[b] = bi;
    a.tend[b] = min(max(bi + d0 + bk - W / 2, 0), Lt - 1);
  }
}

// Threads a block may have: a register budget of 128 a thread (64 at 1,024
// threads cost the 4-warp pairs of C = 2 a few per cent on the card).
constexpr int MAXT = 512;

template <int C, bool UNGAPPED, bool BIAS, int MODE>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = (a.W + WARP * C - 1) / (WARP * C);
  if (G * WARP > MAXT) return cudaErrorInvalidConfiguration;
  const bool use_buf = !UNGAPPED && (G > 1 || MODE == INLANE);
  const size_t smem = MAT_BYTES + (size_t)layout(G, C, a.R, use_buf, BIAS).bytes;
  if (smem > SMEM_LIMIT) return cudaErrorInvalidConfiguration;
  auto kernel = banded_kernel<C, UNGAPPED, BIAS, MODE, MAXT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, G * WARP, smem, stream>>>(a);
  return cudaGetLastError();
}

// The gapped mode's E-window mode by S and C; the ungapped mode has none.
template <int C, bool UNGAPPED, bool BIAS>
cudaError_t by_mode(const Args& a, cudaStream_t st) {
  if constexpr (UNGAPPED) {
    return launch<C, true, BIAS, INLANE>(a, st);
  } else {
    if (a.S <= C) return launch<C, false, BIAS, INLANE>(a, st);
    if (a.S < WARP * C) return launch<C, false, BIAS, LANES>(a, st);
    return launch<C, false, BIAS, WARPS>(a, st);
  }
}

template <bool UNGAPPED, bool BIAS>
cudaError_t by_columns(const Args& a, int C, cudaStream_t st) {
  switch (C) {
    case 1: return by_mode<1, UNGAPPED, BIAS>(a, st);
    case 2: return by_mode<2, UNGAPPED, BIAS>(a, st);
    case 4: return by_mode<4, UNGAPPED, BIAS>(a, st);
    case 8: return by_mode<8, UNGAPPED, BIAS>(a, st);
    case 16: return by_mode<16, UNGAPPED, BIAS>(a, st);
  }
  return cudaErrorInvalidValue;
}

// Columns a lane (C) by band-width class (its upper W) and mode, the
// fastest of chip_smoke.py phase 3e's sweep at the engine's batches.
struct Columns {
  int W, C;
};
constexpr Columns GAPPED_TABLE[] = {{128, 1}, {256, 2}, {384, 2}, {512, 4}, {1024, 4},
                                    {2048, 4}, {4096, 8}, {MAX_W, 16}};
constexpr Columns UNGAPPED_TABLE[] = {{128, 1}, {256, 2}, {384, 1}, {512, 4}, {1024, 2},
                                      {2048, 4}, {4096, 8}, {MAX_W, 16}};

int columns(int W, bool ungapped) {
  const Columns* table = ungapped ? UNGAPPED_TABLE : GAPPED_TABLE;
  int n = 0;
  while (table[n].W < W) ++n;
  return table[n].C;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The E window spans the smallest power of two >= min(W, gap_window)
// (W when gap_window is 0): the JAX log steps d = 1, 2, 4, ... < that.
// C (columns a lane) overrides the table where C > 0.
extern "C" int banded_forward_launch(
    const int* qa, const int* qs, const int* ta, const int* ts,
    const int* qlen, const int* tlen, const int* d0, const int* qc,
    const float* saa, const float* s3d,
    float go, float ge, float w_aa, float w_3di,
    int B, int Lq, int Lt, int W, int gap_window, int ungapped, int C,
    float* best, int* qend, int* tend, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lq <= 0 || Lt <= 0 || W <= 0 || W > MAX_W || gap_window < 0) return (int)cudaErrorInvalidValue;
  const int limit = gap_window ? min(W, gap_window) : W;
  int S = 1;
  while (S < limit) S <<= 1;
  if (C <= 0) C = columns(W, ungapped != 0);
  const Args a{qa, qs, ta, ts, qlen, tlen, d0, qc, saa, s3d, go, ge, w_aa, w_3di,
               B, Lq, Lt, W, S, min(Lq, STAGE_ROWS), best, qend, tend};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (ungapped)
    e = qc != nullptr ? by_columns<true, true>(a, C, st) : by_columns<true, false>(a, C, st);
  else
    e = qc != nullptr ? by_columns<false, true>(a, C, st) : by_columns<false, false>(a, C, st);
  return (int)e;
}

// The table's C for a band of W columns in a mode.
extern "C" int banded_forward_columns(int W, int ungapped) {
  return columns(min(max(W, 1), MAX_W), ungapped != 0);
}

// Widest band the kernel takes, and the rows it stages at a time.
extern "C" int banded_forward_max_w() { return MAX_W; }
extern "C" int banded_forward_stage_rows() { return STAGE_ROWS; }
