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
// What bounds it on this card: operations, not bytes.  A pair reads
// 2*Lq + 2*Lt codes and writes 12 bytes, but does about 14 scalar
// operations on each of its qlen*W band cells (6 ungapped).  The rows are
// serial, so what keeps a pair from that floor is the latency of a row.
//
// What the design does about it:
//   * one block per pair (so the pair's row count is uniform in its block),
//     G = ceil(W / (32*C)) warps, lane t of warp w owning the contiguous band
//     columns [k0, k0 + C), k0 = (32*w + t)*C, with H, F, the per-column
//     best and its first row in registers.  The diagonal predecessor is the
//     same register; "up" is the next register, one __shfl_down_sync for the
//     lane's last column, and for a warp's last lane a value it recomputes
//     from what the next warp published (below);
//   * the target codes slide one column left per row: each lane shifts its
//     C code offsets by one register and loads only the code of its last
//     column, two rows ahead; the query codes run two rows ahead too; the
//     scores are gathers from the two weighted 21x21 matrices in shared
//     memory;
//   * the E window: S = the smallest power of two >= min(W, gap_window)
//     (W when gap_window is 0) covers exactly the plain version's log steps,
//     and Pexc[k] = max(prefix[k-1], suffix[k-S]) over segments of S columns
//     aligned at multiples of S (van Herk/Gil-Werman; max is exact, so any
//     cover of the window gives the same bits), plus NEG where the window
//     reaches left of column 0.  Segments inside a lane are scanned in
//     registers, segments of 2-32 lanes with log-step shuffles, segments of
//     whole warps through each warp's total in shared memory;
//   * a pair of G > 1 warps meets once per row at a barrier: before it each
//     warp publishes its last column's prefix (its total for segments of
//     whole warps), the suffix maxima a later warp's window reaches, and its
//     first column's H0 and F; after it the warp's last lane recomputes the
//     next warp's first H (same operations, same bits), which the next row's
//     "up" needs.  The records are double-buffered by row parity.
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
  float* best;
  int* qend;
  int* tend;
};

// A warp's record in a pair's row buffer (gapped mode, G > 1 or S <= C).
constexpr int R_LAST = 0;  // prefix max at the warp's last column (its total for whole-warp segments)
constexpr int R_H0F = 1;   // H0 of the warp's first column
constexpr int R_FF = 2;    // F of the warp's first column
constexpr int R_SUF = 4;   // suffix maxima within the segment, [c * 32 + lane]

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

template <int C, bool UNGAPPED, bool BIAS, int MAXT>
__global__ void __launch_bounds__(MAXT) banded_kernel(Args a) {
  constexpr int WW = WARP * C;  // columns of one warp
  constexpr int NW = MAXT / WARP;
  extern __shared__ float smem[];
  __shared__ float red_f[NW];
  __shared__ unsigned long long red_k[NW];

  const int G = blockDim.x / WARP;
  const int lane = threadIdx.x & (WARP - 1);
  const int w = threadIdx.x / WARP;
  const int b = blockIdx.x;
  const int Lq = a.Lq, Lt = a.Lt, W = a.W, S = a.S;
  const float go = a.go, ge = a.ge;
  const int rec = R_SUF + WW;
  float* mat = smem;                  // [0, 441) w_aa * saa, [441, 882) w_3di * s3d
  float* xbuf = smem + 2 * NA * NA;   // [parity][warp] records
  const char* sbase = reinterpret_cast<const char*>(smem);

  for (int k = threadIdx.x; k < NA * NA; k += blockDim.x) {
    mat[k] = a.w_aa * a.saa[k];
    mat[NA * NA + k] = a.w_3di * a.s3d[k];
  }
  __syncthreads();

  const int tlen = a.tlen[b], d0 = a.d0[b];
  const int ql = max(0, min(a.qlen[b], Lq));
  const int* qa_b = a.qa + (size_t)b * Lq;
  const int* qs_b = a.qs + (size_t)b * Lq;
  const int* qc_b = BIAS ? a.qc + (size_t)b * Lq : nullptr;
  const int* ta_b = a.ta + (size_t)b * Lt;
  const int* ts_b = a.ts + (size_t)b * Lt;

  int nrows = ql;
  if (!UNGAPPED) {
    // exact_dp (see the note at the top); every warp computes it alike
    bool integral = true;
    float amax = 0.f, smax = 0.f;
    for (int k = lane; k < NA * NA; k += WARP) {
      const float x = mat[k], y = mat[NA * NA + k];
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
                          && (double)ql * ((double)amax + (double)smax + qmax) + (double)W * ge
                             + (double)go + (double)ge < 16777216.0;
    if (!exact_dp) nrows = Lq;
  }

  // E-window mode: segments inside a lane, of m lanes, or of gs whole warps
  const bool inlane = S <= C;
  const bool warps = S >= WW;
  const bool lanes = !inlane && !warps;
  const int m = inlane ? 1 : (warps ? WARP : S / C);
  const int gs = warps ? S / WW : 1;
  const bool use_buf = !UNGAPPED && (G > 1 || inlane);

  const int k0 = w * WW + lane * C;  // the lane's first band column
  const int jbase = d0 - W / 2 + k0;  // its target column at row 0
  // byte offsets of each column's target codes in the two matrices: a score
  // is the gather at this plus the row's query offset
  int oa[C], os[C], br[C];
  float h[C], f[C], bb[C], jge[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = min(max(jbase + c, 0), Lt - 1);
    oa[c] = ta_b[j] * 4;
    os[c] = ts_b[j] * 4 + NA * NA * 4;
    h[c] = 0.f;
    f[c] = NEG;
    bb[c] = 0.f;
    br[c] = 0;
    jge[c] = (float)(k0 + c) * ge;
  }
  // the code of the lane's last column, rows ahead
  auto tcode = [&](int r, int& ca, int& cs) {
    const int j = min(max(r + jbase + C - 1, 0), Lt - 1);
    ca = ta_b[j];
    cs = ts_b[j];
  };
  auto qcode = [&](int r, int& ca, int& cs, int& q) {
    r = min(r, Lq - 1);
    ca = qa_b[r];
    cs = qs_b[r];
    q = BIAS ? qc_b[r] : 0;
  };
  int na1, ns1, na2, ns2;
  tcode(1, na1, ns1);
  tcode(2, na2, ns2);
  int qa0, qs0, q0, qa1, qs1, q1;
  qcode(0, qa0, qs0, q0);
  qcode(1, qa1, qs1, q1);
  float hr = 0.f, fr = NEG;  // H, F of the previous row at column k0 + C (a warp's last lane)

  for (int i = 0; i < nrows; ++i) {
    const int ra = qa0 * (NA * 4), rs = qs0 * (NA * 4);
    const int jf = i + jbase;
    const bool rowv = i < ql;
    const float qf = (float)q0;
    float s[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float x = *reinterpret_cast<const float*>(sbase + oa[c] + ra)
                + *reinterpret_cast<const float*>(sbase + os[c] + rs);
      if (BIAS) x = x + qf;
      const int j = jf + c;
      s[c] = rowv && j >= 0 && j < tlen ? x : NEG;
    }

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
        for (int d = 1; d < m; d <<= 1) {
          const float o = __shfl_up_sync(FULL, v, d);
          const float o2 = __shfl_down_sync(FULL, u, d);
          if (pos >= d) v = fmaxf(v, o);
          if (pos + d < m) u = fmaxf(u, o2);
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
        const int s0 = w - w % gs;
        if (s0 < w) {
          float t = rp[s0 * rec + R_LAST];
          for (int v = s0 + 1; v < w; ++v) t = fmaxf(t, rp[v * rec + R_LAST]);
#pragma unroll
          for (int c = 0; c < C; ++c) P[c] = fmaxf(P[c], t);
        }
      }
      // prefix at column k0 - 1
      float pl = __shfl_up_sync(FULL, P[C - 1], 1);
      if (lane == 0 && w > 0) {
        pl = rp[(w - 1) * rec + R_LAST];
        if (warps)
          for (int v = (w - 1) - (w - 1) % gs; v < w - 1; ++v) pl = fmaxf(pl, rp[v * rec + R_LAST]);
      }
      // suffix at column k - S (read only where k >= S)
      float q2[C];
      if (lanes) {
#pragma unroll
        for (int c = 0; c < C; ++c) q2[c] = __shfl_up_sync(FULL, U[c], m);
        if (lane < m && w > 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) q2[c] = rp[(w - 1) * rec + R_SUF + c * WARP + lane + WARP - m];
        }
      } else if (warps) {
        const int v = w - gs;
        if (v >= 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) q2[c] = rp[v * rec + R_SUF + c * WARP + lane];
          const int vend = v - v % gs + gs - 1;
          if (vend > v) {
            float t = rp[(v + 1) * rec + R_LAST];
            for (int u = v + 2; u <= vend; ++u) t = fmaxf(t, rp[u * rec + R_LAST]);
#pragma unroll
            for (int c = 0; c < C; ++c) q2[c] = fmaxf(q2[c], t);
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

      if (G > 1 && lane == WARP - 1 && w < G - 1) {
        // H of the next warp's first column e in this row, from its
        // records (the operations it does itself): the next row's "up"
        const int e = (w + 1) * WW;
        float q = NEG;
        if (e >= S) {
          const int col = e - S;
          q = suf_at<C>(rp, rec, col);
          if (warps) {
            const int v = col / WW;
            for (int u = v + 1; u <= v - v % gs + gs - 1; ++u) q = fmaxf(q, rp[u * rec + R_LAST]);
          }
        }
        const float E = ((fmaxf(P[C - 1], q) - go) + ge) - (float)e * ge;
        hr = fmaxf(rp[(w + 1) * rec + R_H0F], E);
        fr = rp[(w + 1) * rec + R_FF];
      }
    }

    // slide the target codes one column left; the query codes move up
#pragma unroll
    for (int c = 0; c < C - 1; ++c) {
      oa[c] = oa[c + 1];
      os[c] = os[c + 1];
    }
    oa[C - 1] = na1 * 4;
    os[C - 1] = ns1 * 4 + NA * NA * 4;
    na1 = na2;
    ns1 = ns2;
    tcode(i + 3, na2, ns2);
    qa0 = qa1;
    qs0 = qs1;
    q0 = q1;
    qcode(i + 2, qa1, qs1, q1);
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
  if (threadIdx.x == 0) {
    for (int v = 0; v < G; ++v) key = red_k[v] < key ? red_k[v] : key;
    const int bi = (int)(key >> 32), bk = (int)(key & 0xffffffffu);
    a.best[b] = mx;
    a.qend[b] = bi;
    a.tend[b] = min(max(bi + d0 + bk - W / 2, 0), Lt - 1);
  }
}

template <int C, bool UNGAPPED, bool BIAS, int MAXT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = (a.W + WARP * C - 1) / (WARP * C);
  const bool use_buf = !UNGAPPED && (G > 1 || a.S <= C);
  const size_t smem = (2 * NA * NA + (use_buf ? (size_t)2 * G * (R_SUF + WARP * C) : 0)) * sizeof(float);
  auto kernel = banded_kernel<C, UNGAPPED, BIAS, MAXT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<a.B, WARP * G, smem, stream>>>(a);
  return cudaGetLastError();
}

// Columns per lane (C) and the block's thread limit by band width and
// mode: a single warp per pair up to W = 512 (gapped), up to 16 warps.
template <bool BIAS>
cudaError_t dispatch(const Args& a, bool ungapped, cudaStream_t st) {
  if (ungapped) {
    if (a.W <= 256) return launch<8, true, BIAS, 32>(a, st);
    if (a.W <= 2048) return launch<8, true, BIAS, 256>(a, st);
    return launch<8, true, BIAS, 1024>(a, st);
  }
  if (a.W <= 128) return launch<4, false, BIAS, 32>(a, st);
  if (a.W <= 256) return launch<8, false, BIAS, 32>(a, st);
  if (a.W <= 512) return launch<16, false, BIAS, 32>(a, st);
  if (a.W <= 4096) return launch<16, false, BIAS, 256>(a, st);
  return launch<16, false, BIAS, 512>(a, st);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// The E window spans the smallest power of two >= min(W, gap_window)
// (W when gap_window is 0): the JAX log steps d = 1, 2, 4, ... < that.
extern "C" int banded_forward_launch(
    const int* qa, const int* qs, const int* ta, const int* ts,
    const int* qlen, const int* tlen, const int* d0, const int* qc,
    const float* saa, const float* s3d,
    float go, float ge, float w_aa, float w_3di,
    int B, int Lq, int Lt, int W, int gap_window, int ungapped,
    float* best, int* qend, int* tend, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Lq <= 0 || Lt <= 0 || W <= 0 || W > MAX_W || gap_window < 0) return (int)cudaErrorInvalidValue;
  const int limit = gap_window ? min(W, gap_window) : W;
  int S = 1;
  while (S < limit) S <<= 1;
  const Args a{qa, qs, ta, ts, qlen, tlen, d0, qc, saa, s3d, go, ge, w_aa, w_3di,
               B, Lq, Lt, W, S, best, qend, tend};
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = qc != nullptr ? dispatch<true>(a, ungapped != 0, st)
                                      : dispatch<false>(a, ungapped != 0, st);
  return (int)e;
}

// Widest band the kernel takes.
extern "C" int banded_forward_max_w() { return MAX_W; }
