// Affine direction-bit DP for Hopper, sm_90a: the MSA merge's semi-global
// NW forward and the m8 traceback's local SW forward, one template with a
// compile-time LOCAL flag.
//
// Replaces two XLA programs of the JAX package, each a lax.scan over the DP
// rows that XLA compiles into one TPU program (neither is a Pallas kernel):
//   LOCAL = false: unicore_tpu/ops/nw_device.py::nw_forward_bits
//                  (the port's plain version: ops/nw_device.py::nw_forward_bits);
//   LOCAL = true:  unicore_tpu/ops/sw_bits.py::sw_forward_bits
//                  (the port's plain version: ops/sw_bits.py::sw_forward_bits).
// For each pair it writes the direction bits of every cell of its (L1, L2)
// score matrix, padded cells included, and the end cell and score,
// bit-identical to the plain version on every input.
//
// The recurrence, as the plain versions write it (1-based DP coordinates,
// H[0][*] = H[*][0] = 0, F[0][*] = INT_NEG; all int32):
//   F(j)     = max(H[i-1][j] - go, F[i-1][j] - ge)
//   h0(j)    = max(H[i-1][j-1] + S[i-1][j-1], F(j))     (then max(., 0) when LOCAL)
//   Escan(j) = max(0, max_{1<=k<j} h0(k) + k*ge) - (j*ge + go - ge)
//   H(j)     = max(h0(j), Escan(j))
//   E(j)     = max(0, max_{1<=k<j} H(k) + k*ge) - (j*ge + go - ge)
//   bit0 H==E, bit1 H==F, bit2 E==H(j-1)-go, bit3 F==H[i-1][j]-go,
//   bit4 H==0 (LOCAL only).
// Where go >= ge, E(j) == Escan(j): H(k) + k*ge is the larger of h0(k) + k*ge
// and Escan(k) + k*ge = P(k) - (go - ge) <= P(k), with P(k) the (monotone)
// prefix max of h0 + m*ge over m < k, so the prefix max of H + k*ge is that
// of h0 + k*ge.  The kernel then carries one prefix a row (ONESCAN); where
// go < ge the "E scan from h0" is not Gotoh's E, and a second prefix, of
// H + k*ge, reproduces the plain versions as they stand.  INT_NEG = -2^28 leaves headroom: with
// |S| <= 2^15 (int16, or the callers' int32 merge scores), go, ge < 2^16
// and L < 2^14, no sum of the recurrence leaves int32.
//
// End cells.  NW: the best of H over row l1 (columns 0..l2) and over column
// l2 (rows 0..l1), row 0 and column 0 counting as 0; the first maximum in
// each, the row winning ties.  SW: the row-major first maximum of H over
// rows < l1 and columns < l2 (0-based), or -1, -1, 0 where it is not
// positive.
//
// What bounds it on this card: bytes, nominally.  A cell reads 2 or 4
// bytes of S and writes 1 byte of bits against about 20 integer operations
// (24 when LOCAL): at 3.35 TB/s and 33.45 Tops/s the bytes take the longer.
// But each row is a prefix max from left to right and the rows are
// serial, so what keeps a pair from that floor is the latency of a row's
// chain; and a merge batch (1-64 pairs) fills at most half of the 132 SMs.
//
// What the design does about it: warps pipelined down the rows.
//   * one block per pair; lane l of warp w owns the C contiguous columns
//     [k*C + 1, k*C + C], k = 32*w + l, of a band of blockDim.x * C
//     columns, C = 2-8 from a table by row width (chip_smoke.py phase 3f's
//     sweep at the callers' batches: 4 to 16 warps from 256 columns on);
//     its H and F of the row above stay in registers.  Warp w works on row
//     s - LAG*w at step s, so the warps of a pair run LAG rows apart
//     instead of in lockstep on one row;
//   * in a row, a warp needs from the warp to its left only that warp's
//     prefix max of h0 + j*ge through its last column, its last H and,
//     with two prefixes, the second prefix.  The left warp publishes them
//     in a ring in shared memory; the block meets at a barrier every BP
//     steps and LAG = BP + 1, so a value is written before a barrier that
//     precedes its read (a step ahead of its use), and the ring's R = 2*BP
//     slots are not refilled before a barrier after the read.  No barrier
//     and no cross-warp reduction sits in a row's chain;
//   * within the warp the row's one chain is the prefix max of h0 + j*ge:
//     in registers over the lane's C columns, then a log-step shuffle scan
//     across the warp.  H(j0-1) for a lane's first column is max(h0(j0-1),
//     pre - ((j0-1)*ge + go - ge)) with `pre` the lane's own prefix before
//     j0: that prefix holds h0(j0-1) + (j0-1)*ge too, which adds h0(j0-1) -
//     (go - ge) <= h0(j0-1) to the max where go >= ge; so a lane needs only
//     its left lane's last h0 (a shuffle off the chain), and the warp's
//     first lane the left warp's last H;
//   * where go < ge (ONESCAN false, chosen by the launch from the gaps) a
//     second scan, of H + j*ge, gives Gotoh's E as the plain versions
//     compute it;
//   * a row wider than a band is walked band by band, the band's last lane
//     leaving its per-row values in `scratch` for the next band's first
//     warp (staged with its scores);
//   * S, its dtype a template parameter, is staged per lane: each lane
//     copies its own C scores of row r + DS (DS = 8 or 16) into its slot
//     of a ring in shared memory with cp.async (a warp's copies are one
//     contiguous run of the row; zero-filled past L2) where the rows are
//     aligned to the copy (the callers' widths), with plain copies
//     otherwise; only the lane reads them, so its wait_group is the only
//     synchronization.  Its next row's scores, and its warp's inputs from
//     the left for the next row, are read at the end of a step;
//   * a lane's C bits go out in one store where the row allows it, a
//     warp's stores one contiguous run;
//   * end cells: NW tracks the last column in its owner alone and the last
//     row in its step alone, SW every valid cell (the first maximum within
//     a band, then across bands by key); all are reduced once per pair as
//     (value, first index) keys.
// No runtime division, modulo or branch on the mode in the step loop.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int MAXW = 32;             // warps a block may have (1,024 threads)
constexpr int BP = 8;                // steps between block barriers (a power of two)
constexpr int LAG = BP + 1;          // rows a warp trails the warp to its left
constexpr int R = 2 * BP;            // slots of the warp-to-warp ring
constexpr int INT_NEG = -(1 << 28);  // == ops/nw_device.py, ops/sw_bits.py INT_NEG
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_LIMIT = 232448;   // shared memory a block can use

// Threads a block may have at C columns a lane (registers: 64 a thread at
// 1,024, 128 at 512).  A row of up to max_threads(C) * C columns is one
// band.
__host__ __device__ constexpr int max_threads(int C) { return C <= 2 ? 1024 : 512; }

template <typename T>
struct Args {
  const T* S;      // (B, L1, L2)
  const int* l1;   // (B,)
  const int* l2;   // (B,)
  int go, ge, B, L1, L2;
  int vec;         // S's rows are aligned to a lane's copy: cp.async
  uint8_t* bits;   // (B, L1, L2)
  int* end_i;
  int* end_j;
  int* score;
  int* scratch;    // (B, 2 band parities, 3 (P, H, Q), L1) where a row is several bands, else null
};

// C values of T as one aligned load
template <typename T, int C>
struct alignas(C * sizeof(T) < 16 ? C * sizeof(T) : 16) Vec {
  T x[C];
};

// Copy N bytes (4, 8 or 16) of global memory to shared memory, of which
// the first `valid` are read and the rest zero-filled.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N), "r"(valid)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (value, index) as one key whose maximum is the largest value at the
// lowest index; 0 is below every key of a real cell.
__device__ __forceinline__ unsigned long long key_of(int v, unsigned idx) {
  return (unsigned long long)((unsigned)v ^ 0x80000000u) << 32 | (unsigned)~idx;
}
__device__ __forceinline__ int key_value(unsigned long long k) {
  return (int)((unsigned)(k >> 32) ^ 0x80000000u);
}
__device__ __forceinline__ unsigned key_index(unsigned long long k) { return ~(unsigned)k; }

__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, k, o);
    k = x > k ? x : k;
  }
  return k;
}

// Inclusive prefix max of one value a lane across the warp (a lane below d
// gets its own value back from the shuffle, which leaves the max as it is).
__device__ __forceinline__ int warp_scan(int x) {
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) x = max(x, __shfl_up_sync(FULL, x, d));
  return x;
}

// Rows of S a lane stages ahead (a power of two): 16, or 8 where a lane's
// row is 32 bytes or more, which keeps the ring within 128 KB a block.
template <typename T, int C>
__host__ __device__ constexpr int stage_rows() { return C * sizeof(T) >= 32 ? 8 : 16; }

template <bool LOCAL, bool ONESCAN, typename T, int C>
__global__ void __launch_bounds__(C <= 2 ? 1024 : 512) dirbits_kernel(Args<T> a) {
  constexpr int DS = stage_rows<T, C>();
  static_assert(C >= 2, "a lane's scores are one copy of 4 bytes or more");
  constexpr int VB = C * (int)sizeof(T);  // bytes of a lane's scores in a row
  constexpr int CP = VB < 16 ? VB : 16;   // bytes a copy
  constexpr int NCP = VB / CP;            // copies a lane a row
  constexpr int EPC = CP / (int)sizeof(T);
  constexpr int NW4 = (C + 3) / 4;        // 4-byte words of a lane's bits
  extern __shared__ __align__(16) unsigned char smem[];  // [DS][threads * C] T: the lanes' staged S
  __shared__ __align__(16) int ring[MAXW][R][4];  // a warp's (P, H, Q) of its last column by row, for the next warp
  __shared__ __align__(16) int xring[16][4];      // band > 0: the previous band's (P, H, Q) by row, staged
  __shared__ unsigned long long red[2][MAXW];

  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t & (WARP - 1), w = t / WARP, G = nt / WARP;
  const int b = blockIdx.x;
  const int L1 = a.L1, L2 = a.L2, go = a.go, ge = a.ge, gh = go - ge;
  const int l1 = min(max(a.l1[b], 0), L1), l2 = min(max(a.l2[b], 0), L2);
  const int tw = nt * C;
  const int nbands = (L2 + tw - 1) / tw;
  const int off = LAG * w;  // the warp's row at step s is s - off
  const int nsteps = L1 + LAG * (G - 1);
  const bool one_store = L2 % C == 0;  // every lane's bits are aligned for whole words
  const size_t row0 = (size_t)b * L1;
  const T* Sb = a.S + row0 * L2;
  T* mine = reinterpret_cast<T*>(smem) + t * C;  // slot k at mine + k * tw
  int* xb = nbands > 1 ? a.scratch + (size_t)b * 6 * L1 : nullptr;  // [band parity][P, H, Q][row]

  // end-cell trackers: NW the last column (value, row) and the last row
  // (value, column); SW the best key over the bands done
  int cbest = INT_MIN, ci = 0, rbest = INT_MIN, rj = 0;
  unsigned long long skey = 0ull;

  for (int band = 0; band < nbands; ++band) {
    const int c0 = band * tw + t * C;  // the lane's first column, 0-based
    const int jg0 = (c0 + 1) * ge;
    const int valid = min(max((L2 - c0) * (int)sizeof(T), 0), VB);  // bytes of its scores in a row
    const int own = l2 - 1 - c0;  // NW: column l2 within the lane, where in [0, C)
    const int* xprev = band ? xb + ((band - 1) & 1) * 3 * L1 : nullptr;
    int* xcur = band + 1 < nbands ? xb + (band & 1) * 3 * L1 : nullptr;
    const bool from = w || band;  // the warp's inputs come from the left (else G(0) = H[i][0] = 0)

    // row r's scores, from src = S's row r + c0 (and, past the first band,
    // the previous band's values) into slot r & (DS - 1)
    auto stage = [&](int r, const T* src) {
      T* dst = mine + (r & (DS - 1)) * tw;
      if (a.vec) {
        if (!valid) src -= c0;  // nothing is read: an aligned address
#pragma unroll
        for (int k = 0; k < NCP; ++k)
          cp_async<CP>(dst + k * EPC, src + k * EPC, min(max(valid - k * CP, 0), CP));
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) dst[c] = c0 + c < L2 ? src[c] : (T)0;
      }
      if (band && t == 0) {
#pragma unroll
        for (int q = 0; q < 3; ++q) cp_async<4>(&xring[r & (DS - 1)][q], xprev + q * L1 + r, 4);
      }
    };
    const T* srcn = Sb + c0;  // S's row DS (after the prologue) at the lane's first column
#pragma unroll 1
    for (int k = 0; k < DS; ++k, srcn += L2) {
      if (k < L1) stage(k, srcn);
      cp_commit();
    }
    uint8_t* outp = a.bits + row0 * L2 + c0;  // the bits of the warp's next row at the lane's first column
    cp_wait<DS - 1>();  // this lane's copies of row 0
    __syncwarp();       // the warp's first lane's copies (xring) for its lanes
    // the lane's scores of its next row, and its warp's inputs from the
    // left for that row: read a step ahead
    Vec<T, C> sn = *reinterpret_cast<const Vec<T, C>*>(mine);
    int4 xn = *reinterpret_cast<const int4*>(xring[0]);

    int hp[C], fp[C];  // H and F of the row above at the lane's columns
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hp[c] = 0;
      fp[c] = INT_NEG;
    }
    int hdiag = 0;                  // H of the row above at the column left of the lane's first
    int best = -1, bi = 0, bj = 0;  // SW: the band's best cell

    for (int s = 0; s < nsteps; ++s) {
      if (G > 1 && (s & (BP - 1)) == 0) __syncthreads();
      const int r = s - off;  // 0-based row, the same for the warp's lanes
      if ((unsigned)r < (unsigned)L1) {
        const int Pw = from ? xn.x : 0;  // the prefix through the columns left of the warp's
        const int Hw = from ? xn.y : 0;  // H(j0 - 1) of the warp's first lane
        const int Qw = from ? xn.z : 0;  // the second prefix, likewise

        // h0 and its prefix max (+ j*ge) over the lane's columns
        int F[C], h0[C], P[C];
        int left = hdiag;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          F[c] = max(hp[c] - go, fp[c] - ge);
          int h = max(left + (int)sn.x[c], F[c]);
          if (LOCAL) h = max(h, 0);
          h0[c] = h;
          left = hp[c];
          const int v = h + (jg0 + c * ge);
          P[c] = c ? max(P[c - 1], v) : v;
        }
        const int h0L = __shfl_up_sync(FULL, h0[C - 1], 1);  // the left lane's last h0
        const int x = warp_scan(P[C - 1]);
        const int ex = __shfl_up_sync(FULL, x, 1);
        const int pre = lane ? max(Pw, ex) : Pw;  // the prefix before the lane's first column
        int H[C], E[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          E[c] = (c ? max(pre, P[c - 1]) : pre) - (jg0 + c * ge + gh);
          H[c] = max(h0[c], E[c]);
        }
        int hl;  // H(j0 - 1) of this row
        int Qout = 0;
        if (ONESCAN) {
          hl = lane ? max(h0L, pre - (jg0 - ge + gh)) : Hw;
        } else {
          // Gotoh's E: the prefix max of H + j*ge, a second warp scan
          int Q[C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int v = H[c] + (jg0 + c * ge);
            Q[c] = c ? max(Q[c - 1], v) : v;
          }
          const int x2 = warp_scan(Q[C - 1]);
          const int ex2 = __shfl_up_sync(FULL, x2, 1);
          const int pre2 = lane ? max(Qw, ex2) : Qw;
#pragma unroll
          for (int c = 0; c < C; ++c) E[c] = (c ? max(pre2, Q[c - 1]) : pre2) - (jg0 + c * ge + gh);
          hl = __shfl_up_sync(FULL, H[C - 1], 1);
          hl = lane ? hl : Hw;
          Qout = max(Qw, x2);
        }

        // the warp's last column's values, for the warp to the right (or
        // the next band)
        if (lane == WARP - 1) {
          const int Pout = max(Pw, x);
          if (w + 1 < G) {
            int* y = ring[w][r & (R - 1)];
            y[0] = Pout;
            y[1] = H[C - 1];
            y[2] = Qout;
          } else if (xcur) {
            xcur[r] = Pout;
            xcur[L1 + r] = H[C - 1];
            xcur[2 * L1 + r] = Qout;
          }
        }

        // the bits, each selected straight into its place in the lane's words
        uint32_t pk[NW4];
#pragma unroll
        for (int q = 0; q < NW4; ++q) pk[q] = 0;
        left = hl;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int sh = 8 * (c % 4);
          uint32_t v = (H[c] == E[c] ? 1u << sh : 0u) | (H[c] == F[c] ? 2u << sh : 0u) |
                       (E[c] == left - go ? 4u << sh : 0u) | (F[c] == hp[c] - go ? 8u << sh : 0u);
          if (LOCAL) v |= H[c] == 0 ? 16u << sh : 0u;
          pk[c / 4] |= v;
          left = H[c];
        }
        if (one_store && c0 + C <= L2) {
          if (C == 2) *reinterpret_cast<uint16_t*>(outp) = (uint16_t)pk[0];
          else if (C == 4) *reinterpret_cast<uint32_t*>(outp) = pk[0];
          else *reinterpret_cast<uint2*>(outp) = make_uint2(pk[0], pk[NW4 - 1]);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (c0 + c < L2) outp[c] = (uint8_t)(pk[c / 4] >> (8 * (c % 4)));
        }
        outp += L2;

        if (LOCAL) {
          if (r < l1) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (c0 + c < l2 && H[c] > best) {
                best = H[c];
                bi = r;
                bj = c0 + c;
              }
            }
          }
        } else {
          if (r < l1 && (unsigned)own < (unsigned)C) {
            int v = H[0];
#pragma unroll
            for (int c = 1; c < C; ++c)
              if (c == own) v = H[c];
            if (v > cbest) {
              cbest = v;
              ci = r + 1;
            }
          }
          if (r == l1 - 1) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              if (c0 + c < l2 && H[c] > rbest) {
                rbest = H[c];
                rj = c0 + c + 1;
              }
            }
          }
        }

#pragma unroll
        for (int c = 0; c < C; ++c) {
          hp[c] = H[c];
          fp[c] = F[c];
        }
        hdiag = hl;
        if (r + DS < L1) stage(r + DS, srcn);
        srcn += L2;
        cp_commit();
        cp_wait<DS - 1>();  // this lane's copies of row r + 1
        sn = *reinterpret_cast<const Vec<T, C>*>(mine + ((r + 1) & (DS - 1)) * tw);
      }
      // the warp's inputs from the left for its next row: its left warp
      // wrote them at least BP steps ago, with a barrier since (in warp 0,
      // the staged band values, landed above)
      __syncwarp();
      xn = *reinterpret_cast<const int4*>(w ? ring[w - 1][(r + 1) & (R - 1)] : xring[(r + 1) & (DS - 1)]);
    }
    if (LOCAL && best >= 0) {
      const unsigned long long k = key_of(best, (unsigned)bi * (unsigned)L2 + (unsigned)bj);
      skey = k > skey ? k : skey;
    }
    __syncthreads();  // the band's values for the next band; the rings' reuse
  }

  // reduce the trackers: NW keys (value, row) and (value, column) with row 0
  // and column 0 at 0; SW (value, row-major index)
  unsigned long long k0, k1;
  if (LOCAL) {
    k0 = skey;
    k1 = 0ull;
  } else {
    k0 = cbest > INT_MIN ? key_of(cbest, (unsigned)ci) : 0ull;
    k1 = rbest > INT_MIN ? key_of(rbest, (unsigned)rj) : 0ull;
  }
  k0 = warp_max_key(k0);
  k1 = warp_max_key(k1);
  if (lane == 0) {
    red[0][w] = k0;
    red[1][w] = k1;
  }
  __syncthreads();
  if (t == 0) {
    for (int v = 0; v < G; ++v) {
      k0 = red[0][v] > k0 ? red[0][v] : k0;
      k1 = red[1][v] > k1 ? red[1][v] : k1;
    }
    if (LOCAL) {
      const int v = k0 ? key_value(k0) : 0;
      const unsigned flat = key_index(k0);
      const bool found = v > 0;
      a.end_i[b] = found ? (int)(flat / (unsigned)L2) : -1;
      a.end_j[b] = found ? (int)(flat % (unsigned)L2) : -1;
      a.score[b] = found ? v : 0;
    } else {
      const unsigned long long base = key_of(0, 0u);  // H[0][l2] and H[l1][0]
      k0 = k0 > base ? k0 : base;
      k1 = k1 > base ? k1 : base;
      const int best_col = key_value(k0), best_row = key_value(k1);
      const bool row_wins = best_row >= best_col;
      a.end_i[b] = row_wins ? l1 : (int)key_index(k0);
      a.end_j[b] = row_wins ? (int)key_index(k1) : l2;
      a.score[b] = max(best_row, best_col);
    }
  }
}

// Threads of a block for a row of L2 columns at C columns a lane.
int threads_of(int L2, int C) {
  const int lanes = (L2 + C - 1) / C;
  return lanes > max_threads(C) ? max_threads(C) : (lanes + WARP - 1) / WARP * WARP;
}

template <bool LOCAL, bool ONESCAN, typename T, int C>
cudaError_t launch(const Args<T>& a, cudaStream_t st) {
  const int threads = threads_of(a.L2, C);
  const size_t smem = (size_t)stage_rows<T, C>() * threads * C * sizeof(T);
  if (smem > SMEM_LIMIT - 16 * 1024) return cudaErrorInvalidConfiguration;
  auto kernel = dirbits_kernel<LOCAL, ONESCAN, T, C>;
  // on every launch (the attribute is the current device's): with the
  // kernel's static shared memory, the ring may pass the default 48 KB
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.B, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool LOCAL, bool ONESCAN, typename T>
cudaError_t by_columns(const Args<T>& a, int C, cudaStream_t st) {
  switch (C) {
    case 2: return launch<LOCAL, ONESCAN, T, 2>(a, st);
    case 4: return launch<LOCAL, ONESCAN, T, 4>(a, st);
    case 8: return launch<LOCAL, ONESCAN, T, 8>(a, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_mode(const Args<T>& a, bool local, bool onescan, int C, cudaStream_t st) {
  if (local)
    return onescan ? by_columns<true, true, T>(a, C, st) : by_columns<true, false, T>(a, C, st);
  return onescan ? by_columns<false, true, T>(a, C, st) : by_columns<false, false, T>(a, C, st);
}

// Columns a lane (C) by row-width class (its upper L2), from chip_smoke.py
// phase 3f's sweep at the callers' full batches in both instances on an
// H100: C = 4 led from 1,024 to 2,048 columns (SW from 512), C = 8 is the
// one C of a single band at 4,096, and to 256 columns C = 2 led or tied
// within the sweep's spread.  C = 1 (twice C = 2's warps; its 2-byte
// scores copied in pairs of lanes) and C = 16 were built and swept, and
// lost or tied at every class (PERF.md).
struct Columns {
  int L2, C;
};
constexpr Columns TABLE[] = {{256, 2}, {2048, 4}, {INT_MAX, 8}};

int columns(int L2) {
  int n = 0;
  while (TABLE[n].L2 < L2) ++n;
  return TABLE[n].C;
}

// Whether the rows of S are aligned to a lane's copy at C columns a lane.
bool aligned(const void* S, int esize, int L2, int C) {
  const int cp = C * esize < 16 ? C * esize : 16;
  return ((size_t)L2 * esize) % cp == 0 && (uintptr_t)S % 16 == 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// One prefix a row where go >= ge (exact there), two otherwise; C (columns
// a lane: 2, 4 or 8) overrides the table where C > 0.  `scratch` holds
// dirbits_forward_scratch_ints(B, L1, L2, C) int32 (null where that is 0).
// l1 and l2 are clamped to [0, L1] and [0, L2].
extern "C" int dirbits_forward_launch(
    const void* S, int s_int16, const int* l1, const int* l2, int go, int ge,
    int B, int L1, int L2, int local, int C,
    uint8_t* bits, int* end_i, int* end_j, int* score, int* scratch, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (L1 <= 0 || L2 <= 0 || (unsigned long long)L1 * (unsigned long long)L2 >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  if (C <= 0) C = columns(L2);
  if (C != 2 && C != 4 && C != 8) return (int)cudaErrorInvalidValue;
  if (L2 > max_threads(C) * C && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int esize = s_int16 ? 2 : 4;
  const int vec = aligned(S, esize, L2, C);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (s_int16) {
    const Args<short> a{(const short*)S, l1, l2, go, ge, B, L1, L2, vec, bits, end_i, end_j, score, scratch};
    e = by_mode<short>(a, local != 0, go >= ge, C, st);
  } else {
    const Args<int> a{(const int*)S, l1, l2, go, ge, B, L1, L2, vec, bits, end_i, end_j, score, scratch};
    e = by_mode<int>(a, local != 0, go >= ge, C, st);
  }
  return (int)e;
}

// The table's C for a row of L2 columns.
extern "C" int dirbits_forward_columns(int L2) { return columns(max(L2, 1)); }

// int32 of scratch a launch at C columns a lane (0: the table's) needs:
// each band's per-row values (two bands' worth) where a row is wider than
// one band.
extern "C" long long dirbits_forward_scratch_ints(int B, int L1, int L2, int C) {
  if (C <= 0) C = columns(max(L2, 1));
  return L2 > max_threads(C) * C ? (long long)B * 6 * (long long)L1 : 0;
}
