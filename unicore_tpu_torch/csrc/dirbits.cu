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
// The terms are those of the plain versions, in their order: no regrouping.
// Where go < ge the "E scan from h0" is not Gotoh's E; it is reproduced as
// it stands.  INT_NEG = -2^28 leaves headroom: with |S| <= 2^15 (int16, or
// the callers' int32 merge scores), go, ge < 2^16 and L < 2^14, no sum of
// the recurrence leaves int32.
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
// But the rows are serial, each a chain of two prefix-max scans across the
// row, so what keeps a pair from that floor is the latency of a row, and a
// merge batch (8-64 pairs) fills a fraction of the 132 SMs.
//
// What the design does about it:
//   * one block per pair, thread t owning the contiguous columns
//     [t*C + 1, t*C + C] of a tile of blockDim.x * C columns; H and F of
//     the previous row stay in registers where the row is one tile
//     (L2 <= TILE = 4,096), the diagonal neighbour is the left register,
//     and for a thread's first column the left thread's last H of the
//     previous row, kept from the row before;
//   * each scan runs in registers over the thread's C columns, then as a
//     log-step shuffle scan across the warp, then across warps through
//     each warp's total in shared memory: one barrier per scan, two per
//     row tile; the prefixes start from G(0) = H[i][0] = 0;
//   * a row wider than TILE is walked in tiles of TILE columns, left to
//     right, carrying both prefix maxima and the last H into the next tile;
//     the rows' H and F then live in `scratch` (two rows, by parity);
//   * S is loaded one step ahead of its use; a thread's C bits go out as
//     one 8-byte store where the row allows it;
//   * the end cells are tracked in registers (the owner of column l2 for
//     the last column, every thread over its cells otherwise) and reduced
//     once per pair as (value, first index) keys.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int C = 8;                 // columns per thread
constexpr int WARP = 32;
constexpr int MAXT = 512;            // threads per block
constexpr int MAXW = MAXT / WARP;
constexpr int TILE = MAXT * C;       // the widest row held in registers
constexpr int INT_NEG = -(1 << 28);  // == ops/nw_device.py, ops/sw_bits.py INT_NEG
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* S;   // (B, L1, L2) int16 or int32
  int s16;         // S is int16
  const int* l1;   // (B,)
  const int* l2;   // (B,)
  int go, ge, B, L1, L2;
  uint8_t* bits;   // (B, L1, L2)
  int* end_i;
  int* end_j;
  int* score;
  int* scratch;    // (B, 2 parities, 2 (H, F), L2 + 1) where L2 > TILE, else null
};

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

// Prefix max across the block of one value per thread: `pre` is the max of
// `carry` and the totals of every earlier thread, `all` that of `carry` and
// every thread's.  One barrier; `wtot` is this scan's own buffer.
__device__ __forceinline__ void block_scan(int total, int carry, int* wtot, int lane, int w, int nw,
                                           int& pre, int& all) {
  int x = total;
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x = max(x, y);
  }
  const int ex = __shfl_up_sync(FULL, x, 1);
  if (lane == WARP - 1) wtot[w] = x;
  __syncthreads();
  pre = carry;
  all = carry;
  for (int v = 0; v < nw; ++v) {
    const int t = wtot[v];
    if (v < w) pre = max(pre, t);
    all = max(all, t);
  }
  if (lane > 0) pre = max(pre, ex);
}

template <bool LOCAL>
__global__ void __launch_bounds__(MAXT) dirbits_kernel(Args a) {
  __shared__ int wtot1[MAXW], wtot2[MAXW], wlast[MAXW];
  __shared__ unsigned long long red[2][MAXW];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP, nw = blockDim.x / WARP;
  const int L1 = a.L1, L2 = a.L2, go = a.go, ge = a.ge, gh = go - ge;
  const int l1 = min(max(a.l1[b], 0), L1), l2 = min(max(a.l2[b], 0), L2);
  const int tw = blockDim.x * C;
  const int ntiles = (L2 + tw - 1) / tw;
  const bool tiled = ntiles > 1;
  const bool vec = L2 % C == 0;  // every thread's bits are 8-byte aligned
  const size_t row0 = (size_t)b * L1;
  int* hbuf = tiled ? a.scratch + (size_t)b * 4 * (L2 + 1) : nullptr;  // [parity][H, F][L2 + 1]

  if (tiled) {
    for (int j = threadIdx.x; j <= L2; j += blockDim.x) {
      hbuf[j] = 0;
      hbuf[L2 + 1 + j] = INT_NEG;
    }
    if (threadIdx.x == 0) hbuf[2 * (L2 + 1)] = 0;  // parity 1's H[*][0]
    __syncthreads();
  }

  // S of step (i, tile), one step ahead; columns past L2 read 0
  auto load_s = [&](int i, int tile, int* s) {
    const int c0 = tile * tw + threadIdx.x * C;  // 0-based column of the first
    const size_t base = (row0 + i - 1) * L2;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c0 + c;
      s[c] = col < L2 ? (a.s16 ? (int)((const short*)a.S)[base + col] : ((const int*)a.S)[base + col]) : 0;
    }
  };

  int hp[C], fp[C];  // H and F of the previous row at the thread's columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    hp[c] = 0;
    fp[c] = INT_NEG;
  }
  int hdiag = 0;  // H of the previous row at the column left of the thread's first

  // end-cell trackers: NW the last column (value, row) and the last row
  // (value, column); SW the best cell (value, row, column)
  int cbest = INT_MIN, ci = 0, rbest = INT_MIN, rj = 0;
  int best = -1, bi = 0, bj = 0;

  int sn[C];
  load_s(1, 0, sn);
  for (int i = 1; i <= L1; ++i) {
    int carry1 = 0, carry2 = 0, carryH = 0;  // G(0) = H[i][0] = 0
    const int* hprev = tiled ? hbuf + ((i - 1) & 1) * 2 * (L2 + 1) : nullptr;
    int* hcur = tiled ? hbuf + (i & 1) * 2 * (L2 + 1) : nullptr;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int j0 = tile * tw + threadIdx.x * C + 1;  // the thread's first column, 1-based
      int s[C];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = sn[c];
      if (tile + 1 < ntiles) load_s(i, tile + 1, sn);
      else if (i < L1) load_s(i + 1, 0, sn);
      if (tiled) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          hp[c] = j <= L2 ? hprev[j] : 0;
          fp[c] = j <= L2 ? hprev[L2 + 1 + j] : INT_NEG;
        }
        hdiag = j0 - 1 <= L2 ? hprev[j0 - 1] : 0;
      }

      int F[C], h0[C], H[C], jg[C];
      int tot = INT_MIN, left = hdiag;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        jg[c] = (j0 + c) * ge;
        F[c] = max(hp[c] - go, fp[c] - ge);
        int h = max(left + s[c], F[c]);
        if (LOCAL) h = max(h, 0);
        h0[c] = h;
        left = hp[c];
        tot = max(tot, h + jg[c]);
      }
      int pre, all;
      block_scan(tot, carry1, wtot1, lane, w, nw, pre, all);
      carry1 = all;
      tot = INT_MIN;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        H[c] = max(h0[c], pre - (jg[c] + gh));
        pre = max(pre, h0[c] + jg[c]);
        tot = max(tot, H[c] + jg[c]);
      }

      // H(j0 - 1) of this row: the left lane's, the left warp's, or the
      // previous tile's last
      int hl = __shfl_up_sync(FULL, H[C - 1], 1);
      if (lane == WARP - 1) wlast[w] = H[C - 1];
      block_scan(tot, carry2, wtot2, lane, w, nw, pre, all);
      carry2 = all;
      if (lane == 0) hl = w ? wlast[w - 1] : carryH;
      carryH = wlast[nw - 1];

      unsigned long long packed = 0;
      left = hl;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int j = j0 + c;
        const int E = pre - (jg[c] + gh);
        unsigned v = (unsigned)(H[c] == E) | (unsigned)(H[c] == F[c]) << 1 |
                     (unsigned)(E == left - go) << 2 | (unsigned)(F[c] == hp[c] - go) << 3;
        if (LOCAL) v |= (unsigned)(H[c] == 0) << 4;
        packed |= (unsigned long long)v << (8 * c);
        pre = max(pre, H[c] + jg[c]);
        left = H[c];
        if (LOCAL) {
          if (i <= l1 && j <= l2 && H[c] > best) {
            best = H[c];
            bi = i - 1;
            bj = j - 1;
          }
        } else {
          if (i <= l1 && j == l2 && H[c] > cbest) {
            cbest = H[c];
            ci = i;
          }
          if (i == l1 && j <= l2 && H[c] > rbest) {
            rbest = H[c];
            rj = j;
          }
        }
      }
      uint8_t* out = a.bits + (row0 + i - 1) * L2 + (j0 - 1);
      if (vec && j0 - 1 + C <= L2) {
        *reinterpret_cast<unsigned long long*>(out) = packed;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (j0 + c <= L2) out[c] = (uint8_t)(packed >> (8 * c));
      }

      if (tiled) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int j = j0 + c;
          if (j <= L2) {
            hcur[j] = H[c];
            hcur[L2 + 1 + j] = F[c];
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          hp[c] = H[c];
          fp[c] = F[c];
        }
        hdiag = hl;
      }
    }
  }

  // reduce the trackers: NW keys (value, row) and (value, column) with row 0
  // and column 0 at 0; SW (value, row-major index)
  unsigned long long k0, k1;
  if (LOCAL) {
    k0 = best >= 0 ? key_of(best, (unsigned)bi * (unsigned)L2 + (unsigned)bj) : 0ull;
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
  if (threadIdx.x == 0) {
    for (int v = 0; v < nw; ++v) {
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

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// `scratch` holds dirbits_forward_scratch_ints(B, L2) int32 (null where
// that is 0).  l1 and l2 are clamped to [0, L1] and [0, L2].
extern "C" int dirbits_forward_launch(
    const void* S, int s_int16, const int* l1, const int* l2, int go, int ge,
    int B, int L1, int L2, int local,
    uint8_t* bits, int* end_i, int* end_j, int* score, int* scratch, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (L1 <= 0 || L2 <= 0 || (unsigned long long)L1 * (unsigned long long)L2 >= (1ull << 31))
    return (int)cudaErrorInvalidValue;
  if (L2 > TILE && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = L2 > TILE ? MAXT : ((L2 + C - 1) / C + WARP - 1) / WARP * WARP;
  const Args a{S, s_int16 != 0, l1, l2, go, ge, B, L1, L2, bits, end_i, end_j, score, scratch};
  cudaStream_t st = (cudaStream_t)stream;
  if (local)
    dirbits_kernel<true><<<B, threads, 0, st>>>(a);
  else
    dirbits_kernel<false><<<B, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// int32 of scratch the launch needs: two rows of H and F per pair where a
// row is wider than one tile.
extern "C" long long dirbits_forward_scratch_ints(int B, int L2) {
  return L2 > TILE ? (long long)B * 4 * ((long long)L2 + 1) : 0;
}
