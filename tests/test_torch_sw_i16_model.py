"""`kernel_model`, a numpy transliteration of csrc/sw.cu's int16 instance
(`sw_i16_kernel`: two int16 columns to a 32-bit word, a warp's block of
2*32*C columns folded in two), against the plain int16 DP
(ops/sw.py::sw_forward_i16) and JAX's `sw_forward_pallas(...,
dp_dtype="i16", interpret=True)` on the CPU; and the exhaustive check of the
kernel's score shortcut.  Inputs from a numpy seed; bit-identical on (best,
qend, tend).  The kernel itself runs in tests/test_torch_sw_i16_cuda.py (on
the card)."""

import re

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch, random_pairs
from unicore_tpu.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu.ops import sw as jsw
from unicore_tpu_torch.ops import sw as tsw
from unicore_tpu_torch.ops import sw_cuda

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
LAYOUT = dict(batch_tile=16, unroll=1, segments=1)  # tests/test_torch_sw_i16.py's
NA = 21
PAD = NA
NEG_I16, H_CAP, NONE, FAST_MAX = -20000, 30000, -32768, 256
I16 = np.int16


# ---------------------------------------------------------------------------
# the kernel's decomposition, transliterated
# ---------------------------------------------------------------------------

def kernel_table(ungapped):
    """The kernel's table of words a lane (`dispatch_i16` in csrc/sw.cu),
    read from the source: per mode, a chain of (Lt limit, words, whether
    the instance is the multi-warp one), the last limit None."""
    body = re.search(r"cudaError_t dispatch_i16\(.*?\n\}", sw_cuda.SOURCE.read_text(), re.S).group(0)
    ungapped_, gapped = body.split("\n  }\n", 1)
    rows = re.findall(r"(?:if \(a\.Lt <= (\d+)\) )?return launch_i16_mode<(\d+), (true|false), BIAS, (true|false)>",
                      ungapped_ if ungapped else gapped)
    assert rows and all(ug == ("true" if ungapped else "false") for _, _, ug, _ in rows)
    return [(int(limit) if limit else None, int(words), multi == "true") for limit, words, _, multi in rows]


def kernel_words(Lt, ungapped):
    """Words a lane the kernel's table gives a target of Lt columns."""
    return next(words for limit, words, _ in kernel_table(ungapped) if limit is None or Lt <= limit)


def bf16(x):
    """float32 rounded to bfloat16 (to nearest, ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def to_i16(x):
    """float32 -> int16 toward zero, saturating (`to_i16`, XLA's convert)."""
    return np.clip(np.trunc(np.asarray(x, np.float32)), -32768, 32767).astype(I16)


def score_fn(x):
    """A cell's score from its float32 sum: `to_i16(bf16_round(x))`."""
    return to_i16(bf16(x))


def wrap(x):
    """int -> int16, wrapping (the low 16 bits)."""
    return np.asarray(x, np.int64).astype(I16)


def rot(x, k, fill, WARP):
    """`rot`: every lane's word moved right by k virtual lanes (x: (G, WARP,
    ..., 2), the last axis the lo and hi halves): lane t takes lane t-k's
    word; a lane t < k takes lane t-k+WARP's lo half into its hi half (the
    seam) and `fill` (a scalar or one per warp) into its lo half."""
    assert 1 <= k <= WARP
    v = np.roll(x, k, axis=1)
    out = v.copy()
    out[:, :k, ..., 1] = v[:, :k, ..., 0]
    fill = np.asarray(fill, I16).reshape((-1,) + (1,) * (x.ndim - 2))
    out[:, :k, ..., 0] = fill
    return out


def kernel_model(qa, qs, ta, ts, qlen, tlen, saa, s3d, go=100.0, ge=10.0, w_aa=4.0, w_3di=6.0,
                 gap_window=0, ungapped=False, qc=None, C=None, WARP=32, MAX_WARPS=8, paths=None):
    """sw_i16_kernel step by step in numpy, per pair vectorized over its
    threads' words as (G warps, WARP lanes, C words, 2 halves): the tables
    in float and as ints, the fast and the per-cell score of row i + 1
    (the fast one asserted equal to the other where taken), F, H0 and t on
    words, the windowed max on virtual lanes in its three modes (rotations
    across the seam), the records each warp publishes before the pair's
    barrier (entries a row does not write are marked, so a read of one
    fails), what each warp reads after it, the recomputed diagonal at each
    warp's left edge (asserted equal to the H the warp to its left holds),
    the lanes' bests and the end reduction.  A row's score is the fast one
    where the tables, the target codes and the row allow it, in a gapped
    pair of one warp (its scoring warp decides row by row) and in an
    ungapped pair where every row the DP runs does (a vote before the
    first row); every other row's is the per-cell score.  C is the
    kernel's table's (`kernel_words`) unless given; WARP smaller than 32
    reaches every path at small widths.  `paths`, a set, gets the (mode,
    fast) pairs met.  Returns (best f32, qend i32, tend i32)."""
    f32 = np.float32
    B, Lq = qa.shape
    Lt = ta.shape[1]
    go, ge = int(go), int(ge)
    pad_v = tsw.i16_pad_value(w_aa, w_3di)
    limit = min(Lt, gap_window) if gap_window else Lt
    S = 1
    while S < limit and S < Lt:
        S <<= 1
    C = C or kernel_words(Lt, ungapped)
    W = WARP * C
    G = -(-Lt // (2 * W))
    assert G <= MAX_WARPS, (Lt, C, G)
    mode = "full" if S >= 2 * W else "lanes" if S >= C else "steps"
    m = S // C

    # the tables, as each block builds them: float, and the same as ints
    ftab = []
    for mtx, w in ((saa, w_aa), (s3d, w_3di)):
        t = np.full((NA + 1, NA + 1), -f32(pad_v), f32)
        t[:NA, :NA] = mtx
        ftab.append(bf16(t * f32(w)))
    itab = [np.trunc(t).astype(np.int64) for t in ftab]
    ok_tab = all((t[:NA, :NA] == np.rint(t[:NA, :NA])).all() for t in ftab)
    tmax = sum(int(min(np.abs(t[:NA, :NA]).max(), 65536)) for t in ftab)

    # the layout: word c of lane t of warp v holds column v*2W + t*C + c (lo)
    # and that + W (hi)
    col = (np.arange(G)[:, None, None, None] * 2 * W + np.arange(WARP)[None, :, None, None] * C
           + np.arange(C)[None, None, :, None] + np.array([0, W])[None, None, None, :])
    j0 = col[:, :, 0, 0]
    e = np.arange(G) * 2 * W
    jge = wrap(col * ge)
    neoff = wrap(-(col * ge + go - ge))
    # the cap on H, -32768 at or past Lt (ungapped: 32767, under a max with 0)
    capw = np.where(col < Lt, I16(32767 if ungapped else H_CAP), I16(NONE))
    best = np.zeros(B, f32)
    qend = np.zeros(B, np.int32)
    tend = np.zeros(B, np.int32)
    for b in range(B):
        ql = max(0, min(int(qlen[b]), Lq))
        tl = min(int(tlen[b]), Lt)
        valid_col = col < tl
        cidx = np.minimum(col, Lt - 1)
        a_col = np.where(valid_col, ta[b][cidx], PAD)
        s_col = np.where(valid_col, ts[b][cidx], PAD)
        ok = ok_tab and bool(((a_col < NA) & (s_col < NA) | ~valid_col).all())
        nrows = ql if ungapped or (go >= 0 and ge >= 0) else Lq

        def load(r):
            if r < ql:
                return int(qa[b, r]), int(qs[b, r]), int(qc[b, r]) if qc is not None else 0
            return PAD, PAD, 0

        def row_fast(r):
            ca, cs, q = load(r)
            qb = bf16(f32(q)) if qc is not None else f32(0)
            return ca < NA and cs < NA and abs(float(qb)) <= FAST_MAX - tmax

        pair_fast = ungapped and ok and all(row_fast(r) for r in range(nrows))

        def score(r):
            ca, cs, q = load(r)
            qb = bf16(f32(q)) if qc is not None else f32(0)
            x = ftab[0][ca][a_col] + ftab[1][cs][s_col]
            if qc is not None:
                x = x + qb
            slow = score_fn(x)
            fast = pair_fast if ungapped else G == 1 and ok and row_fast(r)
            if paths is not None and r < nrows:
                paths.add((mode, fast))
            if not fast:
                return slow
            xp = ftab[0][ca][PAD] + ftab[1][cs][PAD]
            if qc is not None:
                xp = xp + qb
            quick = wrap(itab[0][ca][a_col] + itab[1][cs][s_col] + int(qb))
            quick = np.where(valid_col, quick, score_fn(xp))
            assert np.array_equal(quick, slow), ("fast score differs", b, r)
            return quick

        h = np.zeros((G, WARP, C, 2), I16)
        f = np.full((G, WARP, C, 2), NEG_I16, I16)
        edge = np.zeros(G, I16)  # H[i-1][e - 1], the diagonal left of each warp
        lbest = np.zeros((G, WARP), np.int64)
        lrow = np.zeros((G, WARP), np.int64)
        lcol = j0.copy()

        def track(i):
            ms = h.reshape(G, WARP, 2 * C).max(axis=2).astype(np.int64)
            up = ms > lbest
            if up.any():
                # the lowest column holding it: lo halves first, then hi
                order = h.transpose(0, 1, 3, 2).reshape(G, WARP, 2 * C)
                first = np.argmax(order == ms[..., None], axis=2)
                cols = col.transpose(0, 1, 3, 2).reshape(G, WARP, 2 * C)
                got = np.take_along_axis(cols, first[..., None], axis=2)[..., 0]
                lbest[up], lrow[up], lcol[up] = ms[up], i, got[up]

        for i in range(nrows):
            sc = score(i)
            hl = rot(h[:, :, C - 1], 1, edge, WARP)
            diag = np.concatenate([hl[:, :, None], h[:, :, :C - 1]], axis=2)
            if ungapped:
                h = np.maximum(np.minimum(diag + sc, capw), I16(0))
                track(i)
                # each warp publishes its last column's H, the next one's diagonal
                edge = np.concatenate([[I16(0)], h[:-1, WARP - 1, C - 1, 1]]).astype(I16)
                continue

            f = np.maximum(h + wrap(-go), f + wrap(-ge))
            H0 = np.maximum(np.maximum(diag + sc, f), I16(0))
            P = H0 + jge
            suf = np.maximum.accumulate(P[:, :, ::-1], axis=2)[:, :, ::-1]
            if mode == "full":
                P = np.maximum.accumulate(P, axis=2)
                tot = P[:, :, C - 1]
                k = 1
                while k <= WARP:
                    tot = np.maximum(tot, rot(tot, k, NONE, WARP))
                    k <<= 1
                P = np.maximum(P, rot(tot, 1, NONE, WARP)[:, :, None])
            elif mode == "lanes":
                P = np.maximum.accumulate(P, axis=2)
                win = P[:, :, C - 1]
                k = 1
                while k < m >> 1:
                    win = np.maximum(win, rot(win, k, NONE, WARP))
                    k <<= 1
                mid = np.full_like(win, NONE)
                if m >= 2:
                    mid = np.maximum(rot(win, 1, NONE, WARP), rot(win, m >> 1, NONE, WARP))
                far = rot(suf[:, :, 1:], m, NONE, WARP)
                P[:, :, :C - 1] = np.maximum(np.maximum(P[:, :, :C - 1], mid[:, :, None]), far)
                P[:, :, C - 1] = np.maximum(P[:, :, C - 1], mid)
            else:
                d = 1
                while d < S:
                    assert d < C
                    frm = rot(P[:, :, C - d:], 1, NONE, WARP)
                    P[:, :, d:] = np.maximum(P[:, :, d:], P[:, :, :-d].copy())
                    P[:, :, :d] = np.maximum(P[:, :, :d], frm)
                    d <<= 1

            # the records: written before the barrier, read after it
            SUF = np.zeros((G, WARP, C, 2), I16)
            wrote = np.zeros((G, WARP), bool)
            TOT = np.full(G, 12345, I16)
            tot_wrote = np.zeros(G, bool)
            R_H0 = H0[:, WARP - 1, C - 1, 1]
            R_PW = P[:, WARP - 1, C - 2, 1]
            y = np.maximum.accumulate(suf[:, ::-1, 0], axis=1)[:, ::-1]  # lanes >= t, per half
            ex = np.concatenate([y[:, 1:], np.full((G, 1, 2), NONE, I16)], axis=1)
            for v in range(G - 1):
                if mode == "full":
                    top = y[v, 0]
                    TOT[v] = max(top[0], top[1])
                    tot_wrote[v] = True
                    hit = np.array([top[1], NONE], I16)
                    SUF[v] = np.maximum(np.maximum(suf[v], ex[v][:, None]), hit)
                    wrote[v] = True
                else:
                    first = WARP - (m if mode == "lanes" else 1)
                    SUF[v, first:] = np.maximum(suf[v, first:], ex[v, first:, None])
                    wrote[v, first:] = True

            def suf_at(v, lane):
                assert wrote[v, lane], ("read of an unwritten record", v, lane)
                return SUF[v, lane]

            def tot_of(v):
                assert tot_wrote[v], ("read of an unwritten total", v)
                return TOT[v]

            pe = np.concatenate([rot(P[:, :, C - 1], 1, NONE, WARP)[:, :, None], P[:, :, :C - 1]], axis=2)
            for w in range(1, G):
                if mode == "full":
                    v2 = w - S // (2 * W)
                    t = I16(NONE)
                    for v in range(max(v2 + 1, 0), w):
                        t = max(t, tot_of(v))
                    if v2 >= 0:
                        src = np.stack([suf_at(v2, ln) for ln in range(WARP)])
                        pe[w] = np.maximum(np.maximum(pe[w], src), t)
                    else:
                        pe[w] = np.maximum(pe[w], t)
                elif mode == "lanes":
                    for ln in range(m):
                        pe[w, ln, :, 0] = np.maximum(pe[w, ln, :, 0], suf_at(w - 1, WARP - m + ln)[:, 1])
                else:
                    for c in range(S):
                        pe[w, 0, c, 0] = max(pe[w, 0, c, 0], suf_at(w - 1, WARP - 1)[C - S + c, 1])
            if mode == "full":
                pe[e < S] = np.maximum(pe[e < S], I16(NEG_I16))
            elif mode == "lanes":
                pe[0, :m, :, 0] = np.maximum(pe[0, :m, :, 0], I16(NEG_I16))
            else:
                pe[0, 0, :S, 0] = np.maximum(pe[0, 0, :S, 0], I16(NEG_I16))

            h = np.minimum(np.maximum(pe + neoff, H0), capw)
            track(i)

            # each warp's left edge, recomputed from warp w-1's records
            new_edge = np.zeros(G, I16)
            for w in range(1, G):
                p = int(R_PW[w - 1])
                if mode == "full":
                    v2 = w - 1 - S // (2 * W)
                    for v in range(max(v2 + 1, 0), w - 1):
                        p = max(p, int(tot_of(v)))
                    if v2 >= 0:
                        p = max(p, int(suf_at(v2, WARP - 1)[C - 1, 1]))
                if e[w] - 1 < S:
                    p = max(p, NEG_I16)
                E = int(wrap(p - ((e[w] - 1) * ge + go - ge)))
                new_edge[w] = min(max(int(R_H0[w - 1]), E), H_CAP)
                assert new_edge[w] == h[w - 1, WARP - 1, C - 1, 1], ("edge", b, i, w)
            edge = new_edge

        valid = j0 < Lt
        mx = int(lbest[valid].max())
        keys = [(int(lrow[v, t]), int(lcol[v, t])) for v, t in zip(*np.nonzero(valid & (lbest >= mx)))]
        best[b], (qend[b], tend[b]) = mx, min(keys)
    return best, qend, tend


# ---------------------------------------------------------------------------
# the model against the plain int16 DP and JAX's interpret mode
# ---------------------------------------------------------------------------

def plain(arrays, qc=None, **kw):
    t = as_torch(*arrays, SAA, S3D, qc)
    return [x.numpy() for x in tsw.sw_forward_plain(*t[:8], qc=t[8], dp_dtype="i16", **kw)]


def model(arrays, qc=None, **kw):
    return list(kernel_model(*arrays, SAA, S3D, qc=qc, **kw))


def jax_i16(arrays, qc, **kw):
    out = jsw.sw_forward_pallas(*arrays, SAA, S3D, qc=qc, dp_dtype="i16", interpret=True, **LAYOUT, **kw)
    return [np.asarray(x) for x in out]


def assert_same(ref, got, what=""):
    for name, a, b in zip(("best", "qend", "tend"), ref, got):
        assert np.array_equal(a, b), (what, name, np.nonzero(a != b)[0][:8], a[a != b][:8], b[a != b][:8])


def held(arrays, qc=None, paths=None, **kw):
    """The model (and its path log) against the plain int16 DP."""
    mk = {k: kw.pop(k) for k in ("C", "WARP", "MAX_WARPS") if k in kw}
    got = model(arrays, qc, paths=paths, **mk, **kw)
    assert_same(plain(arrays, qc, **kw), got, (mk, kw))
    return got


MODES = {"w64": dict(gap_window=64), "w0": dict(gap_window=0), "ungapped": dict(ungapped=True)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("Lt", [60, 128, 256, 301])
def test_model_matches_plain_random(Lt, C, mode):
    """Random ragged pairs with planted homologies and bias, at every words
    a lane: one warp (Lt <= 64C) and several, Lt odd and not a multiple of
    a block (ge 10 up to 256 columns, 5 above: the int16 contract)."""
    rng = np.random.RandomState(Lt * 10 + C)
    arrays = random_pairs(rng, 6, 48, Lt, plant=48)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    held(arrays, qc, C=C, ge=10.0 if Lt <= 256 else 5.0, **MODES[mode])


@pytest.mark.parametrize("gw", [1, 2, 3, 4, 8, 16, 40, 64, 100, 128, 256, 1000])
@pytest.mark.parametrize("C", [2, 4, 8])
def test_model_every_window_small_warps(C, gw):
    """Warps of 4 lanes, so blocks of 8C columns: every windowed-max mode
    (S < C, C <= S <= W, S >= 2W), windows crossing the seam and one to
    several warps back, go > ge and go < ge, and a ge of -150, where
    t = H0 + j*ge falls below the window's outside (-20000) and E takes it."""
    rng = np.random.RandomState(C * 1000 + gw)
    arrays = random_pairs(rng, 4, 40, 150, plant=40)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    for go, ge in ((100.0, 10.0), (5.0, 12.0), (10.0, -150.0)):
        held(arrays, qc, C=C, WARP=4, MAX_WARPS=64, gap_window=gw, go=go, ge=ge)


def test_model_reaches_every_mode():
    seen = set()
    rng = np.random.RandomState(3)
    arrays = random_pairs(rng, 2, 20, 100, plant=20)
    for gw in (1, 8, 1000):
        held(arrays, None, C=4, WARP=4, MAX_WARPS=64, gap_window=gw, paths=seen)
    assert {m for m, _ in seen} == {"full", "lanes", "steps"}


@pytest.mark.parametrize("tl", [1, 63, 64, 65, 127, 128, 200, 255])
@pytest.mark.parametrize("mode", list(MODES))
def test_model_tlen_across_the_seam(mode, tl):
    """Self pairs whose target ends left of, at and right of the seam
    (column W = 128 at C = 4) and at the block's end."""
    qa = np.random.RandomState(tl).randint(0, 20, (1, 256)).astype(np.int32)
    qs = np.random.RandomState(tl + 1).randint(0, 20, (1, 256)).astype(np.int32)
    arrays = (qa[:, :200], qs[:, :200], qa, qs, np.array([200], np.int32), np.array([tl], np.int32))
    held(arrays, C=4, **MODES[mode])


@pytest.mark.parametrize("Lt", [255, 257, 513, 1023])
def test_model_odd_lt_multi_warp(Lt):
    rng = np.random.RandomState(Lt)
    arrays = random_pairs(rng, 3, 30, Lt, plant=30)
    for C in (2, 4):
        for mode in MODES:
            held(arrays, None, C=C, go=10.0, ge=1.0, **MODES[mode])


def self_pair(B, L, aa=17, tdi=10, lens=None):
    qa = np.full((B, L), aa, np.int32)
    qs = np.full((B, L), tdi, np.int32)
    ln = np.full(B, L, np.int32) if lens is None else np.asarray(lens, np.int32)
    return qa, qs, qa.copy(), qs.copy(), ln, ln.copy()


@pytest.mark.parametrize("ungapped,want", [(False, (30000.0, 288, 288)), (True, (32760.0, 314, 314))])
def test_model_cap_and_wrap_512_self_pair(ungapped, want):
    """chip_smoke.py's I16_CAP_PAIR: gapped H stops at 30,000 at (288,
    288); ungapped the diagonal reaches 32,760 at (314, 314) and wraps."""
    got = held(self_pair(1, 512), ge=1.0, ungapped=ungapped)
    assert (float(got[0][0]), int(got[1][0]), int(got[2][0])) == want


@pytest.mark.parametrize("mode", list(MODES))
def test_model_cells_past_150_with_bias(mode):
    """A bias of 255: cells of 359, rounded to 360, take the per-cell score;
    the capped H plus j*ge wraps in the E scan, the diagonal wraps."""
    arrays = self_pair(3, 128, lens=[128, 100, 77])
    qc = np.full((3, 128), 255, np.int32)
    qc[2, ::3] = -255
    seen = set()
    held(arrays, qc, go=40.0, ge=20.0, paths=seen, **MODES[mode])
    assert {fast for _, fast in seen} == {False}
    qc[0] = 7  # pair 0's rows all allow the fast score
    qc[1, 1:] = 7  # pair 1's all but its first
    seen.clear()
    held(arrays, qc, go=40.0, ge=20.0, paths=seen, **MODES[mode])
    assert {fast for _, fast in seen} == {False, True}


def test_model_near_the_lt_edge():
    """ge = 5 at Lt = 512 (Lt*ge + 30150 = 32710): the self pairs reach the
    cap and t = H0 + j*ge comes within 110 of int16's end."""
    rng = np.random.RandomState(5)
    qa, qs, ta, ts, ql, tl = random_pairs(rng, 3, 512, 512)
    ta[:2], ts[:2], tl[:2] = qa[:2], qs[:2], ql[:2]
    ql[0] = tl[0] = 512
    ta[1, ::7] = rng.randint(0, 20, len(ta[1, ::7]))
    got = held((qa, qs, ta, ts, ql, tl), go=12.0, ge=5.0)
    assert got[0][0] == 30000.0


def test_model_rows_past_qlen_run_where_a_gap_is_negative():
    """go < 0: every row runs, rows past qlen on the pad code (the per-cell
    score); ge < 0 too; qlen 0 and 1; go - ge = -20002, where column 0's E,
    -20000 - (go - ge), is positive."""
    rng = np.random.RandomState(11)
    arrays = list(random_pairs(rng, 4, 40, 100, minlen=1, plant=20))
    arrays[4][:2] = [0, 1]
    for go, ge in ((-3.0, 2.0), (6.0, -1.0), (-20001.0, 1.0)):
        for mode in ("w64", "w0"):
            held(arrays, go=go, ge=ge, **MODES[mode])


def test_model_weights_outside_the_fast_score():
    """Weights that make |aa| + |3di| > 256, and a pad code 21 in a valid
    target column: every row takes the per-cell score."""
    rng = np.random.RandomState(12)
    arrays = random_pairs(rng, 4, 40, 100, plant=30)
    seen = set()
    held(arrays, w_aa=40.0, w_3di=3.0, gap_window=64, paths=seen)
    assert {fast for _, fast in seen} == {False}
    ta = arrays[2].copy()
    ta[:, 3] = PAD
    seen.clear()
    held((arrays[0], arrays[1], ta, *arrays[3:]), gap_window=64, paths=seen)
    assert {fast for _, fast in seen} == {False}


@pytest.mark.parametrize("Lt,go,ge", [(1024, 10.0, 1.0), (2048, 10.0, 1.0), (4096, 10.0, 0.0)])
def test_model_wide_rows_at_the_kernel_table(Lt, go, ge):
    """The table's words a lane and 4 to 8 warps a pair, the windows at 64
    and the whole row, a few rows."""
    rng = np.random.RandomState(Lt)
    arrays = random_pairs(rng, 2, 12, Lt, minlen=8, plant=12)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    for mode in MODES:
        held(arrays, qc, go=go, ge=ge, **MODES[mode])


@pytest.mark.parametrize("mode", list(MODES))
def test_model_matches_jax_interpret(mode):
    """The model against JAX's Pallas kernel in interpret mode, at powers of
    two for Lt (where the Pallas kernel is right), bias on."""
    rng = np.random.RandomState(17)
    arrays = random_pairs(rng, 16, 64, 128)
    qc = rng.randint(-60, 40, arrays[0].shape).astype(np.int32)
    qc[3] = 255
    assert_same(jax_i16(arrays, qc, **MODES[mode]), model(arrays, qc, **MODES[mode]))


def test_model_ties_are_row_major():
    """Constant scores: many cells share the best; the lowest row, then the
    lowest column, across lanes, halves and warps."""
    qa = np.zeros((2, 30), np.int32)
    ta = np.zeros((2, 300), np.int32)
    arrays = (qa, qa.copy(), ta, ta.copy(), np.array([30, 5], np.int32), np.array([300, 170], np.int32))
    for C in (2, 4):
        for mode in MODES:
            held(arrays, C=C, go=10.0, ge=1.0, **MODES[mode])


@pytest.mark.parametrize("Lt", [1, 2, 3])
def test_model_tiny_targets(Lt):
    """Targets of 1 to 3 columns (most of the block past Lt), queries of
    1 to 5 rows, qlen and tlen 0 among them, every mode."""
    rng = np.random.RandomState(Lt)
    qa = rng.randint(0, 20, (6, 5)).astype(np.int32)
    ta = rng.randint(0, 20, (6, Lt)).astype(np.int32)
    ql = np.array([0, 1, 5, 3, 5, 2], np.int32)
    tl = np.array([Lt, Lt, 0, 1, Lt, Lt], np.int32)
    arrays = (qa, qa[:, ::-1].copy(), ta, ta.copy(), ql, tl)
    for mode in MODES:
        held(arrays, **MODES[mode])
        held(arrays, go=-3.0, ge=2.0, **MODES[mode])


def test_kernel_words_from_the_source():
    """The table gives 2, 4 or 8 words, at most 8 warps a pair up to
    MAX_LT, and the one-warp instance exactly where a warp's 64C columns
    hold the row."""
    for ungapped in (False, True):
        table = kernel_table(ungapped)
        assert table[-1][0] is None and all(limit for limit, _, _ in table[:-1])
        lows = [0] + [limit for limit, _, _ in table[:-1]]
        highs = [limit or sw_cuda.MAX_LT for limit, _, _ in table]
        for low, high, (_, words, multi) in zip(lows, highs, table):
            assert words in (2, 4, 8) and low < high and -(-high // (64 * words)) <= 8
            assert multi == (low >= 64 * words) and (multi or high <= 64 * words), (ungapped, low, high, words)
    assert [kernel_words(L, False) for L in (128, 129, 256, 257, 1024, 1025)] == [2, 4, 4, 2, 2, 8]
    assert [kernel_words(L, True) for L in (128, 129, 1024, 1025, 4096)] == [2, 2, 2, 8, 8]


# ---------------------------------------------------------------------------
# the score shortcut
# ---------------------------------------------------------------------------

def test_fast_score_exhaustive():
    """Every integer a fast row's cell can sum to (|x| <= 256) is its own
    score: `to_i16(bf16_round(x))` leaves it as it is, so four int gathers
    and two adds give the plain version's score.  And the per-cell score
    of every integer in [-70000, 70000] (the pad sentinel plus any bias
    that does not saturate both ways) equals torch's bfloat16 rounding and
    XLA's saturating conversion, as build_scores_i16 computes it."""
    x = np.arange(-FAST_MAX, FAST_MAX + 1)
    assert np.array_equal(score_fn(x.astype(np.float32)), x.astype(I16))
    wide = np.arange(-70000, 70001).astype(np.float32)
    ref = torch.from_numpy(wide).to(torch.bfloat16).float().clamp(-32768, 32767).to(torch.int16).numpy()
    assert np.array_equal(score_fn(wide), ref)
