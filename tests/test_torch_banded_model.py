"""`kernel_model`, a numpy transliteration of csrc/banded.cu, against the
plain row loop (ops/banded.py::sw_forward_banded) and JAX's
sw_forward_banded on the CPU; the engine's banded batch size per route
(`banded_batch_size`), and the port's banded pass against JAX's when a
bucket holds more pairs than the plain route's cap.  Inputs from a numpy
seed; bit-identical.  The kernel itself runs in
tests/test_torch_banded_cuda.py (on the card)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import as_torch, port_env  # noqa: F401  (fixture)
from unicore_tpu.align import engine as jeng_mod
from unicore_tpu.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu.ops import banded as jb
from unicore_tpu_torch.align import engine as teng_mod
from unicore_tpu_torch.ops import banded as tb
from unicore_tpu_torch.ops.banded_cuda import STAGE_ROWS
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.synthetic import BANDED_EDGE_CASES, banded_edge_pairs

SAA = get_aa_matrix().astype(np.float32)
S3D = get_3di_matrix().astype(np.float32)
NA = 21


# ---------------------------------------------------------------------------
# the kernel's decomposition, transliterated
# ---------------------------------------------------------------------------

def _at(arr, idx):
    """arr[idx] where every index must lie inside arr (numpy would wrap a
    negative one): the kernel's shared-memory reads stay in their arrays."""
    idx = np.asarray(idx)
    assert idx.min() >= 0 and idx.max() < len(arr), (idx.min(), idx.max(), len(arr))
    return arr[idx]


def _shfl_up(x, d):
    """__shfl_up_sync over the lane axis (1) of (G, WARP[, C]): a lane below
    d keeps its own value."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def _shfl_down(x, d):
    y = x.copy()
    y[:, :-d] = x[:, d:]
    return y


def kernel_model(qa, qs, ta, ts, qlen, tlen, d0, saa, s3d, W, go=100.0, ge=10.0, w_aa=4.0,
                 w_3di=6.0, gap_window=0, ungapped=False, qc=None, C=2, WARP=32, R=STAGE_ROWS,
                 trace=None):
    """csrc/banded.cu step by step in numpy, vectorized over one pair's
    threads as (G warps, WARP lanes, C columns): the staged code windows of
    R rows (refilled when a pair runs past them), the scores of row i + 1
    formed during row i, the in-lane, across-lane and
    across-warp segmented prefix and suffix maxima of the E window, the
    records each warp publishes before the pair's barrier (double-buffered
    by row parity; entries a row does not write hold +inf, so a read of one
    shows), what each warp reads after it, the last lane's recomputation of
    the next warp's first H, and the end reduction over (row, column) keys;
    a block is one pair.  WARP and R are the kernel's (32, STAGE_ROWS) by
    default; smaller ones reach every path at small widths.  Returns (best f32, qend i32, tend i32); `trace`, a list, gets
    (pair, row, H, F) of every row run (F None when ungapped)."""
    f32 = np.float32
    NEG = f32(-1e9)
    B, Lq = qa.shape
    Lt = ta.shape[1]
    go, ge = f32(go), f32(ge)
    mat = np.concatenate([(f32(w_aa) * saa.astype(f32)).ravel(), (f32(w_3di) * s3d.astype(f32)).ravel()])
    limit = min(W, gap_window) if gap_window else W
    S = 1
    while S < limit:
        S <<= 1
    WW = WARP * C
    G = -(-W // WW)
    inlane, warps = S <= C, S >= WW
    lanes = not inlane and not warps
    m = 1 if inlane else (WARP if warps else S // C)
    gs = S // WW if warps else 1
    use_buf = not ungapped and (G > 1 or inlane)
    Rr = min(Lq, R)
    lane = np.arange(WARP)
    k0 = np.arange(G)[:, None] * WW + lane[None, :] * C       # (G, WARP)
    kk = k0[:, :, None] + np.arange(C)[None, None, :]           # (G, WARP, C) band columns
    jge = kk.astype(f32) * ge
    integral = bool(np.all(mat == np.rint(mat)))
    amax, smax = float(np.abs(mat[:NA * NA]).max()), float(np.abs(mat[NA * NA:]).max())
    best = np.zeros(B, f32)
    qend = np.zeros(B, np.int32)
    tend = np.zeros(B, np.int32)

    def suf_at(rp_suf, col):
        return rp_suf[col // WW, col % C, (col // C) % WARP]

    for b in range(B):  # a block: one pair
        tl_, dd = int(tlen[b]), int(d0[b])
        ql = max(0, min(int(qlen[b]), Lq))
        jbase = dd - W // 2 + kk

        def stage(r0):
            r = np.minimum(r0 + np.arange(Rr + 1), Lq - 1)
            j = np.clip(r0 + dd - W // 2 + np.arange(Rr + G * WW), 0, Lt - 1)
            qcw = None if qc is None else qc[b, r]
            return np.stack([qa[b, r], qs[b, r]], 1), qcw, np.stack([ta[b, j], ts[b, j]], 1)

        qw, qcw, tw = stage(0)
        nrows = ql
        if not ungapped:
            qmax = float(np.abs(qc[b, :ql].astype(np.float64)).max()) if qc is not None and ql else 0.0
            exact_dp = (integral and go >= 0 and ge >= 0 and go == np.rint(go) and ge == np.rint(ge)
                        and ql * (amax + smax + qmax) + W * float(ge) + float(go) + float(ge) < 2.0 ** 24)
            if not exact_dp:
                nrows = Lq

        def scores(i, li):
            q = _at(qw, li)
            t = _at(tw, li + kk)
            x = mat[q[0] * NA + t[..., 0]] + mat[NA * NA + q[1] * NA + t[..., 1]]
            if qcw is not None:
                x = x + f32(_at(qcw, li))
            j = i + jbase
            return np.where((i < ql) & (j >= 0) & (j < tl_), x, NEG).astype(f32)

        h = np.zeros((G, WARP, C), f32)
        f = np.full((G, WARP, C), NEG, f32)
        bb = np.zeros((G, WARP, C), f32)
        br = np.zeros((G, WARP, C), np.int64)
        hr, fr = np.zeros(G, f32), np.full(G, NEG, f32)
        # records by parity: R_LAST, R_H0F, R_FF per warp; R_SUF [warp, c, lane]
        xbuf = [dict(last=np.full(G, np.inf, f32), h0f=np.full(G, np.inf, f32),
                     ff=np.full(G, np.inf, f32), suf=np.full((G, C, WARP), np.inf, f32))
                for _ in range(2)]
        s = scores(0, 0)
        r0 = 0
        for i in range(nrows):
            if i - r0 == Rr:
                r0 = i
                qw, qcw, tw = stage(r0)
            sn = scores(i + 1, i + 1 - r0)
            if ungapped:
                H = np.maximum(f32(0), h + s)
                up = H > bb
                bb, br, h = np.where(up, H, bb), np.where(up, i, br), H
                s = sn
                if trace is not None:
                    trace.append((b, i, H.reshape(-1)[:W], None))
                continue
            hn, fn = _shfl_down(h[:, :, 0], 1), _shfl_down(f[:, :, 0], 1)
            hn[:, WARP - 1], fn[:, WARP - 1] = hr, fr
            inn = kk + 1 < W
            hu = np.where(inn, np.concatenate([h[:, :, 1:], hn[:, :, None]], 2), NEG)
            fu = np.where(inn, np.concatenate([f[:, :, 1:], fn[:, :, None]], 2), NEG)
            F = np.maximum(hu - go, fu - ge)
            H0 = np.maximum(f32(0), np.maximum(h + s, F))
            Pm = H0 + jge
            U = Pm.copy()
            for c in range(C - 2, -1, -1):
                if not (inlane and ((c + 1) & (S - 1)) == 0):
                    U[:, :, c] = np.maximum(U[:, :, c + 1], Pm[:, :, c])
            for c in range(1, C):
                if not (inlane and (c & (S - 1)) == 0):
                    Pm[:, :, c] = np.maximum(Pm[:, :, c - 1], Pm[:, :, c])
            if not inlane:
                pos = lane & (m - 1)
                v, u = Pm[:, :, C - 1].copy(), U[:, :, 0].copy()
                d = 1
                while d < m:
                    o, o2 = _shfl_up(v, d), _shfl_down(u, d)
                    v = np.where(pos >= d, np.maximum(v, o), v)
                    u = np.where(pos + d < m, np.maximum(u, o2), u)
                    d <<= 1
                ex, exs = _shfl_up(v, 1), _shfl_down(u, 1)
                Pm = np.where((pos > 0)[None, :, None], np.maximum(Pm, ex[:, :, None]), Pm)
                U = np.where((pos < m - 1)[None, :, None], np.maximum(U, exs[:, :, None]), U)

            rp = xbuf[i & 1]
            if use_buf:
                for key in rp:
                    rp[key][...] = np.inf  # what this row does not write
                rp["last"][:] = Pm[:, WARP - 1, C - 1]
                rp["h0f"][:] = H0[:, 0, 0]
                rp["ff"][:] = F[:, 0, 0]
                writers = lane >= WARP - m if lanes else np.ones(WARP, bool)
                rp["suf"][:, :, writers] = np.transpose(U, (0, 2, 1))[:, :, writers]
                # the pair's barrier
            last, suf = rp["last"], rp["suf"]

            if warps and G > 1:
                for w in range(G):
                    s0 = w - w % gs
                    if s0 < w:
                        Pm[w] = np.maximum(Pm[w], last[s0:w].max())
            pl = _shfl_up(Pm[:, :, C - 1], 1)
            for w in range(1, G):
                pl[w, 0] = last[w - 1]
                if warps:
                    for v in range((w - 1) - (w - 1) % gs, w - 1):
                        pl[w, 0] = max(pl[w, 0], last[v])
            if lanes:
                q2 = _shfl_up(U, m)
                for w in range(1, G):
                    q2[w, :m, :] = suf[w - 1][:, WARP - m:].T
            elif warps:
                q2 = np.empty_like(U)
                for w in range(G):
                    v = w - gs
                    if v >= 0:
                        q2[w] = suf[v].T
                        vend = v - v % gs + gs - 1
                        if vend > v:
                            q2[w] = np.maximum(q2[w], last[v + 1:vend + 1].max())
                    else:
                        q2[w] = NEG
            else:
                col = kk - S
                q2 = np.where(col >= 0, suf_at(suf, np.maximum(col, 0)), NEG)

            pp = np.concatenate([pl[:, :, None], Pm[:, :, :-1]], 2)
            pe = np.where(kk == 0, NEG, np.maximum(pp, np.where(kk < S, NEG, q2)))
            E = ((pe - go) + ge) - jge
            H = np.maximum(H0, E)
            up = H > bb
            bb, br, h, f = np.where(up, H, bb), np.where(up, i, br), H, F
            if trace is not None:
                trace.append((b, i, H.reshape(-1)[:W], F.reshape(-1)[:W]))
            for w in range(G - 1):
                e = (w + 1) * WW
                q = NEG
                if e >= S:
                    col = e - S
                    if warps and gs == 1:
                        q = U[w, 0, 0]  # col is the warp's first column: lane 0's, by a shuffle
                    else:
                        q = suf_at(suf, col)
                        if warps:
                            v = col // WW
                            for u in range(v + 1, v - v % gs + gs):
                                q = max(q, last[u])
                E1 = ((max(Pm[w, WARP - 1, C - 1], q) - go) + ge) - f32(e) * ge
                hr[w], fr[w] = max(rp["h0f"][w + 1], E1), rp["ff"][w + 1]
            s = sn

        inside = kk < W
        mx = max(f32(0), bb[inside].max())
        keys = np.where(inside & (bb >= mx), br << 32 | kk, np.iinfo(np.int64).max)
        key = int(keys.min())
        bi, bk = key >> 32, key & 0xFFFFFFFF
        best[b], qend[b] = mx, bi
        tend[b] = min(max(bi + dd + bk - W // 2, 0), Lt - 1)
    return best, qend, tend


WARP = 4  # small warps: a few columns reach several warps and every E-window mode
WIDTHS = [1, 3, 4, 5, 8, 9, 16, 17, 33, 40]
WINDOWS = [0, 1, 2, 3, 5, 8, 16, 64]


def _plain_rows(arrays, kw, saa=SAA):
    """H and F of every row of ops/banded.py::sw_forward_banded's loop
    (its body, keeping the rows), (B, W) each."""
    import torch.nn.functional as F

    from unicore_tpu_torch.ops.sw import NEG, _prefix_max

    qa, qs, ta, ts, qlen, tlen, d0, saa_t, s3d, qc = as_torch(*arrays[:7], saa, S3D, arrays[7])
    W, go, ge, window = kw["W"], kw["go"], kw["ge"], kw.get("gap_window", 0)
    ungapped = kw.get("ungapped", False)
    B, Lq = qa.shape
    Lt = ta.shape[1]
    i_idx = torch.arange(Lq, dtype=torch.int32)[None, :, None]
    J = i_idx + d0[:, None, None] + torch.arange(W, dtype=torch.int32)[None, None, :] - W // 2
    valid = (J >= 0) & (J < tlen[:, None, None]) & (i_idx < qlen[:, None, None])
    Jc = J.clamp(0, Lt - 1).long().reshape(B, -1)
    s = (4.0 * saa_t[qa.long()[:, :, None], torch.gather(ta.long(), 1, Jc).reshape(B, Lq, W)]
         + 6.0 * s3d[qs.long()[:, :, None], torch.gather(ts.long(), 1, Jc).reshape(B, Lq, W)])
    if qc is not None:
        s = s + qc[:, :, None].to(torch.float32)
    s = torch.where(valid, s, torch.tensor(NEG, dtype=torch.float32))
    jge = (torch.arange(W, dtype=torch.float32) * ge)[None, :]
    H = torch.zeros((B, W), dtype=torch.float32)
    Fm = torch.full((B, W), NEG, dtype=torch.float32)
    rows = []
    for i in range(Lq):
        if ungapped:
            H = torch.clamp_min(H + s[:, i, :], 0.0)
        else:
            Fm = torch.maximum(F.pad(H[:, 1:], (0, 1), value=NEG) - go,
                               F.pad(Fm[:, 1:], (0, 1), value=NEG) - ge)
            H0 = torch.clamp_min(torch.maximum(H + s[:, i, :], Fm), 0.0)
            P = _prefix_max(H0 + jge, window=window)
            H = torch.maximum(H0, F.pad(P[:, :-1], (1, 0), value=NEG) - go + ge - jge)
        rows.append((H.numpy(), None if ungapped else Fm.numpy()))
    return rows


def _same_rows(trace, rows, what):
    """The model's H and F of each row it ran equal the plain loop's."""
    assert trace
    for b, i, H, F in trace:
        assert np.array_equal(H, rows[i][0][b]), ("H", what, b, i)
        if F is not None:
            assert np.array_equal(F, rows[i][1][b]), ("F", what, b, i)


def _plain(arrays, kw, saa=SAA):
    t = as_torch(*arrays[:7], saa, S3D, arrays[7])
    return [x.numpy() for x in tb.sw_forward_banded(*t[:9], qc=t[9], **kw)]


def _jax(arrays, kw, saa=SAA):
    import jax.numpy as jnp

    *x, qc = arrays
    return [np.asarray(r) for r in jb.sw_forward_banded(
        *(jnp.asarray(a) for a in (*x, saa, S3D)), qc=None if qc is None else jnp.asarray(qc), **kw)]


def _same(got, ref, what):
    for name, g, r in zip(("best", "qend", "tend"), got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r), (name, what, g, r)


def _cases(W, C, seed):
    """(arrays, kw) over every case of synthetic.banded_edge_pairs: two E
    windows each (all of WINDOWS over the cases), the ungapped mode on
    every other case, bias off on every other one, 5 pairs of 13-19 rows."""
    rng = np.random.RandomState(seed)
    for n, case in enumerate(BANDED_EDGE_CASES):
        arrays, go, ge = banded_edge_pairs(rng, case, 5, 13 + n, 20 + 3 * n, W)
        if n % 2:
            arrays = (*arrays[:7], None)
        for window in (WINDOWS[n % 8], WINDOWS[(n + 4) % 8]):
            yield arrays, dict(W=W, go=go, ge=ge, gap_window=window), (case, window)
        if n % 2 == 0:
            yield arrays, dict(W=W, go=go, ge=ge, ungapped=True), (case, "ungapped")


@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("W", WIDTHS)
def test_kernel_model_matches_plain(C, W):
    """C of 1-4 at W of 1-40 with 4-lane warps: one to ten warps a pair,
    E windows inside a lane, across lanes and across one or more whole
    warps, rows past qlen where exact_dp fails, the code windows refilled
    every 7 rows; H and F of every row as well as the results."""
    for arrays, kw, what in _cases(W, C, 100 * W + C):
        trace = []
        got = kernel_model(*arrays[:7], SAA, S3D, qc=arrays[7], C=C, WARP=WARP, R=7, trace=trace,
                           **kw)
        _same(got, _plain(arrays, kw), (C, what))
        _same_rows(trace, _plain_rows(arrays, kw), (C, what))


@pytest.mark.parametrize("W", [5, 17, 40])
def test_kernel_model_matches_jax(W):
    """The same cases at C = 2 against JAX's sw_forward_banded."""
    for arrays, kw, what in _cases(W, 2, 7 * W):
        got = kernel_model(*arrays[:7], SAA, S3D, qc=arrays[7], C=2, WARP=WARP, R=5, **kw)
        _same(got, _jax(arrays, kw), what)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_kernel_model_at_kernel_constants(C):
    """32-lane warps and the kernel's STAGE_ROWS at the engine's E window
    (64) and at gap_window 0: W 128 to 512, one to sixteen warps."""
    rng = np.random.RandomState(C)
    for W in (128, 256, 512):
        arrays, go, ge = banded_edge_pairs(rng, "ragged", 3, 40, 300, W)
        for kw in (dict(gap_window=64), dict(gap_window=0), dict(ungapped=True)):
            kw = dict(W=W, go=go, ge=ge, **kw)
            got = kernel_model(*arrays[:7], SAA, S3D, qc=arrays[7], C=C, **kw)
            _same(got, _plain(arrays, kw), (C, kw))


def test_kernel_model_restages_past_the_window():
    """A pair of more rows than the staged window (refilled three times),
    with a fractional matrix so every row runs."""
    rng = np.random.RandomState(4)
    arrays, go, ge = banded_edge_pairs(rng, "full", 2, 30, 40, 16)
    saa = (SAA + np.float32(0.375)).astype(np.float32)
    for kw in (dict(gap_window=3), dict(ungapped=True)):
        kw = dict(W=16, go=go, ge=ge, **kw)
        got = kernel_model(*arrays[:7], saa, S3D, qc=arrays[7], C=2, WARP=WARP, R=8, **kw)
        _same(got, _plain(arrays, kw, saa), kw)
        _same(got, _jax(arrays, kw, saa), kw)


# ---------------------------------------------------------------------------
# the engine's banded batches
# ---------------------------------------------------------------------------

def test_banded_batch_size_by_route():
    """The kernel route takes the engine's batch_size; the plain route (the
    CPU) and the sharded route keep the (B, LQ, W) float32 band under 128
    MB, 8 pairs at least."""
    size = teng_mod.banded_batch_size
    assert teng_mod.PLAIN_BAND_BYTES == 128 * 2**20
    for LQ, W, cap in ((2048, 256, 64), (2048, 512, 32), (2048, 2048, 8), (1024, 512, 64),
                       (256, 256, 512), (4096, 8192, 8)):
        assert size(512, LQ, W, kernel_route=False) == cap
        assert size(512, LQ, W, kernel_route=True) == 512
    assert size(100, 256, 256, kernel_route=False) == 100
    assert size(100, 2048, 2048, kernel_route=True) == 100


def _long_pairs(n, seed):
    """n pairs of 230-250 residues in one (256, 256, 128) bucket, each
    target a mutated copy of its query at a small shift."""
    rng = np.random.RandomState(seed)
    entries = []
    for k in range(n):
        L = rng.randint(230, 251)
        qa, qs = rng.randint(0, 20, L).astype(np.int32), rng.randint(0, 20, L).astype(np.int32)
        shift = rng.randint(0, 5)
        ta = np.concatenate([rng.randint(0, 20, shift), qa[: L - shift]]).astype(np.int32)
        ts = np.concatenate([rng.randint(0, 20, shift), qs[: L - shift]]).astype(np.int32)
        sub = rng.randint(0, L, L // 6)
        ta[sub] = rng.randint(0, 20, len(sub))
        entries.append((k, qa, qs, ta, ts))
    return entries


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_banded_pass_past_the_old_cap_matches_jax(port_env, monkeypatch, route):  # noqa: F811
    """20 pairs in one bucket whose plain-route cap is 8 pairs (the band
    bytes lowered to 1 MB): the plain route makes three batches, the
    kernel route's size (forced here on the CPU, where the wrapper runs the
    plain version) one of 32; both equal JAX's banded pass pair for pair,
    and the counters count 20 pairs in 1 bucket."""
    monkeypatch.setattr(teng_mod, "PLAIN_BAND_BYTES", 2**20)
    if route == "kernel":
        size = teng_mod.banded_batch_size
        monkeypatch.setattr(teng_mod, "banded_batch_size",
                            lambda bs, LQ, W, kernel_route: size(bs, LQ, W, True))
    kw = dict(long_threshold=150, band_width=128)
    je = jeng_mod.AlignmentEngine(jeng_mod.AlignParams(**kw))
    te = teng_mod.AlignmentEngine(teng_mod.AlignParams(**kw), device="cpu")
    entries = _long_pairs(20, 3)
    for ungapped in (False, True):
        profiling.reset_counters()
        got = te._banded_pass(entries, ungapped=ungapped)
        c = profiling.get_counters()
        ref = je._banded_pass(entries, ungapped=ungapped)
        assert got == ref
        assert min(v[0] for v in got.values()) > 0
        assert (c["banded.pairs"], c["banded.buckets"]) == (20, 1)
        assert c["banded.launches"] == (1 if route == "kernel" else 3)
        assert c["align.cells"] == (32 if route == "kernel" else 24) * 256 * 128


def test_banded_batch_is_independent_of_its_companions():
    """A pair's result does not depend on the pairs batched beside it (the
    rows each pair runs are its own where exact_dp holds, and all Lq
    otherwise): one batch of 12 equals three of 4."""
    rng = np.random.RandomState(9)
    for case in ("ragged", "big_bias"):
        arrays, go, ge = banded_edge_pairs(rng, case, 12, 60, 80, 32)
        kw = dict(W=32, go=go, ge=ge, gap_window=8)
        whole = _plain(arrays, kw)
        parts = [_plain([None if x is None else x[k:k + 4] for x in arrays], kw) for k in (0, 4, 8)]
        for n in range(3):
            assert np.array_equal(whole[n], np.concatenate([p[n] for p in parts]))


def test_wrapper_rejects_a_bad_tiling():
    """The kernel's launch at a chosen tiling (the sweep's C) takes C of
    the kernel's columns a lane and CUDA tensors alone: no plain route."""
    from unicore_tpu_torch.ops import banded_cuda

    rng = np.random.RandomState(1)
    arrays, go, ge = banded_edge_pairs(rng, "ragged", 2, 20, 30, 16)
    t = as_torch(*arrays[:7], SAA, S3D)
    for bad in (0, 3, 32):
        with pytest.raises(ValueError, match="C must be one of"):
            banded_cuda.sw_forward_banded_columns(bad, *t, W=16)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        banded_cuda.sw_forward_banded_columns(2, *t, W=16)
    got = banded_cuda.sw_forward_banded_cuda(*t, W=16)  # the CPU: the plain version
    _same([x.numpy() for x in got], _plain((*arrays[:7], None), dict(W=16)), "cpu")


def test_sweep_columns_fit_the_block():
    """chip_smoke.py phase 3e's sweep tries only C of the kernel's columns
    a lane that give a pair of its class's widest band 4 to
    MAX_THREADS / 32 warps (a block is one pair)."""
    import os
    import sys

    from unicore_tpu_torch.ops import banded_cuda

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    assert set(chip_smoke.BANDED_SWEEP_COLUMNS) == set(chip_smoke.BANDED_SWEEP)
    for W, columns in chip_smoke.BANDED_SWEEP_COLUMNS.items():
        assert all(shape[3] <= W for shape in chip_smoke.BANDED_SWEEP[W])
        for C in columns:
            warps = -(-W // (32 * C))
            assert C in banded_cuda.COLUMNS and 4 <= warps <= banded_cuda.MAX_THREADS // 32, (W, C)
