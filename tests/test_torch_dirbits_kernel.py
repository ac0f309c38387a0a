"""The direction-bit DP's wrappers (ops/dirbits_cuda.py) on CPU tensors,
where they run the plain versions, against those versions and JAX's
nw_forward_bits / sw_forward_bits; their checks and the sweep's entry
point; the launch-shape counters; the callers' route through them with the
callers' counters; and a numpy transliteration of the kernel's
decomposition (csrc/dirbits.cu: warps pipelined down the rows, C columns a
lane from the kernel's table, a warp scan a row with one prefix where
go >= ge and two where go < ge, the warp-to-warp ring and its barriers,
bands of columns, the staged S ring and its waits, the end-cell keys) held
bit-exact against the plain versions and JAX, at each row-width class's
edge, at every C, and on the E == Escan identity.  Inputs from numpy
seeds; integer arithmetic, so no tolerance.  The kernel itself runs in
tests/test_torch_dirbits_cuda.py (on the card)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_nw_cuda import _entries
from torch_port_helpers import as_torch
from unicore_tpu.ops import nw_device as jnw
from unicore_tpu.ops import sw_bits as jsw
from unicore_tpu_torch.ops import dirbits_cuda, nw_device, sw_bits
from unicore_tpu_torch.runtime import profiling
from unicore_tpu_torch.synthetic import DIRBITS_KINDS, dirbits_scores

# the MSA's 11/1 in QUANT units, another merge pair, the engine's 10/1,
# go == ge, and go < ge (where the E scan from h0 is not Gotoh's)
GAPS = [(2816, 256), (1100, 100), (100, 10), (10, 10), (5, 20)]
INT_NEG = nw_device.INT_NEG
FNS = {
    "nw": (dirbits_cuda.nw_forward_bits_cuda, nw_device.nw_forward_bits, jnw.nw_forward_bits),
    "sw": (dirbits_cuda.sw_forward_bits_cuda, sw_bits.sw_forward_bits, jsw.sw_forward_bits),
}


def _assert_same(got, ref, what):
    for name, g, r in zip(("bits", "end_i", "end_j", "score"), got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape and g.dtype == r.dtype, (what, name)
        assert np.array_equal(g, r), (what, name)


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("gaps", GAPS)
def test_wrapper_on_cpu_matches_plain_and_jax(fn, gaps):
    wrapper, plain, jax_fn = FNS[fn]
    rng = np.random.RandomState(sum(gaps) + len(fn))
    cases = [(kind, dtype, (6, 24, 17)) for kind in DIRBITS_KINDS for dtype in (np.int16, np.int32)]
    cases.append(("rand", np.int16, (1, 1, 1)))
    for kind, dtype, shape in cases:
        S, l1, l2 = dirbits_scores(rng, *shape, kind, dtype)
        before = dict(dirbits_cuda.LAUNCHES)
        got = wrapper(*as_torch(S, l1, l2), *gaps)
        assert dirbits_cuda.LAUNCHES == before  # the CPU runs no kernel
        what = (kind, np.dtype(dtype).name, shape)
        _assert_same([x.numpy() for x in got], [x.numpy() for x in plain(*as_torch(S, l1, l2), *gaps)], what)
        ref = jax_fn(jnp.asarray(S), jnp.asarray(l1), jnp.asarray(l2), *gaps)
        _assert_same([x.numpy() for x in got], [np.asarray(x) for x in ref], what)


@pytest.mark.parametrize("fn", list(FNS))
def test_wrapper_rejects(fn):
    wrapper = FNS[fn][0]
    S, l1, l2 = as_torch(*dirbits_scores(np.random.RandomState(0), 3, 8, 9, "rand"))
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        wrapper(S.long(), l1, l2, 100, 10)
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        wrapper(S.float(), l1, l2, 100, 10)
    with pytest.raises(TypeError, match="l1: expected torch.int32"):
        wrapper(S, l1.long(), l2, 100, 10)
    with pytest.raises(TypeError, match="torch.Tensor"):
        wrapper(S.numpy(), l1, l2, 100, 10)
    with pytest.raises(ValueError, match="shape"):
        wrapper(S[0], l1, l2, 100, 10)
    with pytest.raises(ValueError, match=r"l2: expected shape \(3,\)"):
        wrapper(S, l1, l2[:2], 100, 10)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(S.transpose(1, 2), l1, l2, 100, 10)
    with pytest.raises(ValueError, match="on meta"):
        wrapper(S, l1.to("meta"), l2, 100, 10)
    with pytest.raises(ValueError, match="unsupported device meta"):
        wrapper(*(x.to("meta") for x in (S, l1, l2)), 100, 10)


def test_forward_bits_columns_rejects():
    """The sweep's entry point takes the kernel's C alone, and CUDA
    tensors only (it has no plain version)."""
    S, l1, l2 = as_torch(*dirbits_scores(np.random.RandomState(1), 2, 5, 6, "rand"))
    for C in (0, 3, 16):
        with pytest.raises(ValueError, match="C must be one of"):
            dirbits_cuda.forward_bits_columns(C, S, l1, l2, 100, 10, False)
    with pytest.raises(TypeError, match="int16 or torch.int32"):
        dirbits_cuda.forward_bits_columns(2, S.long(), l1, l2, 100, 10, False)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        dirbits_cuda.forward_bits_columns(2, S, l1, l2, 100, 10, False)


def test_band_threads_read_from_the_source():
    """Threads a block by C, read from the kernel's max_threads: 1,024 up
    to C = 2 (64 registers a thread), 512 above; each C's band is at least
    2,048 columns, so the callers' buckets to 2,048 are one band at every
    C."""
    assert [dirbits_cuda.band_threads(C) for C in dirbits_cuda.COLUMNS] == [1024, 512, 512]
    assert min(dirbits_cuda.band_threads(C) * C for C in dirbits_cuda.COLUMNS) == 2048


def test_shape_counters(monkeypatch):
    """SHAPES as the CLI's counters, `kernel.dirbits.{instance}.shape.
    {B}x{L1}x{L2}`, cleared with the launch counts; the CLI dumps them
    beside the launches."""
    from unicore_tpu_torch import cli

    monkeypatch.setitem(dirbits_cuda.SHAPES, "nw", {(64, 512, 512): 3, (7, 2048, 2048): 1})
    monkeypatch.setitem(dirbits_cuda.SHAPES, "sw_bits", {(32, 1024, 1024): 2})
    want = {"kernel.dirbits.nw.shape.64x512x512": 3, "kernel.dirbits.nw.shape.7x2048x2048": 1,
            "kernel.dirbits.sw_bits.shape.32x1024x1024": 2}
    assert dirbits_cuda.shape_counters() == want
    dumped = {}
    monkeypatch.setenv("UNICORE_TPU_TORCH_COUNTERS", "counters.json")
    monkeypatch.setattr(profiling, "dump", lambda path, extra: dumped.update(extra))
    cli._dump_counters()
    assert {k: v for k, v in dumped.items() if ".shape." in k} == want
    dirbits_cuda.reset_launch_counts()
    assert dirbits_cuda.SHAPES == {"nw": {}, "sw_bits": {}} and dirbits_cuda.shape_counters() == {}


def _spy(monkeypatch, name):
    calls = []
    fn = getattr(dirbits_cuda, name)
    monkeypatch.setattr(dirbits_cuda, name, lambda *a, **k: calls.append(a[0].shape) or fn(*a, **k))
    return calls


def test_merge_pipeline_goes_through_the_wrapper(monkeypatch):
    """CountsMergePipeline (through nw_align_batch_counts): one wrapper
    call per merge batch, each counted once in msa.dispatches, and the
    merges JAX's."""
    from unicore_tpu.msa import progressive as jprog
    from unicore_tpu_torch.msa import progressive as tprog

    calls = _spy(monkeypatch, "nw_forward_bits_cuda")
    rng = np.random.RandomState(11)
    entries = _entries(rng, 10, 6, 100) + _entries(rng, 2, 3, 300)
    eng = tprog.ProgressiveMSA(mode="3di+aa", device="cpu")
    args = (eng.go_q, eng.ge_q, eng.saa, eng.s3d, eng._wA, eng._wS)
    profiling.reset_counters()
    got = nw_device.nw_align_batch_counts(entries, *args, device="cpu")
    c = profiling.get_counters()
    buckets = sorted({nw_device._bucket(max(e[0].shape[0], e[2].shape[0])) for e in entries})
    assert [s[1] for s in calls] == buckets and len(buckets) > 1  # one batch per bucket
    assert c["msa.dispatches"] == len(calls) and c["msa.nw.seconds"] > 0
    jeng = jprog.ProgressiveMSA(mode="3di+aa")
    assert (jeng.go_q, jeng.ge_q, jeng._wA, jeng._wS) == (eng.go_q, eng.ge_q, eng._wA, eng._wS)
    ref = jnw.nw_align_batch_counts(entries, jeng.go_q, jeng.ge_q, jeng.saa, jeng.s3d, jeng._wA, jeng._wS)
    assert got == ref


@pytest.mark.parametrize("sharded", [False, True])
def test_nw_align_batch_goes_through_the_wrapper(monkeypatch, sharded):
    """nw_align_batch, on one device and on a mesh of 4 CPU shards (one
    wrapper call per shard), with msa.dispatches counting the calls."""
    from unicore_tpu_torch.ops import nw as tnw
    from unicore_tpu_torch.parallel import mesh as mesh_mod

    if sharded:
        mesh = mesh_mod.make_mesh(devices=["cpu"] * 4, dp=4, tp=1)
        monkeypatch.setattr(mesh_mod, "local_mesh", lambda device=None: mesh)
    calls = _spy(monkeypatch, "nw_forward_bits_cuda")
    rng = np.random.RandomState(4)
    S_list = []
    for a, b in [(12, 17), (1, 9), (9, 1), (64, 64), (33, 70), (5, 300)]:
        S = rng.randn(a, b) * 2.0 - 1.0
        S[np.arange(min(a, b)), np.arange(min(a, b))] += 6.0
        S_list.append(tnw.quantize_scores(S))
    profiling.reset_counters()
    got = nw_device.nw_align_batch(S_list, 2816, 256, device="cpu")
    assert len(calls) == 3 * (4 if sharded else 1)  # buckets 64, 128, 512
    assert profiling.get_counters()["msa.dispatches"] == len(calls)
    assert got == jnw.nw_align_batch(S_list, 2816, 256)


def test_sw_traceback_batch_goes_through_the_wrapper(monkeypatch):
    calls = _spy(monkeypatch, "sw_forward_bits_cuda")
    rng = np.random.RandomState(9)
    windows = [rng.randint(-30, 25, (a, b)).astype(np.int32)
               for a, b in [(3, 5), (40, 70), (1, 1), (90, 80), (200, 130)]]
    profiling.reset_counters()
    got = sw_bits.sw_traceback_batch(windows, 100, 10, device="cpu")
    c = profiling.get_counters()
    assert [s[1] for s in calls] == [64, 128, 256]
    assert c["traceback.dispatches"] == len(calls) and c["traceback.seconds"] > 0
    ref = jsw.sw_traceback_batch(windows, 100, 10)
    for (q, t, s), (rq, rt, rs) in zip(got, ref):
        assert np.array_equal(q, rq) and np.array_equal(t, rt) and s == rs


# ---------------------------------------------------------------------------
# the kernel's decomposition, transliterated
# ---------------------------------------------------------------------------

def kernel_table():
    """The kernel's table of columns a lane by row-width class, read from
    csrc/dirbits.cu: [(upper L2, C)], the last class open-ended."""
    body = re.search(r"TABLE\[\] = \{(.*?)\};", dirbits_cuda.SOURCE.read_text()).group(1)
    return [(np.inf if w == "INT_MAX" else int(w), int(c)) for w, c in re.findall(r"\{(\w+), (\d+)\}", body)]


def table_columns(L2):
    return next(c for w, c in kernel_table() if L2 <= w)


def _key(v, idx):
    return ((int(v) ^ 0x80000000) & 0xFFFFFFFF) << 32 | (~int(idx) & 0xFFFFFFFF)


def _key_value(k):
    v = (k >> 32) ^ 0x80000000
    return v - (1 << 32) if v >= 1 << 31 else v


def kernel_model(S, l1, l2, go, ge, local, C=None, WARP=32, MAXT=None, DS=None, BP=8, scans=None, vec=None):
    """csrc/dirbits.cu step by step in numpy, vectorized over a block's
    lanes: warps pipelined down the rows.  Lane l of warp w owns the
    columns band*T*C + (WARP*w + l)*C + 1 .. + C of a band of T*C columns
    (T threads: the row's lanes rounded up to warps, at most MAXT; C from
    the kernel's table and MAXT from its max_threads by default), and warp
    w works on row s - LAG*w at step s
    (LAG = BP + 1).  A step of a warp: h0 and its prefix max (+ j*ge) over
    each lane's C columns, a warp scan, the prefix before each lane (from
    the warp's input from the left: the left warp's prefix through its
    last column, or the previous band's, or 0), H, and H(j0-1) as
    max(h0(j0-1), that prefix - ((j0-1)*ge + go - ge)) from the left
    lane's shuffled h0 or, for the warp's first lane, the left warp's last
    H; with two prefixes (`scans` 2; by default where go < ge) a second
    warp scan of H + j*ge.  The warp's last lane publishes its values in a
    ring of R = 2*BP slots that the next warp reads at the end of the step
    before it uses them; the block meets at a barrier every BP steps, and
    the model asserts that every ring value is read after a barrier that
    follows its write, and its slot refilled only after a barrier that
    follows the read.  S goes through each lane's ring of DS slots (16, or
    8 where a lane's row is 32 bytes or more): row r + DS staged at the
    end of the warp's step on row r, then row r + 1 read; a copy lands
    only when a wait retires its group (wait_group DS-1 after the prologue
    and after each step's staging, where `vec`, by default where rows are
    aligned to a lane's copy) or at once (plain copies); slots start as
    garbage, columns past L2 read 0.  The NW end cells are tracked by the
    last column's owner and in row l1, the SW one over every valid cell
    (first maximum in a band, then by key), all reduced as (value, first
    index) keys."""
    B, L1, L2 = S.shape
    C = C or table_columns(L2)
    MAXT = MAXT or dirbits_cuda.band_threads(C)
    scans = scans or (1 if go >= ge else 2)
    esize = S.dtype.itemsize
    DS = DS or (8 if C * esize >= 32 else 16)
    vec = (L2 * esize) % min(16, C * esize) == 0 if vec is None else vec
    S = S.astype(np.int64)
    lanes = -(-L2 // C)
    T = MAXT if lanes > MAXT else -(-lanes // WARP) * WARP
    tw, G = T * C, T // WARP
    nbands = -(-L2 // tw)
    LAG, R = BP + 1, 2 * BP
    t = np.arange(T)
    lane, warp = t % WARP, t // WARP
    off = LAG * warp
    nsteps = L1 + LAG * (G - 1)
    cols = np.arange(C)
    gh = go - ge
    bits = np.zeros((B, L1, L2), np.uint8)
    ends = np.zeros((3, B), np.int32)
    low = np.iinfo(np.int64).min // 4
    lastlane = lane == WARP - 1

    def up(v):  # __shfl_up_sync(v, 1): lane 0 keeps its own value
        r = v.reshape(G, WARP).copy()
        r[:, 1:] = v.reshape(G, WARP)[:, :-1]
        return r.ravel()

    def wscan(v):  # inclusive prefix max across each warp
        return np.maximum.accumulate(v.reshape(G, WARP), axis=1).ravel()

    def barrier_between(a, b):  # a block barrier at the start of a step in (a, b]
        return G > 1 and (b // BP) * BP > a

    for b in range(B):
        lb1, lb2 = min(max(int(l1[b]), 0), L1), min(max(int(l2[b]), 0), L2)
        cbest, ci = low, 0
        rbest, rj = np.full(T, low), np.zeros(T, np.int64)
        skey = 0
        xb = np.zeros((2, 3, L1), np.int64)  # [band parity][P, H, Q][row]
        for band in range(nbands):
            c0 = band * tw + t * C  # the lanes' first columns, 0-based
            J = c0[:, None] + cols  # 0-based columns
            jg = (J + 1) * ge
            jg0 = jg[:, 0]
            own = lb2 - 1 - c0
            frm = (warp > 0) | (band > 0)
            ring = np.full((DS, T, C), 7777, np.int64)  # staged S, garbage until a copy lands
            xring = np.full((DS, 3), 7777, np.int64)
            staged = np.full(T, DS)  # groups committed: group g stages row g
            landed = np.zeros(T, np.int64)
            wring = {}  # (warp, slot) -> (row, P, H, Q, written at step, last read at step)

            def land(n_pending):
                nonlocal landed
                while True:
                    due = landed < staged - n_pending
                    if not due.any():
                        return
                    g = landed
                    put = due & (g < L1)
                    if put.any():
                        rows = np.minimum(g, L1 - 1)
                        val = np.where(J < L2, S[b, rows[:, None], np.minimum(J, L2 - 1)], 0)
                        slot = g & (DS - 1)
                        ring[slot[put], t[put]] = val[put]
                        if band and put[0]:
                            xring[slot[0]] = xb[(band - 1) & 1, :, g[0]]
                    landed = np.where(due, landed + 1, landed)

            land(DS - 1 if vec else 0)  # after the prologue: row 0
            sn = ring[0].copy()  # each lane's next row's scores, read a step ahead
            xn = np.tile(xring[0], (G, 1))  # each warp's next row's inputs from the left
            hp = np.zeros((T, C), np.int64)
            fp = np.full((T, C), INT_NEG, np.int64)
            hdiag = np.zeros(T, np.int64)
            best, bi, bj = np.full(T, -1), np.zeros(T, np.int64), np.zeros(T, np.int64)
            for s in range(nsteps):
                r = s - off
                act = (r >= 0) & (r < L1)
                Pw, Hw, Qw = (np.where(frm, xn[warp, q], 0) for q in range(3))
                F = np.maximum(hp - go, fp - ge)
                h0 = np.maximum(np.concatenate([hdiag[:, None], hp[:, :-1]], axis=1) + sn, F)
                if local:
                    h0 = np.maximum(h0, 0)
                P = np.maximum.accumulate(h0 + jg, axis=1)
                h0L = up(h0[:, -1])
                x = wscan(P[:, -1])
                pre = np.where(lane > 0, np.maximum(Pw, up(x)), Pw)
                Pex = np.concatenate([pre[:, None], np.maximum(pre[:, None], P[:, :-1])], axis=1)
                E = Pex - (jg + gh)
                H = np.maximum(h0, E)
                Qout = np.zeros(T, np.int64)
                if scans == 1:
                    hl = np.where(lane > 0, np.maximum(h0L, pre - (jg0 - ge + gh)), Hw)
                else:
                    Q = np.maximum.accumulate(H + jg, axis=1)
                    x2 = wscan(Q[:, -1])
                    pre2 = np.where(lane > 0, np.maximum(Qw, up(x2)), Qw)
                    Qex = np.concatenate([pre2[:, None], np.maximum(pre2[:, None], Q[:, :-1])], axis=1)
                    E = Qex - (jg + gh)
                    hl = np.where(lane > 0, up(H[:, -1]), Hw)
                    Qout = np.maximum(Qw, x2)
                Pout = np.maximum(Pw, x)
                for k in np.nonzero(act & lastlane)[0]:
                    if warp[k] + 1 < G:
                        key = (warp[k], r[k] & (R - 1))
                        if key in wring:
                            assert barrier_between(wring[key][5], s), "warp ring refilled before its read"
                        wring[key] = (r[k], Pout[k], H[k, -1], Qout[k], s, -1)
                    elif band + 1 < nbands:
                        xb[band & 1, :, r[k]] = Pout[k], H[k, -1], Qout[k]
                left = np.concatenate([hl[:, None], H[:, :-1]], axis=1)
                v = (H == E) | (H == F) << 1 | (E == left - go) << 2 | (F == hp - go) << 3
                if local:
                    v |= (H == 0) << 4
                for k in np.nonzero(act)[0]:
                    keep = J[k] < L2
                    bits[b, r[k], J[k][keep]] = v[k][keep]
                if local:
                    for c in range(C):
                        up_ = act & (r < lb1) & (J[:, c] < lb2) & (H[:, c] > best)
                        best = np.where(up_, H[:, c], best)
                        bi, bj = np.where(up_, r, bi), np.where(up_, J[:, c], bj)
                else:
                    for k in np.nonzero(act & (r < lb1) & (own >= 0) & (own < C))[0]:
                        if H[k, own[k]] > cbest:
                            cbest, ci = H[k, own[k]], r[k] + 1
                    for c in range(C):
                        up_ = act & (r == lb1 - 1) & (J[:, c] < lb2) & (H[:, c] > rbest)
                        rbest, rj = np.where(up_, H[:, c], rbest), np.where(up_, J[:, c] + 1, rj)
                a2 = act[:, None]
                hp, fp = np.where(a2, H, hp), np.where(a2, F, fp)
                hdiag = np.where(act, hl, hdiag)
                # end of the step: stage row r + DS, land row r + 1, read it
                staged = np.where(act, staged + 1, staged)
                land(DS - 1 if vec else 0)
                nxt = act & (r + 1 < L1)
                sn[nxt] = np.where(J[nxt] < L2, ring[(r[nxt] + 1) & (DS - 1), t[nxt]], 0)
                for w in range(G):  # each warp's next row's inputs from the left
                    rn = s + 1 - LAG * w
                    if w and 0 <= rn < L1:
                        row, P_, H_, Q_, ws, _ = wring[(w - 1, rn & (R - 1))]
                        assert row == rn and barrier_between(ws, s), "warp ring read unordered"
                        wring[(w - 1, rn & (R - 1))] = (row, P_, H_, Q_, ws, s)
                        xn[w] = P_, H_, Q_
                    elif not w:
                        xn[w] = xring[rn & (DS - 1)]
            if local:
                skey = max([skey] + [_key(best[k], bi[k] * L2 + bj[k]) for k in range(T) if best[k] >= 0])
        if local:
            k = skey
            val = _key_value(k) if k else 0
            flat = ~k & 0xFFFFFFFF
            ends[:, b] = (flat // L2, flat % L2, val) if val > 0 else (-1, -1, 0)
        else:
            base = _key(0, 0)
            k0 = max([base] + ([_key(cbest, ci)] if cbest > low else []))
            k1 = max([base] + [_key(rbest[k], rj[k]) for k in range(T) if rbest[k] > low])
            best_col, best_row = _key_value(k0), _key_value(k1)
            if best_row >= best_col:
                ends[:, b] = (lb1, ~k1 & 0xFFFFFFFF, best_row)
            else:
                ends[:, b] = (~k0 & 0xFFFFFFFF, lb2, best_col)
    return bits, ends[0], ends[1], ends[2]


PLAIN = {False: nw_device.nw_forward_bits, True: sw_bits.sw_forward_bits}
JAX = {False: jnw.nw_forward_bits, True: jsw.sw_forward_bits}
CALLER_GAPS = {False: GAPS[0], True: GAPS[2]}  # the MSA's and the m8 traceback's
# go > ge, go == ge and go < ge (one scan, one scan, two scans)
SCAN_GAPS = {False: [GAPS[0], GAPS[3], GAPS[4]], True: [GAPS[2], GAPS[3], GAPS[4]]}


def _held(S, l1, l2, gaps, local, what, with_jax=False, **kw):
    got = kernel_model(S, l1, l2, *gaps, local, **kw)
    _assert_same(got, [x.numpy() for x in PLAIN[local](*as_torch(S, l1, l2), *gaps)], what)
    if with_jax:
        ref = JAX[local](jnp.asarray(S), jnp.asarray(l1), jnp.asarray(l2), *gaps)
        _assert_same(got, [np.asarray(x) for x in ref], what)
    return got


# (C, WARP, MAXT, DS, BP) small enough that a few columns reach several
# warps and bands and reuse the rings: a band of 16 columns, 2 warps of 4
# lanes of 2 columns, 4 staged rows, a barrier every 2 steps
SMALL = dict(C=2, WARP=4, MAXT=8, DS=4, BP=2)


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("L2", [1, 3, 8, 9, 16, 17, 40])
def test_kernel_model_matches_plain_small_tiles(local, L2):
    """Single lane, a partial warp, one warp, two, a full band, a band and
    one column, three bands; one prefix a row (go >= ge) and two (go <
    ge), int16 and int32 S, the staged copies on arrival and at the
    waits."""
    rng = np.random.RandomState(L2 + 100 * local)
    for n, (kind, gaps) in enumerate(zip(DIRBITS_KINDS * 3, GAPS)):
        S, l1, l2 = dirbits_scores(rng, 4, 5 + 7 * n, L2, kind, (np.int16, np.int32)[n % 2])
        for vec in (False, True):
            _held(S, l1, l2, gaps, local, (kind, gaps, vec), vec=vec, **SMALL)


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("B,L1,L2", [(3, 40, 300), (2, 5, 4100), (1, 4, 9000)])
def test_kernel_model_matches_plain_at_kernel_constants(local, B, L1, L2):
    """The kernel's own WARP, table, MAXT, DS and BP: one band of several
    warps, then rows of 2 and 3 bands of 4,096 columns."""
    rng = np.random.RandomState(L2)
    for kind, gaps in zip(DIRBITS_KINDS, GAPS[2:4]):
        S, l1, l2 = dirbits_scores(rng, B, L1, L2, kind)
        _held(S, l1, l2, gaps, local, (kind, gaps))


def test_kernel_model_end_cells_on_planted_paths():
    """End cells away from the edges: a planted SW best in a middle band,
    and an NW last column that beats the last row."""
    rng = np.random.RandomState(3)
    S = rng.randint(-40, -20, (2, 12, 40)).astype(np.int32)
    S[0, np.arange(5, 9), np.arange(20, 24)] = 90  # a local best in the second band
    l1, l2 = np.array([12, 9], np.int32), np.array([40, 33], np.int32)
    got = {local: _held(S, l1, l2, (100, 10), local, local, **SMALL) for local in (True, False)}
    assert (int(got[True][1][0]), int(got[True][2][0])) == (8, 23)
    S2 = np.full((1, 10, 30), -5, np.int32)
    S2[0, np.arange(8), np.arange(2, 10)] = 80  # a path into the last column at row 8
    got = _held(S2, np.array([10], np.int32), np.array([10], np.int32), (100, 10), False, "col", **SMALL)
    assert (int(got[1][0]), int(got[2][0])) == (8, 10)


def _class_edges():
    widths = [64, 128, 256, 512, 1024, 2048, 4096]  # the callers' buckets, the table's edges among them
    assert {w for w, _ in kernel_table() if w != np.inf} <= set(widths)
    return [w + d for w in widths for d in (0, 1)]


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("L2", _class_edges())
def test_kernel_model_width_class_edges(local, L2):
    """Each row-width class's upper edge and one past it at the table's C
    (and the kernel's MAXT, WARP and ring), for go > ge, go == ge and
    go < ge, against the plain version, and against JAX at the callers'
    gaps."""
    rng = np.random.RandomState(L2 + 7 * local)
    for n, gaps in enumerate(SCAN_GAPS[local]):
        S, l1, l2 = dirbits_scores(rng, 2, 3, L2, DIRBITS_KINDS[n % 2], (np.int16, np.int32)[(n + L2) % 2])
        _held(S, l1, l2, gaps, local, (L2, gaps), with_jax=gaps == CALLER_GAPS[local])


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("C", dirbits_cuda.COLUMNS)
def test_kernel_model_every_columns_count(local, C):
    """Every C the kernel has, at its MAXT: widths of one warp, several
    warps and the widest single band (MAXT * C), two bands past it (2,049
    columns at C = 2, 4,097 at 4 and 8) and two whole bands, each scan
    mode."""
    maxt = dirbits_cuda.band_threads(C)
    rng = np.random.RandomState(C + 10 * local)
    for n, L2 in enumerate([32 * C - 3, 128 * C, maxt * C, maxt * C + 1, 2 * maxt * C]):
        gaps = SCAN_GAPS[local][n % 3]
        S, l1, l2 = dirbits_scores(rng, 2, 3, L2, DIRBITS_KINDS[n % 2], (np.int16, np.int32)[n % 2])
        _held(S, l1, l2, gaps, local, (C, L2, gaps), C=C)


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
def test_kernel_model_ring_depths(local):
    """The staged S through rings of 1, 2, 4 and 8 rows, with copies
    landing at the waits (rows aligned to a lane's copy) and on arrival
    (odd rows), and barriers every 1, 2 and 8 steps, over one band and
    over three."""
    rng = np.random.RandomState(5 + local)
    for DS, BP in ((1, 1), (2, 2), (4, 8), (8, 2)):
        for L2, dtype in ((64, np.int16), (60, np.int32), (19, np.int16), (40, np.int16)):
            S, l1, l2 = dirbits_scores(rng, 2, 11, L2, "rand", dtype)
            kw = dict(C=2, WARP=4, MAXT=8) if L2 == 40 else {}
            _held(S, l1, l2, CALLER_GAPS[local], local, (DS, BP, L2), DS=DS, BP=BP, **kw)


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
def test_one_scan_equals_two_scans_where_go_ge_ge(local):
    """E == Escan: on random rows the one-scan and the two-scan models give
    the same bits and end cells wherever go >= ge, and the one-scan model
    differs on some row where go < ge (there only two scans are exact)."""
    rng = np.random.RandomState(17 + local)
    differ = 0
    for go, ge in [(2816, 256), (100, 10), (10, 10), (11, 10), (0, 0), (5, 20), (1, 2), (3, 30)]:
        for rep in range(3):
            S, l1, l2 = dirbits_scores(rng, 3, 9, 37, DIRBITS_KINDS[rep % 2])
            two = _held(S, l1, l2, (go, ge), local, (go, ge), scans=2, **SMALL)
            one = kernel_model(S, l1, l2, go, ge, local, scans=1, **SMALL)
            same = all(np.array_equal(a, b) for a, b in zip(one, two))
            if go >= ge:
                assert same, (go, ge, rep)
            differ += not same
    assert differ > 0
