"""The direction-bit DP's wrappers (ops/dirbits_cuda.py) on CPU tensors,
where they run the plain versions, against those versions and JAX's
nw_forward_bits / sw_forward_bits; their checks; the callers' route
through them with the callers' counters; and a numpy transliteration of
the kernel's decomposition (csrc/dirbits.cu: thread segments, warp scans,
warp totals, column tiles with carried prefix maxima and end-cell keys)
held bit-exact against the plain versions.  Inputs from numpy seeds;
integer arithmetic, so no tolerance.  The kernel itself runs in
tests/test_torch_dirbits_cuda.py (on the card)."""

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

def _key(v, idx):
    return ((int(v) ^ 0x80000000) & 0xFFFFFFFF) << 32 | (~int(idx) & 0xFFFFFFFF)


def _key_value(k):
    v = (k >> 32) ^ 0x80000000
    return v - (1 << 32) if v >= 1 << 31 else v


def kernel_model(S, l1, l2, go, ge, local, C=8, WARP=32, MAXT=512):
    """csrc/dirbits.cu step by step in numpy, vectorized over a block's
    threads: thread t owns the columns tile*T*C + t*C + 1 .. + C; the two
    prefix maxima per row run in each thread's columns, across each warp's
    lanes and across warps through their totals, and carry from column
    tile to column tile with the last H; H and F of the previous row stay
    per thread where the row is one tile and go through a two-row buffer
    otherwise; the end cells are tracked per thread and reduced as
    (value, first index) keys.  C, WARP and MAXT are the kernel's (8, 32,
    512) by default; smaller ones reach every path at small widths."""
    B, L1, L2 = S.shape
    S = S.astype(np.int64)
    tiled = L2 > MAXT * C
    T = MAXT if tiled else -(-(-(-L2 // C)) // WARP) * WARP
    tw, nw = T * C, T // WARP
    ntiles = -(-L2 // tw)
    t = np.arange(T)
    lane, warp = t % WARP, t // WARP
    gh = go - ge
    low = np.iinfo(np.int64).min
    bits = np.zeros((B, L1, L2), np.uint8)
    ends = np.zeros((3, B), np.int32)

    def block_scan(total, carry):
        x = np.maximum.accumulate(total.reshape(nw, WARP), axis=1)
        ex = np.concatenate([np.full((nw, 1), low), x[:, :-1]], axis=1).ravel()
        acc = np.maximum.accumulate(np.concatenate([[carry], x[:, -1]]))
        pre = np.where(lane > 0, np.maximum(acc[warp], ex), acc[warp])
        return pre, acc[-1]

    for b in range(B):
        lb1, lb2 = min(max(int(l1[b]), 0), L1), min(max(int(l2[b]), 0), L2)
        hp = np.zeros((T, C), np.int64)
        fp = np.full((T, C), INT_NEG, np.int64)
        hdiag = np.zeros(T, np.int64)
        buf = np.zeros((2, 2, L2 + 1), np.int64)  # [parity][H, F][column]
        buf[0, 1] = INT_NEG
        cbest, ci = np.full(T, low), np.zeros(T, np.int64)
        rbest, rj = np.full(T, low), np.zeros(T, np.int64)
        best, bi, bj = np.full(T, -1), np.zeros(T, np.int64), np.zeros(T, np.int64)
        for i in range(1, L1 + 1):
            carry1 = carry2 = carryH = 0
            for tile in range(ntiles):
                J = tile * tw + t[:, None] * C + 1 + np.arange(C)  # 1-based columns
                act = J <= L2
                Jc = np.minimum(J, L2)
                s = np.where(act, S[b, i - 1, Jc - 1], 0)
                if tiled:
                    prev = buf[(i - 1) & 1]
                    hp = np.where(act, prev[0, Jc], 0)
                    fp = np.where(act, prev[1, Jc], INT_NEG)
                    j0m1 = J[:, 0] - 1
                    hdiag = np.where(j0m1 <= L2, prev[0, np.minimum(j0m1, L2)], 0)
                jg = J * ge
                F = np.maximum(hp - go, fp - ge)
                h0 = np.maximum(np.concatenate([hdiag[:, None], hp[:, :-1]], axis=1) + s, F)
                if local:
                    h0 = np.maximum(h0, 0)
                pre, carry1 = block_scan((h0 + jg).max(axis=1), carry1)
                H = np.empty_like(h0)
                for c in range(C):
                    H[:, c] = np.maximum(h0[:, c], pre - (jg[:, c] + gh))
                    pre = np.maximum(pre, h0[:, c] + jg[:, c])
                wlast = H[:, -1].reshape(nw, WARP)[:, -1]
                hl = np.where(lane > 0, np.roll(H[:, -1], 1),
                              np.where(warp > 0, wlast[np.maximum(warp - 1, 0)], carryH))
                pre, carry2 = block_scan((H + jg).max(axis=1), carry2)
                carryH = wlast[-1]
                v = np.zeros((T, C), np.int64)
                left = hl
                for c in range(C):
                    j, Hc, Fc = J[:, c], H[:, c], F[:, c]
                    E = pre - (jg[:, c] + gh)
                    v[:, c] = (Hc == E) | (Hc == Fc) << 1 | (E == left - go) << 2 | (Fc == hp[:, c] - go) << 3
                    if local:
                        v[:, c] |= (Hc == 0) << 4
                        up = (i <= lb1) & (j <= lb2) & (Hc > best)
                        best, bi, bj = np.where(up, Hc, best), np.where(up, i - 1, bi), np.where(up, j - 1, bj)
                    else:
                        up = (i <= lb1) & (j == lb2) & (Hc > cbest)
                        cbest, ci = np.where(up, Hc, cbest), np.where(up, i, ci)
                        up = (i == lb1) & (j <= lb2) & (Hc > rbest)
                        rbest, rj = np.where(up, Hc, rbest), np.where(up, j, rj)
                    pre = np.maximum(pre, Hc + jg[:, c])
                    left = Hc
                bits[b, i - 1, J[act] - 1] = v[act]
                if tiled:
                    buf[i & 1, 0, J[act]] = H[act]
                    buf[i & 1, 1, J[act]] = F[act]
                else:
                    hp, fp, hdiag = H, F, hl
        if local:
            k = max([_key(best[x], bi[x] * L2 + bj[x]) if best[x] >= 0 else 0 for x in range(T)])
            val = _key_value(k) if k else 0
            flat = ~k & 0xFFFFFFFF
            ends[:, b] = (flat // L2, flat % L2, val) if val > 0 else (-1, -1, 0)
        else:
            base = _key(0, 0)
            k0 = max([base] + [_key(cbest[x], ci[x]) for x in range(T) if cbest[x] > low])
            k1 = max([base] + [_key(rbest[x], rj[x]) for x in range(T) if rbest[x] > low])
            best_col, best_row = _key_value(k0), _key_value(k1)
            if best_row >= best_col:
                ends[:, b] = (lb1, ~k1 & 0xFFFFFFFF, best_row)
            else:
                ends[:, b] = (~k0 & 0xFFFFFFFF, lb2, best_col)
    return bits, ends[0], ends[1], ends[2]


# (C, WARP, MAXT) small enough that a few columns reach several warps and
# tiles: a tile of 16 columns, 2 warps of 4 threads of 2 columns
SMALL = dict(C=2, WARP=4, MAXT=8)


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("L2", [1, 3, 8, 9, 16, 17, 40])
def test_kernel_model_matches_plain_small_tiles(local, L2):
    """Single thread, a partial warp, one warp, two, a full tile, a tile
    and one column, three tiles."""
    plain = sw_bits.sw_forward_bits if local else nw_device.nw_forward_bits
    rng = np.random.RandomState(L2 + 100 * local)
    for n, (kind, gaps) in enumerate(zip(DIRBITS_KINDS * 3, GAPS)):
        S, l1, l2 = dirbits_scores(rng, 4, 5 + 7 * n, L2, kind, (np.int16, np.int32)[n % 2])
        got = kernel_model(S, l1, l2, *gaps, local, **SMALL)
        _assert_same(got, [x.numpy() for x in plain(*as_torch(S, l1, l2), *gaps)], (kind, gaps))


@pytest.mark.parametrize("local", [False, True], ids=["nw", "sw"])
@pytest.mark.parametrize("B,L1,L2", [(3, 40, 300), (2, 5, 4100), (1, 4, 9000)])
def test_kernel_model_matches_plain_at_kernel_constants(local, B, L1, L2):
    """The kernel's own C, WARP and MAXT: one tile of 2 warps, then rows
    of 2 and 3 tiles of 4,096 columns."""
    plain = sw_bits.sw_forward_bits if local else nw_device.nw_forward_bits
    rng = np.random.RandomState(L2)
    for kind, gaps in zip(DIRBITS_KINDS, GAPS[2:4]):
        S, l1, l2 = dirbits_scores(rng, B, L1, L2, kind)
        got = kernel_model(S, l1, l2, *gaps, local)
        _assert_same(got, [x.numpy() for x in plain(*as_torch(S, l1, l2), *gaps)], (kind, gaps))


def test_kernel_model_end_cells_on_planted_paths():
    """End cells away from the edges: a planted SW best in a middle tile,
    and an NW last column that beats the last row."""
    rng = np.random.RandomState(3)
    S = rng.randint(-40, -20, (2, 12, 40)).astype(np.int32)
    S[0, np.arange(5, 9), np.arange(20, 24)] = 90  # a local best in the second tile
    l1, l2 = np.array([12, 9], np.int32), np.array([40, 33], np.int32)
    got = {}
    for local, plain in ((True, sw_bits.sw_forward_bits), (False, nw_device.nw_forward_bits)):
        got[local] = kernel_model(S, l1, l2, 100, 10, local, **SMALL)
        _assert_same(got[local], [x.numpy() for x in plain(*as_torch(S, l1, l2), 100, 10)], local)
    assert (int(got[True][1][0]), int(got[True][2][0])) == (8, 23)
