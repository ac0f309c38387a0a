"""Progressive multiple sequence alignment (FoldMason / MAFFT equivalent).

Modes:
  * "3di+aa" — structure-aware: column scores combine AA (BLOSUM62) and
    3Di substitution profiles, FoldMason-style weighting
    (`foldmason structuremsa` contract, tree.rs:201-231)
  * "aa"     — sequence-only (mafft / mafft-linsi contract,
    tree.rs:166-198); `refine_iters > 0` adds iterative refinement
    passes (linsi-flavored accuracy bump)

Algorithm: hashed-kmer distances -> UPGMA guide tree -> postorder
profile-profile semi-global NW merges.  Alignments are represented as
(n_seqs, n_cols) int32 index matrices (-1 = gap), so merges are pure
integer column surgery; profiles are one-hot averages.

Device path: profile scores are quantized to integers (ops/nw.py QUANT)
and the NW forward pass runs batched on the accelerator
(ops/nw_device.py) — `align_many` schedules merge rounds ACROSS genes so
one dispatch carries every ready merge of every gene (the tree stage's
hot loop, tree.rs:166-231).  Integer DP makes the device path
bit-identical to the host reference `nw_align`, including ties.

Counterpart of unicore_tpu/msa/progressive.py.  The engine resolves its
device once (runtime/device.py: CUDA unless the caller or
UNICORE_TPU_TORCH_DEVICE asks for the CPU), and runs the guide gram, the
count-profile products and every NW forward there.  Merges whose n1*n2
exceeds `nw_counts_exact_bound` keep the JAX package's host-scored route
(`_score_matrix` on the host, the DP on the device), counted in
`msa.host_route_merges`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from unicore_tpu_torch.alphabets import AA_SIZE, TDI_SIZE, encode_3di, encode_aa
from unicore_tpu_torch.matrices import get_3di_matrix, get_aa_matrix
from unicore_tpu_torch.msa.guide_tree import GuideNode, kmer_distance_matrices, upgma
from unicore_tpu_torch.ops.nw import QUANT, nw_align
from unicore_tpu_torch.ops.nw_device import (
    CountsMergePipeline, nw_align_batch, nw_counts_exact_bound)
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import profiling


class _Alignment:
    """rows: original sequence indices; cols: index matrix (n, L), -1=gap."""

    __slots__ = ("rows", "cols")

    def __init__(self, rows: List[int], cols: np.ndarray):
        self.rows = rows
        self.cols = cols  # (n, L) int32


def _count_profile(aln: _Alignment, seqs_codes: List[np.ndarray], size: int) -> np.ndarray:
    """Integer (L, size) residue-count profile, fully vectorized (no
    per-row Python loop): gather every row's residue codes through a
    flat concatenated code array, then histogram (column, code) pairs
    with one bincount."""
    n, L = aln.cols.shape
    flat = np.concatenate([seqs_codes[s] for s in aln.rows])
    lens = np.array([len(seqs_codes[s]) for s in aln.rows], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int64)
    idx = aln.cols
    valid = idx >= 0
    gidx = np.where(valid, idx + offs[:, None], 0)
    codes = flat[gidx]
    cols = np.broadcast_to(np.arange(L, dtype=np.int64), (n, L))
    key = cols[valid] * size + codes[valid]
    return np.bincount(key, minlength=L * size).reshape(L, size).astype(np.int64)


def _merge(aln1: _Alignment, aln2: _Alignment, path: List[Tuple[int, int]]) -> _Alignment:
    L = len(path)
    n1, n2 = aln1.cols.shape[0], aln2.cols.shape[0]
    p = np.asarray(path, dtype=np.int32).reshape(L, 2)
    pi, pj = p[:, 0], p[:, 1]
    out = np.full((n1 + n2, L), -1, dtype=np.int32)
    m1 = pi >= 0
    out[:n1, m1] = aln1.cols[:, pi[m1]]
    m2 = pj >= 0
    out[n1:, m2] = aln2.cols[:, pj[m2]]
    return _Alignment(aln1.rows + aln2.rows, out)


class _GeneTask:
    """Per-gene progressive-merge schedule state for align_many."""

    __slots__ = ("names", "aa_seqs", "aa_codes", "ss_codes", "nodes", "aln", "pending")

    def __init__(self, names, aa_seqs, aa_codes, ss_codes, root: GuideNode):
        self.names = names
        self.aa_seqs = aa_seqs
        self.aa_codes = aa_codes
        self.ss_codes = ss_codes
        # postorder internal nodes; each entry (node, left_id, right_id)
        # where ids index self.aln (leaves first, then internals in order)
        self.nodes: List[Tuple[int, int]] = []
        self.aln: Dict[int, Optional[_Alignment]] = {}
        self._number(root)
        self.pending = set(range(len(self.aa_codes), len(self.aa_codes) + len(self.nodes)))

    def _number(self, node: GuideNode) -> int:
        if node.is_leaf:
            L = len(self.aa_codes[node.idx])
            self.aln[node.idx] = _Alignment(
                [node.idx], np.arange(L, dtype=np.int32)[None, :]
            )
            return node.idx
        li = self._number(node.left)
        ri = self._number(node.right)
        nid = len(self.aa_codes) + len(self.nodes)
        self.nodes.append((li, ri))
        self.aln[nid] = None
        return nid

    def ready(self) -> List[int]:
        out = []
        for nid in sorted(self.pending):
            li, ri = self.nodes[nid - len(self.aa_codes)]
            if self.aln[li] is not None and self.aln[ri] is not None:
                out.append(nid)
        return out

    @property
    def root_aln(self) -> _Alignment:
        root_id = len(self.aa_codes) + len(self.nodes) - 1 if self.nodes else 0
        return self.aln[root_id]


class ProgressiveMSA:
    name = "torch-progressive-msa"

    def __init__(
        self,
        mode: str = "3di+aa",
        refine_iters: int = 0,
        gap_open: float = 11.0,
        gap_extend: float = 1.0,
        w_aa: float = 1.4,
        w_3di: float = 2.1,
        device=None,
    ):
        self.device = device_mod.resolve(device)
        self.mode = mode
        self.refine_iters = refine_iters
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        if mode == "3di+aa":
            self.w_aa, self.w_3di = w_aa, w_3di
        else:
            self.w_aa, self.w_3di = 1.0, 0.0
        self.saa = get_aa_matrix().astype(np.float32)
        self.s3d = get_3di_matrix().astype(np.float32)
        # integer DP units (exactness contract with ops/nw_device.py)
        self.go_q = int(round(QUANT * gap_open))
        self.ge_q = int(round(QUANT * gap_extend))
        # integer channel weights (x10): the score quantization is pure
        # integer arithmetic on count profiles (see _score_matrix)
        self._wA = int(round(10 * self.w_aa))
        self._wS = int(round(10 * self.w_3di))

    # ------------------------------------------------------------------
    def align(
        self, names: List[str], aa_seqs: List[str], ss_seqs: Optional[List[str]] = None
    ) -> Dict[str, str]:
        """Returns {name: aligned AA sequence with '-' gaps} preserving
        input order."""
        return self.align_many([(names, aa_seqs, ss_seqs)])[0]

    # ------------------------------------------------------------------
    def align_many(
        self, genes: Sequence[Tuple[List[str], List[str], Optional[List[str]]]]
    ) -> List[Dict[str, str]]:
        """Align many genes at once: each merge ROUND batches the ready
        merges of every gene into one device dispatch (nw_align_batch)."""
        t0 = time.time()
        results: List[Optional[Dict[str, str]]] = [None] * len(genes)
        tasks: List[Optional[_GeneTask]] = [None] * len(genes)
        # guide stage: ONE gram matmul over every gene's k-mer bags on the
        # engine's device instead of per-gene matmuls
        multi = [g for g, (_, aa_seqs, _) in enumerate(genes) if len(aa_seqs) > 1]
        Ds = kmer_distance_matrices([genes[g][1] for g in multi], device=self.device)
        D_by_gene = dict(zip(multi, Ds))
        for g, (names, aa_seqs, ss_seqs) in enumerate(genes):
            n = len(aa_seqs)
            if n == 0:
                results[g] = {}
                continue
            if n == 1:
                results[g] = {names[0]: aa_seqs[0]}
                continue
            aa_codes = [encode_aa(s).astype(np.int32) for s in aa_seqs]
            use_ss = self.w_3di > 0 and ss_seqs is not None
            ss_codes = (
                [encode_3di(s).astype(np.int32) for s in ss_seqs] if use_ss else None
            )
            tasks[g] = _GeneTask(names, aa_seqs, aa_codes, ss_codes, upgma(D_by_gene[g]))

        # ---- merge stage: software-pipelined across the merge DAG ----
        # Every ready merge dispatches as soon as its inputs exist; the
        # decode/apply/profile-build host work for one batch runs WHILE
        # later batches compute on device (CountsMergePipeline submit/
        # collect split).  The old round-barrier form (decode ALL of
        # round r before dispatching r+1) left the device idle for the
        # whole host phase every round.  Merge results are independent of
        # batch composition, so outputs are bit-identical to the round
        # form.
        pipe = CountsMergePipeline(self.go_q, self.ge_q, self.saa, self.s3d,
                                   self._wA, self._wS, device=self.device)
        n1n2_max = nw_counts_exact_bound(self.saa, self.s3d, self._wA, self._wS)
        ncells = 0.0
        merge_args: Dict[Tuple[int, int], Tuple[_Alignment, _Alignment]] = {}

        def stage_ready(gene_ids) -> List[tuple]:
            """Build entries for every currently-ready merge of the given
            genes; big merges run inline through the host-scored device
            DP (rare: n1*n2 > exact bound needs > ~180 taxa)."""
            nonlocal ncells
            keyed = []
            for g in gene_ids:
                task = tasks[g]
                if task is None or not task.pending:
                    continue
                rescan = True
                while rescan:  # big-path inline applies can unblock more
                    rescan = False
                    for nid in task.ready():
                        if (g, nid) in merge_args:
                            continue
                        li, ri = task.nodes[nid - len(task.aa_codes)]
                        a1, a2 = task.aln[li], task.aln[ri]
                        merge_args[(g, nid)] = (a1, a2)
                        n1, n2 = a1.cols.shape[0], a2.cols.shape[0]
                        ncells += float(a1.cols.shape[1] * a2.cols.shape[1])
                        if n1 * n2 > n1n2_max:
                            profiling.add_counter("msa.host_route_merges", 1)
                            S = self._score_matrix(a1, a2, task.aa_codes,
                                                   task.ss_codes)
                            (path, _), = nw_align_batch([S], self.go_q, self.ge_q,
                                                        device=self.device)
                            apply_merge(g, nid, path)
                            rescan = True
                            continue
                        c1a = _count_profile(a1, task.aa_codes, AA_SIZE)
                        c2a = _count_profile(a2, task.aa_codes, AA_SIZE)
                        c1s = c2s = None
                        if task.ss_codes is not None and self._wS:
                            c1s = _count_profile(a1, task.ss_codes, TDI_SIZE)
                            c2s = _count_profile(a2, task.ss_codes, TDI_SIZE)
                        keyed.append(((g, nid), (c1a, c1s, c2a, c2s, n1, n2)))
            return keyed

        def apply_merge(g: int, nid: int, path) -> None:
            task = tasks[g]
            a1, a2 = merge_args.pop((g, nid))
            task.aln[nid] = self._strip_empty(_merge(a1, a2, path))
            task.pending.discard(nid)

        # Flush policy: newly-unblocked merges ACCUMULATE until the
        # device pipeline is nearly dry (pending <= 1) or the buffer is
        # a full batch — flushing every collect's ~batch-of-unblocked
        # immediately fragments dispatches, and every dispatch pays the
        # forward's fixed cost (here: one row loop of small launches per
        # bucket).  Keeping >= 2 batches in flight preserves the
        # decode/compute overlap without shrinking batch sizes.
        buffer = stage_ready(range(len(tasks)))
        while buffer or pipe.pending():
            if buffer and (pipe.pending() <= 1 or len(buffer) >= 64):
                touched = set()
                for key, r in pipe.submit(buffer):
                    apply_merge(*key, r[0])
                    touched.add(key[0])
                buffer = []
                buffer.extend(stage_ready(sorted(touched)))
            done = pipe.collect_one()
            if done:
                touched = set()
                for (g, nid), (path, _) in done:
                    apply_merge(g, nid, path)
                    touched.add(g)
                # stage the merges the decodes just unblocked (their
                # device batches overlap the NEXT collect's host decode)
                buffer.extend(stage_ready(sorted(touched)))
        profiling.add_counter("msa.cells", ncells)

        # ---- linsi refinement: leave-one-out steps batched across genes
        # (each gene's steps stay strictly sequential — identical results
        # to the per-gene host loop — but every gene's current step rides
        # one nw_align_batch dispatch per round) ----
        states: Dict[int, list] = {}
        for g, task in enumerate(tasks):
            if task is None:
                continue
            aln = task.root_aln
            n = len(aln.rows)
            if self.refine_iters and n >= 3:
                sched = [r for _ in range(self.refine_iters) for r in range(n)]
                states[g] = [aln, sched, 0]
            else:
                results[g] = self._emit(aln, task.names, task.aa_seqs)
        while states:
            batch2: List[tuple] = []
            for g in sorted(states):
                aln, sched, pos = states[g]
                task = tasks[g]
                r = sched[pos]
                rows_rest = [i for i in range(len(aln.rows)) if i != r]
                rest = self._strip_empty(_Alignment(
                    [aln.rows[i] for i in rows_rest], aln.cols[rows_rest]
                ))
                solo_idx = aln.rows[r]
                L = len(task.aa_codes[solo_idx])
                solo = _Alignment([solo_idx], np.arange(L, dtype=np.int32)[None, :])
                S = self._score_matrix(rest, solo, task.aa_codes, task.ss_codes)
                batch2.append((g, rest, solo, S))
            paths = nw_align_batch([b[3] for b in batch2], self.go_q, self.ge_q,
                                   device=self.device)
            profiling.add_counter(
                "msa.cells", float(sum(b[3].shape[0] * b[3].shape[1] for b in batch2))
            )
            for (g, rest, solo, _), (path, _) in zip(batch2, paths):
                task = tasks[g]
                st = states[g]
                merged = self._strip_empty(_merge(rest, solo, path))
                prev = st[0]
                # NB: argsort(perm) is the INVERSE permutation — the row
                # order drifts rather than being restored.  Harmless
                # (rows/cols stay consistent; _emit maps by row id) but
                # it MUST match _refine's identical quirk or the
                # batched-vs-host equivalence breaks.
                order = np.argsort([merged.rows.index(x) for x in prev.rows])
                st[0] = _Alignment([merged.rows[i] for i in order], merged.cols[order])
                st[2] += 1
                if st[2] >= len(st[1]):
                    results[g] = self._emit(st[0], task.names, task.aa_seqs)
                    del states[g]
        profiling.add_counter("msa.seconds", time.time() - t0)
        return results

    # ------------------------------------------------------------------
    def _score_matrix(self, a1, a2, aa_codes, ss_codes) -> np.ndarray:
        """Quantized integer profile-profile scores — PURE INTEGER
        arithmetic (round-half-up of QUANT*(wA*A + wS*B)/(10*n1*n2) with
        A/B integer count-profile matmuls and wA/wS = round(10*w)), the
        exact formula the fused device path computes
        (ops/nw_device.py::_nw_counts_impl) — so host and device merges
        stay bit-identical including every tie decision."""
        C1a = _count_profile(a1, aa_codes, AA_SIZE)
        C2a = _count_profile(a2, aa_codes, AA_SIZE)
        n1, n2 = a1.cols.shape[0], a2.cols.shape[0]
        saa_i = self.saa.astype(np.int64)
        A = C1a @ saa_i @ C2a.T
        acc = self._wA * A
        if ss_codes is not None and self._wS:
            C1s = _count_profile(a1, ss_codes, TDI_SIZE)
            C2s = _count_profile(a2, ss_codes, TDI_SIZE)
            acc = acc + self._wS * (C1s @ self.s3d.astype(np.int64) @ C2s.T)
        n1n2 = max(n1, 1) * max(n2, 1)
        N = QUANT * acc
        return ((N + 5 * n1n2) // (10 * n1n2)).astype(np.int32)

    def _pairwise_merge(self, a1, a2, aa_codes, ss_codes) -> _Alignment:
        """Host-reference merge (same integer DP as the device path)."""
        Sq = self._score_matrix(a1, a2, aa_codes, ss_codes)
        path, _ = nw_align(Sq, go=self.go_q, ge=self.ge_q)
        merged = _merge(a1, a2, path)
        return self._strip_empty(merged)

    @staticmethod
    def _strip_empty(aln: _Alignment) -> _Alignment:
        keep = (aln.cols >= 0).any(axis=0)
        return _Alignment(aln.rows, aln.cols[:, keep])

    # ------------------------------------------------------------------
    def _refine(self, aln: _Alignment, aa_codes, ss_codes) -> _Alignment:
        """Leave-one-out iterative refinement (linsi-flavored)."""
        n = len(aln.rows)
        if n < 3:
            return aln
        for r in range(n):
            rows_rest = [i for i in range(n) if i != r]
            rest = self._strip_empty(
                _Alignment([aln.rows[i] for i in rows_rest], aln.cols[rows_rest])
            )
            solo_idx = aln.rows[r]
            L = len(aa_codes[solo_idx])
            solo = _Alignment([solo_idx], np.arange(L, dtype=np.int32)[None, :])
            merged = self._pairwise_merge(rest, solo, aa_codes, ss_codes)
            # NB: argsort(perm) is the INVERSE permutation (row order
            # drifts, harmlessly) — keep in lockstep with align_many's
            # batched refinement, which replicates this exactly
            order = np.argsort([merged.rows.index(x) for x in aln.rows])
            aln = _Alignment(
                [merged.rows[i] for i in order], merged.cols[order]
            )
        return aln

    # ------------------------------------------------------------------
    @staticmethod
    def _emit(aln: _Alignment, names: List[str], aa_seqs: List[str]) -> Dict[str, str]:
        out: Dict[str, str] = {}
        by_row = {sidx: r for r, sidx in enumerate(aln.rows)}
        for sidx in range(len(names)):
            idx = aln.cols[by_row[sidx]]
            seq_b = np.frombuffer(aa_seqs[sidx].encode(), dtype=np.uint8)
            if len(seq_b) == 0:
                # all-gap row: the clip-then-gather below would index an
                # empty array even though every lane selects '-'
                out[names[sidx]] = "-" * len(idx)
                continue
            chars = np.where(idx >= 0, seq_b[np.clip(idx, 0, None)], ord("-"))
            out[names[sidx]] = chars.astype(np.uint8).tobytes().decode()
        return out

    def probe(self) -> bool:
        out = self.align(["a", "b"], ["ACDE", "ACDE"], ["DDDD", "DDDD"])
        return out["a"] == "ACDE" and out["b"] == "ACDE"
