"""TreeEngine — the in-process equivalent of iqtree / fasttree / raxml-ng.

Consumes an alignment (fasta path or dict), runs model setup + ML search
+ bootstrap, and writes the same principal output files the reference
expects from each builder (tree.rs:233-296):

  * iqtree   -> {out}/iqtree.treefile (+ iqtree.log, iqtree.iqtree)
               options: "-m JTT+F+I+G -B 1000" (default, tree.rs:143)
  * fasttree -> {out}/fasttree.nwk
               options: "-gamma -boot 1000"
  * raxml-ng -> {out}/raxml-ng.raxml.bestTree + .raxml.support
               options: "--model JTT+F+I+G --seed 12345 --all
                         --tree pars{90},rand{10}"

Schedules differ in search effort (starting trees, NNI rounds); the
likelihood core is shared.

Counterpart of unicore_tpu/phylo/engine.py: the same schedules, option
parsing, model optimization, bootstrap and output files, over the port's
LikelihoodEngine on the engine's device (runtime/device.py).  Not ported
yet, each a typed ERR_MODULE_NOT_IMPLEMENTED raised before anything is
written: partitioned models (`-p`/`-q`, phylo/partition.py) and the
batched gene-tree entries `infer_batched`/`run_files` (`gene-tree`).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from unicore_tpu_torch.io import fasta
from unicore_tpu_torch.phylo.likelihood import (
    LikelihoodEngine,
    arrays_to_tree,
    empirical_frequencies,
    msa_to_codes,
    unroot,
)
from unicore_tpu_torch.phylo.models import ModelSpec, SubstModel
from unicore_tpu_torch.phylo.newick import Node
from unicore_tpu_torch.phylo.nj import neighbor_joining, protein_distances
from unicore_tpu_torch.phylo.search import TreeSearch
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling


def _parse_tokens(options: str) -> Dict[str, str]:
    toks = (options or "").split()
    out: Dict[str, str] = {}
    i = 0
    while i < len(toks):
        t = toks[i]
        if t.startswith("-"):
            if i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                out[t] = toks[i + 1]
                i += 2
                continue
            out[t] = ""
        i += 1
    return out


def check_ported_options(options: str) -> None:
    """The typed exit for tree options the port does not run yet: a
    partition file (`-p FILE` / `-q FILE`, as the JAX engine reads it)."""
    opts = _parse_tokens(options)
    if opts.get("-p") or opts.get("-q"):
        err.error(err.ERR_MODULE_NOT_IMPLEMENTED,
                  "partitioned models (-p/-q) are not yet ported to unicore_tpu_torch")


def _not_ported(what: str) -> None:
    err.error(err.ERR_MODULE_NOT_IMPLEMENTED,
              f"{what} (gene-tree) is not yet ported to unicore_tpu_torch")


class TreeEngine:
    name = "torch-phylo"

    def __init__(self, schedule: str = "iqtree", device=None):
        self.schedule = schedule
        self.device = device_mod.resolve(device)

    # ------------------------------------------------------------------
    def infer(
        self,
        msa: Dict[str, str],
        options: str = "",
        seed: int = 12345,
        n_boot: Optional[int] = None,
        model_str: Optional[str] = None,
        n_starts: int = 1,
        max_nni_rounds: int = 20,
        blen_steps: int = 150,
    ) -> Tuple[Node, float, Dict]:
        """Run inference; returns (tree_with_supports, lnL, info)."""
        check_ported_options(options)
        t_start = time.time()
        _, model_str, n_boot, seed, n_starts, max_nni_rounds = self._parse_opts(
            options, model_str, n_boot, seed, n_starts, max_nni_rounds
        )
        names = list(msa.keys())
        seqs = [msa[n] for n in names]
        if len(names) < 2:
            t = Node()
            for n in names:
                t.add(Node(n, 0.0))
            return t, 0.0, {"n_taxa": len(names)}
        if len(names) == 2:
            D = protein_distances(names, seqs)
            t = Node()
            t.add(Node(names[0], D[0, 1] / 2))
            t.add(Node(names[1], D[0, 1] / 2))
            return t, 0.0, {"n_taxa": 2}

        spec = ModelSpec.parse(model_str)
        codes = msa_to_codes(names, seqs)
        freqs = empirical_frequencies(codes)
        model = SubstModel.build(spec, empirical_freqs=freqs, alpha=1.0, p_inv=0.02 if spec.plus_i else 0.0)

        t0 = time.time()
        engine = LikelihoodEngine(names, seqs, model, device=self.device)
        msg.println_message(
            f"  {len(names)} taxa, {engine.L} sites, {engine.patterns.shape[1]} patterns", 4
        )
        profiling.add_counter("phylo.patterns", engine.patterns.shape[1])

        # starting tree(s)
        D = protein_distances(names, seqs)
        nj_tree = neighbor_joining(D, names)
        search = TreeSearch(engine, seed=seed)

        best_tree, best_ll = search.optimize(
            nj_tree, max_rounds=max_nni_rounds, blen_steps=blen_steps
        )

        # model parameter optimization (alpha, p_inv) + re-search once
        if spec.plus_g or spec.plus_i:
            model = self._optimize_model(engine, search, spec, freqs, best_tree)
            best_tree, best_ll = search.optimize(
                best_tree, max_rounds=max_nni_rounds, blen_steps=blen_steps
            )

        for s in range(1, n_starts):
            start = search.perturb(best_tree, n_moves=2 + s)
            t, ll = search.optimize(start, max_rounds=max_nni_rounds, blen_steps=blen_steps)
            if ll > best_ll:
                best_tree, best_ll = t, ll

        info = {
            "n_taxa": len(names),
            "n_sites": engine.L,
            "n_patterns": int(engine.patterns.shape[1]),
            "n_partitions": 1,
            "lnL": best_ll,
            "alpha": model.alpha,
            "p_inv": model.p_inv,
            "model": model_str,
            "seconds": time.time() - t0,
        }

        # bootstrap supports
        if n_boot and len(names) >= 4:
            best_tree = self._bootstrap(engine, best_tree, n_boot, seed)
            # low-support full-data NNI polish: at supermatrix scale the
            # subsampled topology search can stop short of splits the
            # FULL data supports (measured config-4: the mis-inferred
            # splits carried UFBoot support 0.0).  Re-bootstrap when the
            # topology changes so reported supports match the final tree.
            from unicore_tpu_torch.phylo.newick import bipartitions as _bips
            low = [k for k, nd in _bips(best_tree).items()
                   if nd.support is not None and nd.support < 60.0]
            if low:
                polished, pll, moved = search.polish_edges(
                    best_tree, engine, low, blen_steps=blen_steps)
                if moved:
                    best_tree, best_ll = polished, pll
                    info["lnL"] = best_ll
                    best_tree = self._bootstrap(engine, best_tree, n_boot, seed)

        profiling.add_counter("phylo.seconds", time.time() - t_start)
        return unroot(best_tree), best_ll, info

    # ------------------------------------------------------------------
    def _parse_opts(self, options, model_str, n_boot, seed, n_starts, max_nni_rounds):
        """Per-schedule option resolution."""
        opts = _parse_tokens(options)
        if self.schedule == "iqtree":
            model_str = model_str or opts.get("-m", "JTT+F+I+G")
            n_boot = n_boot if n_boot is not None else int(opts.get("-B", opts.get("-bb", "0")) or 0)
        elif self.schedule == "raxml-ng":
            model_str = model_str or opts.get("--model", "JTT+F+I+G")
            seed = int(opts.get("--seed", seed) or seed)
            n_boot = n_boot if n_boot is not None else (1000 if "--all" in opts else 0)
            n_starts = max(n_starts, 3)
        elif self.schedule == "fasttree":
            model_str = model_str or ("JTT+F+G" if "-gamma" in opts else "JTT+F")
            n_boot = n_boot if n_boot is not None else int(opts.get("-boot", "0") or 0)
            max_nni_rounds = min(max_nni_rounds, 10)
        else:
            model_str = model_str or "JTT+F+I+G"
            n_boot = n_boot or 0
        return opts, model_str, n_boot, seed, n_starts, max_nni_rounds

    # ------------------------------------------------------------------
    def infer_batched(self, msas: List[Dict[str, str]], options: str = "", **_) -> list:
        """Batched gene-tree inference (phylo/genebatch.py): not yet ported."""
        _not_ported("batched gene-tree inference (TreeEngine.infer_batched)")

    # ------------------------------------------------------------------
    def _optimize_model(self, engine, search, spec, freqs, tree) -> SubstModel:
        """Coordinate golden-section over alpha (and p_inv)."""
        from unicore_tpu_torch.phylo.likelihood import make_root_binary, tree_to_arrays
        from unicore_tpu_torch.phylo.search import copy_tree

        children, blens = tree_to_arrays(make_root_binary(copy_tree(tree)), engine.names)

        def ll_for(alpha: float, p_inv: float) -> float:
            m = SubstModel.build(spec, empirical_freqs=freqs, alpha=alpha, p_inv=p_inv)
            engine.set_model(m)
            return engine.loglik(children, blens)

        alpha, p_inv = 1.0, (0.02 if spec.plus_i else 0.0)
        if spec.plus_g:
            grid = [0.2, 0.4, 0.7, 1.0, 1.5, 2.5, 4.0]
            lls = [ll_for(a, p_inv) for a in grid]
            alpha = grid[int(np.argmax(lls))]
            # one refinement pass around the best point
            lo = max(alpha * 0.6, 0.05)
            hi = alpha * 1.6
            grid2 = np.linspace(lo, hi, 5)
            lls2 = [ll_for(a, p_inv) for a in grid2]
            alpha = float(grid2[int(np.argmax(lls2))])
        if spec.plus_i:
            grid = [0.0, 0.02, 0.05, 0.1, 0.2]
            lls = [ll_for(alpha, p) for p in grid]
            p_inv = float(grid[int(np.argmax(lls))])
        final = SubstModel.build(spec, empirical_freqs=freqs, alpha=alpha, p_inv=p_inv)
        engine.set_model(final)
        return final

    # ------------------------------------------------------------------
    def _bootstrap(self, engine, best_tree, n_boot, seed) -> Node:
        """True per-replicate bootstrap (`-B 1000` UFBoot semantics,
        tree.rs:143): every replicate runs its own weighted NNI climb
        from the ML tree (phylo/bootstrap.py::ufboot_supports).  The
        round-2 pool-RELL (fixed candidate set) is gone — splits outside
        a sampled pool could never lose there."""
        from unicore_tpu_torch.phylo.bootstrap import ufboot_supports

        return ufboot_supports(engine, best_tree, n_boot=n_boot, seed=seed)

    # ------------------------------------------------------------------
    def run_file(
        self, msa_fasta: str, output_dir: str, options: str = "", threads: int = 0
    ) -> str:
        """File-level entry with the per-builder output conventions."""
        msa = fasta.read_fasta(msa_fasta)
        tree, ll, info = self.infer(msa, options=options)
        return self._write_outputs(tree, info, output_dir)

    def run_files(self, msa_fastas: List[str], output_dirs: List[str],
                  options: str = "", threads: int = 0) -> List[str]:
        """Batched file-level entry over `infer_batched`: not yet ported."""
        _not_ported("batched gene-tree inference (TreeEngine.run_files)")

    def _write_outputs(self, tree: Node, info: Dict, output_dir: str) -> str:
        os.makedirs(output_dir, exist_ok=True)
        if self.schedule == "iqtree":
            out = os.path.join(output_dir, "iqtree.treefile")
            with open(out, "w") as f:
                f.write(tree.to_newick() + "\n")
            with open(os.path.join(output_dir, "iqtree.iqtree"), "w") as f:
                f.write(self._report(info))
            with open(os.path.join(output_dir, "iqtree.log"), "w") as f:
                f.write(self._report(info))
        elif self.schedule == "fasttree":
            out = os.path.join(output_dir, "fasttree.nwk")
            with open(out, "w") as f:
                f.write(tree.to_newick() + "\n")
        elif self.schedule == "raxml-ng":
            out = os.path.join(output_dir, "raxml-ng.raxml.bestTree")
            with open(out, "w") as f:
                f.write(tree.to_newick(with_support=False) + "\n")
            with open(os.path.join(output_dir, "raxml-ng.raxml.support"), "w") as f:
                f.write(tree.to_newick() + "\n")
        else:
            out = os.path.join(output_dir, "tree.nwk")
            with open(out, "w") as f:
                f.write(tree.to_newick() + "\n")
        return out

    @staticmethod
    def _report(info: Dict) -> str:
        lines = ["unicore_tpu phylogenetic inference report", ""]
        for k, v in info.items():
            lines.append(f"{k}: {v}")
        return "\n".join(lines) + "\n"

    def probe(self) -> bool:
        msa = {"a": "ACDEFGHIKL", "b": "ACDEFGHIKL", "c": "ACDEFGHIKW"}
        tree, _, _ = self.infer(msa, n_boot=0, model_str="JTT")
        return len(tree.leaves()) == 3
