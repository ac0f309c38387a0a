"""profile — taxonomic profiling / core-gene identification.

Bit-exact re-implementation of the reference's one pure-algorithmic stage
(src/modules/profile.rs:13-171):

  * loads `{db}.map` -> gene -> {species} (split_whitespace, cols 0/1)
  * streams the cluster TSV (rep\tmember) or search m8 (ref-gene\tmember...)
    sequentially grouped on column 1 changes
  * per group counts per-species copy numbers of mapped members
  * core test: single_copy * 100 >= threshold * species_count   (:134)
  * copiness.tsv: "Query\tMultipleCopyPercent\tSingleCopyPercent" where
    MultipleCopyPercent = 100 * |species with >=1 copy| / |species| and
    SingleCopyPercent   = 100 * |species with exactly 1 copy| / |species|
  * per-core-gene `{display}.txt` where display = query.split('-')[1] if
    present (AFDB AF-XXXX-F1 -> accession) else query; lines are
    "member\tspecies" for species carrying exactly one distinct member
  * warns about species covering < (core_cnt+1)/2 of core genes (:109-115)

Float formatting matches Rust's `{}` Display for f64 (shortest roundtrip,
integral values without ".0").
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Set, TextIO

from unicore_tpu_torch.io.mapfile import gene_to_species
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg


def fmt_f64(x: float) -> str:
    """Rust `{}`-style f64 display: shortest roundtrip, no trailing '.0'."""
    if x == int(x) and abs(x) < 1e16:
        return str(int(x))
    return repr(x)


def _flush_group(
    out: Optional[TextIO],
    query: str,
    spe_cnt: Dict[str, int],
    gene2spe: Dict[str, Set[str]],
    species_count: int,
    threshold: int,
    output_dir: str,
) -> bool:
    single_copy = sum(1 for c in spe_cnt.values() if c == 1)
    multiple_copy = len(spe_cnt)

    single_pct = single_copy * 100.0 / species_count
    multiple_pct = multiple_copy * 100.0 / species_count

    msg.println_message(
        f"Gene {query} reported {single_pct:.2f}% single copy and {multiple_pct:.2f}% multiple copy",
        4,
    )
    if out is not None:
        out.write(f"{query}\t{fmt_f64(multiple_pct)}\t{fmt_f64(single_pct)}\n")

    if single_copy * 100 >= threshold * species_count:
        parts = query.split("-")
        display = parts[1] if len(parts) > 1 else query
        path = os.path.join(output_dir, f"{display}.txt")
        with open(path, "w") as f:
            # deterministic order (the reference iterates a HashMap; line
            # order is unspecified there, so sorting is contract-compatible)
            for spe in sorted(gene2spe):
                targets = gene2spe[spe]
                if len(targets) == 1:
                    f.write(f"{next(iter(targets))}\t{spe}\n")
        return True
    return False


def profile(
    tsv_file: str,
    mapping: str,
    output_dir: str,
    threshold: int,
    print_copiness: bool,
) -> None:
    gene_to_spe, species_set = gene_to_species(mapping)
    species_count = len(species_set)
    if species_count == 0:
        err.error(err.ERR_GENERAL, f"No species found in mapping file {mapping}")

    out: Optional[TextIO] = None
    if print_copiness:
        out = open(os.path.join(output_dir, "copiness.tsv"), "w")
        out.write("Query\tMultipleCopyPercent\tSingleCopyPercent\n")

    spe_full_cnt: Dict[str, int] = {spe: 0 for spe in species_set}
    total_cnt = 0
    core_cnt = 0

    msg.print_message("Profiling the taxonomic distribution of the genes...", 3)

    curr_query: Optional[str] = None
    spe_cnt: Dict[str, int] = {}
    gene2spe: Dict[str, Set[str]] = {}

    def _finish_group(q: str) -> None:
        nonlocal total_cnt, core_cnt
        total_cnt += 1
        is_core = _flush_group(out, q, spe_cnt, gene2spe, species_count, threshold, output_dir)
        if is_core:
            core_cnt += 1
            for spe, count in spe_cnt.items():
                if count == 1:
                    if spe in spe_full_cnt:
                        spe_full_cnt[spe] += 1
                    else:
                        err.error(err.ERR_GENERAL, f"Species {spe} not found in the mapping file")

    with open(tsv_file) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            query, target = parts[0], parts[1]
            if query != curr_query:
                if curr_query is not None:
                    _finish_group(curr_query)
                curr_query = query
                spe_cnt = {}
                gene2spe = {}
            species = gene_to_spe.get(target)
            if species is not None:
                for spe in species:
                    spe_cnt[spe] = spe_cnt.get(spe, 0) + 1
                    gene2spe.setdefault(spe, set()).add(target)

    if curr_query is not None:
        _finish_group(curr_query)

    if out is not None:
        out.close()

    msg.println_message(" Done", 3)
    msg.println_message(f"{core_cnt} structural core genes found from {total_cnt} candidates", 3)

    core_threshold = (core_cnt + 1) // 2
    for spe in sorted(spe_full_cnt):
        count = spe_full_cnt[spe]
        if count < core_threshold:
            err.warning(
                err.WRN_GENERAL,
                f"Species {spe} has only {count} core genes out of {core_cnt} core genes",
            )


def run(args) -> None:
    """Module entry (profile.rs:149-171): checkpoints + dir creation."""
    input_db = args.profile_input_db
    input_tsv = args.profile_input_tsv
    output = args.profile_output
    threshold = args.profile_threshold
    print_copiness = args.profile_print_copiness

    os.makedirs(output, exist_ok=True)
    chkpnt.write_checkpoint(os.path.join(output, "profile.chk"), "0")
    profile(input_tsv, input_db + ".map", output, threshold, print_copiness)
    chkpnt.write_checkpoint(os.path.join(output, "profile.chk"), "1")
