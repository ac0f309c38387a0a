"""createdb — proteome FASTAs -> seqdb triplet with predicted 3Di.

Behavioral contract of modules/createdb.rs:20-217:
  * scan the input (directory of .fa/.fasta files, or a single file);
    species name = file stem (createdb.rs:89)
  * per sequence: drop len<2 (:96), optional --max-len filter (:93),
    sanitize header (:15-18,101), name = "unicore_" + md5(seq)[:10]
    (:104-106); write "{out}.map" (:86-108) and combined_aa.fasta
  * optional AFDB/custom lookup pre-resolves 3Di for known sequences
    (:128-135); the remainder goes through the model
  * translate AA -> 3Di with ProstT5 (models/prostt5.py on the device
    runtime/device.py resolves, or the deterministic mock backend) and
    write the {db}, {db}_ss, {db}_h triplet
  * checkpoint createdb.chk, refusing to redo work without --overwrite
    (:55-65)

Counterpart of unicore_tpu/modules/createdb.py, in its order: the model
is made after the .map and combined_aa.fasta are written.
"""

from __future__ import annotations

import os
from typing import Dict, List

from unicore_tpu_torch.io import fasta
from unicore_tpu_torch.io.mapfile import hashed_name, sanitize_header, write_map
from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg


def _gather_fasta_files(input_path: str) -> List[str]:
    if os.path.isfile(input_path):
        return [input_path]
    if not os.path.isdir(input_path):
        err.error(err.ERR_FILE_NOT_FOUND, input_path)
    files = []
    for name in sorted(os.listdir(input_path)):
        if name.endswith(".fa") or name.endswith(".fasta"):
            files.append(os.path.join(input_path, name))
    if not files:
        err.error(err.ERR_GENERAL, f"No fasta files found in {input_path}")
    return files


def get_predictor(model: str):
    """Resolve the 3Di predictor backend from the model argument.

    `mock` stays a CLI-level backend choice (UNICORE_TPU_MOCK_PROSTT5=1
    selects it for any model argument, as in the JAX package); otherwise
    the engine comes from the registry so engines.cfg can override it."""
    if model == "mock" or os.environ.get("UNICORE_TPU_MOCK_PROSTT5") == "1":
        from unicore_tpu_torch.models.mock import MockProstT5
        return MockProstT5()
    if model not in ("random",) and os.path.isdir(model):
        # createdb.rs:148-155 analog: fetch weights into the model dir
        # when absent (gated; no-op on zero-egress builds)
        from unicore_tpu_torch.models.fetch import maybe_download_prostt5
        maybe_download_prostt5(model)
    from unicore_tpu_torch.runtime import registry
    return registry.get("prostt5")(model)


def run(args) -> None:
    input_path = args.createdb_input
    output = args.createdb_output
    model = args.createdb_model
    overwrite = bool(args.createdb_overwrite)
    max_len = args.createdb_max_len

    parent = os.path.dirname(output) or "."
    os.makedirs(parent, exist_ok=True)

    chk = os.path.join(parent, "createdb.chk")
    if chkpnt.is_done(chk) and not overwrite:
        err.error(
            err.ERR_GENERAL,
            "Database already exists, please use --overwrite option to overwrite it",
        )
    chkpnt.write_checkpoint(chk, "0")

    fasta_files = _gather_fasta_files(input_path)

    # Read fastas; build hashed-name records and the .map file
    map_rows = []
    fasta_data: Dict[str, str] = {}
    for file in fasta_files:
        species = os.path.splitext(os.path.basename(file))[0]
        for key, value in fasta.read_fasta(file).items():
            if max_len is not None and len(value) > max_len:
                continue
            if len(value) < 2:
                msg.println_message(f"Skipping {key} as it is too short", 3)
                continue
            key = sanitize_header(key)
            name = hashed_name(value)
            fasta_data[name] = value
            map_rows.append((name, species, key))
    write_map(output + ".map", map_rows)

    combined_aa = os.path.join(parent, "combined_aa.fasta")

    # AFDB / custom lookup split: known sequences get precomputed 3Di,
    # the rest ("combined") go through the model (createdb.rs:128-135).
    pre_names: List[str] = []
    pre_aa: List[str] = []
    pre_ss: List[str] = []
    lookup = args.createdb_afdb_lookup or args.createdb_custom_lookup
    if lookup:
        from unicore_tpu_torch.seq.lookup import split_by_lookup
        resolved, remaining = split_by_lookup(
            fasta_data, lookup, custom=bool(args.createdb_custom_lookup),
            out_dir=parent,
        )
        for name, (aa_seq, ss_seq) in resolved.items():
            pre_names.append(name)
            pre_aa.append(aa_seq)
            pre_ss.append(ss_seq)
        fasta.write_fasta(combined_aa, remaining)
        todo = remaining
    else:
        fasta.write_fasta(combined_aa, fasta_data)
        todo = fasta_data

    # Translate AA -> 3Di
    predictor = get_predictor(model)
    names = list(todo.keys())
    seqs = [todo[n] for n in names]
    msg.print_message(f"Predicting 3Di for {len(seqs)} sequences...", 3)
    ss = predictor.predict(seqs) if seqs else []
    msg.println_message(" Done", 3)

    for s, q in zip(ss, seqs):
        if len(s) != len(q):
            err.error(err.ERR_GENERAL, "3Di prediction length mismatch")

    db = SeqDB(
        names=pre_names + names,
        aa_seqs=pre_aa + seqs,
        ss_seqs=pre_ss + ss,
        sources=None,
    )
    db.write(output, source_files=[os.path.basename(f) for f in fasta_files])

    chkpnt.write_checkpoint(chk, "1")
