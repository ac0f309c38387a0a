"""createdb — proteome FASTAs -> seqdb triplet with predicted 3Di.

Behavioral contract of modules/createdb.rs:20-217:
  * scan the input (directory of .fa/.fasta files, or a single file);
    species name = file stem (createdb.rs:89)
  * per sequence: drop len<2 (:96), optional --max-len filter (:93),
    sanitize header (:15-18,101), name = "unicore_" + md5(seq)[:10]
    (:104-106); write "{out}.map" (:86-108) and combined_aa.fasta
  * optional AFDB/custom lookup pre-resolves 3Di for known sequences
    (:128-135); the remainder goes through the model
  * translate AA -> 3Di with the deterministic mock backend and write the
    {db}, {db}_ss, {db}_h triplet
  * checkpoint createdb.chk, refusing to redo work without --overwrite
    (:55-65)

Counterpart of unicore_tpu/modules/createdb.py.  Not yet ported: a real
ProstT5 model directory and the AFDB / custom lookups (seq/lookup); they
end in a typed "not yet ported" error before anything is written.
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
    """Resolve the 3Di predictor backend from the model argument: only
    the mock backend is ported (UNICORE_TPU_MOCK_PROSTT5=1 selects it
    for any model argument, as in the JAX package)."""
    if model == "mock" or os.environ.get("UNICORE_TPU_MOCK_PROSTT5") == "1":
        from unicore_tpu_torch.models.mock import MockProstT5
        return MockProstT5()
    err.error(err.ERR_MODULE_NOT_IMPLEMENTED,
              f"ProstT5 model '{model}' is not yet ported to unicore_tpu_torch; use 'mock'")


def run(args) -> None:
    input_path = args.createdb_input
    output = args.createdb_output
    model = args.createdb_model
    overwrite = bool(args.createdb_overwrite)
    max_len = args.createdb_max_len

    if args.createdb_afdb_lookup or args.createdb_custom_lookup:
        err.error(err.ERR_MODULE_NOT_IMPLEMENTED,
                  "--afdb-lookup / --custom-lookup are not yet ported to unicore_tpu_torch")
    predictor = get_predictor(model)

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

    fasta.write_fasta(os.path.join(parent, "combined_aa.fasta"), fasta_data)

    # Translate AA -> 3Di
    names = list(fasta_data.keys())
    seqs = [fasta_data[n] for n in names]
    msg.print_message(f"Predicting 3Di for {len(seqs)} sequences...", 3)
    ss = predictor.predict(seqs) if seqs else []
    msg.println_message(" Done", 3)

    for s, q in zip(ss, seqs):
        if len(s) != len(q):
            err.error(err.ERR_GENERAL, "3Di prediction length mismatch")

    db = SeqDB(names=names, aa_seqs=seqs, ss_seqs=ss, sources=None)
    db.write(output, source_files=[os.path.basename(f) for f in fasta_files])

    chkpnt.write_checkpoint(chk, "1")
