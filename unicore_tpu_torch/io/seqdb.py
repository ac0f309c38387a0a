"""Flat sequence database ("seqdb") — Foldseek-DB-compatible triplets.

The reference pipeline communicates between stages through Foldseek
database triplets: `{db}` (AA sequences), `{db}_ss` (3Di strings),
`{db}_h` (headers), each a flat data file of NUL-terminated records plus
`.index` / `.dbtype` / `.lookup` side files.  The reference reads these
files *as text lines with embedded NULs* (seq/create_gene_specific_fasta.rs:9-25
strips a leading NUL per line), which fixes the record layout to

    <payload>\n\0<payload>\n\0...

We reproduce exactly that layout so reference tooling can cross-check any
stage.  Side files:
  * `{db}.index`   — "<id>\t<offset>\t<record-len>" per record
  * `{db}.dbtype`  — 4 little-endian bytes (0 = amino acid, 12 = header)
  * `{db}.lookup`  — "<id>\t<name>\t<file-id>" (foldseek lookup format)
  * `{db}.source`  — "<file-id>\t<source-file>" per input proteome
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

DBTYPE_AA = 0
DBTYPE_HEADER = 12
DBTYPE_3DI = 0  # foldseek stores 3Di as an aa-alphabet db
DBTYPE_ALIGNMENT = 5  # mmseqs/foldseek alignment result db
DBTYPE_CLUSTER = 6  # mmseqs/foldseek clustering result db


def _write_data(path: str, records: List[str]) -> List[tuple]:
    """Write NUL-terminated records; return (offset, length) per record."""
    index = []
    off = 0
    with open(path, "wb") as f:
        for rec in records:
            payload = rec.encode() + b"\n\x00"
            f.write(payload)
            index.append((off, len(payload)))
            off += len(payload)
    return index


def _write_index(path: str, entries: List[tuple]) -> None:
    with open(path, "w") as f:
        for i, (off, ln) in enumerate(entries):
            f.write(f"{i}\t{off}\t{ln}\n")


def _write_dbtype(path: str, dbtype: int) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<i", dbtype))


def read_db(path: str) -> List[str]:
    """Read a flat data file as the reference does (line records, strip NULs).

    Contract of create_gene_specific_fasta.rs:9-25: split on newlines,
    drop a single leading NUL per line, keep nonempty lines.
    """
    out: List[str] = []
    with open(path, "rb") as f:
        data = f.read()
    for raw in data.split(b"\n"):
        if raw.startswith(b"\x00"):
            raw = raw[1:]
        # records end with "\n\x00" so a trailing NUL may remain at EOF
        raw = raw.rstrip(b"\x00")
        if raw:
            out.append(raw.decode())
    return out


@dataclass
class SeqDB:
    """In-memory view of a database triplet.

    names[i], aa_seqs[i], ss_seqs[i] (3Di, optional) are parallel arrays.
    """

    names: List[str] = field(default_factory=list)
    aa_seqs: List[str] = field(default_factory=list)
    ss_seqs: Optional[List[str]] = None
    sources: Optional[List[str]] = None  # per-record source file-id name

    def __len__(self) -> int:
        return len(self.names)

    @property
    def has_ss(self) -> bool:
        return self.ss_seqs is not None and len(self.ss_seqs) == len(self.names)

    def name_to_idx(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.names)}

    # ---------------------------------------------------------------- write
    def write(self, db_path: str, source_files: Optional[List[str]] = None) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
        idx = _write_data(db_path, self.aa_seqs)
        _write_index(db_path + ".index", idx)
        _write_dbtype(db_path + ".dbtype", DBTYPE_AA)

        hidx = _write_data(db_path + "_h", self.names)
        _write_index(db_path + "_h.index", hidx)
        _write_dbtype(db_path + "_h.dbtype", DBTYPE_HEADER)

        if self.has_ss:
            sidx = _write_data(db_path + "_ss", self.ss_seqs)  # type: ignore[arg-type]
            _write_index(db_path + "_ss.index", sidx)
            _write_dbtype(db_path + "_ss.dbtype", DBTYPE_3DI)

        with open(db_path + ".lookup", "w") as f:
            for i, name in enumerate(self.names):
                file_id = 0
                if self.sources is not None and source_files:
                    try:
                        file_id = source_files.index(self.sources[i])
                    except ValueError:
                        file_id = 0
                # lookup stores the first token of the header
                f.write(f"{i}\t{name.split()[0] if name else name}\t{file_id}\n")
        if source_files:
            with open(db_path + ".source", "w") as f:
                for i, s in enumerate(source_files):
                    f.write(f"{i}\t{s}\n")

    # ----------------------------------------------------------------- read
    @classmethod
    def read(cls, db_path: str, require_ss: bool = False) -> "SeqDB":
        from unicore_tpu_torch.runtime import errors as err

        if not os.path.isfile(db_path):
            err.error(err.ERR_DB_INVALID, f"Database not found: {db_path}")
        names = read_db(db_path + "_h")
        aa = read_db(db_path)
        ss: Optional[List[str]] = None
        if os.path.isfile(db_path + "_ss"):
            ss = read_db(db_path + "_ss")
        elif require_ss:
            err.error(err.ERR_DB_INVALID, f"3Di database not found: {db_path}_ss")
        if len(names) != len(aa) or (ss is not None and len(ss) != len(names)):
            err.error(
                err.ERR_DB_INVALID,
                "Lengths of names, amino acid and 3di sequences in database are not same",
            )
        return cls(names=names, aa_seqs=aa, ss_seqs=ss)

    @classmethod
    def from_fasta(cls, fasta_path: str) -> "SeqDB":
        from unicore_tpu_torch.io.fasta import iter_fasta

        names, seqs = [], []
        for h, s in iter_fasta(fasta_path):
            names.append(h)
            seqs.append(s)
        return cls(names=names, aa_seqs=seqs)


def write_cluster_db(db_path: str, clusters: Dict[int, List[int]]) -> None:
    """Reference-format clustering result DB (the `{out}_cluster` that
    `foldseek cluster` leaves behind, cluster.rs:43-55 / --keep path):
    one record per representative, keyed by the rep's internal id in the
    .index, payload = member internal ids one per line, `\\n\\0` framing
    readable by the reference's read_db."""
    entries = []
    off = 0
    with open(db_path, "wb") as f:
        for rep in sorted(clusters):
            payload = ("\n".join(str(m) for m in clusters[rep])).encode() + b"\n\x00"
            f.write(payload)
            entries.append((rep, off, len(payload)))
            off += len(payload)
    with open(db_path + ".index", "w") as f:
        for key, o, ln in entries:
            f.write(f"{key}\t{o}\t{ln}\n")
    _write_dbtype(db_path + ".dbtype", DBTYPE_CLUSTER)


def write_aln_db(db_path: str, hits, qlen, tlen) -> None:
    """Reference-format alignment result DB (the `{out}_aln` that
    `foldseek search` leaves behind with --keep-aln-db, search.rs:64-72):
    one record per query, keyed by the query's internal id in the .index,
    payload = one alignment row per hit in the mmseqs/foldseek alignment
    format

        targetKey score seqId eValue qStart qEnd qLen tStart tEnd tLen

    (space-separated, 0-based inclusive coordinates), `\\n\\0` framing
    readable by the reference's read_db.  `hits` must be sorted by qidx
    (modules/search.py sorts before writing)."""
    by_query: Dict[int, List[str]] = {}
    for h in hits:
        by_query.setdefault(h.qidx, []).append(
            f"{h.tidx} {int(round(h.score))} {h.fident:.3f} {h.evalue:.3E} "
            f"{h.qstart} {h.qend} {qlen[h.qidx]} "
            f"{h.tstart} {h.tend} {tlen[h.tidx]}"
        )
    entries = []
    off = 0
    with open(db_path, "wb") as f:
        for qidx in sorted(by_query):
            payload = ("\n".join(by_query[qidx])).encode() + b"\n\x00"
            f.write(payload)
            entries.append((qidx, off, len(payload)))
            off += len(payload)
    with open(db_path + ".index", "w") as f:
        for key, o, ln in entries:
            f.write(f"{key}\t{o}\t{ln}\n")
    _write_dbtype(db_path + ".dbtype", DBTYPE_ALIGNMENT)


# ------------------------------------------------------------- db utilities
# Equivalents of `foldseek base:concatdbs / mvdb / rmdb` (createdb.rs:177-204)

def _suffixes(with_ss: bool = True) -> List[str]:
    sfx = ["", ".index", ".dbtype", "_h", "_h.index", "_h.dbtype", ".lookup", ".source"]
    if with_ss:
        sfx += ["_ss", "_ss.index", "_ss.dbtype"]
    return sfx


def rmdb(db_path: str) -> None:
    for sfx in _suffixes():
        p = db_path + sfx
        if os.path.isfile(p):
            os.remove(p)


def mvdb(src: str, dst: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    for sfx in _suffixes():
        p = src + sfx
        if os.path.isfile(p):
            os.replace(p, dst + sfx)


def concatdbs(a: str, b: str, out: str) -> None:
    da, db_ = SeqDB.read(a), SeqDB.read(b)
    merged = SeqDB(
        names=da.names + db_.names,
        aa_seqs=da.aa_seqs + db_.aa_seqs,
        ss_seqs=(da.ss_seqs or []) + (db_.ss_seqs or []) if (da.has_ss or db_.has_ss) else None,
    )
    merged.write(out)
