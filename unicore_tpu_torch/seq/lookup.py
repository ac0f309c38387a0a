"""AFDB / custom 3Di lookup tables.

Contract of seq/afdb_lookup.rs:50-181:
  * AFDB mode: md5(sequence + "\n") hex; shard = first two hex chars;
    table file {dir}/{shard}.tsv (or {dir}/md5/{shard}.tsv) with lines
    "md5hex\t3di"; found sequences are split into converted_aa.fasta /
    converted_ss.fasta (sorted), the rest go to combined_aa.fasta for
    model prediction.  Table download needs egress and is therefore
    gated: we never auto-download (offline environment) — a missing
    table is an error instructing the user to provide it.
  * custom mode: key = raw AA sequence against any seqdb pair
    ({db}, {db}_ss).

Copy of unicore_tpu/seq/lookup.py on the port's io and runtime.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Tuple

from unicore_tpu_torch.io import fasta
from unicore_tpu_torch.io.seqdb import read_db
from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg


# Upstream table host (afdb_lookup.rs:27: unicore.steineggerlab.workers.dev)
AFDB_TABLE_URL = "https://unicore.steineggerlab.workers.dev"
_ALL_SHARDS = [f"{i:02x}" for i in range(256)]


def download_afdb_tables(
    dest: str,
    base_url: str = AFDB_TABLE_URL,
    assume_yes: bool = False,
    shards=None,
) -> int:
    """Download the 256 md5-sharded AFDB 3Di tables (~30 GB total).

    Mirrors afdb_lookup.rs:15-64: per-shard `{base}/{shard}.tsv.gz`
    fetched and gunzipped to `{dest}/md5/{shard}.tsv`, with a stdin y/n
    confirmation for the 30 GB unless `assume_yes`.  Improvements over
    the reference: RESUMABLE (shards whose final .tsv already exists are
    skipped; partial downloads land in .part files and are atomically
    renamed) and CHECKSUMMED (the gzip CRC32 of every shard is verified
    by full decompression before the rename — upstream publishes no
    separate digests).  Returns the number of shards fetched.
    """
    import gzip
    import sys
    import urllib.request

    shards = list(shards) if shards is not None else _ALL_SHARDS
    md5_dir = os.path.join(dest, "md5")
    os.makedirs(md5_dir, exist_ok=True)
    todo = [s for s in shards if not _shard_ok(md5_dir, s)]
    if not todo:
        msg.println_message("AFDB lookup tables already present; nothing to do", 3)
        return 0
    if not assume_yes:
        if not sys.stdin.isatty():
            err.error(
                err.ERR_GENERAL,
                "AFDB table download needs ~30 GB; re-run with --afdb-download-yes "
                "or on an interactive terminal to confirm",
            )
        print(f"Download {len(todo)} AFDB table shards (~30 GB total)? [y/N] ",
              end="", flush=True)
        if input().strip().lower() not in ("y", "yes"):
            err.error(err.ERR_GENERAL, "AFDB table download declined")

    fetched = 0
    for i, s in enumerate(todo):
        final = os.path.join(md5_dir, f"{s}.tsv")
        part = final + ".part"
        url = f"{base_url}/{s}.tsv.gz"
        try:
            with urllib.request.urlopen(url) as resp:
                blob = resp.read()
            # full decompression validates the gzip CRC32 + length
            data = gzip.decompress(blob)
        except Exception as e:  # noqa: BLE001 — typed exit below
            err.error(err.ERR_GENERAL,
                      f"AFDB shard {s} download/verify failed: {e}")
        with open(part, "wb") as f:
            f.write(data)
        os.replace(part, final)  # atomic: resume never sees half a shard
        fetched += 1
        msg.print_message(
            f"\rDownloading AFDB tables... {i + 1}/{len(todo)}", 3)
    msg.println_message(" Done", 3)
    return fetched


def _shard_ok(md5_dir: str, shard: str) -> bool:
    p = os.path.join(md5_dir, f"{shard}.tsv")
    return os.path.isfile(p) and os.path.getsize(p) > 0


def split_by_lookup(
    fasta_data: Dict[str, str],
    lookup_path: str,
    custom: bool,
    out_dir: str,
) -> Tuple[Dict[str, Tuple[str, str]], Dict[str, str]]:
    """Returns (resolved {name: (aa, 3di)}, remaining {name: aa}) and writes
    converted_aa/ss.fasta + (caller writes combined_aa.fasta)."""
    if custom:
        resolved, remaining = _custom_lookup(fasta_data, lookup_path)
    else:
        resolved, remaining = _afdb_lookup(fasta_data, lookup_path)

    conv_aa = {h: aa for h, (aa, _) in resolved.items()}
    conv_ss = {h: ss for h, (_, ss) in resolved.items()}
    fasta.write_fasta(os.path.join(out_dir, "converted_aa.fasta"), conv_aa, sort=True)
    fasta.write_fasta(os.path.join(out_dir, "converted_ss.fasta"), conv_ss, sort=True)
    msg.println_message(f"{len(resolved)} sequences found from the lookup tables", 3)
    msg.println_message(f"{len(remaining)} sequences not found and will be predicted", 3)
    return resolved, remaining


def _afdb_lookup(fasta_data, path):
    md5_path = os.path.join(path, "md5")
    if os.path.isfile(os.path.join(path, "00.tsv")):
        md5_path = path
    if not os.path.isfile(os.path.join(md5_path, "00.tsv")):
        if os.environ.get("UNICORE_TPU_AFDB_AUTO_DOWNLOAD"):
            download_afdb_tables(path, assume_yes=True)
            md5_path = os.path.join(path, "md5")
        else:
            err.error(
                err.ERR_FILE_NOT_FOUND,
                f"AFDB lookup tables not found under {path} (zero-egress "
                "build: set UNICORE_TPU_AFDB_AUTO_DOWNLOAD=1 to fetch the "
                "256 md5-sharded tables, ~30 GB, resumable)",
            )
    shards: Dict[str, Dict[str, Tuple[str, str]]] = {}
    for h, seq in fasta_data.items():
        digest = hashlib.md5((seq + "\n").encode()).hexdigest()
        shards.setdefault(digest[:2], {})[h] = (digest, seq)

    resolved: Dict[str, Tuple[str, str]] = {}
    remaining: Dict[str, str] = {}
    for i, (hexs, items) in enumerate(sorted(shards.items())):
        table_file = os.path.join(md5_path, f"{hexs}.tsv")
        table: Dict[str, str] = {}
        with open(table_file) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    table[parts[0]] = parts[1]
        for h, (digest, seq) in items.items():
            ss = table.get(digest)
            if ss is not None:
                resolved[h] = (seq, ss)
            else:
                remaining[h] = seq
        msg.print_message(
            f"\rLooking up the AFDB tables... {100.0 * (i + 1) / len(shards):.1f}%", 3
        )
    msg.println_message(" Done", 3)
    return resolved, remaining


def _custom_lookup(fasta_data, path):
    if not os.path.isfile(path) or not os.path.isfile(path + "_ss"):
        err.error(
            err.ERR_GENERAL,
            "Custom lookup database does not exist or improperly formatted.",
        )
    table_aa = read_db(path)
    table_ss = read_db(path + "_ss")
    if len(table_aa) != len(table_ss):
        err.error(err.ERR_GENERAL, "The custom lookup database is not properly formatted.")
    table = dict(zip(table_aa, table_ss))
    resolved: Dict[str, Tuple[str, str]] = {}
    remaining: Dict[str, str] = {}
    for h, seq in fasta_data.items():
        ss = table.get(seq)
        if ss is not None:
            resolved[h] = (seq, ss)
        else:
            remaining[h] = seq
    return resolved, remaining
