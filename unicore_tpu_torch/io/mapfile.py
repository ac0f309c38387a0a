"""Gene-origin mapping (`{db}.map`) and md5-hashed sequence naming.

Contract of modules/createdb.rs:84-111:
  * record name = "unicore_" + first 10 hex chars of md5(sequence)
  * map line   = "<hashed_name>\t<species>\t<sanitized original header>"
  * header sanitization replaces whitespace and ;:,=/() with '_'
    (createdb.rs:15-18)
  * identical sequences across files collapse to one DB record but keep
    one map line per occurrence (HashMap insert overwrites).
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, Iterable, List, Set, Tuple

_SANITIZE_RE = re.compile(r"[\s;:,=/()]")


def sanitize_header(header: str) -> str:
    return _SANITIZE_RE.sub("_", header)


def hashed_name(sequence: str) -> str:
    return "unicore_" + hashlib.md5(sequence.encode()).hexdigest()[:10]


def write_map(path: str, rows: Iterable[Tuple[str, str, str]]) -> None:
    with open(path, "w") as f:
        for name, species, header in rows:
            f.write(f"{name}\t{species}\t{header}\n")


def read_map(path: str) -> List[Tuple[str, str, str]]:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                rows.append((parts[0], parts[1], parts[2]))
    return rows


def gene_to_species(path: str) -> Tuple[Dict[str, Set[str]], Set[str]]:
    """First-two-whitespace-columns view used by profile (profile.rs:17-27)."""
    gene_to_spe: Dict[str, Set[str]] = {}
    species: Set[str] = set()
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            gene_to_spe.setdefault(parts[0], set()).add(parts[1])
            species.add(parts[1])
    return gene_to_spe, species
