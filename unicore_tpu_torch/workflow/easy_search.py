"""easy-search workflow: createdb -> search -> profile -> tree.

Counterpart of unicore_tpu/workflow/easy_search.py.  Mirrors workflow/easy_search.rs:14-95 (identical shape to easy-core with
search as step 2; profile consumes search/search.m8 whose column 1 is the
*reference* gene — search.rs:44-46 runs the reference DB as the alignment
query).
"""

from __future__ import annotations

import os

from unicore_tpu_torch.modules import createdb, profile, search, tree
from unicore_tpu_torch.runtime import checkpoint as chkpnt
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling


def run(args) -> None:
    out_db_parent = os.path.dirname(args.createdb_output) or "."
    if chkpnt.is_done(os.path.join(out_db_parent, "createdb.chk")) and not args.createdb_overwrite:
        msg.println_message("Database already exists, skipping createdb", 3)
    else:
        with profiling.stage("createdb"):
            createdb.run(args)

    search_parent = os.path.dirname(args.search_output) or "."
    if chkpnt.is_done(os.path.join(search_parent, "search.chk")):
        msg.println_message("Search result already exists, skipping search", 3)
    else:
        with profiling.stage("search"):
            search.run(args)

    if chkpnt.is_done(os.path.join(args.profile_output, "profile.chk")):
        msg.println_message("Profiled database already exists, skipping profile", 3)
    else:
        with profiling.stage("profile"):
            profile.run(args)

    if chkpnt.is_done(os.path.join(args.tree_output, "tree.chk")):
        msg.println_message("Tree already exists, skipping tree", 3)
    else:
        with profiling.stage("tree"):
            tree.run(args)
