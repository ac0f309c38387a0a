"""easy-core workflow: createdb -> cluster -> profile -> tree.

Counterpart of unicore_tpu/workflow/easy_core.py (workflow/easy_core.rs:
14-95): each stage is skipped iff its checkpoint file reads "1" (createdb
additionally honors --overwrite).  The tree stage runs the MSA, the
supermatrix and, unless -n/--no-inference, species-tree inference
(modules/tree.py); tree options naming a partition file (-p/-q) exit with
ERR_MODULE_NOT_IMPLEMENTED before any stage writes anything (cli.run checks
them first).
"""

from __future__ import annotations

import os

from unicore_tpu_torch.modules import cluster, createdb, profile, tree
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

    cluster_parent = os.path.dirname(args.cluster_output) or "."
    if chkpnt.is_done(os.path.join(cluster_parent, "cluster.chk")):
        msg.println_message("Clustered database already exists, skipping cluster", 3)
    else:
        with profiling.stage("cluster"):
            cluster.run(args)

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
