"""`createdb IN OUT MODEL_DIR` through unicore_tpu_torch's CLI against
unicore_tpu's on a small checkpoint in the real HF layout (bf16, the
CLI's default), on the CPU: the .map, combined_aa.fasta, the {db} and
{db}_h files and every index and .dbtype byte-identical, and {db}_ss
equal under the tie rule (torch_port_helpers.assert_same_3di)."""

import jax.numpy as jnp
import numpy as np

from torch_port_helpers import (  # noqa: F401  (port_env: fixture)
    assert_same_3di, files_of, port_env, write_prostt5_checkpoint, write_proteomes,
)
from unicore_tpu.cli import main as jax_main
from unicore_tpu.models import prostt5 as J
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.io.seqdb import read_db
from unicore_tpu_torch.models.prostt5 import _bucket_len, frame_batch
from unicore_tpu_torch.runtime import profiling


def test_createdb_checkpoint_cli_matches_jax(port_env, monkeypatch):  # noqa: F811
    monkeypatch.delenv("UNICORE_TPU_MOCK_PROSTT5", raising=False)
    write_proteomes(port_env / "in")
    ckpt = port_env / "ckpt"
    write_prostt5_checkpoint(ckpt, "bin", seed=6)
    profiling.reset_counters()
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        db = str(port_env / side / "proteome" / "proteome_db")
        assert main(["createdb", str(port_env / "in"), db, str(ckpt), "-v", "0"]) == 0
    ref, out = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(out)
    for name in ref:
        if name != "proteome/proteome_db_ss":
            assert ref[name] == out[name], name
    assert {"proteome/proteome_db.map", "proteome/combined_aa.fasta", "proteome/proteome_db_ss.index",
            "proteome/proteome_db_h", "proteome/proteome_db.dbtype"} <= set(out)
    seqs = read_db(str(port_env / "jax" / "proteome" / "proteome_db"))
    jss, tss = (read_db(str(port_env / side / "proteome" / "proteome_db_ss")) for side in ("jax", "port"))
    je = J.ProstT5Engine(str(ckpt))

    def ref_logits(i):
        toks, mask = frame_batch([seqs[i]], _bucket_len(len(seqs[i]) + 2))
        lg = J.residue_logits(je.params, je.cfg, jnp.asarray(toks.astype(np.int32)), jnp.asarray(mask))
        return np.asarray(lg)[0, 1:len(seqs[i]) + 1]

    assert_same_3di(seqs, jss, tss, ref_logits, "bfloat16")
    c = profiling.get_counters()
    assert c["prostt5.residues"] == sum(map(len, seqs)) and c["prostt5.batches"] >= 3
