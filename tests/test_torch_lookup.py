"""The port's AFDB / custom 3Di lookups (unicore_tpu_torch/seq/lookup.py)
and the ProstT5 weight fetcher (unicore_tpu_torch/models/fetch.py)
against the JAX package's, on the CPU: `split_by_lookup` equal, the
downloaders against a local HTTP server (resume, CRC and size checks,
the gates), and `createdb mock --afdb-lookup|--custom-lookup` through
both CLIs with every file byte-identical."""

import gzip
import hashlib
import http.server
import os
import threading

import pytest

from torch_port_helpers import files_of, port_env, write_proteomes  # noqa: F401  (fixture)
from unicore_tpu.cli import main as jax_main
from unicore_tpu.seq import lookup as jlookup
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.io.fasta import read_fasta
from unicore_tpu_torch.io.seqdb import SeqDB
from unicore_tpu_torch.models import fetch as tfetch
from unicore_tpu_torch.runtime import errors
from unicore_tpu_torch.seq import lookup as tlookup


def _md5(seq):
    return hashlib.md5((seq + "\n").encode()).hexdigest()


def _afdb_tables(root, known, layout="md5"):
    """256 shard tables, every other sequence of `known` {aa: 3di} listed;
    `layout` "md5" puts them under root/md5, "flat" in root itself."""
    d = root / "md5" if layout == "md5" else root
    d.mkdir(parents=True)
    shards = {f"{i:02x}": [] for i in range(256)}
    for aa, ss in sorted(known.items())[::2]:
        shards[_md5(aa)[:2]].append(f"{_md5(aa)}\t{ss}\n")
    for s, lines in shards.items():
        (d / f"{s}.tsv").write_text("".join(lines) + "ffff\tjunk-without-match\nshort\n")


def _custom_db(path, known):
    items = sorted(known.items())[1::2]
    SeqDB(names=[f"n{i}" for i in range(len(items))], aa_seqs=[a for a, _ in items],
          ss_seqs=[s for _, s in items], sources=None).write(str(path), source_files=["x.fa"])


def _fasta_data(ind):
    out = {}
    for f in sorted(os.listdir(ind)):
        for k, v in read_fasta(str(ind / f)).items():
            out[f"unicore_{len(out)}_{k}"] = v
    return out


@pytest.mark.parametrize("custom,layout", [(False, "md5"), (False, "flat"), (True, None)])
def test_split_by_lookup_equals_jax(port_env, custom, layout):  # noqa: F811
    write_proteomes(port_env / "in")
    data = _fasta_data(port_env / "in")
    known = {aa: "V" * len(aa) for aa in data.values()}
    table = port_env / "table"
    if custom:
        _custom_db(table, known)
    else:
        _afdb_tables(table, known, layout)
    out = []
    for mod, side in ((jlookup, "jax"), (tlookup, "port")):
        (port_env / side).mkdir()
        out.append(mod.split_by_lookup(data, str(table), custom=custom, out_dir=str(port_env / side)))
    assert out[0] == out[1]
    assert 0 < len(out[1][0]) < len(data)
    assert files_of(port_env / "jax") == files_of(port_env / "port")


def test_lookup_errors_equal_jax(port_env, monkeypatch):  # noqa: F811
    monkeypatch.delenv("UNICORE_TPU_AFDB_AUTO_DOWNLOAD", raising=False)
    (port_env / "empty").mkdir()
    _custom_db(port_env / "bad", {"MKV": "DDD", "MKL": "VVV", "MKW": "AAA", "MKA": "CCC"})
    os.remove(port_env / "bad_ss")
    for args, code in (((str(port_env / "empty"), False), errors.ERR_FILE_NOT_FOUND),
                       ((str(port_env / "bad"), True), errors.ERR_GENERAL)):
        for mod in (jlookup, tlookup):
            with pytest.raises(SystemExit) as e:
                mod.split_by_lookup({"a": "MKV"}, args[0], custom=args[1], out_dir=str(port_env))
            assert e.value.err_code == code


@pytest.mark.parametrize("option", ["--afdb-lookup", "--custom-lookup"])
def test_createdb_lookup_cli_matches_jax(port_env, monkeypatch, option):  # noqa: F811
    """createdb mock with a lookup: converted_aa/ss.fasta, combined_aa.fasta
    (the rest), the .map and the seqdb triplet byte-identical."""
    write_proteomes(port_env / "in")
    known = {aa: "V" * len(aa) for aa in _fasta_data(port_env / "in").values()}
    table = port_env / "table"
    if option == "--custom-lookup":
        _custom_db(table, known)
    else:
        _afdb_tables(table, known)
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        db = str(port_env / side / "proteome" / "proteome_db")
        assert main(["createdb", str(port_env / "in"), db, "mock", option, str(table), "-v", "0"]) == 0
    ref, out = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(out)
    for name in ref:
        assert ref[name] == out[name], name
    assert {"proteome/converted_aa.fasta", "proteome/converted_ss.fasta",
            "proteome/combined_aa.fasta", "proteome/proteome_db_ss"} <= set(out)
    assert b"VVVVVVVVVV" in out["proteome/proteome_db_ss"]  # 3Di from the table


# ---------------------------------------------------------------------------
# the downloaders, against a local server
# ---------------------------------------------------------------------------

@pytest.fixture
def local_host(tmp_path):
    """An HTTP server on localhost over tmp_path/host; /short.bin claims
    100 bytes and sends 10.  Yields (host dir, base URL)."""
    host = tmp_path / "host"
    host.mkdir()

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(host), **kw)

        def do_GET(self):
            if self.path == "/short.bin":
                self.send_response(200)
                self.send_header("Content-Length", "100")
                self.end_headers()
                self.wfile.write(b"0123456789")
                return
            super().do_GET()

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield host, f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


def test_afdb_download_resume_and_crc(tmp_path, local_host):
    host, url = local_host
    (host / "00.tsv.gz").write_bytes(gzip.compress(b"aaaa\tDDDD\n"))
    (host / "ab.tsv.gz").write_bytes(gzip.compress(b"bbbb\tVVVV\n"))
    for mod, side in ((jlookup, "jax"), (tlookup, "port")):
        dest = tmp_path / side
        assert mod.download_afdb_tables(str(dest), base_url=url, assume_yes=True, shards=["00", "ab"]) == 2
        before = os.path.getmtime(dest / "md5" / "00.tsv")
        assert mod.download_afdb_tables(str(dest), base_url=url, assume_yes=True, shards=["00", "ab"]) == 0
        assert os.path.getmtime(dest / "md5" / "00.tsv") == before
        with pytest.raises(errors.UnicoreError if mod is tlookup else SystemExit):
            mod.download_afdb_tables(str(tmp_path / f"{side}_t"), base_url=url, assume_yes=False, shards=["00"])
    assert files_of(tmp_path / "jax") == files_of(tmp_path / "port")
    blob = bytearray(gzip.compress(b"cccc\tLLLL\n" * 50))
    blob[-3] ^= 0xFF  # break the CRC32 trailer
    (host / "cd.tsv.gz").write_bytes(bytes(blob))
    with pytest.raises(errors.UnicoreError):
        tlookup.download_afdb_tables(str(tmp_path / "port"), base_url=url, assume_yes=True, shards=["cd"])
    assert not os.path.exists(tmp_path / "port" / "md5" / "cd.tsv")


def test_prostt5_download_resume_size_and_gate(tmp_path, local_host, monkeypatch):
    host, url = local_host
    (host / "config.json").write_text('{"d_model": 1024}')
    (host / "spiece.model").write_bytes(b"\x00sp")
    dest = str(tmp_path / "model")
    assert tfetch.download_prostt5(dest, base_url=url, files=["config.json", "spiece.model"]) == 2
    assert tfetch.download_prostt5(dest, base_url=url, files=["config.json", "spiece.model"]) == 0
    for name in ("nope.bin", "short.bin"):  # missing; shorter than its Content-Length
        with pytest.raises(errors.UnicoreError):
            tfetch.download_prostt5(dest, base_url=url, files=[name])
    assert sorted(os.listdir(dest)) == ["config.json", "spiece.model"]  # no .part left
    # the gate: a no-op unless UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD asks
    monkeypatch.delenv("UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD", raising=False)
    assert tfetch.maybe_download_prostt5(str(tmp_path / "other")) is False
    monkeypatch.setenv("UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD", "1")
    (tmp_path / "has").mkdir()
    (tmp_path / "has" / "pytorch_model.bin").write_bytes(b"x")
    assert tfetch.maybe_download_prostt5(str(tmp_path / "has")) is False
    monkeypatch.setattr(tfetch, "PROSTT5_FILES", ["config.json"])
    monkeypatch.setattr(tfetch, "PROSTT5_URL", url)
    monkeypatch.setattr(tfetch.download_prostt5, "__defaults__", (url, None))
    assert tfetch.maybe_download_prostt5(str(tmp_path / "new")) is True
    assert (tmp_path / "new" / "config.json").read_text() == '{"d_model": 1024}'
