"""ProstT5 weight fetching — the `foldseek databases ProstT5` analog.

The reference auto-downloads ProstT5 weights into the model dir when
absent (createdb.rs:148-155).  This build is zero-egress by default, so
the download is gated behind UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD=1 (or an
explicit call); fetches are per-file resumable (.part + atomic rename)
with Content-Length verification when the server provides it.

The file list is the HuggingFace ProstT5 checkpoint layout consumed by
models/prostt5.py::load_params (config + sentencepiece vocab + weights).

Copy of unicore_tpu/models/fetch.py, gated by the same variable.
"""

from __future__ import annotations

import os
from typing import List, Optional

from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg

PROSTT5_URL = "https://huggingface.co/Rostlab/ProstT5/resolve/main"
PROSTT5_FILES = [
    "config.json",
    "spiece.model",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "pytorch_model.bin",
]


def download_prostt5(
    model_dir: str,
    base_url: str = PROSTT5_URL,
    files: Optional[List[str]] = None,
) -> int:
    """Fetch the ProstT5 checkpoint files into model_dir; returns the
    number of files fetched (files already present are skipped)."""
    import urllib.request

    files = files if files is not None else PROSTT5_FILES
    os.makedirs(model_dir, exist_ok=True)
    fetched = 0
    for i, name in enumerate(files):
        final = os.path.join(model_dir, name)
        if os.path.isfile(final) and os.path.getsize(final) > 0:
            continue
        part = final + ".part"
        url = f"{base_url}/{name}"
        try:
            with urllib.request.urlopen(url) as resp:
                want = resp.headers.get("Content-Length")
                with open(part, "wb") as f:
                    while True:
                        chunk = resp.read(1 << 22)
                        if not chunk:
                            break
                        f.write(chunk)
            if want is not None and os.path.getsize(part) != int(want):
                raise IOError(
                    f"size mismatch: got {os.path.getsize(part)}, want {want}"
                )
        except Exception as e:  # noqa: BLE001 — typed exit below
            if os.path.isfile(part):
                os.remove(part)
            err.error(err.ERR_GENERAL, f"ProstT5 download failed for {name}: {e}")
        os.replace(part, final)
        fetched += 1
        msg.print_message(f"\rDownloading ProstT5 weights... {i + 1}/{len(files)}", 3)
    msg.println_message(" Done", 3)
    return fetched


def maybe_download_prostt5(model_dir: str) -> bool:
    """createdb.rs:148-155 analog: fetch weights when the model dir has
    none — gated on UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD=1 (zero-egress
    default keeps this a no-op and the caller falls back to its
    documented offline behavior)."""
    if not os.environ.get("UNICORE_TPU_PROSTT5_AUTO_DOWNLOAD"):
        return False
    has_weights = any(
        os.path.isfile(os.path.join(model_dir, f))
        for f in ("pytorch_model.bin", "model.safetensors", "prostt5_tpu.npz")
    )
    if has_weights:
        return False
    download_prostt5(model_dir)
    return True
