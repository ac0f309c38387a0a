"""ProstT5 / ProtT5 vocabulary mapping.

The real ProstT5 checkpoint (Rostlab/ProstT5, the model behind
`foldseek createdb --prostt5-model`, reference createdb.rs:158-166) uses
the ProtT5-XL-UniRef50 sentencepiece vocabulary:

  * id 0 = ``<pad>``, id 1 = ``</s>``, id 2 = ``<unk>``
  * amino-acid tokens (single residues, each its own piece "▁A")
    start at id 3 in UniRef50-frequency order
    ``A L G V S R E D T I P K F Q N Y M H W C X B O U Z``
  * ProstT5 appends lowercase 3Di tokens and the two direction tokens
    ``<AA2fold>`` / ``<fold2AA>`` as *added tokens* after the base vocab
    (vocab_size 150 in the published config).

Inference in the AA->3Di direction feeds
``[<AA2fold>, residue tokens..., </s>]`` to the encoder; the CNN head
consumes only the residue positions.

This module resolves the internal AA codes (alphabets.py order
``ARNDCQEGHILKMFPSTWYV`` + X) to checkpoint token ids.  When the
checkpoint directory carries tokenizer files (``added_tokens.json``,
``tokenizer.json``, or ``spiece.model``) the mapping is read from them;
otherwise the documented ProtT5 layout above is used and the (less
certain) added-token ids fall back to the first slots after the base
sentencepiece vocab, with a warning.

Copy of unicore_tpu/models/tokenizer.py on the port's alphabets and
runtime; `sentencepiece` stays an optional import.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from unicore_tpu_torch.alphabets import AA_FULL
from unicore_tpu_torch.runtime import logging as msg

# ProtT5 sentencepiece amino-acid piece order, ids 3..27.
PROTT5_AA_ORDER = "ALGVSREDTIPKFQNYMHWCXBOUZ"
PROTT5_BASE_VOCAB = 128          # ProtT5 sentencepiece size (incl. unused tail)
AA2FOLD = "<AA2fold>"
FOLD2AA = "<fold2AA>"
SP_UNDERLINE = "▁"          # sentencepiece word-start marker


@dataclass(frozen=True)
class ProstT5Vocab:
    """Internal-code -> checkpoint-token-id mapping."""

    aa_ids: np.ndarray            # (21,) int32: internal AA code -> HF id
    prefix_id: int                # <AA2fold>
    eos_id: int = 1               # </s>
    pad_id: int = 0               # <pad>
    unk_id: int = 2               # <unk>
    source: str = "default"       # which artifact supplied the mapping

    @classmethod
    def default(cls) -> "ProstT5Vocab":
        return cls(
            aa_ids=_aa_ids_from_piece_map(
                {c: 3 + i for i, c in enumerate(PROTT5_AA_ORDER)}
            ),
            prefix_id=PROTT5_BASE_VOCAB,  # fallback guess: first added token
            source="default",
        )


def _aa_ids_from_piece_map(letter_to_id: Dict[str, int]) -> np.ndarray:
    """Map internal codes 0..20 through a letter->id table (X fallback)."""
    x_id = letter_to_id.get("X")
    if x_id is None:
        raise KeyError("vocabulary has no X token")
    out = np.full(len(AA_FULL), x_id, dtype=np.int32)
    for code, letter in enumerate(AA_FULL):
        if letter in letter_to_id:
            out[code] = letter_to_id[letter]
    return out


def _vocab_from_piece_ids(piece_to_id: Dict[str, int], source: str) -> Optional[ProstT5Vocab]:
    """Build the mapping from a full piece->id table."""
    letters: Dict[str, int] = {}
    for aa in set(AA_FULL):
        for piece in (SP_UNDERLINE + aa, aa):
            if piece in piece_to_id:
                letters[aa] = piece_to_id[piece]
                break
    if "X" not in letters or len(letters) < 21:
        return None
    prefix = None
    for piece in (AA2FOLD, SP_UNDERLINE + AA2FOLD):
        if piece in piece_to_id:
            prefix = piece_to_id[piece]
            break
    if prefix is None:
        return None
    return ProstT5Vocab(
        aa_ids=_aa_ids_from_piece_map(letters),
        prefix_id=prefix,
        eos_id=piece_to_id.get("</s>", 1),
        pad_id=piece_to_id.get("<pad>", 0),
        unk_id=piece_to_id.get("<unk>", 2),
        source=source,
    )


def _try_added_tokens_json(model_dir: str) -> Optional[ProstT5Vocab]:
    """added_tokens.json carries only the appended tokens; the base AA ids
    come from the documented ProtT5 layout (or spiece.model if present)."""
    path = os.path.join(model_dir, "added_tokens.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        added = json.load(f)
    prefix = added.get(AA2FOLD)
    if prefix is None:
        return None
    base = _try_spiece(model_dir)
    aa_ids = base.aa_ids if base is not None else ProstT5Vocab.default().aa_ids
    return ProstT5Vocab(aa_ids=aa_ids, prefix_id=int(prefix), source="added_tokens.json")


def _try_tokenizer_json(model_dir: str) -> Optional[ProstT5Vocab]:
    path = os.path.join(model_dir, "tokenizer.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        tok = json.load(f)
    piece_to_id: Dict[str, int] = {}
    model_vocab = (tok.get("model") or {}).get("vocab")
    if isinstance(model_vocab, list):        # unigram: [[piece, score], ...]
        for i, entry in enumerate(model_vocab):
            piece_to_id[entry[0]] = i
    elif isinstance(model_vocab, dict):      # BPE-style: {piece: id}
        piece_to_id.update({k: int(v) for k, v in model_vocab.items()})
    for t in tok.get("added_tokens", []):
        piece_to_id[t["content"]] = int(t["id"])
    return _vocab_from_piece_ids(piece_to_id, "tokenizer.json")


def _try_spiece(model_dir: str) -> Optional[ProstT5Vocab]:
    path = os.path.join(model_dir, "spiece.model")
    if not os.path.isfile(path):
        return None
    try:
        import sentencepiece as spm
    except ImportError:
        return None
    sp = spm.SentencePieceProcessor()
    sp.Load(path)
    piece_to_id = {sp.IdToPiece(i): i for i in range(sp.GetPieceSize())}
    v = _vocab_from_piece_ids(piece_to_id, "spiece.model")
    if v is not None:
        return v
    # base ProtT5 spiece has no <AA2fold>; still useful for AA ids
    letters = {}
    for aa in set(AA_FULL):
        piece = SP_UNDERLINE + aa
        if piece in piece_to_id:
            letters[aa] = piece_to_id[piece]
    if len(letters) == 21:
        return ProstT5Vocab(
            aa_ids=_aa_ids_from_piece_map(letters),
            prefix_id=sp.GetPieceSize(),  # first added-token slot
            source="spiece.model(base)",
        )
    return None


def _try_gguf(model_dir: str) -> Optional[ProstT5Vocab]:
    """foldseek's prostt5-f16.gguf embeds the tokenizer in its metadata."""
    from unicore_tpu_torch.models.gguf import find_gguf, read_gguf, vocab_from_gguf

    path = find_gguf(model_dir)
    if path is None:
        return None
    try:
        meta, _ = read_gguf(path)
    except Exception:  # noqa: BLE001 — fall through to other probes
        return None
    return vocab_from_gguf(meta)


def load_vocab(model_dir: Optional[str]) -> ProstT5Vocab:
    """Resolve the checkpoint's vocabulary mapping (file-driven when possible)."""
    if model_dir and os.path.isdir(model_dir):
        for probe in (_try_tokenizer_json, _try_added_tokens_json, _try_spiece, _try_gguf):
            v = probe(model_dir)
            if v is not None:
                return v
        msg.println_message(
            f"Warning: no tokenizer files under '{model_dir}'; assuming the "
            "documented ProtT5 sentencepiece layout (AA ids 3..27) and "
            f"<AA2fold> at id {PROTT5_BASE_VOCAB}. Ship added_tokens.json / "
            "tokenizer.json / spiece.model with the checkpoint to pin this.",
            1,
        )
    return ProstT5Vocab.default()
