"""Batch encoding of ZhCharTokenizer through the C extension."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from carel_tpu_torch.native.build import load_fastingest


def codepoint_table(tok) -> np.ndarray:
    """int32 codepoint -> id table of the single-character vocab entries
    (-1 elsewhere), kept on the tokenizer."""
    table = getattr(tok, "_codepoint_table", None)
    if table is None:
        entries = [(ord(t), i) for t, i in tok.token_to_id.items()
                   if len(t) == 1]
        table = np.full(max((cp for cp, _ in entries), default=0) + 1, -1,
                        np.int32)
        for cp, i in entries:
            table[cp] = i
        tok._codepoint_table = table
    return table


def native_encode_batch(tok, texts: Sequence[str], max_len: int):
    """(ids, mask, types) via the C extension, or None where it is not
    available."""
    mod = load_fastingest()
    if mod is None:
        return None
    table = codepoint_table(tok)
    n = len(texts)
    ids = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.int32)
    mod.encode_chars(list(texts), table.tobytes(), memoryview(ids),
                     memoryview(mask), max_len, tok.cls_id, tok.sep_id,
                     tok.unk_id, tok.pad_id)
    return ids, mask, np.zeros((n, max_len), np.int32)
