"""Self-contained byte-level tokenizer (no external vocab files) — the port
of ``repro.data.tokenizer`` (numpy only, verbatim).

ids 0..255 = bytes; 256 = PAD, 257 = BOS, 258 = EOS, 259 = MASK.
"""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS, MASK = 256, 257, 258, 259
VOCAB = 260


class ByteTokenizer:
    vocab_size = VOCAB
    pad_id, bos_id, eos_id, mask_id = PAD, BOS, EOS, MASK

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        b = bytes(i for i in ids if 0 <= i < 256)
        return b.decode("utf-8", errors="replace")

    def pad_to(self, ids: list[int], length: int) -> np.ndarray:
        out = np.full((length,), PAD, np.int32)
        out[:min(len(ids), length)] = ids[:length]
        return out
