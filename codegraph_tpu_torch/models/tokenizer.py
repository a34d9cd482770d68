"""Copy of `codegraph_tpu/models/tokenizer.py` for the PyTorch port.

Deterministic byte-level tokenizer (host-side, zero external assets).

Stands in for the reference's HuggingFace tokenizers dependency
(crates/codegraph-vector/src/prep/chunker.rs tokenizer-aware budgets;
local_provider.rs loads a WordPiece vocab from hf-hub): this environment
has no network egress, so the encoder consumes raw UTF-8 bytes plus a few
special tokens. Byte-level tokenization is exact for code (no OOV), keeps
the vocab tiny (hot for the embedding gather), and makes token budgets
byte budgets — chunking math stays identical.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

PAD_ID = 256
CLS_ID = 257
SEP_ID = 258
VOCAB_SIZE = 260  # 256 bytes + PAD/CLS/SEP + 1 spare


class ByteTokenizer:
    """bytes -> ids with [CLS] ... [SEP] framing, pad/truncate to max_len."""

    pad_id = PAD_ID
    cls_id = CLS_ID
    sep_id = SEP_ID
    vocab_size = VOCAB_SIZE

    def __init__(self, max_len: int = 512):
        self.max_len = int(max_len)

    def count_tokens(self, text: str) -> int:
        """Token count for chunk budgeting (+2 for CLS/SEP framing)."""
        return len(text.encode("utf-8", errors="replace")) + 2

    def encode(self, text: str) -> List[int]:
        raw = text.encode("utf-8", errors="replace")[: self.max_len - 2]
        return [CLS_ID, *raw, SEP_ID]

    def encode_batch(
        self, texts: Sequence[str], max_len: int | None = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (ids [B, L] int32, mask [B, L] bool), L = max_len (static)."""
        L = int(max_len or self.max_len)
        B = len(texts)
        ids = np.full((B, L), PAD_ID, np.int32)
        mask = np.zeros((B, L), np.bool_)
        for b, t in enumerate(texts):
            enc = self.encode(t)[:L]
            ids[b, : len(enc)] = enc
            mask[b, : len(enc)] = True
        return ids, mask

    def decode(self, ids: Sequence[int]) -> str:
        raw = bytes(i for i in ids if 0 <= i < 256)
        return raw.decode("utf-8", errors="replace")


__all__ = ["ByteTokenizer", "PAD_ID", "CLS_ID", "SEP_ID", "VOCAB_SIZE"]
