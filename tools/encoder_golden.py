#!/usr/bin/env python3
"""Write the golden embeddings of the shipped encoder, made by the JAX
package on the CPU, for the PyTorch port to be held to where JAX is absent.

    JAX_PLATFORMS=cpu python3 tools/encoder_golden.py [--out PATH]

Embeds 32 fixed texts (12 short queries and 20 windows of the JAX package's
own sources, long enough to fill each length bucket, 64, 128 and 192
tokens) with `codegraph_tpu.models.providers.EncoderProvider` on
`checkpoints/encoder_r3_512.npz` (6 layers, hidden 512, BPE-16k) and with
the default `EnsembleProvider` (the same encoder + 256 hash dimensions),
and writes to `tests/data/encoder_r3_golden.npz`:

  texts     [32] unicode
  ids       [32, 192] int32, each text's framed BPE ids, padded with pad_id
  mask      [32, 192] bool
  bucket    [32] int32, the length bucket each text runs in
  encoder   [32, 512] float32, EncoderProvider.embed_texts
  ensemble  [32, 768] float32, EnsembleProvider.embed_texts

`tests/test_torch_encoder.py` and `chip_smoke.py` (phase 8) read it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "encoder_r3_golden.npz")
CKPT = os.path.join(ROOT, "checkpoints", "encoder_r3_512.npz")

QUERIES = [
    "parse a source file into nodes and edges",
    "streaming top-k kernel over the corpus",
    "hybrid search with bm25 and graph boost",
    "save the index snapshot manifest",
    "resolve call edges between symbols",
    "where is the config loaded",
    "ivf pq asymmetric distance table",
    "tokenize code with byte pair encoding",
    "load_encoder_checkpoint",
    "def embed_texts(self, texts)",
    "graph hub nodes and coupling metrics",
    "incremental reindex of one changed file",
]

# (file of the JAX package, start character, length in characters)
WINDOWS = [
    ("core/config.py", 0, 260), ("core/config.py", 2000, 900),
    ("core/config.py", 6000, 2400),
    ("parser/chunker.py", 0, 120), ("parser/chunker.py", 1500, 280),
    ("parser/chunker.py", 3000, 2600),
    ("search/bm25.py", 500, 220), ("search/bm25.py", 1800, 1000),
    ("search/hybrid.py", 4000, 300), ("search/hybrid.py", 8000, 3000),
    ("graph/queries.py", 1000, 280), ("graph/queries.py", 5000, 2000),
    ("models/bpe.py", 2500, 130), ("models/bpe.py", 6000, 2500),
    ("ops/topk.py", 300, 280), ("ops/topk.py", 9000, 3000),
    ("index/flat.py", 2000, 260), ("index/flat.py", 5000, 1800),
    ("indexer/resolve.py", 12000, 1200), ("mcp/tools.py", 9000, 330),
]


def golden_texts() -> list:
    texts = list(QUERIES)
    for rel, start, n in WINDOWS:
        with open(os.path.join(ROOT, "codegraph_tpu", rel), encoding="utf-8") as f:
            texts.append(f.read()[start:start + n])
    return texts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from codegraph_tpu.models.providers import EncoderProvider, EnsembleProvider

    texts = golden_texts()
    n = len(texts)
    # batch_size = n: one group a bucket, padded to n rows (not to 256)
    enc = EncoderProvider(batch_size=n, checkpoint=CKPT)
    ens = EnsembleProvider(batch_size=n, checkpoint=CKPT)
    rows = enc._frame_rows(texts)
    L = enc.buckets[-1]
    ids = np.full((n, L), enc.tokenizer.pad_id, np.int32)
    mask = np.zeros((n, L), np.bool_)
    for r, (_, framed) in enumerate(rows):
        ids[r, :len(framed)] = framed
        mask[r, :len(framed)] = True
    bucket = np.asarray([b for b, _ in rows], np.int32)
    e = enc.embed_texts(texts)
    s = ens.embed_texts(texts)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, texts=np.asarray(texts), ids=ids, mask=mask,
                        bucket=bucket, encoder=e.astype(np.float32),
                        ensemble=s.astype(np.float32))
    counts = {int(b): int((bucket == b).sum()) for b in sorted(set(bucket.tolist()))}
    print(f"wrote {args.out}: {n} texts, rows per bucket {counts}, "
          f"encoder {e.shape}, ensemble {s.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
