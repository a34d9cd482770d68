#!/usr/bin/env python3
"""Write the golden scores of the shipped cross-encoder, made by the JAX
package on the CPU, for the PyTorch port to be held to where JAX is absent.

    JAX_PLATFORMS=cpu python3 tools/cross_encoder_golden.py [--out PATH]

Frames 16 (query, document) pairs, 4 queries against 4 windows of the JAX
package's own sources each (from a few lines to more than the 256-token
budget, so that the document is cut), with
`codegraph_tpu.models.cross_encoder.CrossEncoder` on
`checkpoints/cross_encoder_r3.npz` (4 layers, hidden 384, 8 heads, max_len
256, BPE-16k), runs them as one batch, and writes to
`tests/data/cross_encoder_r3_golden.npz`:

  queries   [16] unicode, the query of each pair
  docs      [16] unicode, the document of each pair
  ids       [16, 256] int32, the framed pair: [CLS] q[:64] [SEP] doc [SEP]
  mask      [16, 256] bool
  cls       [16, 384] float32, the CLS representations (encode, normalize=False)
  scores    [16] float32, cls @ head.w + head.b

`tests/test_torch_cross_encoder.py` and `chip_smoke.py` (phase 10) read it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "cross_encoder_r3_golden.npz")
CKPT = os.path.join(ROOT, "checkpoints", "cross_encoder_r3.npz")

QUERIES = [
    "rerank search results with a cross-encoder",
    "where is the graph snapshot loaded from disk",
    "streaming top-k over the corpus tiles",
    "def tokenize(text)",
]

# (file of the JAX package, start character, length in characters), four a query
WINDOWS = [
    ("search/reranker.py", 0, 200), ("search/reranker.py", 4000, 1500),
    ("models/cross_encoder.py", 3000, 3000), ("search/bm25.py", 300, 120),
    ("graph/archive.py", 0, 600), ("index/snapshot.py", 1000, 2500),
    ("graph/store.py", 2000, 400), ("core/config.py", 500, 60),
    ("ops/topk.py", 300, 900), ("ops/topk.py", 9000, 4000),
    ("index/flat.py", 5000, 700), ("parser/chunker.py", 1500, 280),
    ("search/bm25.py", 1800, 1000), ("models/bpe.py", 2500, 130),
    ("models/tokenizer.py", 0, 1200), ("mcp/tools.py", 9000, 330),
]


def golden_pairs() -> tuple:
    queries, docs = [], []
    for n, (rel, start, length) in enumerate(WINDOWS):
        with open(os.path.join(ROOT, "codegraph_tpu", rel), encoding="utf-8") as f:
            docs.append(f.read()[start:start + length])
        queries.append(QUERIES[n // 4])
    return queries, docs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from codegraph_tpu.models.cross_encoder import CrossEncoder

    ce = CrossEncoder(checkpoint=CKPT)
    queries, docs = golden_pairs()
    rows = [ce._encode_pairs(q, [d]) for q, d in zip(queries, docs)]
    ids = np.concatenate([r[0] for r in rows])
    mask = np.concatenate([r[1] for r in rows])
    cls = ce._encode(ce.params, jnp.asarray(ids), jnp.asarray(mask), ce.cfg, normalize=False)
    scores = cls @ ce.head["w"] + ce.head["b"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, queries=np.asarray(queries), docs=np.asarray(docs),
                        ids=ids, mask=mask, cls=np.asarray(cls, np.float32),
                        scores=np.asarray(scores, np.float32))
    print(f"wrote {args.out}: {len(docs)} pairs, tokens per pair "
          f"{mask.sum(1).tolist()}, scores {np.round(np.asarray(scores), 4).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
