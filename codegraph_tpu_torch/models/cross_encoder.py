"""Port of `codegraph_tpu/models/cross_encoder.py`: the joint (query,
document) relevance scorer in PyTorch.

Reference: crates/codegraph-vector/src/reranker.rs:170 CrossEncoderReRanker
(stage 2 of the rerank pipeline scores each (query, doc) pair with a
model rather than comparing embeddings). The transformer encoder
(`models/encoder.py`, CLS pooling) runs over the pair `[CLS] query [SEP]
doc [SEP]`, framed at the token-id level, and a scalar head reads the CLS
position; all candidate pairs of a query score as one batch on the
scorer's device.

As in the JAX package the scorer stays opt-in (`SearchConfig.reranker =
"cross_encoder"`): the shipped r3 checkpoint did not transfer across
repositories in the reference's own evaluation (retrieval-only recall@1
0.738 against 0.723 blended), so `rerank_batch` blends the retrieval score
with the model's instead of replacing it.

Where the JAX package falls back, this port raises: a `checkpoint` path
that does not exist (the JAX scorer silently random-inits) and a CUDA
device without a GPU. A random init is built only when no checkpoint is
given, from a `torch.Generator`; its draws cannot equal `jax.random`'s, so
`cross_encoder_params_from_jax` carries a JAX scorer's weights across.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.index.flat import resolve_device
from codegraph_tpu_torch.models.bpe import make_tokenizer
from codegraph_tpu_torch.models.encoder import (
    LAYER_PREFIX,
    EncoderConfig,
    Params,
    encode,
    encoder_params_from_jax,
    encoder_params_to_jax,
    init_encoder_params,
)
from codegraph_tpu_torch.models.providers import load_encoder_checkpoint_ex
from codegraph_tpu_torch.models.tokenizer import VOCAB_SIZE, ByteTokenizer


def _heads(hidden: int) -> int:
    return next(h for h in (8, 4, 2, 1) if hidden % h == 0)


def cross_encoder_params_from_jax(params: Mapping, head: Mapping) -> Tuple[Params, Params]:
    """A JAX cross-encoder's `params` tree and `head` ({"w": [H], "b": []}),
    leaves as numpy arrays, as this port's (encoder params, head) of CPU
    tensors, each keeping its array's dtype."""
    return (encoder_params_from_jax(params),
            {k: torch.from_numpy(np.array(v)) for k, v in head.items()})


class CrossEncoder:
    """Pairwise relevance scorer built on the shared encoder stack."""

    # query token budget inside the joint pair; the trainer
    # (benchmarks/train_cross_encoder_r3.py --q-len) must match
    Q_LEN = 64
    # retrieval-score weight in the blended rerank; mirrors the lexical
    # stage's 0.7/0.3 convention (search/reranker.py CrossScorerReranker)
    BLEND_RETRIEVAL = 0.7

    def __init__(
        self,
        hidden: int = 256,
        n_layers: int = 4,
        max_len: int = 256,
        checkpoint: Optional[str] = None,
        seed: int = 0,
        tokenizer=None,
        device="cuda",
        generator: Optional[torch.Generator] = None,
    ):
        """The architecture of a checkpoint comes from its arrays and its
        `__cfg__` meta (the constructor's sizes are for a random init only);
        its tokenizer, when the meta names one, is resolved next to it. With
        no checkpoint the weights are drawn from `generator` (default: a CPU
        generator seeded with `seed`)."""
        self.device = resolve_device(device)
        if checkpoint is not None:
            if not os.path.exists(checkpoint):
                raise FileNotFoundError(
                    f"cross-encoder checkpoint {checkpoint!r} does not exist "
                    "(the port does not random-init in its place)")
            blob, meta = load_encoder_checkpoint_ex(checkpoint)
            params, head = cross_encoder_params_from_jax(blob["encoder"], blob["head"])
            meta = meta or {}
            tok_emb = params["tok_emb"]
            hidden = int(tok_emb.shape[1])
            # architecture variants (norm style, activation, attention
            # biases, eps) come from the checkpoint meta too
            extra = {k: meta[k] for k in ("norm_style", "attn_bias", "act", "eps") if k in meta}
            if LAYER_PREFIX + "b_qkv" in params:
                extra.setdefault("attn_bias", True)
            cfg = EncoderConfig(
                vocab_size=int(tok_emb.shape[0]), hidden=hidden,
                n_layers=int(params[LAYER_PREFIX + "wqkv"].shape[0]),
                n_heads=int(meta.get("n_heads") or _heads(hidden)),
                max_len=int(params["pos_emb"].shape[0]),
                mlp_ratio=int(params[LAYER_PREFIX + "w_up"].shape[2] // hidden),
                pooling="cls", **extra,
            )
            if tokenizer is None and meta.get("tokenizer"):
                tok_path = os.path.join(os.path.dirname(checkpoint), meta["tokenizer"])
                if os.path.exists(tok_path):
                    tokenizer = make_tokenizer(tok_path, max_len=cfg.max_len)
        else:
            cfg = EncoderConfig(
                vocab_size=VOCAB_SIZE, hidden=hidden, n_layers=n_layers,
                n_heads=_heads(hidden), max_len=max_len, pooling="cls",
            )
            g = generator if generator is not None else torch.Generator().manual_seed(seed)
            params = init_encoder_params(cfg, g)
            head = {"w": torch.randn(hidden, generator=g) / math.sqrt(hidden),
                    "b": torch.zeros(())}
        self._adopt(params, head, cfg, tokenizer)

    def _adopt(self, params: Params, head: Params, cfg: EncoderConfig, tokenizer) -> None:
        self.cfg = cfg
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.head = {k: v.to(device=self.device, dtype=torch.float32) for k, v in head.items()}
        self.tokenizer = tokenizer if tokenizer is not None else ByteTokenizer(max_len=cfg.max_len)

    @classmethod
    def from_params(cls, params: Params, head: Params, cfg: EncoderConfig,
                    tokenizer=None, device="cuda") -> "CrossEncoder":
        """A scorer over given weights (e.g. `cross_encoder_params_from_jax`
        of a JAX scorer's); `cfg` must say pooling="cls"."""
        if cfg.pooling != "cls":
            raise ValueError(f"a cross-encoder reads the CLS position, not {cfg.pooling!r}")
        ce = cls.__new__(cls)
        ce.device = resolve_device(device)
        ce._adopt(params, head, cfg, tokenizer)
        return ce

    # -- pair framing ----------------------------------------------------

    def _raw_ids(self, text: str):
        ids_fn = getattr(self.tokenizer, "ids", None)
        if ids_fn is not None:  # BPE: unframed subword ids
            return list(ids_fn(text))
        return list(text.encode("utf-8", errors="replace"))

    def _encode_pairs(self, query: str, docs: Sequence[str]):
        """[CLS] query[:Q_LEN] [SEP] doc [SEP] at the token-id level, the
        framing the trainer uses -> (ids [n, max_len] int32, mask bool)."""
        tok = self.tokenizer
        L = self.cfg.max_len
        q = self._raw_ids(query)[: min(self.Q_LEN, max(L - 3, 1))]
        n = len(docs)
        ids = np.full((n, L), tok.pad_id, np.int32)
        mask = np.zeros((n, L), np.bool_)
        for r, d in enumerate(docs):
            body = self._raw_ids(d)[: max(L - len(q) - 3, 0)]
            seq = [tok.cls_id, *q, tok.sep_id, *body, tok.sep_id]
            ids[r, : len(seq)] = seq
            mask[r, : len(seq)] = True
        return ids, mask

    # -- scoring ---------------------------------------------------------

    def cls_vectors(self, ids, mask) -> torch.Tensor:
        """[n, hidden] f32 CLS representations of framed pairs, on the
        scorer's device (one forward)."""
        return encode(self.params, torch.as_tensor(ids).to(self.device),
                      torch.as_tensor(mask).to(self.device), self.cfg, normalize=False)

    def score_framed(self, ids, mask) -> torch.Tensor:
        """[n] f32 scores of framed pairs on the scorer's device:
        cls @ head.w + head.b in f32."""
        return self.cls_vectors(ids, mask) @ self.head["w"] + self.head["b"]

    def score_pairs(self, query: str, docs: Sequence[str]) -> np.ndarray:
        """-> [n_docs] f32 relevance scores (one forward)."""
        if not docs:
            return np.zeros((0,), np.float32)
        ids, mask = self._encode_pairs(query, docs)
        return self.score_framed(ids, mask).cpu().numpy().astype(np.float32)

    def as_scorer(self):
        """Adapter for search/reranker.py CrossScorerReranker(scorer=...):
        a (query, text) -> float callable. Prefer `rerank_batch` in hot
        paths: the adapter scores one pair per forward."""

        def scorer(query: str, text: str) -> float:
            return float(self.score_pairs(query, [text])[0])

        return scorer

    def rerank_batch(self, query: str, results: List, k: int) -> List:
        """Batched rerank over SearchResult-like items (uses .snippet/.name).

        The final order blends the incoming retrieval score with the
        cross-encoder score (both min-max normalized within the candidate
        list): a misbehaving scorer can then only perturb the ranking, not
        erase it. Ties order as `np.argsort(-blended)` orders them, as in
        the JAX package."""
        if not results:
            return results
        ce = self.score_pairs(
            query, [f"{r.name} {r.snippet}" for r in results]
        ).astype(np.float64)
        base = np.array([float(r.score) for r in results], np.float64)

        def _norm(v):
            span = v.max() - v.min()
            return (v - v.min()) / span if span > 0 else np.zeros_like(v)

        a = self.BLEND_RETRIEVAL
        blended = a * _norm(base) + (1.0 - a) * _norm(ce)
        order = np.argsort(-blended)[:k]
        out = []
        for idx in order:
            r = results[int(idx)]
            r.score = float(blended[int(idx)])
            out.append(r)
        return out


def save_cross_encoder(path: str, ce: CrossEncoder,
                       tokenizer_file: Optional[str] = None) -> None:
    """Save under the JAX package's npz keys ("['encoder']/['tok_emb']",
    "['encoder']/['layers']/['wqkv']", "['head']/['w']", ...) with the
    config meta; either package loads the file."""
    tree = encoder_params_to_jax(ce.params)
    flat: Dict[str, np.ndarray] = {
        f"['encoder']/['{k}']": v for k, v in tree.items() if k != "layers"}
    flat.update({f"['encoder']/['layers']/['{k}']": v for k, v in tree["layers"].items()})
    flat.update({f"['head']/['{k}']": v.detach().cpu().numpy() for k, v in ce.head.items()})
    cfg = ce.cfg
    meta = {"norm_style": cfg.norm_style, "attn_bias": cfg.attn_bias, "act": cfg.act,
            "pooling": cfg.pooling, "eps": cfg.eps, "n_heads": cfg.n_heads}
    if tokenizer_file:
        meta["tokenizer"] = os.path.basename(tokenizer_file)
    flat["__cfg__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def default_cross_encoder_checkpoint() -> Optional[str]:
    """The shipped cross-encoder reranker checkpoint under the repo root's
    checkpoints/, if present (trained by
    benchmarks/train_cross_encoder_r3.py)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for name in ("cross_encoder_r3.npz",):
        path = os.path.join(here, "checkpoints", name)
        if os.path.exists(path):
            return path
    return None


__all__ = ["CrossEncoder", "cross_encoder_params_from_jax", "save_cross_encoder",
           "default_cross_encoder_checkpoint"]
