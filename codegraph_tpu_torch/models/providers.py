"""Port of `codegraph_tpu/models/providers.py`: the provider registry, the
on-device encoder (`EncoderProvider`), the default `EnsembleProvider`, the
HTTP providers (host copies) and the fallback pipeline.

Three differences from the JAX package, all so that a fault on the card
cannot hide behind the hash provider:

* a missing checkpoint for `encoder`/`ensemble` raises at `create_provider`
  (the reference skips the provider and serves hash embeddings);
* `HybridEmbeddingPipeline` rotates to the next provider only when an HTTP
  provider reports itself unavailable; any exception raised by a local
  provider (the encoder on the card) propagates;
* the encoder runs on the `device` given to `create_provider`/`make_provider`
  ("cuda" unless the caller asks for the CPU; CUDA without a GPU raises).

The encoder pads each length-bucket group to its own row count, not to
`batch_size` as the JAX package does (that keeps jit to one compiled shape
per bucket; PyTorch compiles nothing): rows are independent, so a B=1 query
runs 1 x 64 tokens instead of 256 x 64.

Embedding provider registry + fallback pipeline (host side).

Capability parity with the reference's provider zoo
(crates/codegraph-vector/src/providers.rs:61-283 `EmbeddingProvider` trait,
`HybridEmbeddingPipeline` fallback strategy :120, `ProviderHealthChecker`
:258; embedding.rs:160,366 auto-selection; openai/jina/ollama/lmstudio
provider files). The default compute path is the on-device encoder
(EncoderProvider) instead of HTTP round-trips; HTTP providers remain for
parity and external models.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from codegraph_tpu_torch.core.config import CodeGraphConfig, EmbeddingConfig
from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.index.flat import resolve_device
from codegraph_tpu_torch.models.bpe import load_hf_tokenizer, make_tokenizer
from codegraph_tpu_torch.models.encoder import (
    LAYER_PREFIX,
    EncoderConfig,
    encode,
    encoder_params_from_jax,
    encoder_params_to_jax,
    init_encoder_params,
)
from codegraph_tpu_torch.models.hash_embedder import hash_embed_texts
from codegraph_tpu_torch.models.hf_import import is_hf_model_dir, load_hf_encoder
from codegraph_tpu_torch.models.tokenizer import VOCAB_SIZE, ByteTokenizer

logger = logging.getLogger("codegraph_tpu_torch.providers")


class EmbeddingMetrics:
    """texts/s + failure accounting (reference: providers.rs:7-40)."""

    def __init__(self) -> None:
        self.texts = 0
        self.seconds = 0.0
        self.failures = 0

    def record(self, n_texts: int, seconds: float) -> None:
        self.texts += n_texts
        self.seconds += seconds

    @property
    def texts_per_second(self) -> float:
        return self.texts / self.seconds if self.seconds > 0 else 0.0


class EmbeddingProvider:
    """Interface: subclasses implement `_embed` and `is_available`."""

    name = "base"

    def __init__(self, dimension: int, batch_size: int = 256):
        self.dimension = int(dimension)
        self.batch_size = int(batch_size)
        self.metrics = EmbeddingMetrics()

    def is_available(self) -> bool:
        return True

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Batched embed, [N, dimension] f32 (reference: embed_texts_batched,
        embedding.rs:627)."""
        if not texts:
            return np.zeros((0, self.dimension), np.float32)
        out = []
        t0 = time.perf_counter()
        for start in range(0, len(texts), self.batch_size):
            out.append(np.asarray(self._embed(texts[start : start + self.batch_size])))
        result = np.concatenate(out, axis=0).astype(np.float32)
        self.metrics.record(len(texts), time.perf_counter() - t0)
        return result

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]

    def embed_texts_device(self, texts: Sequence[str]) -> torch.Tensor:
        """Embeddings as a tensor for the index's add(). This base version
        wraps the host path; EncoderProvider returns a tensor on its own
        device, so its embeddings never visit host memory."""
        return torch.from_numpy(self.embed_texts(texts))


class HashProvider(EmbeddingProvider):
    """Deterministic feature-hash embeddings — always available."""

    name = "hash"

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        return hash_embed_texts(list(texts), self.dimension)


class EncoderCounters:
    """Where an EncoderProvider's time goes: host tokenization (framing the
    id and mask arrays included) apart from the device forward (host clock
    from the first launch to a synchronize), with the texts, real tokens,
    padded tokens and forwards they covered."""

    def __init__(self) -> None:
        self.tokenize_seconds = 0.0
        self.forward_seconds = 0.0
        self.texts = 0
        self.tokens = 0
        self.padded_tokens = 0
        self.forwards = 0

    def to_dict(self) -> Dict[str, float]:
        return dict(self.__dict__)


class EncoderProvider(EmbeddingProvider):
    """On-device transformer encoder (the default provider's dense half).

    Replaces Candle/ONNX in-process inference (local_provider.rs:27-661,
    onnx_provider.rs:32-421). Weights load from an .npz checkpoint or an HF
    model directory when given; otherwise a seeded random init (useful for
    perf tests and as a fixed random-projection encoder).

    Sequence bucketing: attention is O(L^2) and most code chunks are far
    shorter than max_len, so texts group into power-of-two length buckets
    (64..max_len), each run as its own batch.
    """

    name = "encoder"

    def __init__(
        self,
        dimension: int = 384,
        batch_size: int = 256,
        max_len: int = 512,
        checkpoint: Optional[str] = None,
        seed: int = 0,
        tokenizer=None,
        device="cuda",
    ):
        super().__init__(dimension, batch_size)
        self.device = resolve_device(device)
        self.checkpoint = checkpoint
        if checkpoint and os.path.isdir(checkpoint):
            # HF-format model directory (config.json + safetensors/bin):
            # user-supplied BERT/MiniLM weights, run natively with
            # norm_style="post" (models/hf_import.py)
            tree, self.cfg = load_hf_encoder(checkpoint)
            params = encoder_params_from_jax(tree)
            self.dimension = self.cfg.hidden
            max_len = self.cfg.max_len
            if tokenizer is None:
                tokenizer = load_hf_tokenizer(checkpoint, max_len=max_len)
        elif checkpoint and os.path.exists(checkpoint):
            # architecture is implied by the checkpoint's array shapes
            # (+ optional __cfg__ metadata for norm/bias/act variants)
            tree, meta = load_encoder_checkpoint_ex(checkpoint)
            params = encoder_params_from_jax(tree)
            tok_emb = params["tok_emb"]
            wqkv = params[LAYER_PREFIX + "wqkv"]
            w_up = params[LAYER_PREFIX + "w_up"]
            hidden = int(tok_emb.shape[1])
            dimension = hidden
            max_len = int(params["pos_emb"].shape[0])
            n_layers = int(wqkv.shape[0])
            mlp_ratio = int(w_up.shape[2] // hidden)
            n_heads = next(h for h in (12, 8, 6, 4, 2, 1) if hidden % h == 0)
            extra = {k: meta[k] for k in
                     ("norm_style", "attn_bias", "act", "pooling", "eps")
                     if meta and k in meta}
            if tokenizer is None and meta and meta.get("tokenizer"):
                # the checkpoint names its training tokenizer; resolve
                # next to the checkpoint file
                tok_path = os.path.join(
                    os.path.dirname(os.path.abspath(checkpoint)),
                    meta["tokenizer"],
                )
                if os.path.exists(tok_path):
                    tokenizer = make_tokenizer(tok_path, max_len=max_len)
            if LAYER_PREFIX + "b_qkv" in params:
                extra.setdefault("attn_bias", True)
            self.cfg = EncoderConfig(
                vocab_size=int(tok_emb.shape[0]), hidden=hidden,
                n_layers=n_layers, n_heads=int(meta.get("n_heads", n_heads))
                if meta else n_heads, mlp_ratio=mlp_ratio,
                max_len=max_len, **extra,
            )
            self.dimension = dimension
        else:
            n_heads = next(h for h in (12, 8, 6, 4, 2, 1) if dimension % h == 0)
            vocab = tokenizer.vocab_size if tokenizer is not None else VOCAB_SIZE
            self.cfg = EncoderConfig(
                vocab_size=vocab, hidden=dimension, n_heads=n_heads,
                max_len=max_len,
            )
            params = init_encoder_params(self.cfg, torch.Generator().manual_seed(seed))
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.tokenizer = tokenizer if tokenizer is not None else \
            ByteTokenizer(max_len=max_len)
        self.buckets = [b for b in (64, 128, 256, 512, 1024, 2048) if b < max_len] + [max_len]
        self.counters = EncoderCounters()

    def _frame_rows(self, texts: Sequence[str]):
        """Tokenize each text ONCE -> [(bucket, framed id list)].

        Tokenizing a char-capped prefix once is exact: byte-level
        BPE/WordPiece tokens cover >= 1 char each, so a 32*max_bucket-char
        prefix cannot under-fill the largest bucket unless the whole text
        fits."""
        tok = self.tokenizer
        max_b = self.buckets[-1]
        ids_fn = getattr(tok, "ids", None)
        cap = max_b * 32
        rows = []
        for t in texts:
            if ids_fn is not None:
                body = ids_fn(t[:cap])[: max_b - 2]
            else:  # byte tokenizer: bytes ARE the ids
                body = list(t[: cap].encode("utf-8",
                                            errors="replace")[: max_b - 2])
            enc = [tok.cls_id, *body, tok.sep_id]
            need = len(enc)
            bucket = next((b for b in self.buckets if need <= b), max_b)
            rows.append((bucket, enc))
        return rows

    def _batches(self, texts: Sequence[str]):
        """[(row indices, ids [n, bucket] int32, mask [n, bucket] bool)]: the
        texts grouped by length bucket, each group cut into batch_size rows
        and padded to its own row count."""
        rows = self._frame_rows(texts)
        groups: Dict[int, List[int]] = {}
        for idx, (bucket, _) in enumerate(rows):
            groups.setdefault(bucket, []).append(idx)
        pad_id = self.tokenizer.pad_id
        out = []
        for bucket, idxs in groups.items():
            for start in range(0, len(idxs), self.batch_size):
                sel = idxs[start:start + self.batch_size]
                ids = np.full((len(sel), bucket), pad_id, np.int32)
                mask = np.zeros((len(sel), bucket), np.bool_)
                for r, i in enumerate(sel):
                    enc = rows[i][1][:bucket]
                    ids[r, : len(enc)] = enc
                    mask[r, : len(enc)] = True
                out.append((sel, ids, mask))
        return out

    def _encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """[len(texts), dimension] f32 on the encoder's device."""
        c = self.counters
        t0 = time.perf_counter()
        batches = self._batches(texts)
        t1 = time.perf_counter()
        out = torch.zeros((len(texts), self.dimension), device=self.device)
        for sel, ids, mask in batches:
            with torch.inference_mode():
                emb = encode(self.params, torch.from_numpy(ids).to(self.device),
                             torch.from_numpy(mask).to(self.device), self.cfg)
            out[torch.as_tensor(sel, device=self.device)] = emb
            c.tokens += int(mask.sum())
            c.padded_tokens += mask.size
            c.forwards += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        c.tokenize_seconds += t1 - t0
        c.forward_seconds += time.perf_counter() - t1
        c.texts += len(texts)
        return out

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        return self._encode_texts(texts).cpu().numpy()

    def embed_texts_device(self, texts: Sequence[str]) -> torch.Tensor:
        """The encode with NO host round-trip of the embeddings: a tensor on
        the encoder's device, for a device-resident index build."""
        if not texts:
            return torch.zeros((0, self.dimension), device=self.device)
        return self._encode_texts(texts)


def save_encoder_checkpoint(path: str, params, cfg=None,
                            tokenizer_file: Optional[str] = None) -> None:
    """Save params (this port's flat dict of tensors, `models/encoder.py`)
    under the JAX package's npz keys ("['tok_emb']", "['layers']/['wqkv']",
    ...), each array in its own dtype, + optional EncoderConfig variant
    metadata and the tokenizer file the model was trained with (stored as a
    basename, resolved next to the checkpoint at load). Either package
    loads the file."""
    tree = encoder_params_to_jax(params)
    flat = {f"['{k}']": v for k, v in tree.items() if k != "layers"}
    flat.update({f"['layers']/['{k}']": v for k, v in tree["layers"].items()})
    if cfg is not None or tokenizer_file:
        meta = {}
        if cfg is not None:
            meta = {"norm_style": cfg.norm_style, "attn_bias": cfg.attn_bias,
                    "act": cfg.act, "pooling": cfg.pooling, "eps": cfg.eps,
                    "n_heads": cfg.n_heads}
        if tokenizer_file:
            meta["tokenizer"] = os.path.basename(tokenizer_file)
        flat["__cfg__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
    np.savez(path, **flat)


def load_encoder_checkpoint_ex(path: str):
    """-> (params, meta dict | None): params as the JAX package's nested tree
    of numpy arrays (`encoder_params_from_jax` makes tensors of them). meta
    carries EncoderConfig variant fields (norm_style/attn_bias/act/pooling/
    eps/n_heads) when the checkpoint was saved with a cfg."""
    data = np.load(path)
    params: Dict = {}
    meta = None
    for flat_key in data.files:
        if flat_key == "__cfg__":
            meta = json.loads(bytes(data[flat_key]).decode())
            continue
        parts = [p.strip(".[]'\"") for p in flat_key.split("/")]
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[flat_key]
    return params, meta


def load_encoder_checkpoint(path: str):
    return load_encoder_checkpoint_ex(path)[0]


class _HTTPProvider(EmbeddingProvider):
    """Shared REST plumbing with retry/backoff (reference:
    lmstudio_embedding_provider.rs retry/backoff)."""

    url = ""
    api_key_env = ""
    model = ""
    timeout_s = 30.0
    max_retries = 2

    def is_available(self) -> bool:
        if self.api_key_env and not os.environ.get(self.api_key_env):
            return False
        return bool(self.url)

    def _request_body(self, texts: Sequence[str]) -> dict:
        raise NotImplementedError

    def _parse(self, payload: dict) -> np.ndarray:
        raise NotImplementedError

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        body = json.dumps(self._request_body(texts)).encode()
        headers = {"Content-Type": "application/json"}
        key = os.environ.get(self.api_key_env, "") if self.api_key_env else ""
        if key:
            headers["Authorization"] = f"Bearer {key}"
        last: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            try:
                req = urllib.request.Request(self.url, data=body, headers=headers)
                with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                    return self._parse(json.loads(resp.read()))
            except (urllib.error.URLError, OSError, ValueError) as exc:
                last = exc
                time.sleep(min(2.0**attempt * 0.5, 8.0))
        self.metrics.failures += 1
        raise ProviderUnavailable(f"{self.name}: {last}")


def _check_dim(provider: str, model: str, out: np.ndarray, want: int):
    """Fail with an actionable message instead of a downstream index
    shape crash when the API's width differs from the configured one."""
    if out.ndim == 2 and out.shape[1] != want:
        raise ValueError(
            f"{provider} model {model!r} returned {out.shape[1]}-dim "
            f"embeddings but embedding.dimension={want}; set "
            f"CODEGRAPH_EMBEDDING_DIMENSION={out.shape[1]} (or pick a "
            "model/dimensions combination that matches)"
        )


class OpenAIProvider(_HTTPProvider):
    """OpenAI REST batch embeddings (reference: openai_provider.rs)."""

    name = "openai"
    api_key_env = "OPENAI_API_KEY"

    def __init__(self, dimension: int = 1536, batch_size: int = 256,
                 model: str = "text-embedding-3-small", base_url: str = ""):
        super().__init__(dimension, batch_size)
        self.model = model
        base = base_url or os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
        self.url = base.rstrip("/") + "/embeddings"

    def _request_body(self, texts):
        # v3 models honor the dimensions param (matryoshka truncation), so
        # the API returns the configured width, not the model's native one
        return {"model": self.model, "input": list(texts),
                "dimensions": self.dimension}

    def _parse(self, payload):
        rows = sorted(payload["data"], key=lambda r: r["index"])
        out = np.asarray([r["embedding"] for r in rows], np.float32)
        _check_dim(self.name, self.model, out, self.dimension)
        return out


class JinaProvider(_HTTPProvider):
    """Jina cloud embeddings with batch clamping (reference:
    jina_provider.rs:432-444)."""

    name = "jina"
    api_key_env = "JINA_API_KEY"
    MAX_BATCH = 2048  # hard clamp (jina_provider.rs MAX_NODE_TEXTS_HARD_LIMIT)

    def __init__(self, dimension: int = 1024, batch_size: int = 512,
                 model: str = "jina-embeddings-v3", base_url: str = ""):
        super().__init__(dimension, min(batch_size, self.MAX_BATCH))
        self.model = model
        self.url = (base_url or "https://api.jina.ai/v1").rstrip("/") + "/embeddings"

    def _request_body(self, texts):
        # jina-embeddings-v3 supports matryoshka dimensions as well
        return {"model": self.model, "input": list(texts),
                "dimensions": self.dimension}

    def _parse(self, payload):
        rows = sorted(payload["data"], key=lambda r: r["index"])
        out = np.asarray([r["embedding"] for r in rows], np.float32)
        _check_dim(self.name, self.model, out, self.dimension)
        return out


class OllamaProvider(_HTTPProvider):
    """Local Ollama HTTP embeddings (reference: ollama_embedding_provider.rs)."""

    name = "ollama"

    def __init__(self, dimension: int = 768, batch_size: int = 64,
                 model: str = "nomic-embed-text", base_url: str = ""):
        super().__init__(dimension, batch_size)
        self.model = model
        base = base_url or os.environ.get("OLLAMA_HOST", "http://localhost:11434")
        self.url = base.rstrip("/") + "/api/embed"

    def is_available(self) -> bool:
        try:
            urllib.request.urlopen(self.url.replace("/api/embed", "/api/tags"), timeout=2)
            return True
        except Exception:
            return False

    def _request_body(self, texts):
        return {"model": self.model, "input": list(texts)}

    def _parse(self, payload):
        return np.asarray(payload["embeddings"], np.float32)


class LMStudioProvider(_HTTPProvider):
    """LM Studio OpenAI-compatible endpoint (reference:
    lmstudio_embedding_provider.rs)."""

    name = "lmstudio"

    def __init__(self, dimension: int = 768, batch_size: int = 64,
                 model: str = "", base_url: str = ""):
        super().__init__(dimension, batch_size)
        self.model = model
        base = base_url or os.environ.get("LMSTUDIO_HOST", "http://localhost:1234")
        self.url = base.rstrip("/") + "/v1/embeddings"

    def is_available(self) -> bool:
        try:
            urllib.request.urlopen(self.url.replace("/embeddings", "/models"), timeout=2)
            return True
        except Exception:
            return False

    def _request_body(self, texts):
        return {"model": self.model, "input": list(texts)}

    def _parse(self, payload):
        rows = sorted(payload["data"], key=lambda r: r["index"])
        return np.asarray([r["embedding"] for r in rows], np.float32)


class EnsembleProvider(EmbeddingProvider):
    """Dense + lexical ensemble: concat(sqrt(w)*encoder, sqrt(1-w)*hash).

    Cosine over the concatenation equals w*cos_enc + (1-w)*cos_hash, so
    this is score-level mixing packaged as a single index-able vector. The
    reference's weight sweep (w in 0.3..0.9) peaks at 0.5 with the round-3
    encoder. Its `embed_texts_device` is the base host path, as in the
    reference.
    """

    name = "ensemble"

    def __init__(self, dimension: int = 768, batch_size: int = 256,
                 max_len: int = 512, checkpoint: Optional[str] = None,
                 w_enc: float = 0.5, tokenizer=None, device="cuda"):
        self.encoder = EncoderProvider(
            dimension=dimension // 2, batch_size=batch_size,
            max_len=max_len, checkpoint=checkpoint, tokenizer=tokenizer,
            device=device,
        )
        # a checkpoint dictates the encoder's width, which can leave
        # dimension - enc_dim degenerate (0 would silently drop the lexical
        # half; negative crashes hash_embed_texts): keep the halves balanced
        # and let the total dimension self-correct, as EncoderProvider does
        self.hash_dim = dimension - self.encoder.dimension
        if self.hash_dim < 16:
            self.hash_dim = self.encoder.dimension
        super().__init__(self.encoder.dimension + self.hash_dim, batch_size)
        self.w_enc = float(w_enc)
        self.tokenizer = self.encoder.tokenizer

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        e = self.encoder.embed_texts(list(texts))
        h = hash_embed_texts(list(texts), self.hash_dim)

        def norm(x):
            return x / np.maximum(
                np.linalg.norm(x, axis=1, keepdims=True), 1e-9)

        return np.concatenate(
            [np.sqrt(self.w_enc) * norm(e),
             np.sqrt(1.0 - self.w_enc) * norm(h)], axis=1,
        ).astype(np.float32)


_PROVIDERS = {
    "hash": HashProvider,
    "encoder": EncoderProvider,
    "ensemble": EnsembleProvider,
    "openai": OpenAIProvider,
    "jina": JinaProvider,
    "ollama": OllamaProvider,
    "lmstudio": LMStudioProvider,
}


def _default_checkpoint() -> Optional[str]:
    """The shipped default checkpoint under the repo root's checkpoints/, in
    the reference's order of measured quality: the round-3 6L/512 BPE-16k
    model, then the round-2 BPE-8k 4L/384, then the byte-level round-1
    seeds."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("encoder_r3_512.npz", "encoder_bpe_384.npz",
                 "encoder_seed_384.npz", "encoder_seed.npz"):
        path = os.path.join(here, "checkpoints", name)
        if os.path.exists(path):
            return path
    return None


def make_provider(name: str, ecfg: EmbeddingConfig, device="cuda") -> EmbeddingProvider:
    """One provider by name; an encoder-backed one runs on `device`."""
    cls = _PROVIDERS.get(name)
    if cls is None:
        raise ProviderUnavailable(f"unknown provider {name!r}")
    if cls in (EncoderProvider, EnsembleProvider):
        # embedding.model may point at an .npz checkpoint or an HF model
        # directory (config.json + safetensors/bin, hf_import.py);
        # otherwise use the shipped checkpoint
        ckpt = None
        if ecfg.model and (ecfg.model.endswith(".npz")
                           or is_hf_model_dir(ecfg.model)):
            ckpt = ecfg.model
        elif ecfg.model in ("", "minilm-l6", "seed"):
            ckpt = _default_checkpoint()
        else:
            # an unrecognized model string must not silently become a
            # random-weight encoder
            logger.warning(
                "embedding.model=%r is neither an .npz checkpoint nor an "
                "HF model directory; falling back to the shipped seed "
                "checkpoint (set embedding.model to a real path to use "
                "your own weights)", ecfg.model,
            )
            ckpt = _default_checkpoint()
        if ckpt is None or not os.path.exists(ckpt):
            # the reference skips the provider here and serves hash
            # embeddings; the port raises, so that a stripped install
            # cannot pass for the default configuration
            raise ProviderUnavailable(
                f"provider {name!r} needs a trained checkpoint and none "
                f"is shipped under checkpoints/ (embedding.model="
                f"{ecfg.model!r}); set embedding.model or choose provider 'hash'")
        tok = None
        tok_spec = getattr(ecfg, "tokenizer", "byte")
        if tok_spec and tok_spec != "byte":
            tok = make_tokenizer(tok_spec, max_len=ecfg.max_chunk_tokens)
        return cls(
            dimension=ecfg.dimension,
            batch_size=ecfg.batch_size,
            max_len=ecfg.max_chunk_tokens,
            checkpoint=ckpt,
            tokenizer=tok,
            device=device,
        )
    if cls in (OpenAIProvider, JinaProvider, OllamaProvider,
               LMStudioProvider):
        kw = {}
        if ecfg.model and not ecfg.model.endswith(".npz") \
                and ecfg.model not in ("minilm-l6", "seed"):
            kw["model"] = ecfg.model
        if ecfg.base_url:
            kw["base_url"] = ecfg.base_url  # CODEGRAPH_OLLAMA_URL etc.
        return cls(dimension=ecfg.dimension, batch_size=ecfg.batch_size,
                   **kw)
    return cls(dimension=ecfg.dimension, batch_size=ecfg.batch_size)


class HybridEmbeddingPipeline(EmbeddingProvider):
    """Primary provider + ordered fallback chain (reference:
    HybridEmbeddingPipeline, providers.rs:120-256). An HTTP provider that
    reports itself unavailable (`is_available()` false, or
    ProviderUnavailable after its retries) rotates to the next, and is
    skipped for `cooldown_s`; an exception from any other provider
    propagates (the reference rotates on every exception)."""

    name = "hybrid"

    def __init__(self, providers: List[EmbeddingProvider], cooldown_s: float = 60.0):
        if not providers:
            raise ValueError("need at least one provider")
        super().__init__(providers[0].dimension, providers[0].batch_size)
        self.providers = providers
        self.cooldown_s = cooldown_s
        self._dead_until: Dict[str, float] = {}

    def is_available(self) -> bool:
        return any(p.is_available() for p in self.providers)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        now = time.monotonic()
        errors = []
        for p in self.providers:
            if self._dead_until.get(p.name, 0.0) > now:
                continue
            if not isinstance(p, _HTTPProvider):
                return p.embed_texts(texts)
            try:
                if not p.is_available():
                    raise ProviderUnavailable(f"{p.name} unavailable")
                return p.embed_texts(texts)
            except ProviderUnavailable as exc:
                logger.warning("provider %s failed: %s", p.name, exc)
                self._dead_until[p.name] = now + self.cooldown_s
                errors.append(f"{p.name}: {exc}")
        raise ProviderUnavailable("all providers failed: " + "; ".join(errors))


def create_provider(cfg: CodeGraphConfig, device="cuda") -> EmbeddingProvider:
    """The configured provider, or the pipeline of it and its fallbacks
    (reference: embedding.rs:160-366 env/config auto-selection). An
    encoder-backed provider runs on `device`; every provider of the chain
    must be creatable (the reference skips one that is not)."""
    ecfg = cfg.embedding
    chain = [ecfg.provider] + [f for f in ecfg.fallbacks if f != ecfg.provider]
    providers = [make_provider(name, ecfg, device) for name in chain]
    if len(providers) == 1:
        return providers[0]
    return HybridEmbeddingPipeline(providers)


__all__ = [
    "EmbeddingMetrics",
    "EmbeddingProvider",
    "HashProvider",
    "EncoderCounters",
    "EncoderProvider",
    "EnsembleProvider",
    "OpenAIProvider",
    "JinaProvider",
    "OllamaProvider",
    "LMStudioProvider",
    "HybridEmbeddingPipeline",
    "create_provider",
    "make_provider",
    "save_encoder_checkpoint",
    "load_encoder_checkpoint",
    "load_encoder_checkpoint_ex",
]
