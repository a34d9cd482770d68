"""Copy of `codegraph_tpu/models/providers.py` for the PyTorch port:
`EmbeddingProvider`, `HashProvider` and `create_provider` only.

Embedding provider registry (host side).

Capability parity with the reference's provider zoo
(crates/codegraph-vector/src/providers.rs:61-283 `EmbeddingProvider` trait,
`HybridEmbeddingPipeline` fallback strategy :120, `ProviderHealthChecker`
:258; embedding.rs:160,366 auto-selection; openai/jina/ollama/lmstudio
provider files). The default compute path is the on-chip encoder
(EncoderProvider) instead of HTTP round-trips; HTTP providers remain for
parity and external models.
"""

from __future__ import annotations

import logging
import time
from typing import Sequence

import numpy as np
import torch

from codegraph_tpu_torch.core.config import CodeGraphConfig, EmbeddingConfig
from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.models.hash_embedder import hash_embed_texts

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
        """Embeddings as a tensor for the index's add(). The hash provider
        computes on the host; an on-device encoder returns a CUDA tensor
        here so its embeddings never visit host memory."""
        return torch.from_numpy(self.embed_texts(texts))


class HashProvider(EmbeddingProvider):
    """Deterministic feature-hash embeddings — always available."""

    name = "hash"

    def _embed(self, texts: Sequence[str]) -> np.ndarray:
        return hash_embed_texts(list(texts), self.dimension)


#: providers of the JAX package that this port does not run yet, with the
#: ROADMAP item that ports them
UNPORTED_PROVIDERS = {
    "ensemble": "ROADMAP item 6 (encoder + ensemble provider)",
    "encoder": "ROADMAP item 6 (encoder + ensemble provider)",
    "openai": "ROADMAP item 6 (HTTP providers, after the encoder)",
    "jina": "ROADMAP item 6 (HTTP providers, after the encoder)",
    "ollama": "ROADMAP item 6 (HTTP providers, after the encoder)",
    "lmstudio": "ROADMAP item 6 (HTTP providers, after the encoder)",
}

_PROVIDERS = {"hash": HashProvider}


def make_provider(name: str, ecfg: EmbeddingConfig) -> EmbeddingProvider:
    if name in UNPORTED_PROVIDERS:
        raise NotImplementedError(
            f"embedding provider {name!r} is not ported yet: "
            f"{UNPORTED_PROVIDERS[name]}; use provider 'hash'")
    cls = _PROVIDERS.get(name)
    if cls is None:
        raise ProviderUnavailable(f"unknown provider {name!r}")
    return cls(dimension=ecfg.dimension, batch_size=ecfg.batch_size)


def create_provider(cfg: CodeGraphConfig) -> EmbeddingProvider:
    """The configured provider. The JAX package rotates to its fallback
    chain when a provider is unavailable; here every name in the chain
    must be a ported provider, so an unported configuration raises
    NotImplementedError instead of quietly serving hash embeddings."""
    ecfg = cfg.embedding
    chain = [ecfg.provider] + [f for f in ecfg.fallbacks if f != ecfg.provider]
    providers = [make_provider(name, ecfg) for name in chain]
    if len(providers) > 1:
        raise NotImplementedError(
            "a fallback chain of several providers (HybridEmbeddingPipeline) "
            "is not ported yet: ROADMAP item 6")
    return providers[0]


__all__ = [
    "EmbeddingMetrics",
    "EmbeddingProvider",
    "HashProvider",
    "UNPORTED_PROVIDERS",
    "create_provider",
    "make_provider",
]
