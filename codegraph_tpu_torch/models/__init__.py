"""Model family: the text encoder (PyTorch) and the host-side embedding
providers, with the JAX package's exports but `encoder_param_shardings`
(the sharded encode and sharded training wait for ROADMAP item 15). The
encoder trains on one device through models/training.py."""

from codegraph_tpu_torch.models.encoder import (
    EncoderConfig,
    init_encoder_params,
    encode,
)
from codegraph_tpu_torch.models.tokenizer import ByteTokenizer
from codegraph_tpu_torch.models.hash_embedder import hash_embed_texts
from codegraph_tpu_torch.models.providers import (
    EmbeddingProvider,
    HashProvider,
    EncoderProvider,
    HybridEmbeddingPipeline,
    create_provider,
)

__all__ = [
    "EncoderConfig",
    "init_encoder_params",
    "encode",
    "ByteTokenizer",
    "hash_embed_texts",
    "EmbeddingProvider",
    "HashProvider",
    "EncoderProvider",
    "HybridEmbeddingPipeline",
    "create_provider",
]
