"""Tensor ops and the CUDA kernels' wrappers (the ported part of
`codegraph_tpu/ops/__init__.py`; K4, kmeans and PQ are not ported yet)."""

from codegraph_tpu_torch.ops.quantize import (
    dequantize_rows,
    quantize_rows,
    rescore_topk,
    streaming_topk_int8,
    streaming_topk_int8_cuda,
    streaming_topk_int8_cuda_qmajor,
    streaming_topk_int8_cuda_qres,
)
from codegraph_tpu_torch.ops.similarity import l2_normalize, pairwise_scores
from codegraph_tpu_torch.ops.topk import (
    NEG_INF,
    exact_topk,
    merge_topk,
    streaming_topk,
    streaming_topk_cuda,
    streaming_topk_cuda_qmajor,
    streaming_topk_cuda_qres,
)

__all__ = [
    "NEG_INF",
    "l2_normalize",
    "pairwise_scores",
    "exact_topk",
    "merge_topk",
    "streaming_topk",
    "streaming_topk_cuda",
    "streaming_topk_cuda_qmajor",
    "streaming_topk_cuda_qres",
    "quantize_rows",
    "dequantize_rows",
    "streaming_topk_int8",
    "streaming_topk_int8_cuda",
    "streaming_topk_int8_cuda_qmajor",
    "streaming_topk_int8_cuda_qres",
    "rescore_topk",
]
