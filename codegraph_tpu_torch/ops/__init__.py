"""Tensor ops and the CUDA kernels' wrappers (port of
`codegraph_tpu/ops/__init__.py`: top-k K1-K4, int8 K5-K7, k-means, PQ and
OPQ; K8 lives with its index, `index/ivfpq.py`)."""

from codegraph_tpu_torch.ops.kmeans import assign_clusters, assign_clusters_topk, kmeans
from codegraph_tpu_torch.ops.opq import opq_train, pq_distortion, pq_train_batched
from codegraph_tpu_torch.ops.pq import PQCodebook, pq_adc_topk, pq_decode, pq_encode, pq_train
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
    streaming_topk_cuda_qmajor_xt,
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
    "streaming_topk_cuda_qmajor_xt",
    "kmeans",
    "assign_clusters",
    "assign_clusters_topk",
    "PQCodebook",
    "pq_train",
    "pq_encode",
    "pq_decode",
    "pq_adc_topk",
    "pq_train_batched",
    "opq_train",
    "pq_distortion",
    "quantize_rows",
    "dequantize_rows",
    "streaming_topk_int8",
    "streaming_topk_int8_cuda",
    "streaming_topk_int8_cuda_qmajor",
    "streaming_topk_int8_cuda_qres",
    "rescore_topk",
]
