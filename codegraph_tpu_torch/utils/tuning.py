"""Copy of `codegraph_tpu/utils/tuning.py` for the PyTorch port (host
only): pick the index layout and its knobs from the corpus profile.

The knobs are index kind (flat vs IVF), storage dtype (f32/bf16/int8),
tile sizes, and IVF nlist/nprobe, all derived from corpus size, dimension
and a device-memory budget. The policy and its thresholds are the
reference's, which were measured on a TPU; they have not been re-measured
on a GPU. `CodeGraph.open` passes the budget (`api.py`): on a CUDA device
half of the card's memory, on the CPU `DEFAULT_HBM_BUDGET`, so that a CPU
plan equals the reference's.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class IndexPlan:
    kind: str           # flat | ivf | ivfpq
    dtype: str          # float32 | bfloat16 | int8
    tile_n: int
    nlist: int = 0
    nprobe: int = 0
    rescore_k: int = 0
    pq_m: int = 0       # ivfpq: bytes per row
    refine: str = ""    # ivfpq: none | int8 | f32 host rescore store
    reason: str = ""

    def to_dict(self):
        return dataclasses.asdict(self)


#: the reference's default budget for the embedding matrix (bytes), kept
#: so that a plan made without a card equals the reference's
DEFAULT_HBM_BUDGET = 8 << 30

IVF_CAPACITY_FACTOR = 1.5  # padded cell storage overhead vs flat


def plan_index(
    n_vectors: int,
    dim: int,
    hbm_budget_bytes: int = DEFAULT_HBM_BUDGET,
    target_recall: float = 0.95,
    batch_hint: int = 256,
) -> IndexPlan:
    """Choose the index configuration for a corpus (the reference's policy).

    * small corpora (< 200k rows) whose f32 rows fit: exact flat f32.
    * bf16 fits the budget: flat bf16 exact scan, except for large offline
      batches (batch_hint >= 1024, >= 2M rows) whose padded IVF cells fit:
      IVF bf16.
    * bf16 over budget, int8 fits: flat int8 scan + rescore. Only the int8
      matrix is held against the budget, not the bf16 rescore copy that
      the int8 index keeps by default (as in the reference).
    * int8 over budget: IVF-PQ with m-byte residual codes + int8 refine.
    """
    f32_bytes = n_vectors * dim * 4
    bf16_bytes = n_vectors * dim * 2
    int8_bytes = n_vectors * dim
    ivf_bf16_bytes = int(bf16_bytes * IVF_CAPACITY_FACTOR)

    nlist = 1 << max(8, min(16, round(math.log2(4 * math.sqrt(n_vectors)))))
    # nprobe fraction rises with target recall
    frac = 0.01 + 0.08 * max(0.0, target_recall - 0.9)
    nprobe = max(8, min(nlist, int(nlist * frac)))

    if n_vectors < 200_000 and f32_bytes <= hbm_budget_bytes:
        return IndexPlan(
            kind="flat", dtype="float32", tile_n=_tile_n(n_vectors),
            reason="small corpus: exact f32 scan",
        )
    if bf16_bytes <= hbm_budget_bytes:
        if (batch_hint >= 1024 and n_vectors >= 2_000_000
                and ivf_bf16_bytes <= hbm_budget_bytes):
            return IndexPlan(
                kind="ivf", dtype="bfloat16", tile_n=_tile_n(n_vectors),
                nlist=nlist, nprobe=nprobe, rescore_k=100,
                reason=(f"large offline batches (B>={batch_hint}): "
                        f"IVF nlist={nlist} nprobe={nprobe}"),
            )
        return IndexPlan(
            kind="flat", dtype="bfloat16", tile_n=_tile_n(n_vectors),
            reason="bf16 fits the budget: exact bf16 scan",
        )
    if int8_bytes <= hbm_budget_bytes:
        return IndexPlan(
            kind="flat", dtype="int8", tile_n=_tile_n(n_vectors),
            rescore_k=100,
            reason="bf16 over the memory budget: int8 scan + rescore",
        )
    pq_m = max(8, dim // 8)
    return IndexPlan(
        kind="ivfpq", dtype="int8", tile_n=_tile_n(n_vectors),
        nlist=nlist, nprobe=nprobe, rescore_k=100,
        pq_m=pq_m, refine="int8",
        reason=(f"int8 matrix over the memory budget: IVF-PQ m={pq_m} "
                f"nlist={nlist} nprobe={nprobe} + int8 host refine"),
    )


def _tile_n(n_vectors: int) -> int:
    if n_vectors < 100_000:
        return 1024
    if n_vectors < 5_000_000:
        return 2048
    return 4096


def apply_plan(config, plan: IndexPlan) -> None:
    """Write a plan into a CodeGraphConfig's index section."""
    config.index.kind = plan.kind
    config.index.dtype = plan.dtype
    if plan.nlist:
        config.index.nlist = plan.nlist
        config.index.nprobe = plan.nprobe
    if plan.rescore_k:
        config.index.rescore_k = plan.rescore_k
    if plan.pq_m:
        config.index.pq_m = plan.pq_m
    if plan.refine:
        config.index.pq_refine = plan.refine


__all__ = ["IndexPlan", "plan_index", "apply_plan", "DEFAULT_HBM_BUDGET"]
