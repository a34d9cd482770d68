"""Copy of `codegraph_tpu/graph/csr.py` for the PyTorch port.

CSR adjacency arrays + the device-side graph-adjacency boost kernel.

The reference's hybrid search joins vector hits against their graph
edges inside SurrealDB (schema/codegraph.surql:481-511, two batched edge
queries of +-50 rows). TPU-natively the graph is four int32/f32 arrays —
(indptr, indices, etype, weight) — and the "join" is a gather/compare
kernel over a *padded adjacency matrix* [N, max_deg]: for every
candidate row we gather its neighbor ids and count matches against the
other candidates of the same query. Static shapes, pure VPU work,
no host round-trip (SURVEY.md north star: "graph-adjacency hybrid
re-rank as CSR gather/scatter").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES, EdgeType
from codegraph_tpu_torch.native import padded_adjacency_native

# edge types that boost hybrid search (reference joins these, surql:481)
BOOST_EDGE_TYPES = (EdgeType.CALLS, EdgeType.USES, EdgeType.DEPENDS_ON)
BOOST_EDGE_CODES = tuple(EDGE_TYPE_CODES[e] for e in BOOST_EDGE_TYPES)


@dataclasses.dataclass
class CSRGraph:
    """Forward + reverse CSR over node rows [0, n_nodes)."""

    n_nodes: int
    indptr: np.ndarray    # [n+1] int64
    indices: np.ndarray   # [m] int32 (dst rows)
    etype: np.ndarray     # [m] int16
    weight: np.ndarray    # [m] f32
    r_indptr: np.ndarray  # reverse CSR
    r_indices: np.ndarray
    r_etype: np.ndarray
    r_weight: np.ndarray

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def neighbors(
        self, row: int, etypes: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        lo, hi = self.indptr[row], self.indptr[row + 1]
        nbr = self.indices[lo:hi]
        if etypes is not None:
            sel = np.isin(self.etype[lo:hi], etypes)
            nbr = nbr[sel]
        return nbr

    def reverse_neighbors(
        self, row: int, etypes: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        lo, hi = self.r_indptr[row], self.r_indptr[row + 1]
        nbr = self.r_indices[lo:hi]
        if etypes is not None:
            sel = np.isin(self.r_etype[lo:hi], etypes)
            nbr = nbr[sel]
        return nbr

    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def in_degree(self) -> np.ndarray:
        return np.diff(self.r_indptr)

    def padded_adjacency(
        self,
        max_deg: int = 32,
        etypes: Sequence[int] = BOOST_EDGE_CODES,
        symmetric: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Dense [n, max_deg] neighbor table for the device boost kernel.

        Returns (nbr [n, max_deg] int32 with -1 pad, w [n, max_deg] f32,
        etype [n, max_deg] int16 with -1 pad, dir [n, max_deg] int8,
        0=outgoing/1=incoming). The etype/dir planes carry the edge
        EVIDENCE the reference's schema attaches to every search hit
        (schema/codegraph.surql:481-536) — not just a boost weight.
        Neighbors beyond max_deg are dropped highest-weight-first kept.
        symmetric=True unions out- and in-edges (the reference joins both
        directions, surql:481-511); outgoing wins weight ties.

        The symmetric table comes from the host library
        (`native.padded_adjacency_native`), as in the JAX package; among
        neighbours of equal weight it keeps and orders as its hash table
        does. `padded_adjacency_plain` is its plain version.
        """
        if symmetric:
            return padded_adjacency_native(
                self.n_nodes,
                self.indptr, self.indices, self.etype, self.weight,
                self.r_indptr, self.r_indices, self.r_etype, self.r_weight,
                etypes, max_deg,
            )
        return self.padded_adjacency_plain(max_deg, etypes, symmetric)

    def padded_adjacency_plain(
        self,
        max_deg: int = 32,
        etypes: Sequence[int] = BOOST_EDGE_CODES,
        symmetric: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """`padded_adjacency` as a Python loop over rows (the JAX package's
        fallback): the same table, ties kept and ordered by weight, then
        outgoing before incoming, then CSR order."""
        n = self.n_nodes
        nbr = np.full((n, max_deg), -1, np.int32)
        wgt = np.zeros((n, max_deg), np.float32)
        ets = np.full((n, max_deg), -1, np.int16)
        dirs = np.zeros((n, max_deg), np.int8)
        for row in range(n):
            lo, hi = self.indptr[row], self.indptr[row + 1]
            sel = np.isin(self.etype[lo:hi], etypes)
            cand = [(self.indices[lo:hi][sel], self.weight[lo:hi][sel],
                     self.etype[lo:hi][sel], 0)]
            if symmetric:
                rlo, rhi = self.r_indptr[row], self.r_indptr[row + 1]
                rsel = np.isin(self.r_etype[rlo:rhi], etypes)
                cand.append((self.r_indices[rlo:rhi][rsel],
                             self.r_weight[rlo:rhi][rsel],
                             self.r_etype[rlo:rhi][rsel], 1))
            ids = np.concatenate([c[0] for c in cand])
            ws = np.concatenate([c[1] for c in cand])
            es = np.concatenate([c[2] for c in cand])
            ds = np.concatenate(
                [np.full(c[0].shape, c[3], np.int8) for c in cand]
            )
            if ids.size == 0:
                continue
            # dedup keep max weight (stable: outgoing wins ties)
            order = np.argsort(-ws, kind="stable")
            ids, ws, es, ds = ids[order], ws[order], es[order], ds[order]
            _, first = np.unique(ids, return_index=True)
            first = np.sort(first)[:max_deg]
            m = first.size
            nbr[row, :m] = ids[first]
            wgt[row, :m] = ws[first]
            ets[row, :m] = es[first]
            dirs[row, :m] = ds[first]
        return nbr, wgt, ets, dirs


def build_csr(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    weight: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build forward+reverse CSR from edge arrays (rows must be < n_nodes)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    etype = np.asarray(etype, np.int16)
    weight = (
        np.asarray(weight, np.float32)
        if weight is not None
        else np.ones((src.size,), np.float32)
    )
    valid = (src >= 0) & (src < n_nodes) & (dst >= 0) & (dst < n_nodes)
    src, dst, etype, weight = src[valid], dst[valid], etype[valid], weight[valid]

    def _one_dir(s, d, et, w):
        order = np.argsort(s, kind="stable")
        s, d, et, w = s[order], d[order], et[order], w[order]
        counts = np.bincount(s, minlength=n_nodes)
        indptr = np.zeros((n_nodes + 1,), np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, d.astype(np.int32), et, w

    indptr, indices, fet, fw = _one_dir(src, dst, etype, weight)
    r_indptr, r_indices, ret, rw = _one_dir(dst, src, etype, weight)
    return CSRGraph(
        n_nodes=n_nodes,
        indptr=indptr, indices=indices, etype=fet, weight=fw,
        r_indptr=r_indptr, r_indices=r_indices, r_etype=ret, r_weight=rw,
    )


def adjacency_boost(
    cand_ids: torch.Tensor,  # [B, K] int32 candidate node rows (-1 pad)
    nbr: torch.Tensor,       # [n, max_deg] int32 padded adjacency (-1 pad)
    wgt: torch.Tensor,       # [n, max_deg] f32
) -> torch.Tensor:
    """Per-candidate graph-context boost, on the tensors' device.

    boost[b, c] = sum of edge weights from candidate c to any *other*
    candidate of query b — vector hits that form a connected neighborhood
    in the code graph rank above isolated hits (surql:481-536). The work
    is a [B, K, max_deg] gather + a K x K compare; it was plain XLA in
    the JAX package (no Pallas kernel), so plain torch here.
    """
    safe = cand_ids.clamp(min=0).long()
    cn = nbr[safe]   # [B, K, max_deg]
    cw = wgt[safe]   # [B, K, max_deg]
    # match neighbor ids against the query's OTHER candidates;
    # a self-loop edge (recursive call) must not boost its own row
    other = cand_ids[:, None, None, :]
    is_cand = (
        (cn[:, :, :, None] == other)
        & (other >= 0)
        & (other != cand_ids[:, :, None, None])
    )
    hit = is_cand.any(dim=-1) & (cn >= 0)  # [B, K, max_deg]
    boost = torch.where(hit, cw, torch.zeros_like(cw)).sum(dim=-1)
    return torch.where(cand_ids >= 0, boost, torch.zeros_like(boost))


__all__ = [
    "CSRGraph",
    "build_csr",
    "adjacency_boost",
    "BOOST_EDGE_TYPES",
    "BOOST_EDGE_CODES",
]
