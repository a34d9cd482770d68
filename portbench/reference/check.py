"""The comparison that decides `correct`, and the exact ground truth.

After the window, with the program's index freed, the reference makes the
corpus again block by block from the seed and works out, for the query
set, in plain PyTorch:

* the exact f32 cosine top-k (for `recall_at_k`);
* the tier's own scan scores, as the configuration states them (for the
  int8 tier: the rows and queries quantized per row, the exact integer dot
  times both scales), and the C-th best of them, where C = max(k,
  candidates) is how many the scan keeps;
* for every row an answer returned, that row's scan score and its
  reference score: the rescore's (f32 query against the rescore copy's
  row) where the tier rescores, else the scan's, in f64.

Each distinct answer is judged by what it says:

* `bad_answers`: answers with a row out of range, a row twice, scores not
  in falling order, fewer than k rows, or none at all (limit 0);
* `scan_gap`: the widest gap by which a returned row's scan score lies
  below the C-th best scan score of its query. An answer the scan could
  have given reads 0, or rounding where normalisation differs by an ulp;
* `score_err`: the widest gap between a returned score and the
  reference's score of that row.

Imports only torch and numpy.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.scoring import Scorer, exact_f32, merge_top, normalize


def _bad_rows(ids: np.ndarray, scores: np.ndarray, n_rows: int) -> np.ndarray:
    """Per answer: True where the answer cannot be right whatever the data."""
    out_of_range = ((ids < 0) | (ids >= n_rows)).any(1)
    srt = np.sort(ids, 1)
    twice = (srt[:, 1:] == srt[:, :-1]).any(1)
    unsorted = (np.diff(scores, axis=1) > 0).any(1) | ~np.isfinite(scores).all(1)
    return out_of_range | twice | unsorted


def judge(config: dict, mixture, queries: np.ndarray, qis: Sequence[int],
          ids: np.ndarray, scores: np.ndarray, device) -> Tuple[Dict[str, float], np.ndarray]:
    """Judge distinct answers: answer u is (ids[u], scores[u]) for query
    qis[u] of `queries`. Returns the numbers compared and each answer's
    recall against the exact f32 top-k."""
    dev = torch.device(device)
    n_rows, k = int(config["n_rows"]), int(config["k"])
    scoring = config["scoring"]
    cand = max(k, int(scoring.get("candidates", k)))
    qis = np.asarray(qis, np.int64)
    ids = np.asarray(ids, np.int64).reshape(len(qis), -1)
    scores = np.asarray(scores, np.float64).reshape(len(qis), -1)
    bad = _bad_rows(ids, scores, n_rows) if ids.shape[1] == k else np.ones(len(qis), bool)

    with torch.no_grad(), exact_f32():
        qn = normalize(torch.from_numpy(np.ascontiguousarray(queries)).to(dev))
        exact = Scorer("float32", qn)
        scan = Scorer(scoring["scan"], qn)
        rescore = (Scorer(scoring["rescore"], qn, round_queries=False)
                   if scoring.get("rescore") else None)
        P = qn.shape[0]
        gt_v = torch.full((P, k), -np.inf, device=dev)
        gt_i = torch.full((P, k), -1, dtype=torch.int64, device=dev)
        tier_v = torch.full((P, cand), -np.inf, device=dev)
        tier_i = torch.full((P, cand), -1, dtype=torch.int64, device=dev)

        good = np.flatnonzero(~bad)
        pair_u = np.repeat(good, k)
        pair_q = qis[pair_u]
        pair_row = ids[good].reshape(-1)
        order = np.argsort(pair_row, kind="stable")
        pair_u, pair_q, pair_row = pair_u[order], pair_q[order], pair_row[order]
        pair_slot = np.tile(np.arange(k), len(good))[order]
        pair_scan = np.zeros(len(pair_row))
        pair_ref = np.zeros(len(pair_row))

        for base, rows in mixture.blocks(n_rows):
            x = normalize(rows)
            del rows
            gt_v, gt_i = merge_top(gt_v, gt_i, exact.block(x), base, k)
            held = scan.rows(x)
            block = scan.block(held)
            tier_v, tier_i = merge_top(tier_v, tier_i, block, base, cand)
            lo, hi = np.searchsorted(pair_row, [base, base + x.shape[0]])
            if hi > lo:
                q_sel = torch.from_numpy(pair_q[lo:hi]).to(dev)
                r_sel = torch.from_numpy(pair_row[lo:hi] - base).to(dev)
                pair_scan[lo:hi] = block[q_sel, r_sel].double().cpu().numpy()
                if rescore is not None:
                    ref = rescore.pairs(rescore.rows(x), q_sel, r_sel)
                else:
                    ref = scan.pairs(held, q_sel, r_sel)
                pair_ref[lo:hi] = ref.cpu().numpy()
            del x, held, block

        cth = tier_v[:, cand - 1].double().cpu().numpy()
        gt = gt_i.cpu().numpy()

    got = scores[pair_u, pair_slot]
    numbers = {
        "bad_answers": float(bad.sum()),
        "scan_gap": float(np.clip(cth[pair_q] - pair_scan, 0, None).max()) if len(pair_row) else 0.0,
        "score_err": float(np.abs(got - pair_ref).max()) if len(pair_row) else 0.0,
    }
    recall = np.array([len(np.intersect1d(ids[u], gt[qis[u]])) / k for u in range(len(qis))])
    return numbers, recall

