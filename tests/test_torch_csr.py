"""The boost table above 32 neighbours (`graph/csr.py` `padded_adjacency`),
held to the JAX package on the CPU.

`HybridSearch` keeps a node's `max_deg = 32` heaviest boost neighbours. One
hub here has 44: four heavy ones and 40 of one equal weight, so 28 of the 40
tied ones are kept. Both packages build the table with their g++ library
(the port's copy of it, `csrc/cghost.cpp`; `tests/test_torch_host.py` holds
the two equal), whose `partial_sort` keeps tied neighbours in hash-map order.
The port's plain version, `padded_adjacency_plain`, is the Python loop of
the JAX package (its stable sort keeps ties in CSR order) and must equal the
JAX package's Python path exactly. The library's table and the Python
loop's hold the same count and weights in every row, and differ only in
which of the tied ids at the cut they keep. A hit beside the hub gets the
hub's boost from one table and not the other exactly where that tied id is
kept by one table only.
"""

import numpy as np
import pytest
import torch

import codegraph_tpu.native as jnative
from codegraph_tpu.core.types import EDGE_TYPE_CODES as J_CODES
from codegraph_tpu.core.types import EdgeType as JEdge
from codegraph_tpu.graph import csr as jcsr
from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES as T_CODES
from codegraph_tpu_torch.core.types import EdgeType as TEdge
from codegraph_tpu_torch.graph import csr as tcsr

MAX_DEG = 32
HUB = 0
TIE_W = 1.0


def _edges(codes, etype):
    """One hub (row 0): 40 callees of weight 1.0 (rows 1-40, some joined by
    an incoming edge instead), 4 heavier ones (2.0, rows 41-44), 3 lighter
    callers (0.5, rows 45-47), 2 neighbours by an edge type that does not
    boost (rows 48-49), and a duplicate edge of lower weight; plus a little
    graph among the other rows. Edges are shuffled, so CSR order is not id
    order."""
    calls, uses, imports = codes[etype.CALLS], codes[etype.USES], codes[etype.IMPORTS]
    e = []
    for n in range(1, 41):
        e.append((n, HUB, calls, TIE_W) if n % 7 == 0 else (HUB, n, calls if n % 2 else uses, TIE_W))
    e += [(HUB, n, calls, 2.0) for n in range(41, 45)]
    e += [(n, HUB, uses, 0.5) for n in range(45, 48)]
    e += [(HUB, n, imports, 5.0) for n in (48, 49)]
    e += [(HUB, 3, calls, 0.25)]                      # a lighter copy of a tied edge
    e += [(n, n + 1, calls, 1.0) for n in range(50, 60)]
    e += [(n, (n * 7) % 60, uses, 0.5 + (n % 3)) for n in range(1, 60, 5)]
    order = np.random.default_rng(11).permutation(len(e))
    src, dst, et, w = (np.array(c) for c in zip(*[e[i] for i in order]))
    return 60, src, dst, et.astype(np.int16), w.astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    jg = jcsr.build_csr(*_edges(J_CODES, JEdge))
    tg = tcsr.build_csr(*_edges(T_CODES, TEdge))
    return jg, tg


def _python_path(jg, monkeypatch):
    monkeypatch.setattr(jnative, "padded_adjacency_native", lambda *a, **k: None)
    out = jg.padded_adjacency(max_deg=MAX_DEG)
    monkeypatch.undo()
    return out


def test_port_equals_the_jax_python_path(graphs, monkeypatch):
    jg, tg = graphs
    want = _python_path(jg, monkeypatch)
    got = tg.padded_adjacency_plain(max_deg=MAX_DEG)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    nbr, wgt = got[0][HUB], got[1][HUB]
    assert (nbr >= 0).sum() == MAX_DEG
    assert sorted(nbr[wgt == 2.0]) == [41, 42, 43, 44]
    assert (wgt == TIE_W).sum() == 28 and not set(nbr) & {45, 46, 47, 48, 49}


def _tied_at_cut(wgt_row, valid):
    """The weight of the last kept neighbour, if the row was cut there."""
    return float(wgt_row[valid].min()) if valid.sum() == MAX_DEG else None


def test_native_table_differs_only_among_tied_ids(graphs, monkeypatch):
    """Row by row: the port's plain version against the table the JAX
    package builds by default (its native library where available, else its
    Python path)."""
    jg, tg = graphs
    native = jg.padded_adjacency(max_deg=MAX_DEG)
    port = tg.padded_adjacency_plain(max_deg=MAX_DEG)
    if not jnative.available():
        for a, b in zip(native, port):
            assert np.array_equal(a, b)
        return
    differing = 0
    for row in range(tg.n_nodes):
        vn, vp = native[0][row] >= 0, port[0][row] >= 0
        assert vn.sum() == vp.sum(), row
        assert sorted(native[1][row][vn]) == sorted(port[1][row][vp]), row
        ids_n, ids_p = set(native[0][row][vn]), set(port[0][row][vp])
        if ids_n != ids_p:
            differing += 1
            cut = _tied_at_cut(port[1][row], vp)
            assert cut is not None, row
            for table, ids in ((native, ids_n - ids_p), (port, ids_p - ids_n)):
                weights = dict(zip(table[0][row], table[1][row]))
                assert all(weights[i] == cut for i in ids), row
        # each kept neighbour carries the same edge type, direction and weight
        for i in ids_n & ids_p:
            kn = int(np.nonzero(native[0][row] == i)[0][0])
            kp = int(np.nonzero(port[0][row] == i)[0][0])
            assert (native[1][row][kn], native[2][row][kn], native[3][row][kn]) == \
                (port[1][row][kp], port[2][row][kp], port[3][row][kp]), (row, i)
    assert differing <= 1  # only the hub is cut


def test_boost_gap_is_the_tied_ids(graphs):
    """A hit beside the hub: the candidates (hub, x) for each tied x. The
    hub's boost is TIE_W where its table keeps x, else 0, on each side, so
    the two packages' boosts differ exactly on the tied ids that one table
    keeps and the other does not; x's own boost (its row holds the hub)
    is the same on both (the port's side: its plain version's table)."""
    jg, tg = graphs
    native = jg.padded_adjacency(max_deg=MAX_DEG)
    port = tg.padded_adjacency_plain(max_deg=MAX_DEG)
    tied = list(range(1, 41))
    cand = np.array([[HUB, x] for x in tied], np.int32)
    b_jax = np.asarray(jcsr.adjacency_boost(cand, native[0], native[1]))
    b_port = tcsr.adjacency_boost(torch.as_tensor(cand), torch.as_tensor(port[0]),
                                  torch.as_tensor(port[1])).numpy()
    kept_n, kept_p = set(native[0][HUB]), set(port[0][HUB])
    for i, x in enumerate(tied):
        assert b_port[i, 0] == TIE_W * (x in kept_p)
        assert b_jax[i, 0] == TIE_W * (x in kept_n)
        assert b_port[i, 1] == b_jax[i, 1] > 0
    gap = b_port[:, 0] - b_jax[:, 0]
    explained = np.array([TIE_W * ((x in kept_p) - (x in kept_n)) for x in tied], np.float32)
    assert np.array_equal(gap, explained)
    assert np.abs(gap).sum() == TIE_W * len((kept_p ^ kept_n) & set(tied))
    # both keep 28 of the 40 tied ids
    assert len(kept_p & set(tied)) == len(kept_n & set(tied)) == 28
