"""The port's small host copies, held to the JAX package on the CPU:
`indexer/writer.py`, `graph/consistency.py`, `core/versioning.py`,
`parser/diff.py`, `parser/semantic.py` and `version.py`.

Each case is one scenario of the JAX package's own tests
(`tests/test_writer.py`, `test_segments_consistency.py`,
`test_versioning.py`, `test_semantic_diff.py`), written once against a
package namespace and run on both; its record (plain values: counts, ids,
states, errors) must be equal. Node ids are content hashes, equal in both
packages. The writer over `SegmentedIndex` is in `tests/test_torch_segments.py`.
"""

import dataclasses
import importlib
import textwrap
import time
import types

import numpy as np
import pytest

MODULES = {
    "types": "core.types", "store": "graph.store", "writer": "indexer.writer",
    "consistency": "graph.consistency", "versioning": "core.versioning",
    "diff": "parser.diff", "extractors": "parser.extractors", "semantic": "parser.semantic",
    "providers": "models.providers", "flat": "index.flat", "version": "version",
}


def _pkg(top):
    ns = types.SimpleNamespace(top=top)
    for key, rel in MODULES.items():
        setattr(ns, key, importlib.import_module(f"{top}.{rel}"))
    return ns


@pytest.fixture(scope="module")
def pkgs():
    return _pkg("codegraph_tpu"), _pkg("codegraph_tpu_torch")


def _flat(p, dim):
    if p.top == "codegraph_tpu":
        return p.flat.FlatIndex(dim, tile_n=128, backend="xla")
    return p.flat.FlatIndex(dim, device="cpu")


def _node(p, name, file="a.py"):
    t = p.types
    return t.CodeNode.make("p", name, t.NodeType.FUNCTION, t.Language.PYTHON,
                           t.Location(file, 1, 3), content=f"def {name}(): ...")


# -- indexer/writer.py ---------------------------------------------------


def writer_applies_jobs_in_order(p):
    store = p.store.GraphStore()
    index = _flat(p, 32)
    w = p.writer.WriterHandle(store, index)
    nodes = [_node(p, "alpha"), _node(p, "beta")]
    chunks = [p.types.CodeChunk.make(n.id, n.content, 0, 1) for n in nodes]
    embs = p.providers.HashProvider(32).embed_texts([c.text for c in chunks])
    w.enqueue_nodes(nodes)
    w.enqueue_chunk_embeddings(chunks, embs)
    w.enqueue_file_metadata("a.py", "h1")
    rec = {"errors": w.flush(), "store": store.stats(), "live": len(index),
           "meta": dict(store.file_metadata), "rows": [c.row for c in chunks]}
    w.enqueue_delete_file("a.py")
    rec["after_delete"] = (w.flush(), store.stats(), len(index))
    rec["stats"] = (w.stats.enqueued, w.stats.applied, w.stats.failed, w.stats.by_kind)
    w.close()
    return rec


def writer_resilient_to_bad_jobs(p):
    store = p.store.GraphStore()

    class ExplodingIndex:
        def add(self, e):
            raise RuntimeError("index down")

        def delete(self, rows):
            pass

        def __len__(self):
            return 0

    w = p.writer.WriterHandle(store, ExplodingIndex())
    n = _node(p, "gamma")
    w.enqueue_nodes([n])
    w.enqueue_chunk_embeddings([p.types.CodeChunk.make(n.id, "text", 0, 1)],
                               np.zeros((1, 8), np.float32))
    w.enqueue_nodes([_node(p, "delta", file="b.py")])
    rec = {"errors": w.flush(), "failed": w.stats.failed, "store": store.stats()}
    w.close()
    return rec


def writer_row_drift_is_reported(p):
    """An index whose rows do not follow the store's: the job is applied to
    the index, then reported as a row drift."""
    store = p.store.GraphStore()
    index = _flat(p, 16)
    index.add(np.ones((3, 16), np.float32))  # the index is 3 rows ahead
    w = p.writer.WriterHandle(store, index)
    chunks = [p.types.CodeChunk.make(f"n{i}", f"t{i}", 0, 1) for i in range(4)]
    w.enqueue_chunk_embeddings(chunks, np.eye(4, 16, dtype=np.float32))
    rec = {"errors": w.flush(), "live": len(index), "store": store.stats()}
    w.close()
    return rec


# -- graph/consistency.py ------------------------------------------------


def txn_commit_flow(p):
    c = p.consistency
    mgr = c.ConsistencyManager()
    state = {"x": 0}
    txn = mgr.begin()
    txn.stage(c.Operation("add", "file:a.py", lambda: state.__setitem__("x", 1),
                          undo=lambda: state.__setitem__("x", 0)))
    prepared = mgr.prepare(txn)
    v = mgr.commit(txn)
    log = [{k: e[k] for k in e if k != "ts"} for e in mgr.txn_log]
    return {"prepared": prepared, "version": v, "state": state, "txn": txn.state.value,
            "log": log}


def txn_lock_conflict_aborts(p):
    c = p.consistency
    mgr = c.ConsistencyManager()
    t1, t2 = mgr.begin(), mgr.begin()
    t1.stage(c.Operation("add", "file:a.py", lambda: None))
    t2.stage(c.Operation("delete", "file:a.py", lambda: None))
    rec = [mgr.prepare(t1), mgr.prepare(t2), t2.state.value]
    mgr.commit(t1)
    t3 = mgr.begin()
    t3.stage(c.Operation("delete", "file:a.py", lambda: None))
    return rec + [mgr.prepare(t3), mgr.version]


def txn_apply_failure_rolls_back(p):
    c = p.consistency
    mgr = c.ConsistencyManager()
    state = {"applied": []}

    def boom():
        raise RuntimeError("disk full")

    txn = mgr.begin()
    txn.stage(c.Operation("add", "k1", lambda: state["applied"].append(1),
                          undo=lambda: state["applied"].pop()))
    txn.stage(c.Operation("add", "k2", boom))
    prepared = mgr.prepare(txn)
    with pytest.raises(RuntimeError) as err:
        mgr.commit(txn)
    return {"prepared": prepared, "error": str(err.value), "txn": txn.state.value,
            "state": state, "version": mgr.version}


def txn_snapshot_visibility(p):
    c = p.consistency
    mgr = c.ConsistencyManager()
    t_old = mgr.begin(c.IsolationLevel.SNAPSHOT)
    t_w = mgr.begin()
    t_w.stage(c.Operation("add", "k", lambda: None))
    mgr.prepare(t_w)
    v = mgr.commit(t_w)
    t_rc = mgr.begin(c.IsolationLevel.READ_COMMITTED)
    cp = mgr.checkpoint("after-write")
    return [mgr.is_visible(t_old, v), mgr.is_visible(t_rc, v), cp.version, cp.label,
            [{k: e[k] for k in e if k != "ts"} for e in mgr.txn_log]]


# -- core/versioning.py --------------------------------------------------


def versioned_value_chain(p):
    vv = p.versioning.VersionedValue({"a": 1})
    rec = [vv.version, vv.update({"a": 2}, note="bump"), vv.current, vv.at(1),
           vv.rollback(1), vv.current, [(h[0], h[1]) for h in vv.history()]]
    with pytest.raises(KeyError) as err:
        vv.at(99)
    return rec + [str(err.value)]


def version_store_diff(p):
    store = p.versioning.VersionStore()
    store.put("node:x", {"name": "f", "complexity": 2})
    store.put("node:x", {"name": "f", "complexity": 5, "exported": True})
    store.put("scalar", 1)
    store.put("scalar", 2)
    rec = [store.version_of("node:x"), store.diff("node:x", 1, 2), store.diff("scalar", 1, 2),
           store.diff("scalar", 2, 2), "node:x" in store, "node:y" in store]
    store.rollback("node:x", 1)
    return rec + [store.get("node:x"), store.get("node:x", 2), store.version_of("node:x")]


# -- parser/diff.py and parser/semantic.py --------------------------------

SRC_V1 = textwrap.dedent('''
    def helper(x):
        return x + 1

    def main():
        return helper(1)
''')
SRC_V2 = textwrap.dedent('''
    def helper(x):
        return x + 2

    def main():
        return helper(1)

    def added():
        return main()
''')


def _ranges(rs):
    return [(r.start, r.end) for r in rs]


def changed_line_ranges(p):
    return [_ranges(p.diff.changed_line_ranges(a, b))
            for a, b in ((SRC_V1, SRC_V2), (SRC_V1, SRC_V1), ("", SRC_V1), (SRC_V2, ""))]


def diff_parser_incremental(p):
    lang = p.types.Language.PYTHON
    old = p.extractors.extract_file("p", "a.py", SRC_V1, lang)
    out = []
    for new in (SRC_V2, SRC_V1):
        inc = p.diff.DiffBasedParser().parse_incremental("p", "a.py", SRC_V1, new, old, lang)
        out.append({"ranges": _ranges(inc.changed_ranges),
                    "affected": sorted(inc.affected_node_ids),
                    "reused": sorted(inc.reused_node_ids),
                    "nodes": sorted((n.id, n.name) for n in inc.result.nodes)})
    return out


def semantic_scope_resolution(p):
    src = textwrap.dedent('''
        import os

        def target():
            return 1

        class Widget:
            def target(self):
                return 2

            def caller(self):
                return target()

        def outer():
            return target() + os.getpid()
    ''')
    r = p.extractors.extract_file("p", "a.py", src, p.types.Language.PYTHON)
    model = p.semantic.SemanticAnalyzer().build(r.nodes, r.edges)
    return {"refs": [dataclasses.asdict(ref) for ref in model.references],
            "scopes": [dataclasses.asdict(s) for s in model.scopes],
            "node_scope": model.node_scope}


def semantic_change_impact(p):
    t = p.types

    def mk(name):
        return t.CodeNode.make("p", name, t.NodeType.FUNCTION, t.Language.PYTHON,
                               t.Location("a.py", 1, 2))

    a, b, c, d = mk("a"), mk("b"), mk("c"), mk("d")
    edges = [t.CodeEdge(b.id, a.id, t.EdgeType.CALLS), t.CodeEdge(c.id, b.id, t.EdgeType.CALLS),
             t.CodeEdge(d.id, a.id, t.EdgeType.USES)]
    an = p.semantic.SemanticAnalyzer()
    return [an.compute_change_impact([a.id], [a, b, c, d], edges),
            an.compute_change_impact([c.id], [a, b, c, d], edges)]


def version_constants(p):
    return [p.version.__version__, p.version.MCP_PROTOCOL_VERSION]


SCENARIOS = [
    writer_applies_jobs_in_order, writer_resilient_to_bad_jobs, writer_row_drift_is_reported,
    txn_commit_flow, txn_lock_conflict_aborts, txn_apply_failure_rolls_back,
    txn_snapshot_visibility, versioned_value_chain, version_store_diff, changed_line_ranges,
    diff_parser_incremental, semantic_scope_resolution, semantic_change_impact,
    version_constants,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_host_copy_equals_jax(pkgs, scenario):
    want, got = scenario(pkgs[0]), scenario(pkgs[1])
    assert got == want


def test_versioned_history_timestamps_are_wall_clock(pkgs):
    for p in pkgs:
        t0 = time.time()
        vv = p.versioning.VersionedValue(1)
        vv.update(2)
        assert all(t0 <= h[2] <= time.time() for h in vv.history())
