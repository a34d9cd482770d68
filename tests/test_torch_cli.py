"""The port's CLI (host copy: `cli.py`, run as `python -m
codegraph_tpu_torch.cli`), held to the JAX CLI on the CPU.

The JAX CLI runs in-process (`codegraph_tpu.cli.main`, JAX on the CPU); the
port's in-process with `--device cpu`, and as a subprocess for `start stdio`,
`start http` and the run without `--device cpu` (in a process where `jax` and
`codegraph_tpu` cannot be imported); `daemon start` spawns one more, the
daemon. Both read one TOML config (hash
provider, no fallbacks). Every subcommand's JSON must be equal: exactly,
except wall-clock fields (`stage_seconds`, `parse_seconds`), the snapshot's
path where each package wrote its own, and search hits, held as in
`tests/test_torch_mcp.py` (scores within 1e-5, ids swapped only where scores
tie, `related` as sets).
"""

import contextlib
import http.client
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest
import torch

from codegraph_tpu import cli as jcli
from codegraph_tpu.core import config as jconfig
from codegraph_tpu.search import hybrid as jhybrid
from codegraph_tpu_torch import cli as tcli
from codegraph_tpu_torch.core import config as tconfig
from codegraph_tpu_torch.search import hybrid as thybrid

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_JAX = r"""
import importlib.abc, runpy, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "codegraph_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
sys.argv = ["codegraph-torch"] + sys.argv[1:]
runpy.run_module("codegraph_tpu_torch.cli", run_name="__main__")
"""


def _write_toml(path, data_dir):
    path.write_text(f'data_dir = "{data_dir}"\n\n[embedding]\nprovider = "hash"\n'
                    'dimension = 128\nfallbacks = []\n')
    return str(path)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "search"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = {"root": root, "proj": str(proj),
           "jcfg": _write_toml(root / "j.toml", root / "jdata"),
           "tcfg": _write_toml(root / "t.toml", root / "tdata")}
    out["jindex"] = run(jcli.main, ["--config", out["jcfg"], "index", str(proj), "--force"])
    out["tindex"] = run(tcli.main, ["--device", "cpu", "--config", out["tcfg"], "index",
                                    str(proj), "--force"])
    return out


def run(main, argv, stdin=None):
    """(exit code, stdout) of one in-process CLI run."""
    out = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        sys.stdin = old_stdin
    return rc, out.getvalue()


def both(env, argv, stdin=None, snapshot="j"):
    """The JAX CLI and the port's (--device cpu) on one config."""
    cfg = env[f"{snapshot}cfg"]
    return (run(jcli.main, ["--config", cfg, *argv], stdin),
            run(tcli.main, ["--device", "cpu", "--config", cfg, *argv], stdin))


def _search_close(a, b):
    assert len(a) == len(b) > 0
    scores = [r["score"] for r in a]
    for i, (x, y) in enumerate(zip(a, b)):
        assert abs(x["score"] - y["score"]) <= TOL
        if x["node_id"] != y["node_id"]:
            assert any(abs(scores[n] - scores[i]) <= TOL
                       for n in (i - 1, i + 1) if 0 <= n < len(scores)), i
            continue
        assert sorted(x) == sorted(y)
        for key in x:
            if key == "related":
                assert sorted(e["weight"] for e in x[key]) == sorted(e["weight"] for e in y[key])
                if len(x[key]) < 8:
                    assert sorted((e["name"], e["relation"]) for e in x[key]) == \
                        sorted((e["name"], e["relation"]) for e in y[key])
            elif isinstance(x[key], float):
                assert abs(x[key] - y[key]) <= TOL, key
            else:
                assert x[key] == y[key], key


def _replies_close(a, b):
    assert [m.get("id") for m in a] == [m.get("id") for m in b]
    for x, y in zip(a, b):
        content = (x.get("result") or {}).get("content")
        if not content:
            assert x == y
            continue
        assert x["result"]["isError"] == y["result"]["isError"]
        px, py = (json.loads(m["result"]["content"][0]["text"]) for m in (x, y))
        if "results" in px:
            assert px["count"] == py["count"]
            _search_close(px["results"], py["results"])
        elif "evidence" in px:
            assert px["agent"] == py["agent"] and px["answer"] == py["answer"]
            assert [e["tool"] for e in px["evidence"]] == [e["tool"] for e in py["evidence"]]
            for ex, ey in zip(px["evidence"], py["evidence"]):
                if "results" in ex["result"]:
                    _search_close(ex["result"]["results"], ey["result"]["results"])
                else:
                    assert ex == ey
        else:
            assert px == py


def test_index_equal(env):
    (rj, oj), (rt, ot) = env["jindex"], env["tindex"]
    assert rj == rt == 0
    a, b = json.loads(oj), json.loads(ot)
    assert sorted(a) == sorted(b)
    assert sorted(a["stage_seconds"]) == sorted(b["stage_seconds"])
    assert b["snapshot"] == str(env["root"] / "tdata")
    for key in a:
        if key not in ("stage_seconds", "snapshot"):
            assert a[key] == b[key], key
    assert b["files_parsed"] > 5 and b["chunks"] > 20


def test_reindex_unchanged_equal(env, tmp_path):
    """An incremental run over a copy of each snapshot: nothing changed."""
    outs = []
    for main, side, extra in ((jcli.main, "j", []), (tcli.main, "t", ["--device", "cpu"])):
        data = tmp_path / f"{side}data"
        shutil.copytree(env["root"] / f"{side}data", data)
        cfg = _write_toml(tmp_path / f"{side}.toml", data)
        rc, out = run(main, [*extra, "--config", cfg, "index", env["proj"]])
        assert rc == 0
        outs.append({k: v for k, v in json.loads(out).items()
                     if k not in ("stage_seconds", "snapshot")})
    assert outs[0] == outs[1] and outs[1]["files_unchanged"] == outs[1]["files_total"]


def test_index_watch_equal(env, tmp_path, monkeypatch):
    """--watch: a modified and a deleted file are reindexed and saved, then
    ctrl-c ends the loop (the watcher's batches are scripted)."""
    from codegraph_tpu.parser import watcher as jwatch
    from codegraph_tpu.parser.watcher import BatchedChanges as JBatch
    from codegraph_tpu_torch.parser import watcher as twatch
    from codegraph_tpu_torch.parser.watcher import BatchedChanges as TBatch

    results = []
    for main, side, mod, batch_cls, extra in (
            (jcli.main, "j", jwatch, JBatch, []),
            (tcli.main, "t", twatch, TBatch, ["--device", "cpu"])):
        proj = tmp_path / f"{side}proj"
        shutil.copytree(env["proj"], proj)
        files = sorted(p for p in os.listdir(proj) if p.endswith(".py") and p != "__init__.py")
        changed, gone = str(proj / files[0]), str(proj / files[1])
        with open(changed, "a") as f:
            f.write("\n\ndef watch_added_function(x):\n    return x\n")
        os.remove(gone)
        batches = [batch_cls(), batch_cls(modified=[changed], deleted=[gone])]

        def next_batch(self, _b=batches):
            if not _b:
                raise KeyboardInterrupt
            return _b.pop(0)

        monkeypatch.setattr(mod.FileWatcher, "next_batch", next_batch)
        monkeypatch.setattr(time, "sleep", lambda s: None)
        cfg = _write_toml(tmp_path / f"{side}.toml", tmp_path / f"{side}data")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, out = run(main, [*extra, "--config", cfg, "index", str(proj), "--force", "--watch"])
        monkeypatch.undo()
        assert rc == 0
        msgs = [ln.replace(str(proj), "PROJ") for ln in err.getvalue().splitlines()
                if ln.startswith(("reindexed", "removed", "watching"))]
        rc, found = run(main, [*extra, "--config", cfg, "search", "watch_added_function",
                               "--limit", "3"])
        results.append((msgs, json.loads(found)[0]["name"]))
    assert results[0] == results[1]
    assert results[1][1] == "watch_added_function" and len(results[1][0]) == 3


def test_estimate_equal(env):
    (rj, oj), (rt, ot) = both(env, ["estimate", env["proj"]])
    assert rj == rt == 0
    a, b = json.loads(oj), json.loads(ot)
    assert a.pop("parse_seconds") >= 0 and b.pop("parse_seconds") >= 0
    assert a == b
    assert b["recommended_index"]["kind"] == "flat" and b["provider"] == "hash"


SEARCHES = [
    ["search", "hybrid search with BM25 and a graph boost"],
    ["search", "cache eviction", "--limit", "4"],
    ["search", "filters", "--language", "python", "--node-type", "function"],
    ["search", "rerank results", "--path-prefix", "PROJ/reranker.py"],
    ["search", "service batches", "--metadata", "kind=none", "--soft-filters"],
]


@pytest.mark.parametrize("argv", SEARCHES, ids=[str(i) for i in range(len(SEARCHES))])
@pytest.mark.parametrize("snapshot", ["j", "t"])
def test_search_equal(env, argv, snapshot):
    """On one snapshot, and each package on its own."""
    argv = [a.replace("PROJ", env["proj"]) for a in argv]
    if snapshot == "j":
        (rj, oj), (rt, ot) = both(env, argv)
    else:
        rj, oj = run(jcli.main, ["--config", env["jcfg"], *argv])
        rt, ot = run(tcli.main, ["--device", "cpu", "--config", env["tcfg"], *argv])
    assert rj == rt == 0
    _search_close(json.loads(oj), json.loads(ot))


@pytest.mark.parametrize("argv", [["status"], ["check"], ["config"], ["stats"],
                                  ["daemon", "status"], ["daemon", "stop"]])
def test_plain_subcommands_equal(env, argv):
    (rj, oj), (rt, ot) = both(env, argv)
    assert rj == rt == 0
    assert json.loads(oj) == json.loads(ot)


def test_daemon_start_status_stop(env, tmp_path, monkeypatch):
    """`daemon start` spawns the port's daemon on the CLI's device; status
    and stop find it through the pid file under the project's data dir."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("CODEGRAPH_EMBEDDING_PROVIDER", "hash")
    monkeypatch.setenv("CODEGRAPH_DATA_DIR", str(tmp_path / "child"))
    cfg = _write_toml(tmp_path / "d.toml", tmp_path / "data")
    argv = ["--device", "cpu", "--config", cfg, "daemon"]
    rc, out = run(tcli.main, [*argv, "start", env["proj"]])
    started = json.loads(out)
    assert rc == 0 and started["status"] == "started"
    try:
        argvs, deadline = b"", time.time() + 30
        while not argvs and time.time() < deadline:
            with open(f"/proc/{started['pid']}/cmdline", "rb") as f:
                argvs = f.read()
            time.sleep(0.05)
        assert argvs.split(b"\0")[-3:-1] == [b"--device", b"cpu"]
        assert json.loads(run(tcli.main, [*argv, "status", env["proj"]])[1]) == \
            {"running": True, "pid": started["pid"]}
    finally:
        rc, out = run(tcli.main, [*argv, "stop", env["proj"]])
    assert json.loads(out) == {"status": "stopped", "pid": started["pid"]}


def test_check_reports_problems_equal(env, tmp_path):
    data = tmp_path / "data"
    shutil.copytree(env["root"] / "jdata", data)
    cfg = _write_toml(tmp_path / "c.toml", data)
    manifest = next(p for p in os.listdir(data) if p.endswith(".json") and "manifest" in p)
    os.remove(data / manifest)
    outs = [run(jcli.main, ["--config", cfg, "check"]),
            run(tcli.main, ["--device", "cpu", "--config", cfg, "check"])]
    assert outs[0] == outs[1]
    assert outs[1][0] == 1 and json.loads(outs[1][1])["problems"] == [
        "store has chunks but no index snapshot"]
    empty = _write_toml(tmp_path / "e.toml", tmp_path / "nothing")
    outs = [run(jcli.main, ["--config", empty, "check"]),
            run(tcli.main, ["--device", "cpu", "--config", empty, "check"])]
    assert outs[0] == outs[1] and outs[1][0] == 1


def test_secret_subcommands_equal(env, tmp_path, monkeypatch):
    outs = []
    for main, cfgmod, extra, side in ((jcli.main, jconfig, [], "j"),
                                      (tcli.main, tconfig, ["--device", "cpu"], "t")):
        monkeypatch.setattr(cfgmod, "CONFIG_DIR", tmp_path / side)
        seq = [["secret", "set", "TEST_KEY", "abc123"], ["secret", "get", "TEST_KEY"],
               ["secret", "list"], ["secret", "delete", "TEST_KEY"],
               ["secret", "get", "TEST_KEY"], ["secret", "list"]]
        outs.append([run(main, [*extra, "--config", env[f"{side}cfg"], *argv]) for argv in seq])
    assert outs[0] == outs[1]
    assert outs[1][1] == (0, "abc123\n") and outs[1][4] == (1, "\n")


STDIO = [
    {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
    {"jsonrpc": "2.0", "id": 2, "method": "tools/list"},
    {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
     "params": {"name": "semantic_code_search",
                "arguments": {"query": "BM25 scoring of documents"},
                "_meta": {"progressToken": "p"}}},
    {"jsonrpc": "2.0", "id": 4, "method": "tools/call",
     "params": {"name": "agentic_context", "arguments": {"query": "query cache"}}},
    {"jsonrpc": "2.0", "id": 5, "method": "prompts/get",
     "params": {"name": "code_search", "arguments": {"query": "cache"}}},
]


def _port_proc(args, env_vars=None, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, **(env_vars or {}))
    return [sys.executable, "-c", BLOCK_JAX, *args], env


def _boost_inputs(data_dir, replies) -> str:
    """Both packages' boost inputs for every hit of the search replies (a
    failure's diagnostic): the hit's row and its boost neighbours with their
    weights, from each package's `padded_adjacency` of the snapshot."""
    import codegraph_tpu.native as jnative
    from codegraph_tpu.graph.store import GraphStore as JStore
    from codegraph_tpu_torch.graph.store import GraphStore as TStore

    # whether the JAX side built its boost table with its g++ library (else
    # its Python loop); the port's `start` process builds it with its own
    lines = [f"codegraph_tpu.native.available() in this process: {jnative.available()}"]
    for name, store in (("jax", JStore.load(data_dir)), ("port", TStore.load(data_dir))):
        nbr, wgt, _, _ = store.csr().padded_adjacency(max_deg=32)
        for reply in replies:
            for hit in reply:
                row = store.node_rows.get(hit["node_id"], -1)
                live = [(store.node_by_row(int(n)).name, float(w))
                        for n, w in zip(nbr[row], wgt[row]) if row >= 0 and n >= 0]
                lines.append(f"{name} {hit['name']} row={row} graph_boost={hit.get('graph_boost')} "
                             f"neighbours={sorted(live)}")
    return "\n".join(lines)


def _replies_close_or_explain(a, b, data_dir):
    """`_replies_close`, and on a mismatch the boost inputs of every search
    hit on both sides in the failure's message."""
    try:
        _replies_close(a, b)
    except AssertionError as exc:
        hits = []
        for x, y in zip(a, b):
            for m in (x, y):
                content = (m.get("result") or {}).get("content")
                if content:
                    payload = json.loads(content[0]["text"])
                    hits.append(payload.get("results", []))
        raise AssertionError(f"{exc}\nboth sides' hits:\n{json.dumps(hits, indent=1)}\n"
                             f"{_boost_inputs(data_dir, hits)}") from exc


def test_start_stdio_subprocess_equal(env):
    """`start stdio` of the port as a process that cannot import JAX: every
    stdout line is a JSON-RPC message, and the replies equal the JAX CLI's."""
    lines = "\n".join(json.dumps(m) for m in STDIO) + "\n"
    rj, oj = run(jcli.main, ["--config", env["jcfg"], "start", "stdio"], stdin=lines)
    cmd, penv = _port_proc(["--device", "cpu", "--config", env["jcfg"], "start", "stdio"])
    proc = subprocess.run(cmd, input=lines, capture_output=True, text=True, timeout=240,
                          env=penv, cwd=env["proj"])
    assert proc.returncode == rj == 0, proc.stderr
    a = [json.loads(ln) for ln in oj.splitlines()]
    b = [json.loads(ln) for ln in proc.stdout.splitlines()]  # every line parses
    assert len(b) == 7
    _replies_close_or_explain(a, b, str(env["root"] / "jdata"))
    assert json.loads(b[5]["result"]["content"][0]["text"])["agent"] == "pipeline"


def test_start_http_subprocess_equal(env):
    """`start http --port N` of the port as a process; its replies over
    HTTP equal the JAX server's (built as the JAX CLI builds it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd, penv = _port_proc(["--device", "cpu", "--config", env["jcfg"], "start", "http",
                            "--port", str(port)])
    proc = subprocess.Popen(cmd, env=penv, cwd=env["proj"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), timeout=1).close()
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.communicate()
                time.sleep(0.2)
        got = []
        for msg in STDIO[:1] + STDIO[2:]:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/mcp", body=json.dumps(msg),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            got.append(json.loads(resp.read()))
            conn.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
    cfg = jconfig.load_config(env["jcfg"])
    server = jcli._make_server(cfg)
    want = [server.handle_message(m) for m in STDIO[:1] + STDIO[2:]]
    _replies_close_or_explain(want, got, str(env["root"] / "jdata"))


def test_start_http_in_process_equal(env, monkeypatch):
    from codegraph_tpu.mcp import server as jsrv
    from codegraph_tpu_torch.mcp import server as tsrv

    seen = []
    for mod in (jsrv, tsrv):
        monkeypatch.setattr(mod.MCPServer, "serve_http",
                            lambda self, host, port, auth_token=None: seen.append((host, port)))
    for port in ([], ["--port", "4321"]):
        (rj, _), (rt, _) = both(env, ["start", "http", *port])
        assert rj == rt == 0
    assert seen == [("127.0.0.1", 3003)] * 2 + [("127.0.0.1", 4321)] * 2


def test_failing_search_is_an_error_reply_on_both(env, monkeypatch):
    """A tool whose search raises answers isError: true (the server does not
    raise, and the CLI exits 0), on both sides."""
    for mod in (jhybrid, thybrid):
        def boom(self, *a, **k):
            raise RuntimeError("search exploded")
        monkeypatch.setattr(mod.HybridSearch, "search_text", boom)
    lines = json.dumps(STDIO[2]) + "\n"
    (rj, oj), (rt, ot) = both(env, ["start", "stdio"], stdin=lines)
    assert rj == rt == 0
    a, b = ([json.loads(ln) for ln in o.splitlines()] for o in (oj, ot))
    assert a == b
    assert b[-1]["result"]["isError"] is True
    assert "RuntimeError: search exploded" in b[-1]["result"]["content"][0]["text"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present: cuda would run")
def test_default_device_without_gpu_fails_loudly(env):
    """Without --device cpu the port runs on "cuda"; with no GPU that is an
    error naming CUDA, not a quiet run on the CPU."""
    cmd, penv = _port_proc(["--config", env["jcfg"], "search", "cache"])
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240, env=penv,
                          cwd=env["proj"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr and proc.stdout == ""
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(["--config", env["jcfg"], "estimate", env["proj"]])
