"""Copy of `codegraph_tpu/cli.py` for the PyTorch port, run as
`python -m codegraph_tpu_torch.cli` (or the `codegraph-torch` script). One
top-level option is new: `--device` (default "cuda"), passed to the
ProjectIndexer, the estimator's planner and the watch daemon; asking for CUDA
without a GPU raises, as the API does. It takes the place of the JAX
package's `apply_platform_env()`, which exists only for JAX. The server is
built by `mcp.server.make_server`, which `CodeGraph.serve` shares.

`codegraph` CLI: index / estimate / search / start / status / daemon.

Reference: codegraph-mcp-server/src/bin/codegraph.rs:39-254 — clap
commands Start{stdio,http} / Stop / Status / Index / Estimate / Config /
DbCheck / Daemon. Same surface, argparse instead of clap; `db-check`
becomes `check` (verifies the snapshot + index instead of a SurrealDB
connection).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import Optional

from codegraph_tpu_torch.core.config import CodeGraphConfig, load_config


def _build_indexer(cfg: CodeGraphConfig, device, load_snapshot: bool = True):
    from codegraph_tpu_torch.indexer.indexer import ProjectIndexer

    indexer = ProjectIndexer(cfg, device=device)
    if load_snapshot:
        data_dir = cfg.resolved_data_dir()
        if (data_dir / "store_meta.json").exists():
            indexer.load(str(data_dir))
    return indexer


def cmd_index(args, cfg: CodeGraphConfig) -> int:
    cfg.project_root = args.path
    indexer = _build_indexer(cfg, args.device, load_snapshot=not args.force)
    stats = indexer.index_project(args.path, force=args.force)
    directory = indexer.save()
    out = stats.to_dict()
    out["snapshot"] = directory
    print(json.dumps(out, indent=2))
    if args.watch:
        _watch_loop(indexer, args.path, cfg)
    return 0


def _watch_loop(indexer, root: str, cfg: CodeGraphConfig) -> None:
    """--watch mode (reference: watch_for_changes, indexer.rs:4297)."""
    import time

    from codegraph_tpu_torch.parser.watcher import FileWatcher

    watcher = FileWatcher(
        root,
        debounce_s=cfg.indexing.watch_debounce_ms / 1000.0,
        exclude_globs=cfg.indexing.exclude_globs,
    )
    print("watching for changes (ctrl-c to stop)...", file=sys.stderr)
    try:
        while True:
            watcher.poll_once()
            time.sleep(cfg.indexing.watch_debounce_ms / 1000.0)
            batch = watcher.next_batch()
            if batch.empty:
                continue
            for path in batch.created + batch.modified:
                indexer.index_single_file(path)
                print(f"reindexed {path}", file=sys.stderr)
            for path in batch.deleted:
                indexer.delete_file(path)
                print(f"removed {path}", file=sys.stderr)
            indexer.save()
    except KeyboardInterrupt:
        pass


def cmd_estimate(args, cfg: CodeGraphConfig) -> int:
    from codegraph_tpu_torch.indexer.estimation import RepositoryEstimator

    cfg.project_root = args.path
    estimator = RepositoryEstimator(cfg, device=args.device)
    est = estimator.analyze(args.path)
    out = est.to_dict()
    if estimator.index_plan is not None:
        out["recommended_index"] = estimator.index_plan.to_dict()
    print(json.dumps(out, indent=2))
    return 0


def cmd_search(args, cfg: CodeGraphConfig) -> int:
    from codegraph_tpu_torch.core.types import SearchFilters

    indexer = _build_indexer(cfg, args.device)
    filters = None
    meta = dict(kv.split("=", 1) for kv in (args.metadata or []) if "=" in kv)
    if args.language or args.node_type or args.path_prefix or meta:
        filters = SearchFilters.make(
            languages=args.language, node_types=args.node_type,
            path_prefixes=args.path_prefix, metadata=meta,
            soft=args.soft_filters,
        )
    results = indexer.search.search_text(args.query, args.limit,
                                         filters=filters)
    print(json.dumps([r.to_dict() for r in results], indent=2))
    return 0


def _make_server(cfg: CodeGraphConfig, device):
    from codegraph_tpu_torch.mcp.server import make_server

    return make_server(_build_indexer(cfg, device), cfg)


def cmd_start(args, cfg: CodeGraphConfig) -> int:
    server = _make_server(cfg, args.device)
    if cfg.daemon.auto_start:
        # CODEGRAPH_DAEMON_AUTO_START: bring the watch daemon up with
        # the server (reference: daemon auto-start on MCP start). The
        # daemon gets a config re-rooted at the WATCH path so its pid
        # file lands under the watched project's data dir (the same
        # orphaned-daemon fix as cmd_daemon below).
        import dataclasses as _dc

        from codegraph_tpu_torch.daemon import DaemonManager

        watch = cfg.daemon.watch_path or cfg.project_root
        dcfg = _dc.replace(cfg, project_root=watch)
        DaemonManager(dcfg, args.device).start(watch)
    if args.transport == "http":
        port = args.port or cfg.server.http_port
        server.serve_http(cfg.server.http_host, port)
    else:
        server.serve_stdio()
    return 0


def cmd_status(args, cfg: CodeGraphConfig) -> int:
    data_dir = cfg.resolved_data_dir()
    status = {"project_root": cfg.project_root, "data_dir": str(data_dir)}
    if (data_dir / "store_meta.json").exists():
        from codegraph_tpu_torch.graph.store import GraphStore

        store = GraphStore.load(str(data_dir))
        status["indexed"] = True
        status.update(store.stats())
    else:
        status["indexed"] = False
    from codegraph_tpu_torch.mcp.process import read_pid

    pid = read_pid(str(data_dir))
    status["daemon_pid"] = pid
    print(json.dumps(status, indent=2))
    return 0


def cmd_check(args, cfg: CodeGraphConfig) -> int:
    """Snapshot + index integrity check (reference: db-check)."""
    data_dir = cfg.resolved_data_dir()
    problems = []
    if not (data_dir / "store_meta.json").exists():
        problems.append(f"no snapshot at {data_dir}")
    else:
        from codegraph_tpu_torch.graph.store import GraphStore

        try:
            from codegraph_tpu_torch.index.snapshot import MANIFEST, load_arrays

            store = GraphStore.load(str(data_dir))
            s = store.stats()
            if s["chunks"]:
                if not (data_dir / MANIFEST).exists():
                    problems.append("store has chunks but no index snapshot")
                else:
                    load_arrays(str(data_dir))  # verifies digests
            arch_dir = data_dir / "graph_archive"
            if arch_dir.exists():
                from codegraph_tpu_torch.graph.archive import ArchivedGraphStore

                arch = ArchivedGraphStore.open(str(arch_dir))  # digests
                if len(arch.nodes) != s["nodes"]:
                    problems.append(
                        f"graph archive node count {len(arch.nodes)} != "
                        f"store {s['nodes']} (stale archive)"
                    )
        except Exception as exc:
            problems.append(f"snapshot load failed: {exc}")
    print(json.dumps({"ok": not problems, "problems": problems}, indent=2))
    return 0 if not problems else 1


def cmd_config(args, cfg: CodeGraphConfig) -> int:
    import dataclasses

    print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    return 0


def cmd_daemon(args, cfg: CodeGraphConfig) -> int:
    from codegraph_tpu_torch.daemon import DaemonManager

    # CODEGRAPH_DAEMON_WATCH_PATH supplies the default watch target
    # (reference: config_manager.rs daemon env overrides)
    path = getattr(args, "path", None) or cfg.daemon.watch_path or None
    # the pid file lives under the TARGET root's data dir — without
    # this, `daemon start /proj` from elsewhere wrote the pid to the
    # CWD's .codegraph while the daemon ran against /proj, so stop/
    # status from the project dir saw not_running (orphaned daemon)
    if path:
        cfg.project_root = path
    mgr = DaemonManager(cfg, args.device)
    if args.action == "start":
        print(json.dumps(mgr.start(path)))
    elif args.action == "stop":
        print(json.dumps(mgr.stop()))
    else:
        print(json.dumps(mgr.status()))
    return 0


def cmd_secret(args, cfg: CodeGraphConfig) -> int:
    """Encrypted API-key storage (reference: config.rs crypto secrets)."""
    from codegraph_tpu_torch.core.secrets import SecretStore

    store = SecretStore()
    if args.action == "set":
        import getpass

        value = args.value or getpass.getpass(f"value for {args.name}: ")
        store.set(args.name, value)
        print(json.dumps({"stored": args.name}))
    elif args.action == "get":
        val = store.get(args.name)
        print(val if val is not None else "")
        return 0 if val is not None else 1
    elif args.action == "delete":
        store.delete(args.name)
        print(json.dumps({"deleted": args.name}))
    else:
        print(json.dumps({"secrets": store.names()}))
    return 0


def cmd_stats(args, cfg: CodeGraphConfig) -> int:
    indexer = _build_indexer(cfg, args.device)
    out = {
        "store": indexer.store.stats(),
        "index_live": len(indexer.index),
        "cache": indexer.search.cache.stats(),
    }
    print(json.dumps(out, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="codegraph-torch",
        description="Code intelligence on a CUDA GPU: index, search, serve.",
    )
    p.add_argument("--config", help="path to config.toml")
    p.add_argument("--device", default="cuda",
                   help="torch device of the index and encoder (default cuda; "
                        "cpu runs the plain PyTorch path)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("index", help="index a project directory")
    sp.add_argument("path", nargs="?", default=".")
    sp.add_argument("--force", action="store_true", help="full re-index")
    sp.add_argument("--watch", action="store_true", help="keep watching")
    sp.set_defaults(fn=cmd_index)

    sp = sub.add_parser("estimate", help="dry-run cost estimate")
    sp.add_argument("path", nargs="?", default=".")
    sp.set_defaults(fn=cmd_estimate)

    sp = sub.add_parser("search", help="hybrid semantic search")
    sp.add_argument("query")
    sp.add_argument("--limit", type=int, default=10)
    sp.add_argument("--language", action="append", default=[],
                    help="filter: only this language (repeatable)")
    sp.add_argument("--node-type", action="append", default=[],
                    help="filter: only this node kind (repeatable)")
    sp.add_argument("--path-prefix", action="append", default=[],
                    help="filter: only files under this prefix (repeatable)")
    sp.add_argument("--metadata", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="filter: metadata attribute equals (repeatable)")
    sp.add_argument("--soft-filters", action="store_true",
                    help="filters boost ranking instead of excluding "
                         "(reference hybrid_search soft mix)")
    sp.set_defaults(fn=cmd_search)

    sp = sub.add_parser("start", help="start the MCP server")
    sp.add_argument("--port", type=int, default=0,
                    help="HTTP port (overrides config)")
    sp.add_argument("transport", nargs="?", default="stdio",
                    choices=["stdio", "http"])
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("status", help="index + daemon status")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("check", help="verify snapshot integrity")
    sp.set_defaults(fn=cmd_check)

    sp = sub.add_parser("config", help="print effective config")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("daemon", help="watch daemon control")
    sp.add_argument("action", choices=["start", "stop", "status"])
    sp.add_argument("path", nargs="?", default=".")
    sp.set_defaults(fn=cmd_daemon)

    sp = sub.add_parser("stats", help="store/index/cache statistics")
    sp.set_defaults(fn=cmd_stats)

    sp = sub.add_parser("secret", help="encrypted API-key storage")
    sp.add_argument("action", choices=["set", "get", "delete", "list"])
    sp.add_argument("name", nargs="?", default="")
    sp.add_argument("value", nargs="?", default="")
    sp.set_defaults(fn=cmd_secret)
    return p


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.WARNING,
        stream=sys.stderr,
    )
    cfg = load_config(args.config)
    return args.fn(args, cfg)


if __name__ == "__main__":
    raise SystemExit(main())
