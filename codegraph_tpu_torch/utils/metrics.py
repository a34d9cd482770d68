"""Copy of `codegraph_tpu/utils/metrics.py` for the PyTorch port.

Prometheus text-format metrics export.

Reference: the HTTP server ships the `prometheus` crate
(the reference's Cargo.toml:219) so operators can scrape the serving
process; the rebuild's counters already exist (PerformanceMonitor
targets, SearchCache hit rates, GraphToolExecutor call counts,
QueryService ServiceStats, served-index generation; in the port also the
span recorder's totals, `make_span_source`) — this module
renders them in the Prometheus exposition format (text/plain; version
0.0.4) and `mcp/server.py` serves them at GET /metrics.

Design: no client library (none baked in, no egress) — the exposition
format is plain text, so a tiny renderer over pull-callbacks is the
whole implementation. Sources register a zero-arg callable returning
{metric_name: value | (value, labels)}; every scrape re-pulls, so the
registry never goes stale and holds no locks of its own.
"""

from __future__ import annotations

import re
import threading
from typing import Any, Callable, Dict, List, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

Sample = Tuple[str, Dict[str, str], float]


def _clean(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


class MetricsRegistry:
    """Pull-based registry: callables are invoked at scrape time."""

    def __init__(self, namespace: str = "codegraph"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._sources: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def register(self, name: str, fn: Callable[[], Dict[str, Any]]) -> None:
        """`fn()` -> {metric: value} or {metric: (value, {label: v})}.
        Re-registering a name replaces the source (hot-reload safe)."""
        with self._lock:
            self._sources[name] = fn

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def gather(self) -> List[Sample]:
        with self._lock:
            sources = list(self._sources.items())
        samples: List[Sample] = []
        for src, fn in sources:
            try:
                metrics = fn() or {}
            except Exception:
                # a broken source must not take down the scrape endpoint
                samples.append((f"{self.namespace}_source_error",
                                {"source": src}, 1.0))
                continue
            for metric, value in metrics.items():
                labels: Dict[str, str] = {}
                if isinstance(value, tuple):
                    value, labels = value
                try:
                    v = float(value)
                except (TypeError, ValueError):
                    continue
                # "family__disambiguator" keys let one source emit the
                # same family with different labels (dict keys must be
                # unique); only the family reaches the output
                family = metric.split("__", 1)[0]
                samples.append((
                    _clean(f"{self.namespace}_{family}"), dict(labels), v))
        return samples

    def render(self) -> str:
        """Prometheus exposition text; one # TYPE gauge line per family."""
        samples = self.gather()
        by_family: Dict[str, List[Sample]] = {}
        for name, labels, v in samples:
            by_family.setdefault(name, []).append((name, labels, v))
        lines: List[str] = []
        for family in sorted(by_family):
            kind = "counter" if family.endswith("_total") else "gauge"
            lines.append(f"# TYPE {family} {kind}")
            for name, labels, v in by_family[family]:
                if labels:
                    lab = ",".join(
                        f'{_clean(k)}="{_escape_label(str(val))}"'
                        for k, val in sorted(labels.items()))
                    lines.append(f"{name}{{{lab}}} {v:g}")
                else:
                    lines.append(f"{name} {v:g}")
        return "\n".join(lines) + "\n"


def make_server_source(server) -> Callable[[], Dict[str, Any]]:
    """Metrics source over an MCPServer: tool calls, caches, perfmon,
    index size/generation. Tolerates partially-wired servers (tests)."""

    def pull() -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        tools = getattr(server, "tools", None)
        if tools is None:
            return out
        stats = tools.stats()
        for tool, n in stats.get("calls", {}).items():
            out[f"tool_calls_total__{tool}"] = (float(n), {"tool": tool})
        for k, v in stats.get("cache", {}).items():
            if isinstance(v, (int, float)):
                out[f"tool_cache_{k}"] = float(v)
        search = getattr(tools, "search", None)
        if search is not None:
            cache = getattr(search, "cache", None)
            if cache is not None:
                for k, v in cache.stats().items():
                    if isinstance(v, (int, float)):
                        out[f"search_cache_{k}"] = float(v)
            mon = getattr(search, "monitor", None)
            if mon is not None:
                for metric, entry in mon.report().items():
                    for stat in ("mean", "p95", "n"):
                        out[f"perf_{stat}__{metric}"] = (
                            float(entry[stat]), {"metric": metric})
                    if "meets_target" in entry:
                        out[f"perf_meets_target__{metric}"] = (
                            1.0 if entry["meets_target"] else 0.0,
                            {"metric": metric})
            index = getattr(search, "index", None)
            if index is not None:
                try:
                    out["index_rows"] = float(len(index))
                except TypeError:
                    pass
                gen = getattr(index, "generation", None)
                if gen is not None:
                    out["index_generation"] = float(gen)
                reloads = getattr(index, "reloads", None)
                if reloads is not None:
                    out["index_reloads_total"] = float(reloads)
        store = getattr(getattr(tools, "queries", None), "store", None)
        if store is not None:
            try:
                s = store.stats()
                out["graph_nodes"] = float(s.get("nodes", 0))
                out["graph_edges"] = float(s.get("edges", 0))
                out["graph_files"] = float(s.get("files", 0))
            except Exception:
                pass
        return out

    return pull


def make_service_source(service) -> Callable[[], Dict[str, Any]]:
    """Metrics source over a QueryService (search/service.py)."""

    def pull() -> Dict[str, Any]:
        st = service.stats
        out = {
            "service_queries_total": float(st.queries),
            "service_batches_total": float(st.batches),
            "service_max_batch_seen": float(st.max_batch_seen),
            "service_avg_batch": float(st.avg_batch),
        }
        for extra in ("shed", "expired"):
            v = getattr(st, extra, None)
            if v is not None:
                out[f"service_{extra}_total"] = float(v)
        depth = getattr(service, "queue_depth", None)
        if depth is not None:
            out["service_queue_depth"] = float(
                depth() if callable(depth) else depth)
        return out

    return pull


def make_span_source(recorder=None) -> Callable[[], Dict[str, Any]]:
    """Metrics source over the span recorder (utils/perfmon.py; default
    its process-global one): per span name `span_count_total` and
    `span_seconds_total` (label `span`), the full collections
    (`gc_full_total`, `gc_full_seconds_total`), the collections of each
    generation (`gc_collections_total`, label `generation`) and the
    records the ring overwrote (`spans_dropped_total`)."""
    if recorder is None:
        from codegraph_tpu_torch.utils.perfmon import RECORDER as recorder

    def pull() -> Dict[str, Any]:
        totals = recorder.totals()
        out: Dict[str, Any] = {}
        for name, (count, seconds) in sorted(totals.items()):
            out[f"span_count_total__{name}"] = (float(count), {"span": name})
            out[f"span_seconds_total__{name}"] = (seconds, {"span": name})
        count, seconds = totals.get("gc.full", (0, 0.0))
        out["gc_full_total"] = float(count)
        out["gc_full_seconds_total"] = seconds
        for gen, n in enumerate(recorder.gc_collections):
            out[f"gc_collections_total__{gen}"] = (float(n), {"generation": str(gen)})
        out["spans_dropped_total"] = float(recorder.dropped())
        return out

    return pull


__all__ = [
    "MetricsRegistry",
    "make_server_source",
    "make_service_source",
    "make_span_source",
]
