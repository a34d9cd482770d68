"""Cells of BENCHMARK.json cut to a size a CPU test holds: every width and
shape of the run kept but the corpus, the query set and the mixture."""

from __future__ import annotations

import dataclasses

from portbench.harness import resolve

TINY = {"n_rows": 3000, "dim": 40, "queries": 24}
TINY_GENERATOR = {"clusters": 12, "block_rows": 1024}


def tiny_cell(name: str, clients: int = 0):
    """The cell `name` at tiny size; `clients` (when set) replaces the
    client count of a mix through the service."""
    cell = resolve(name)
    config = dict(cell.config, **TINY)
    config["generator"] = dict(config["generator"], **TINY_GENERATOR)
    traffic = cell.traffic
    if clients and traffic["via"] == "service":
        traffic = dict(traffic, clients=clients)
    return dataclasses.replace(cell, config=config, traffic=traffic)
