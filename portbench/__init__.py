"""The benchmark of `codegraph_tpu_torch`, the PyTorch and CUDA port.

`run.py` runs one cell of `BENCHMARK.json` on one card: it builds the
cell's index tier from its configuration (`configs/`), drives it with its
traffic mix (`traffic/`), times the window, checks every answer against the
plain reference (`reference/`) and prints the cell's metrics, each read by
its own reader (`metrics/`). A cell (`workloads/`), a configuration, a mix
or a metric is a file of its own, found by its name.

Nothing here imports JAX or the JAX package; the reference imports nothing
of the port.
"""
