"""codegraph_tpu_torch: the PyTorch + CUDA port of `codegraph_tpu`.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
This slice indexes a codebase (parser, graph store, hash embeddings, flat
index) and serves exact flat hybrid search, single and batched, on an
NVIDIA H100: the flat scan runs the hand-written CUDA kernels K1/K2 in
`csrc/flat_topk.cu`. Entry points run on "cuda" unless the caller passes
device="cpu", which runs the kernels' plain PyTorch versions.

The package imports torch, numpy and the standard library only; the
host-side modules it needs from the JAX package are copied, not imported.
"""


def __getattr__(name):
    # lazy, so that importing the package loads no index code
    if name == "CodeGraph":
        from codegraph_tpu_torch.api import CodeGraph

        return CodeGraph
    raise AttributeError(name)


__all__ = ["CodeGraph"]
