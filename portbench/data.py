"""The benchmark's inputs, made from the seed on the device.

Rows and queries are drawn from one Gaussian mixture and L2-normalised:
a row is a unit centre plus noise of norm `spread`, normalised again.
Independent Gaussian vectors in hundreds of dimensions all score about
alike, so their top-k would be decided by rounding; a mixture gives each
query a neighbourhood, as real embeddings have.

Each block of rows has a generator of its own, seeded from the run's seed
and the block's first row, so the reference can make any block again after
the window without holding the corpus.
"""

from __future__ import annotations

import hashlib
import math
from typing import Iterator, Tuple

import torch


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from the run's seed and a label."""
    digest = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True).clamp_min(1e-12))


class GaussianMixture:
    """Rows and queries of one configuration's generator section:
    `clusters` unit centres, noise of norm `spread`, `block_rows` a block."""

    def __init__(self, generator: dict, dim: int, seed: int, device):
        if generator.get("kind") != "gaussian_mixture":
            raise ValueError(f"unknown generator {generator.get('kind')!r}")
        self.dim = int(dim)
        self.seed = int(seed)
        self.device = torch.device(device)
        self.clusters = int(generator["clusters"])
        self.spread = float(generator["spread"])
        self.block_rows = int(generator["block_rows"])
        self.centers = unit_rows(torch.randn(self.clusters, self.dim, device=self.device,
                                             generator=self._generator("centers")))

    def _generator(self, *parts) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, *parts))

    def _draw(self, n: int, g: torch.Generator) -> torch.Tensor:
        pick = torch.randint(0, self.clusters, (n,), generator=g, device=self.device)
        noise = torch.randn(n, self.dim, generator=g, device=self.device)
        return unit_rows(self.centers[pick] + noise * (self.spread / math.sqrt(self.dim)))

    def blocks(self, n_rows: int) -> Iterator[Tuple[int, torch.Tensor]]:
        """(first row, f32 rows [n, dim]) for every block of the corpus."""
        for base in range(0, n_rows, self.block_rows):
            n = min(self.block_rows, n_rows - base)
            yield base, self._draw(n, self._generator("rows", base))

    def queries(self, n: int) -> torch.Tensor:
        """The query set: f32 [n, dim], from the same mixture."""
        return self._draw(n, self._generator("queries"))


def query_order(seed: int, n: int) -> list:
    """The order in which the traffic sends the query set: a permutation
    drawn from the seed, so every seed sends the same queries as often."""
    g = torch.Generator().manual_seed(derive_seed(seed, "order"))
    return torch.randperm(n, generator=g).tolist()
