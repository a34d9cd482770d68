"""Port of `codegraph_tpu/parallel/mesh.py`: a single-controller device mesh,
and the collectives that the JAX package's `shard_map` bodies use.

One process drives every device of the mesh, as JAX's does: a `Mesh` is an
array of `torch.device`s with one named axis per dimension, and the
parallel modules run a `shard_map` body as a loop over the shards of one
axis, holding one tensor per shard in a list. The collectives below act
on such a list:

* `all_gather(xs)`: every shard's value, stacked, on each shard's device;
* `psum(xs)`: the sum of the shards' values, on each shard's device;
* `ppermute(xs, perm)`: value i sent to shard j for each (i, j) of perm,
  zeros where no value arrives (as `jax.lax.ppermute`);
* `all_to_all(xs, split_axis, concat_axis)`: `jax.lax.all_to_all` with
  tiled=True: piece j of shard i's value, cut along split_axis, goes to
  shard j, which joins the pieces in shard order along concat_axis;
* `axis_index(mesh, axis, coords)`: a device's position along an axis.

Each is plain tensor work (`torch.stack`, a sum, a list rotation,
`.to(device)`), so autograd flows through them. A value computed once for
a group of shards on one device is computed once: the collectives do their
work once per distinct device. A "replicated" result of a parallel
function lives on the mesh's first device.

The mesh is not `torch.distributed`: NCCL refuses two ranks on one GPU and
gloo has no all_gather of CUDA tensors, while the JAX package's API (and
its tests, on eight CPU devices faked in one process) is single-controller.
A caller may repeat one device, e.g. `[torch.device("cuda", 0)] * 8` for an
8-shard mesh on one card, the explicit counterpart of XLA's forced host
device count; `make_mesh` never does so on its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def default_mesh_shape(n_devices: int, n_axes: int = 2) -> Tuple[int, ...]:
    """Factor n_devices into a near-square mesh shape, e.g. 8 -> (4, 2).

    Axis order is (dp, tp): the data axis gets the larger factor.
    """
    if n_axes == 1:
        return (n_devices,)
    best = (n_devices, 1)
    for tp in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % tp == 0:
            best = (n_devices // tp, tp)
    return best


class Mesh:
    """Devices laid out on named axes: `devices` is an object array of
    `torch.device` with one dimension per name in `axis_names`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where a replicated result lives."""
        return self.devices.flat[0]

    def device(self, **coords: int) -> torch.device:
        """The device at the named coordinates (an axis not named: 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError(f"no mesh axis {sorted(unknown)} in {self.axis_names}")
        return self.devices[tuple(int(coords.get(a, 0)) for a in self.axis_names)]

    def axis_devices(self, axis: str, **coords: int) -> List[torch.device]:
        """The devices along `axis`, the other axes at `coords` (default 0)."""
        return [self.device(**{**coords, axis: i}) for i in range(self.shape[axis])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def _as_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {d!r} requested but torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device {d!r}")
    return dev


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axes: Sequence[str] = ("data",),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a Mesh over `devices`, by default every visible CUDA device.

    shape=None puts every device on the first axis (1-D corpus sharding);
    otherwise shape/axes describe a multi-axis layout (e.g. (4, 2) x ("dp",
    "tp")). A list that repeats one device puts several shards on it.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(devices=None) takes every CUDA device, and "
                               "torch.cuda.is_available() is False; pass devices, e.g. "
                               "[torch.device('cpu')] * 8")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [_as_device(d) for d in devices]
    if shape is None:
        shape = (len(devs),) + (1,) * (len(axes) - 1)
    n = int(np.prod(shape))
    if n > len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, have {len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs[:n]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


# ---------------------------------------------------------------------------
# collectives over the shards of one axis
# ---------------------------------------------------------------------------


def _once_per_device(xs: Sequence[torch.Tensor], fn) -> List[torch.Tensor]:
    """fn(device) for each shard's device, computed once per distinct device."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for x in xs:
        if x.device not in done:
            done[x.device] = fn(x.device)
        out.append(done[x.device])
    return out


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`jax.lax.all_gather` (not tiled): [n_shards, *x.shape] on each shard's device."""
    return _once_per_device(xs, lambda dev: torch.stack([x.to(dev) for x in xs]))


def psum(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`jax.lax.psum`: the shards' values summed in shard order, on each shard's device."""
    def total(dev):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        return acc
    return _once_per_device(xs, total)


def ppermute(xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """`jax.lax.ppermute`: out[dst] = xs[src] for (src, dst) in perm, moved
    to dst's device; a shard that receives nothing gets zeros."""
    out = [torch.zeros_like(x) for x in xs]
    seen = set()
    for src, dst in perm:
        if dst in seen:
            raise ValueError(f"ppermute: shard {dst} receives twice in {perm}")
        seen.add(dst)
        out[dst] = xs[src].to(xs[dst].device)
    return out


def all_to_all(xs: Sequence[torch.Tensor], split_axis: int, concat_axis: int,
               tiled: bool = True) -> List[torch.Tensor]:
    """`jax.lax.all_to_all(..., tiled=True)`: each shard's value cut into
    n_shards pieces along split_axis; shard j receives piece j of every
    shard and joins them in shard order along concat_axis."""
    if not tiled:
        raise NotImplementedError("all_to_all is written for tiled=True, as the JAX package calls it")
    n = len(xs)
    if xs[0].shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of size {xs[0].shape[split_axis]} "
                         f"does not split into {n} shards")
    pieces = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([pieces[i][j].to(xs[j].device) for i in range(n)], dim=concat_axis)
            for j in range(n)]


def axis_index(mesh: Mesh, axis: str, coords: Dict[str, int]) -> int:
    """`jax.lax.axis_index`: the position along `axis` of the device at
    `coords` (a dict of mesh coordinates)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no mesh axis {axis!r} in {mesh.axis_names}")
    return int(coords.get(axis, 0))


def split_rows(x: torch.Tensor, devices: Sequence[torch.device], dim: int = 0) -> List[torch.Tensor]:
    """x cut into len(devices) equal contiguous pieces along `dim`, piece i on
    devices[i]: a view where x already lies there, a copy elsewhere."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of size {x.shape[dim]} does not split into {n} shards")
    return [p.to(d) for p, d in zip(torch.chunk(x, n, dim=dim), devices)]


__all__ = [
    "Mesh",
    "make_mesh",
    "default_mesh_shape",
    "all_gather",
    "psum",
    "ppermute",
    "all_to_all",
    "axis_index",
    "split_rows",
]
