"""A single-controller device mesh for the PyTorch port.

Counterpart of `jax.sharding.Mesh`, `NamedSharding` / `PartitionSpec` and
of the four collectives babble_tpu/tpu/sharded.py uses (`lax.ppermute`,
`lax.psum`, `lax.all_gather(tiled=True)`, `lax.axis_index`). As JAX's
`shard_map` is, it is single-controller: one process, one Python loop over
the mesh positions, each position's shard a tensor on its position's
device. Several positions may name the same device (the one-card layout;
the CPU tests put every position on "cpu"), and then a collective is a
copy or an add on that device. Positions on distinct cards exchange by
device-to-device copies; nothing waits on the host. Multi-process
`torch.distributed` meshes are out of scope: the reference drives its mesh
from one process too.

A spec is a tuple with one entry per tensor dimension: an axis name, None
(replicated along that dim) or a tuple of axis names. A dim sharded over a
tuple of axes splits in mesh-major order over that tuple: for
(v_axis, r_axis) the block of position (v, r) is v * dr + r.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .device import resolve_device

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class DeviceMesh:
    """An N-D grid of positions, each on a torch device; `devices` lists one
    device per position in row-major order over `shape`."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        shape = tuple(int(s) for s in shape)
        names = tuple(axis_names)
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {shape} and axis names {names} differ in rank")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate mesh axis names {names}")
        size = int(np.prod(shape)) if shape else 1
        devs = [torch.device(d) for d in devices]
        if len(devs) != size or size < 1:
            raise ValueError(f"mesh shape {shape} needs {size} devices, got {len(devs)}")
        kinds = {d.type for d in devs}
        if len(kinds) > 1:
            raise ValueError(f"a mesh may not mix device types: {sorted(kinds)}")
        # a CUDA position on a host without a card raises, as every entry
        # point does; there is no move to the CPU
        self.devices = [resolve_device(d) for d in devs]
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.dims = shape

    @classmethod
    def on(cls, device, shape: Sequence[int], axis_names: Sequence[str]) -> "DeviceMesh":
        """Every position on one device (the one-card layout)."""
        size = int(np.prod(tuple(shape))) if len(shape) else 1
        return cls([device] * size, shape, axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The device of position 0, where replicated work runs."""
        return self.devices[0]

    def coords(self, pos: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(pos, self.dims))

    def position(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.dims))

    def __repr__(self) -> str:
        return (f"DeviceMesh(shape={self.dims}, axis_names={self.axis_names}, "
                f"devices={sorted({str(d) for d in self.devices})})")


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for a in entry if a is not None)


def axis_index(pos: int, mesh: DeviceMesh, axis) -> int:
    """The position's index along `axis`, or along a tuple of axes in
    mesh-major order (lax.axis_index)."""
    c = mesh.coords(pos)
    idx = 0
    for a in _axes(axis):
        k = mesh.axis_names.index(a)
        idx = idx * mesh.dims[k] + c[k]
    return idx


def axis_size(mesh: DeviceMesh, axis) -> int:
    return int(np.prod([mesh.shape[a] for a in _axes(axis)])) if _axes(axis) else 1


def shard(x, mesh: DeviceMesh, spec: Spec) -> List[torch.Tensor]:
    """A host array or tensor -> one contiguous tensor per position on the
    position's device: each sharded dim split evenly over its axes
    (mesh-major over a tuple), replicated dims whole. Positions that share a
    device and a block share one tensor only when the spec replicates it
    entirely; sharded blocks are copies."""
    t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    for d, entry in enumerate(spec):
        if t.shape[d] % axis_size(mesh, entry):
            raise ValueError(f"dim {d} of extent {t.shape[d]} does not split over {entry!r}")
    parts, cache = [], {}
    for pos, dev in enumerate(mesh.devices):
        block = t
        for d, entry in enumerate(spec):
            k = axis_size(mesh, entry)
            if k > 1:
                size = t.shape[d] // k
                block = block.narrow(d, axis_index(pos, mesh, entry) * size, size)
        if all(_axes(e) == () for e in spec):
            key = str(dev)
            if key not in cache:
                cache[key] = block.to(dev).contiguous()
            parts.append(cache[key])
        else:
            parts.append(block.to(dev, copy=True).contiguous())
    return parts


def replicate(x, mesh: DeviceMesh) -> List[torch.Tensor]:
    """The spec P(): one tensor per position (shared by positions on one
    device)."""
    return shard(x, mesh, ())


def unshard(parts: Sequence[torch.Tensor], mesh: DeviceMesh, spec: Spec,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """The inverse of shard: the global tensor on `device` (the mesh's
    device by default), reassembled from the blocks; replicated dims are
    read from the first position that holds each block."""
    dev = mesh.device if device is None else device
    ndim = parts[0].dim()
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    sharded = [d for d, e in enumerate(spec) if axis_size(mesh, e) > 1]
    # block coordinates per sharded dim -> the first position holding it
    blocks = {}
    for pos in range(mesh.size):
        key = tuple(axis_index(pos, mesh, spec[d]) for d in sharded)
        blocks.setdefault(key, pos)
    counts = [axis_size(mesh, spec[d]) for d in sharded]

    def assemble(level, prefix):
        if level == len(sharded):
            return parts[blocks[tuple(prefix)]].to(dev)
        return torch.cat([assemble(level + 1, prefix + [i]) for i in range(counts[level])],
                         dim=sharded[level])

    return assemble(0, [])


def _groups(mesh: DeviceMesh, axis) -> List[List[int]]:
    """Positions grouped by their coordinates off `axis`; each group in
    order along `axis` (mesh-major over a tuple)."""
    names = _axes(axis)
    ks = [mesh.axis_names.index(a) for a in names]
    groups = {}
    for pos in range(mesh.size):
        c = mesh.coords(pos)
        key = tuple(v for i, v in enumerate(c) if i not in ks)
        groups.setdefault(key, []).append(pos)
    return [sorted(g, key=lambda p: axis_index(p, mesh, axis)) for g in groups.values()]


def ppermute_shift_left(parts: List[torch.Tensor], mesh: DeviceMesh, axis) -> None:
    """In place: each position's tensor loses its first row along dim 0 and
    takes the next position's (along `axis`, cyclic) first row last:
    sharded.py's shift1 (lax.ppermute with perm i -> i - 1)."""
    for group in _groups(mesh, axis):
        firsts = [parts[p][:1].clone() for p in group]
        for k, p in enumerate(group):
            x = parts[p]
            recv = firsts[(k + 1) % len(group)].to(x.device)
            x.copy_(torch.cat([x[1:], recv], dim=0))


def psum(parts: List[torch.Tensor], mesh: DeviceMesh, axis) -> List[torch.Tensor]:
    """The sum over `axis` at every position (lax.psum); positions of a
    group on one device share the result tensor."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in _groups(mesh, axis):
        dev0 = parts[group[0]].device
        total = parts[group[0]].clone()
        for p in group[1:]:
            total += parts[p].to(dev0)
        for p in group:
            out[p] = total.to(parts[p].device)
    return out


def all_gather(parts: List[torch.Tensor], mesh: DeviceMesh, axis) -> List[torch.Tensor]:
    """The tiled gather over `axis` along dim 0 at every position
    (lax.all_gather(tiled=True)), mesh-major over a tuple of axes."""
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    for group in _groups(mesh, axis):
        dev0 = parts[group[0]].device
        whole = torch.cat([parts[p].to(dev0) for p in group], dim=0)
        for p in group:
            out[p] = whole.to(parts[p].device)
    return out


__all__ = [
    "DeviceMesh", "Spec", "all_gather", "axis_index", "axis_size",
    "ppermute_shift_left", "psum", "replicate", "shard", "unshard",
]
