"""The shard mesh and its collectives, in one process.

The JAX package runs its multi-device layer single-controller: one
process, a ``jax.sharding.Mesh``, and the collectives ``psum`` and
``ppermute`` inside ``shard_map``.  The port keeps that shape: a
:class:`DeviceMesh` is a list of shard devices held by one process, and
the collectives are written out here:

* :func:`psum` adds the shards' partial results in shard order on shard
  0's device and hands each shard its copy;
* :func:`ppermute` copies each sent buffer to its receiver's device
  (receivers that get nothing get zeros, as in ``lax.ppermute``);
* :func:`allgather` concatenates the shards' blocks along one axis on
  every shard's device.

Every sum runs in the same order on every call and nothing adds with
atomics, so a rerun on the card repeats itself bit for bit.  Several
shards may share one device: on one card every shard is ``cuda:0`` and
every exchange is a copy on that card (or none: a tensor moved to the
device it is on is the tensor itself, so shards on one device share
their received buffers and nothing may modify them in place).  All shards
launch on the device's current stream, in shard order.

:class:`Sharded` holds one tensor per shard -- the shards' blocks of a
partitioned vector, or one copy per shard of a replicated scalar -- and
applies arithmetic shard by shard.
"""

from __future__ import annotations

import operator

import torch

from navierstokes_tpu_torch import config


class DeviceMesh:
    """One ``torch.device`` per shard along a named axis.

    ``devices`` may repeat a device: shards then share it.  Compares equal
    to another mesh with the same devices and axis, and to a plain
    sequence of the same devices.
    """

    def __init__(self, devices, axis="shard"):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("a device mesh needs at least one device")
        for dev in dict.fromkeys(devices):
            config.require_device(dev)
            if dev.type == "cuda" and dev.index is not None \
                    and dev.index >= torch.cuda.device_count():
                raise RuntimeError(f"{dev}: only "
                                   f"{torch.cuda.device_count()} card(s)")
        self.devices = devices
        self.axis = axis

    def __len__(self):
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i):
        return self.devices[i]

    def __eq__(self, other):
        if isinstance(other, DeviceMesh):
            return self.devices == other.devices and self.axis == other.axis
        if isinstance(other, (list, tuple)):
            return self.devices == tuple(torch.device(d) for d in other)
        return NotImplemented

    def __repr__(self):
        return (f"DeviceMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")

    @property
    def physical_devices(self):
        """The distinct devices, in shard order."""
        return list(dict.fromkeys(self.devices))


def as_mesh(mesh, axis="shard"):
    """``mesh`` as a :class:`DeviceMesh` (a plain sequence of devices is
    accepted); None stays None."""
    if mesh is None or isinstance(mesh, DeviceMesh):
        return mesh
    return DeviceMesh(mesh, axis)


def device_mesh(n_devices=None, axis="shard", device=None):
    """A mesh of ``n_devices`` shards.

    ``device="cpu"`` gives n CPU shards (the port's twin of the JAX
    tests' virtual CPU devices); a device with an index (``"cuda:1"``)
    puts every shard on it; the default puts shard i on the card
    ``cuda:(i % device_count)`` and raises without a card.
    ``n_devices`` None is one shard per card (one on the CPU).
    """
    dev = config.require_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return DeviceMesh([dev] * (1 if n_devices is None
                                   else int(n_devices)), axis)
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    return DeviceMesh([torch.device("cuda", i % count) for i in range(n)],
                      axis)


def _to(t, dev):
    return t.to(dev, non_blocking=True)


def psum(parts, mesh):
    """Sum of the shards' partial results, added in shard order on shard
    0's device; returns one copy per shard (a list)."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} parts for {len(mesh)} shards")
    dev0 = mesh.devices[0]
    total = _to(parts[0], dev0)
    for part in parts[1:]:
        total = total + _to(part, dev0)
    copies = {dev: _to(total, dev) for dev in mesh.physical_devices}
    return [copies[dev] for dev in mesh.devices]


def ppermute(bufs, perm, mesh):
    """``lax.ppermute``: shard ``dst`` receives ``bufs[src]`` for each
    ``(src, dst)`` in ``perm`` (on its own device); a shard that receives
    nothing gets zeros shaped like the buffers.  ``bufs[i]`` may be None
    for a shard that sends nothing."""
    out = [None] * len(mesh)
    for src, dst in perm:
        out[dst] = _to(bufs[src], mesh.devices[dst])
    ref = next(b for b in bufs if b is not None)
    return [ref.new_zeros(ref.shape, device=mesh.devices[i])
            if got is None else got for i, got in enumerate(out)]


def allgather(parts, mesh, dim):
    """The shards' blocks concatenated along ``dim`` in shard order, on
    each shard's device (one concatenation per distinct device)."""
    full = {dev: torch.cat([_to(p, dev) for p in parts], dim=dim)
            for dev in mesh.physical_devices}
    return [full[dev] for dev in mesh.devices]


class Sharded:
    """One tensor per shard; arithmetic applies shard by shard.

    Operands are another ``Sharded`` of the same length (paired shard by
    shard) or anything a tensor combines with (a Python float).
    """

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    def __len__(self):
        return len(self.parts)

    def __iter__(self):
        return iter(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def map(self, fn, *others):
        """``Sharded(fn(self[i], other[i], ...))`` over the shards."""
        return Sharded(fn(*args) for args in
                       zip(self.parts, *(o.parts for o in others)))

    def _binary(self, other, op):
        if isinstance(other, Sharded):
            return Sharded(op(a, b) for a, b in zip(self.parts, other.parts))
        return Sharded(op(a, other) for a in self.parts)

    def _rbinary(self, other, op):
        return Sharded(op(other, a) for a in self.parts)

    def __add__(self, other):
        return self._binary(other, operator.add)

    def __radd__(self, other):
        return self._rbinary(other, operator.add)

    def __sub__(self, other):
        return self._binary(other, operator.sub)

    def __rsub__(self, other):
        return self._rbinary(other, operator.sub)

    def __mul__(self, other):
        return self._binary(other, operator.mul)

    def __rmul__(self, other):
        return self._rbinary(other, operator.mul)

    def __truediv__(self, other):
        return self._binary(other, operator.truediv)

    def __rtruediv__(self, other):
        return self._rbinary(other, operator.truediv)

    def __neg__(self):
        return Sharded(-a for a in self.parts)


def sharded_sum(x: Sharded, mesh):
    """Sum of every entry of a sharded vector: local sums added in shard
    order, one copy per shard."""
    return Sharded(psum([torch.sum(a) for a in x], mesh))


def sharded_dot(x: Sharded, y: Sharded, mesh):
    """<x, y> of two sharded vectors: local dots added in shard order, one
    copy per shard."""
    return Sharded(psum([torch.sum(a * b) for a, b in zip(x, y)], mesh))
