"""The port's device mesh: an ordered list of shards, each with a device.

Counterpart of the JAX package's ``parallel/mesh.py`` (a one-axis
``jax.sharding.Mesh`` over the devices).  A device may appear more than
once: shards that share a card are the port's virtual devices, as the
JAX package's tests run the same code on 8 virtual CPU devices of one
host.  The partition, the per-shard kernel launches and the assembly are
the same lines of code whether two shards share a card or not; data
moves between shards with ``tensor.to(device)`` copies, which order
themselves on the current streams of both devices.
"""
from __future__ import annotations

from typing import Sequence

import torch


def canonical(device) -> torch.device:
    """``device`` with its index filled in ("cuda" -> the current card),
    so that two names of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Shards in order, one device each (repeats allowed); shard 0's
    device is the root, where sharded results are assembled."""

    def __init__(self, devices: Sequence):
        devices = tuple(canonical(d) for d in devices)
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        for d in devices:
            if d.type == "cuda" and not (torch.cuda.is_available()
                                         and d.index
                                         < torch.cuda.device_count()):
                raise RuntimeError(f"mesh device {d} is not present")
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def root(self) -> torch.device:
        return self.devices[0]

    def replicate(self, t: torch.Tensor) -> list:
        """One tensor per shard holding ``t``'s values: a copy on each
        other device, the same object for shards on ``t``'s device."""
        return [t.to(d) for d in self.devices]

    def __repr__(self):
        return "Mesh(" + ", ".join(str(d) for d in self.devices) + ")"


def make_mesh(n_shards: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_shards`` shards (default: one per device) over
    ``devices`` (default: every card present), shard i on device i.
    With fewer devices than shards the caller names one device per shard
    (``devices=["cuda:0"] * 4``): nothing is placed on a device the
    caller did not ask for, and never on the CPU unless it is named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: name the mesh's devices (devices=['cpu'] "
                "* n for CPU shards)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1 or n_shards > len(devices):
        raise ValueError(
            f"{n_shards} shards over {len(devices)} devices: name one "
            "device per shard (a device may repeat)")
    return Mesh(devices[:n_shards])


def shard_train_data(mesh: Mesh, *operands: torch.Tensor) -> list:
    """Place the operand tensors of one training covariance on every
    shard: one tuple of tensors per shard.  The operands are replicated,
    as in the JAX package's production build (its ``P()`` specs,
    sharded_kernels.py:273-278); each shard then works on its own tile
    range or stripe of them.  The copies carry the rounded values (the
    bf16 parts in a bf16 mode), so every shard reads one Gram."""
    return list(zip(*(mesh.replicate(t) for t in operands)))
