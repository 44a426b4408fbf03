"""Meshes — the port of `repro/launch/mesh.py` for one H100.

A `Mesh` names its axes and their sizes (`shape`, ordered as the JAX
package's `Mesh.shape`) over the CUDA devices it spans. Functions, not
module constants, so that importing this module touches no device.

* `make_test_mesh` degrades to an all-ones mesh over the card when the
  machine has fewer devices than asked, as the JAX package's does over
  its one CPU device: every sharding rule then resolves to replication.
* `abstract_mesh` is a device-less descriptor of the JAX package's
  16 x 16 and 2 x 16 x 16 production shapes: launch/dryrun.py resolves
  the port's logical axes against it to size each device's share.
  Nothing runs tensors under it (nn/sharding.py's `constrain` refuses
  to split). The JAX package's `make_production_mesh`, which on one
  card could only raise, and its TPU peak constants, which nothing
  reads, have no counterpart (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes over `devices` (torch devices; empty for an
    abstract mesh)."""
    axis_names: tuple
    sizes: tuple
    devices: tuple = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def abstract(self) -> bool:
        return not self.devices

    @property
    def device(self):
        """The one device tensors are placed on under this mesh."""
        if self.abstract:
            raise RuntimeError(f"mesh {self.shape} is abstract: it sizes "
                               f"the dry run and holds no device")
        if self.size != 1:
            raise RuntimeError(f"mesh {self.shape} spans {self.size} "
                               f"cards; the port runs on one")
        return self.devices[0]


def _devices() -> list:
    """The CUDA devices, or the CPU where there is none (the JAX
    package's meshes span its CPU device there)."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> Mesh:
    """Tiny mesh for tests and `--mesh test`: all ones over the first
    device when the machine has fewer devices than `shape` asks for (one
    H100: every rule resolves to replication)."""
    n, have = math.prod(shape), _devices()
    if len(have) < n:
        shape, n = (1,) * len(shape), 1
    return Mesh(tuple(axes), tuple(shape), tuple(have[:n]))


def abstract_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's axes and sizes with no device."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))
