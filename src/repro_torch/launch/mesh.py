"""The deployment's device layouts, the port of the reference
``repro/launch/mesh.py``.

A mesh here is the logical layout alone: axis names and sizes. The
production meshes are the reference's deployment contract, ``(data=16,
model=16)`` for one pod and ``(pod=2, data=16, model=16)`` for two; they
are what the sharding rules (``sharding/specs.py``) fit parameters,
caches and activations to and what the dry-run (``launch/dryrun.py``)
divides memory by. They describe no card. Building one touches no device
and needs no process group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """Named axes and their sizes, in order (the reference's abstract
    mesh: what ``fit_spec`` and the rules read of a ``jax.sharding.Mesh``)."""
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("one size per axis name")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of devices the layout spans."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 256 devices as (data=16, model=16).
    Multi-pod: 2 pods × 256 devices as (pod=2, data=16, model=16)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model_axis: int | None = None) -> Mesh:
    """The layout of this machine's cards: (data=n // m, model=m) over the
    ``torch.cuda.device_count()`` cards (one H100: data=1, model=1); a
    machine without a card counts as one device (the meta dry-run)."""
    import torch
    n = max(1, torch.cuda.device_count())
    m = model_axis or 1
    if n % m:
        raise ValueError(f"model axis {m} does not divide {n} devices")
    return Mesh(("data", "model"), (n // m, m))
