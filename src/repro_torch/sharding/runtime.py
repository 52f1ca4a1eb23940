"""Activation-sharding hooks, the port of the reference
``repro/sharding/runtime.py``.

The reference's launcher installs sequence-parallel (batch→data,
seq→model), head-parallel (q/k/v heads→model) and vocab-parallel (logits)
constraints that the model applies at every layer boundary; XLA reads
them when it partitions the step. The port's models call the same hooks
at the same points (``models/model.py``, ``models/attention.py``).

Outside the dry-run nothing is installed and each hook returns its tensor
as it came: one check of a module global, no op, no kernel, no host sync,
so the hooks stay out of a captured step's way. Inside the dry-run
(``launch/dryrun.py``) :func:`activation_sharding` installs the specs and
each hook records, for the report, the spec fitted to the activation's
shape (:func:`~.specs.fit_spec`: an axis that does not divide a dim moves,
as the reference's ``_apply`` moves it) — to the global shape: the
dry-run runs one device's batch, and ``batch_scale`` (the data-parallel
replicas) scales the leading dim back up first; the tensor still comes back
unchanged, since an eager PyTorch program on one device has no
partitioner to hand the constraint to.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Optional

import torch

from .specs import NamedSharding, PartitionSpec, fit_spec

_ACTIVATION_SHARDING: Optional[NamedSharding] = None
_QKV_SHARDING: Optional[NamedSharding] = None
_LOGITS_SHARDING: Optional[NamedSharding] = None
_HEAD_IN_SHARDING: Optional[NamedSharding] = None
_RECORD: Optional["ActivationRecord"] = None


@dataclass
class ActivationRecord:
    """What the hooks saw while installed: per hook, the distinct (global
    shape, fitted spec) pairs, and how many calls each had."""
    batch_scale: int = 1
    fitted: dict = field(default_factory=dict)  # (hook, shape, spec) → n

    def add(self, hook: str, shape: tuple, spec: PartitionSpec) -> None:
        key = (hook, shape, spec)
        self.fitted[key] = self.fitted.get(key, 0) + 1

    def axes_used(self, hook: Optional[str] = None) -> set:
        """The mesh axes any fitted spec (of ``hook``) placed."""
        out = set()
        for (h, _, spec), _n in self.fitted.items():
            if hook is not None and h != hook:
                continue
            for ax in spec:
                if ax is not None:
                    out.update((ax,) if isinstance(ax, str) else ax)
        return out

    def rows(self) -> list[dict]:
        return [{"hook": h, "shape": list(shape), "spec": list(spec),
                 "calls": n}
                for (h, shape, spec), n in sorted(
                    self.fitted.items(), key=lambda kv: repr(kv[0]))]


@contextlib.contextmanager
def activation_sharding(sharding, qkv=None, logits=None, head_in=None,
                        batch_scale: int = 1):
    """Install residual (B, S, D), q/k/v (B, T, H, hd) and lm-head
    constraints; yields the :class:`ActivationRecord` the hooks fill
    (``batch_scale``: the global batch over the batch the step runs)."""
    global _ACTIVATION_SHARDING, _QKV_SHARDING, _LOGITS_SHARDING, \
        _HEAD_IN_SHARDING, _RECORD
    prev = (_ACTIVATION_SHARDING, _QKV_SHARDING, _LOGITS_SHARDING,
            _HEAD_IN_SHARDING, _RECORD)
    record = ActivationRecord(batch_scale=int(batch_scale))
    (_ACTIVATION_SHARDING, _QKV_SHARDING, _LOGITS_SHARDING,
     _HEAD_IN_SHARDING, _RECORD) = sharding, qkv, logits, head_in, record
    try:
        yield record
    finally:
        (_ACTIVATION_SHARDING, _QKV_SHARDING, _LOGITS_SHARDING,
         _HEAD_IN_SHARDING, _RECORD) = prev


def _apply(h: torch.Tensor, s: Optional[NamedSharding],
           hook: str) -> torch.Tensor:
    if s is None or len(s.spec) != h.dim():
        return h
    shape = tuple(h.shape)
    if _RECORD is not None:
        shape = (shape[0] * _RECORD.batch_scale,) + shape[1:]
    fitted = fit_spec(s.mesh, s.spec, shape)
    if _RECORD is not None:
        _RECORD.add(hook, shape, fitted)
    return h


def constrain(h: torch.Tensor) -> torch.Tensor:
    """Residual-stream constraint (the sequence-parallel layer carry)."""
    return _apply(h, _ACTIVATION_SHARDING, "residual")


def constrain_qkv(x: torch.Tensor) -> torch.Tensor:
    """Head-parallel constraint on the attention q/k/v projections."""
    return _apply(x, _QKV_SHARDING, "qkv")


def constrain_head_in(h: torch.Tensor) -> torch.Tensor:
    """The hidden states entering the lm head."""
    return _apply(h, _HEAD_IN_SHARDING, "head_in")


def constrain_logits(x: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel logits."""
    return _apply(x, _LOGITS_SHARDING, "logits")
