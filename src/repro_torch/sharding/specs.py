"""Partition specs for the production mesh, the port of the reference
``repro/sharding/specs.py``.

Mesh axes are fixed by the deployment contract (``launch/mesh.py``):
single-pod ``(data=16, model=16)``, multi-pod ``(pod=2, data=16,
model=16)``. Logical→mesh rules, the reference's:

- batch            → (pod, data)
- vocab/heads/ffn/experts/ssm-heads → model   (tensor/expert parallel)
- d_model (weights)→ data  (ZeRO-3/FSDP: 2-D weight sharding)
- KV-cache: batch→(pod,data), kv_heads→model. When the global batch cannot
  cover the data axis (long_500k, batch=1) the cache *sequence* dim shards
  over data instead (context parallelism).
- a dim an axis does not divide gets the axis relocated by
  :func:`fit_spec` (40 heads / 16 → head_dim; 8 kv heads / 16 → head_dim).

The rules key on parameter path suffixes. The port's parameter dict keeps
the reference's names and layout (``layers/attn/wq`` is (L, D, H, hd)), so
one table serves both packages and the fitted specs are equal as tuples.
Caches and the train state are walked under the reference's leaf paths
(:func:`named_leaves`): an :class:`AttnCache`'s ``k``/``v``/``pos_map``
are its views without the sink row, which each device keeps one of
(:func:`leaf_shard_bytes`).

A spec here is a :class:`PartitionSpec`, one entry per leading dim: an
axis name, a tuple of names, or None. Nothing in this module touches a
device; the dry-run (``launch/dryrun.py``) turns a leaf's shape and spec
into its per-device bytes with :func:`shard_bytes`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator, Optional

import torch

from ..configs.base import ModelConfig
from ..launch.mesh import Mesh


class PartitionSpec(tuple):
    """A tuple of per-dim mesh axes (name, tuple of names, or None); dims
    past its length are unsharded. ``PartitionSpec("data", None) ==
    ("data", None)``: specs compare as tuples."""

    def __new__(cls, *entries):
        for e in entries:
            if not (e is None or isinstance(e, str) or (
                    isinstance(e, tuple)
                    and all(isinstance(a, str) for a in e))):
                raise TypeError(f"a spec entry is an axis name, a tuple of "
                                f"names or None, not {e!r}")
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's ``jax.sharding.
    NamedSharding``): what the runtime hooks are given."""
    mesh: Mesh
    spec: PartitionSpec


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...]) -> Mesh:
    """The reference's helper of the same name: a mesh of names and sizes
    with no devices behind it."""
    return Mesh(tuple(axis_names), tuple(int(s) for s in axis_sizes))


def _axis_size_of(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return int(mesh.shape[axes])
    return math.prod(mesh.shape[a] for a in axes)


def fit_spec(mesh: Mesh, spec: PartitionSpec,
             shape: tuple[int, ...]) -> PartitionSpec:
    """Repair a preferred spec against a concrete shape.

    For every dim whose assigned axis doesn't divide it, the axis is
    *relocated* to the largest currently-unsharded dim it does divide
    (qwen3's 40 heads can't shard over model=16, so 'model' moves to
    head_dim=128; whisper's odd 51865-vocab drops the vocab sharding
    entirely). Tuple axes degrade to the largest dividing sub-axis before
    relocating. Trailing unsharded dims are dropped."""
    out: list = list(spec) + [None] * (len(shape) - len(spec))
    orphans: list = []
    for i, ax in enumerate(out):
        if ax is None:
            continue
        if shape[i] % _axis_size_of(mesh, ax) == 0:
            continue
        placed = False
        if isinstance(ax, tuple):
            for sub in sorted(ax, key=lambda a: -mesh.shape[a]):
                if shape[i] % mesh.shape[sub] == 0:
                    out[i] = sub
                    orphans.extend(a for a in ax if a != sub)
                    placed = True
                    break
        if not placed:
            orphans.extend([ax] if isinstance(ax, str) else list(ax))
            out[i] = None
    for ax in orphans:
        size = _axis_size_of(mesh, ax)
        cands = sorted((j for j in range(len(shape))
                        if out[j] is None and shape[j] % size == 0
                        and shape[j] >= size),
                       key=lambda j: -shape[j])
        if cands:
            out[cands[0]] = ax
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def shard_shape(mesh: Mesh, spec: PartitionSpec,
                shape: tuple[int, ...]) -> tuple[int, ...]:
    """The per-device block of a ``shape`` laid out by a fitted ``spec``
    (every axis it names divides its dim)."""
    out = list(shape)
    for i, ax in enumerate(spec):
        n = _axis_size_of(mesh, ax)
        if out[i] % n:
            raise ValueError(f"axis {ax!r} of size {n} does not divide dim "
                             f"{i} of {tuple(shape)}: fit the spec first")
        out[i] //= n
    return tuple(out)


def shard_bytes(mesh: Mesh, spec: PartitionSpec, shape: tuple[int, ...],
                dtype: torch.dtype) -> int:
    """Bytes of one device's block of a leaf."""
    return math.prod(shard_shape(mesh, spec, shape)) * dtype.itemsize


# --------------------------------------------------------------------------
# leaves under the reference's paths
# --------------------------------------------------------------------------

def named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of a parameter dict, a cache or a train state, under
    the reference pytree's paths: dicts by sorted key, NamedTuples by
    field, the cache dataclasses by the reference's fields (``k``, ``v``,
    ``pos_map``, ``ring`` of an AttnCache are its public views and flag).
    Leaves are tensors, Python scalars (a TrainState's step) or bools."""
    from ..models.kvcache import (AttnCache, EncDecCache, HybridCacheT,
                                  SSMCache)
    join = (lambda k: f"{prefix}/{k}") if prefix else (lambda k: str(k))
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], join(k))
    elif isinstance(tree, AttnCache):
        yield join("k"), tree.k
        yield join("v"), tree.v
        yield join("pos_map"), tree.pos_map
        yield join("ring"), tree.ring
    elif isinstance(tree, SSMCache):
        yield join("conv"), tree.conv
        yield join("state"), tree.state
    elif isinstance(tree, HybridCacheT):
        yield from named_leaves(tree.ssm, join("ssm"))
        yield from named_leaves(tree.shared_attn, join("shared_attn"))
    elif isinstance(tree, EncDecCache):
        yield from named_leaves(tree.self_attn, join("self_attn"))
        yield join("cross_k"), tree.cross_k
        yield join("cross_v"), tree.cross_v
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from named_leaves(getattr(tree, name), join(name))
    else:
        yield prefix, tree


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else 0


# leaves of a dense cache whose buffer holds one sink row past the batch
# (axis 1, models/kvcache.py)
SINK_LEAVES = ("k", "v", "pos_map")


def leaf_shard_bytes(mesh: Mesh, leaf: Any, spec: PartitionSpec,
                     sink: bool = False) -> int:
    """Per-device bytes of one leaf: its block under ``spec``; with
    ``sink`` (a dense cache's k/v/pos_map) the device's own sink row on
    top, one more row of the batch axis. Python scalars and flags hold no
    device memory."""
    if not isinstance(leaf, torch.Tensor):
        return 0
    shape = shard_shape(mesh, spec, tuple(leaf.shape))
    if sink:
        shape = (shape[0], shape[1] + 1) + shape[2:]
    return math.prod(shape) * leaf.dtype.itemsize


def cache_shard_bytes(mesh: Mesh, cache: Any,
                      specs: dict[str, PartitionSpec]) -> int:
    """Per-device bytes of a cache laid out by ``specs`` (its
    :meth:`ShardingRules.cache_sharding`), sink rows included."""
    return sum(leaf_shard_bytes(mesh, leaf, specs[path],
                                sink=path.split("/")[-1] in SINK_LEAVES)
               for path, leaf in named_leaves(cache))


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------

class ShardingRules:
    """Per-arch partition-spec factory bound to a mesh (the reference's
    table, rule for rule)."""

    def __init__(self, mesh: Mesh, cfg: ModelConfig,
                 fsdp_over_pod: bool = True):
        self.mesh = mesh
        self.cfg = cfg
        axes = mesh.axis_names
        self.has_pod = "pod" in axes
        self.dp: Any = (("pod", "data") if self.has_pod else "data")
        self.fsdp: Any = (("pod", "data") if (self.has_pod and fsdp_over_pod)
                          else "data")
        self.tp = "model"

    def fit(self, spec: PartitionSpec, shape) -> PartitionSpec:
        return fit_spec(self.mesh, spec, tuple(shape))

    # ---------------------------------------------------------------- params

    def param_spec(self, path: str, ndim: int) -> PartitionSpec:
        """Rules keyed on parameter path suffix. The leading ``layers/``
        stacking axis (or ``encoder/``) is never sharded."""
        fs, tp = self.fsdp, self.tp
        stacked = path.startswith(("layers/", "encoder/"))

        def L(*dims):
            return P(None, *dims) if stacked else P(*dims)

        leaf = path.split("/")[-1]
        if leaf == "embed":
            # vocab unsharded, d_model over every axis: the gather and its
            # scatter gradient stay local
            emb_axes = (("pod", "data", "model") if self.has_pod
                        else ("data", "model"))
            return P(None, emb_axes)               # (V, D)
        if leaf == "lm_head":
            return P(fs, tp)                       # (D, V)
        if leaf in ("final_norm", "enc_norm"):
            return P(None)
        if leaf in ("wq", "wk", "wv"):
            return L(fs, tp, None)                 # (D, H, hd)
        if leaf == "wo":
            return L(tp, None, fs)                 # (H, hd, D)
        if leaf in ("bq", "bk", "bv"):
            return L(tp, None)                     # (H, hd)
        if leaf in ("q_norm", "k_norm"):
            return L(None)
        if leaf in ("ln1", "ln2", "ln_x", "norm"):
            return L(None)
        if leaf in ("w_gate", "w_up"):
            if "moe" in path:
                return L(tp, None, fs)             # (E, D, F)
            return L(fs, tp)                       # (D, F)
        if leaf == "w_down":
            if "moe" in path:
                return L(tp, fs, None)             # (E, F, D)
            return L(tp, fs)                       # (F, D)
        if leaf == "router":
            return L(fs, tp)                       # (D, E)
        if leaf in ("res_gate", "res_up"):
            return L(fs, tp)
        if leaf == "res_down":
            return L(tp, fs)
        if leaf == "in_proj":
            return L(fs, tp)                       # (D, 2din+2N+nh)
        if leaf == "out_proj":
            return L(tp, fs)                       # (din, D)
        if leaf == "conv_w":
            return L(None, tp)                     # (K, C)
        if leaf == "conv_b":
            return L(tp)
        if leaf in ("A_log", "D", "dt_bias"):
            return L(tp)                           # (nh,)
        return P(*([None] * ndim)) if not stacked else P(None)

    def params_sharding(self, params: Any) -> dict[str, PartitionSpec]:
        """{path: fitted spec} over every parameter leaf."""
        return {path: self.fit(self.param_spec(path, leaf.dim()),
                               leaf.shape)
                for path, leaf in named_leaves(params)}

    # ----------------------------------------------------------------- data

    def batch_spec(self, global_batch: int) -> Any:
        """Batch axis factor(s) the global batch can actually cover."""
        if global_batch % self._axis_size(self.dp) == 0:
            return self.dp
        if self.has_pod and global_batch % self.mesh.shape["pod"] == 0:
            return "pod"
        return None

    def _axis_size(self, axes) -> int:
        return _axis_size_of(self.mesh, axes)

    def tokens_sharding(self, global_batch: int) -> PartitionSpec:
        return P(self.batch_spec(global_batch), None)

    def frontend_sharding(self, global_batch: int) -> PartitionSpec:
        return P(self.batch_spec(global_batch), None, None)

    def vector_sharding(self, global_batch: int) -> PartitionSpec:
        """(B,) vectors: tokens/positions during decode."""
        return P(self.batch_spec(global_batch))

    # ---------------------------------------------------------------- caches

    def cache_sharding(self, cache: Any, global_batch: int
                       ) -> dict[str, PartitionSpec]:
        """{path: fitted spec} over a cache's leaves. AttnCache k/v (L, B,
        S, Hkv, hd), pos_map (L, B, S); SSMCache conv (L, B, K−1, C), state
        (L, B, nh, hd, N); nested for hybrid and encdec."""
        bspec = self.batch_spec(global_batch)
        # context parallelism when the batch can't cover the data axis
        seq_axis = "data" if bspec in (None, "pod") else None
        out = {}
        for path, leaf in named_leaves(cache):
            nd, lf = _ndim(leaf), path.split("/")[-1]
            if nd == 0:
                out[path] = P()
                continue
            if lf in ("k", "v", "cross_k", "cross_v") and nd == 5:
                pref = P(None, bspec, seq_axis, self.tp, None)
            elif lf == "pos_map" and nd == 3:
                pref = P(None, bspec, seq_axis)
            elif lf == "conv" and nd == 4:
                pref = P(None, bspec, None, self.tp)
            elif lf == "state" and nd == 5:
                pref = P(None, bspec, self.tp, None, None)
            else:
                pref = P(*([None] * nd))
            out[path] = self.fit(pref, leaf.shape)
        return out

    # ------------------------------------------------------------- trainstate

    def train_state_sharding(self, state: Any,
                             params_sharding: Optional[dict] = None
                             ) -> dict[str, PartitionSpec]:
        """{path: spec} over a TrainState: the moments inherit the
        parameters' specs, the step counters are replicated."""
        ps = params_sharding or self.params_sharding(state.params)
        out = {f"params/{k}": v for k, v in ps.items()}
        out["opt/step"] = P()
        out.update({f"opt/mu/{k}": v for k, v in ps.items()})
        out.update({f"opt/nu/{k}": v for k, v in ps.items()})
        out["step"] = P()
        return out
