"""Memory-fit dry-run on the meta device, the port of the reference
``repro/launch/dryrun.py``.

For every (architecture × input shape × mesh): build the step the shape's
kind selects (the train step, a chunked prefill returning the last
position's logits, or ``decode_step`` at uniform positions), run it on the
meta device at the per-device batch with the activation hooks installed
(``sharding/runtime.py``), and report per-device memory against one H100
and the step's FLOPs. Meta tensors have a shape and a dtype and no
storage: nothing is allocated and nothing is computed, and the kernel
wrappers run their plain versions' ops on them (``kernels/__init__.py``).

Per-device memory, by part (``memory`` in a row; ``exact`` and
``estimated`` name which is which):

- exact: parameters, gradients, optimizer moments and caches, each leaf at
  its fitted shard size under the mesh (``sharding/specs.py``), a dense
  cache's sink row once per device; the step's inputs and outputs at the
  per-device batch;
- estimated: activations — the meta run's peak of live bytes allocated
  inside the step (a storage counted from the op that makes it until it
  is freed, rounded up to the caching allocator's 512-byte blocks), less
  the gradients, outputs and the prefill's own cache it holds at full
  size, divided by the ``model`` axis when a hook fitted a sequence- or
  head-parallel spec that placed it.

``argument_bytes`` is parameters (+ moments) + the decode cache + inputs,
``output_bytes`` the outputs (+ the prefill's cache), ``temp_bytes``
gradients + activations, and ``peak_estimate_bytes`` their sum; ``fits``
holds it to one card's memory: 80 GiB on the meta device (an "NVIDIA H100
80GB HBM3"), ``torch.cuda.get_device_properties(0).total_memory`` on the
card. ``flops_per_device`` is the step's FLOPs over the global batch
(the meta run at the per-device batch counted with
``torch.utils.flop_counter``'s formulas, the ones ``FlopCounterMode``
applies, times the data-parallel replicas) spread evenly over the mesh's
devices.

``collectives`` is null: the reference parses XLA's partitioned HLO for
them, and an eager PyTorch program on one card has no partitioned program
to read. The reference's ``lower_s``/``compile_s`` become ``trace_s``, the
seconds of the meta run.

With ``device="cuda"`` (:func:`run_one`) the same step also runs for real
on the card at the ``host`` mesh, and the row carries the measured
``torch.cuda.max_memory_allocated()`` beside the estimate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch all --shape all --mesh single,multi [--out rows.jsonl]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import weakref
from typing import Any, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import ASSIGNED, get_config
from ..configs.base import ModelConfig
from ..models.model import build_model
from ..sharding.runtime import activation_sharding
from ..sharding.specs import (NamedSharding, PartitionSpec as P,
                              ShardingRules, cache_shard_bytes,
                              leaf_shard_bytes, named_leaves)
from ..training.optimizer import AdamWConfig
from ..training.train_step import init_train_state, make_train_step
from .mesh import Mesh, make_host_mesh, make_production_mesh
from .shapes import SHAPES, InputShape, input_specs

H100_BYTES = 80 * 2 ** 30          # "NVIDIA H100 80GB HBM3"
ALLOC_BLOCK = 512                  # the CUDA caching allocator's rounding
PREFILL_CHUNK = 1024
COLLECTIVES_NOTE = ("no partitioned program: the reference parses XLA's "
                    "SPMD-partitioned HLO for collectives; an eager PyTorch "
                    "step on one card has none to read")
MESHES = ("single", "multi", "host")


def make_mesh(kind: str) -> Mesh:
    if kind == "host":
        return make_host_mesh()
    if kind not in MESHES:
        raise ValueError(f"unknown mesh {kind!r}; one of {MESHES}")
    return make_production_mesh(multi_pod=(kind == "multi"))


# --------------------------------------------------------------------------
# live bytes of a step
# --------------------------------------------------------------------------

def _rounded(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


class LiveBytes(TorchDispatchMode):
    """Peak of the bytes held by storages that ops make while the mode is
    on, and the FLOPs of those ops. A storage counts from the op that
    returns it until it is freed (a weak reference's callback; storages
    keep their Python object while they live), rounded up to
    :data:`ALLOC_BLOCK`. Storages that existed before (``static``:
    parameters, moments, caches, inputs) never count, nor do views of them
    or in-place writes to them. FLOPs are ``torch.utils.flop_counter``'s
    formulas (matmuls, convolutions, attention) for the ops that have one,
    counted here rather than under a second dispatch mode. Works on meta
    and on real tensors; autograd's backward runs under it too."""

    def __init__(self, static=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.flops = 0
        self._sizes: dict[int, int] = {}
        self._static = {t.untyped_storage()._cdata for t in static
                        if isinstance(t, torch.Tensor)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in _pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._static or key in self._sizes:
            return
        n = _rounded(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)


def _tensors(*trees) -> list[torch.Tensor]:
    return [leaf for tree in trees for _, leaf in named_leaves(tree)
            if isinstance(leaf, torch.Tensor)]


def _full_bytes(*trees) -> int:
    """Bytes of every tensor of the trees at full size, rounded per
    storage as the tracker counts them (a dense cache's buffers once,
    with their sink row)."""
    seen, total = set(), 0
    for t in _tensors(*trees):
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += _rounded(st.nbytes())
    return total


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------

def _opt_cfg(cfg: ModelConfig) -> AdamWConfig:
    # bf16 moments for the ≥200B-param archs (the reference's rule)
    big = cfg.param_count() > 2e11
    return AdamWConfig(lr=1e-4, state_dtype=torch.bfloat16 if big else None)


def micro_steps(B: int, dp: int, tokens_per_row: int) -> int:
    """The reference's gradient-accumulation rule: bound the live tokens
    per device near 16k, with equal micro-batches the data axis divides."""
    per_dev_tokens = B // max(1, dp) * tokens_per_row
    micro = max(1, per_dev_tokens // 16384)
    while B % micro or (B // micro) % max(1, dp):
        micro -= 1
    return micro


class Step:
    """One (arch, shape, mesh) step ready to run on ``device``: ``fn()``
    runs it; the rest is what the memory accounting needs."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                 device: Union[str, torch.device] = "meta",
                 prefill_chunks: Optional[int] = None,
                 trace_micro: Optional[int] = None):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.prefill_chunks = prefill_chunks
        self.trace_micro = trace_micro
        self.flops_scale = 1.0
        self.device = torch.device(device)
        self.rules = rules = ShardingRules(mesh, cfg)
        B = shape.global_batch
        bspec = rules.batch_spec(B)
        self.dp = rules._axis_size(bspec) if bspec is not None else 1
        self.b_dev = B // self.dp
        model = build_model(cfg, self.device)
        self.spec = spec = input_specs(cfg, shape, model)
        self.micro = 1
        meta_model = build_model(cfg, "meta")
        self.hooks: dict = {}
        act = NamedSharding(mesh, P(bspec, "model", None))
        qkv = NamedSharding(mesh, P(bspec, None, "model", None))
        logits = NamedSharding(mesh, P(bspec, None, "model"))
        kind = spec["kind"]
        if kind == "train":
            self._build_train(model, meta_model, spec, B, act, qkv, logits)
        elif kind == "prefill":
            self._build_prefill(model, meta_model, spec, B, act, qkv)
        else:
            self._build_decode(model, meta_model, spec, B)

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """One device's rows of a global-batch input, on the step's
        device."""
        shape = (self.b_dev,) + tuple(t.shape[1:])
        return torch.zeros(shape, dtype=t.dtype, device=self.device)

    def _params_bytes(self, meta_params) -> int:
        """Per-device bytes of the parameters at their fitted specs."""
        specs = self.rules.params_sharding(meta_params)
        return sum(leaf_shard_bytes(self.mesh, leaf, specs[path])
                   for path, leaf in named_leaves(meta_params))

    def _build_train(self, model, meta_model, spec, B, act, qkv, logits):
        cfg, rules = self.cfg, self.rules
        opt_cfg = _opt_cfg(cfg)
        self.micro = micro_steps(B, self.dp, spec["tokens"].shape[1])
        # ``trace_micro``: run that many of the micro-steps (each the same
        # ops on the same shapes; the FLOPs scale by micro / run; the
        # optimizer's elementwise update has no FLOP formula)
        run = self.micro if self.trace_micro is None \
            else min(self.micro, self.trace_micro)
        self.flops_scale = self.micro / run
        step = make_train_step(model, opt_cfg, micro_steps=run)
        state = init_train_state(model, 0, opt_cfg)
        full = {k: self._local(spec[k])
                for k in ("tokens", "labels", "frontend") if k in spec}
        rows = self.b_dev // self.micro * run
        batch = {k: v[:rows] for k, v in full.items()}
        meta_state = init_train_state(meta_model, 0, opt_cfg)
        st_specs = rules.train_state_sharding(meta_state)
        self.argument_exact = sum(
            leaf_shard_bytes(self.mesh, leaf, st_specs[path])
            for path, leaf in named_leaves(meta_state)) + _full_bytes(full)
        # the train step holds one gradient per leaf, two while it
        # accumulates micro-steps (the running sum and the micro-step's)
        copies = 2 if self.micro > 1 else 1
        self.grad_exact = copies * self._params_bytes(meta_state.params)
        self.inside_full = copies * _full_bytes(meta_state.params)
        self.output_exact = 0
        self.static = _tensors(state, batch)
        self.hooks = dict(sharding=act, qkv=qkv, logits=logits)
        self.tokens = B * spec["tokens"].shape[1]
        self.model_flops = 6.0 * cfg.active_param_count() * self.tokens
        self.fn = lambda: step(state, batch)[1]["loss"]

    def _build_prefill(self, model, meta_model, spec, B, act, qkv):
        cfg, rules = self.cfg, self.rules
        slots = spec["slots"]
        params = model.init_params(0)
        tokens = self._local(spec["tokens"])
        frontend = self._local(spec["frontend"]) if "frontend" in spec \
            else None
        inputs = {"tokens": tokens, "frontend": frontend}
        enc = cfg.n_frontend_tokens if cfg.arch_type == "encdec" else 0
        self.argument_exact = self._params_bytes(meta_model.init_params(0)) \
            + _full_bytes(inputs)
        # the cache the prefill builds is an output: exact at its shard
        # size, and held at full size inside the meta run
        cache_g = meta_model.init_cache(B, slots, enc_frames=enc)
        cache_l = meta_model.init_cache(self.b_dev, slots, enc_frames=enc)
        V = cfg.vocab
        logits_bytes = _rounded(self.b_dev * V * 4)
        self.output_exact = cache_shard_bytes(
            self.mesh, cache_g, rules.cache_sharding(cache_g, B)) \
            + logits_bytes
        self.grad_exact = 0
        self.inside_full = _full_bytes(cache_l) + logits_bytes
        self.static = _tensors(params, inputs)
        self.hooks = dict(sharding=act, qkv=qkv)
        self.tokens = B * self.shape.seq_len
        self.model_flops = 2.0 * cfg.active_param_count() * self.tokens

        # the first ``prefill_chunks`` windows of the prompt into the full
        # cache (None: all of them)
        run = tokens if self.prefill_chunks is None \
            else tokens[:, :self.prefill_chunks * PREFILL_CHUNK]

        def fn():
            logits, _ = model.prefill(params, run, slots, frontend=frontend,
                                      chunk=PREFILL_CHUNK)
            return logits[:, -1, :]
        self.fn = fn

    def _build_decode(self, model, meta_model, spec, B):
        cfg, rules = self.cfg, self.rules
        params = model.init_params(0)
        cache_g = spec["cache"]
        enc = cfg.n_frontend_tokens if cfg.arch_type == "encdec" else 0
        slots = self.shape.seq_len if not spec["ring"] \
            else cfg.serve_sliding_window
        cache = model.init_cache(self.b_dev, slots, ring=spec["ring"],
                                 enc_frames=enc)
        token = self._local(spec["token"])
        # production waves are position-aligned: every row at one position
        # (the reference's uniform_pos; the port's scatter write is the
        # same op for any positions)
        pos = torch.full((self.b_dev,), slots - 1 if not spec["ring"]
                         else self.shape.seq_len - 1, dtype=torch.int32,
                         device=self.device)
        inputs = {"token": token, "pos": pos}
        self.argument_exact = self._params_bytes(meta_model.init_params(0)) \
            + cache_shard_bytes(self.mesh, cache_g,
                                rules.cache_sharding(cache_g, B)) \
            + _full_bytes(inputs)
        logits_bytes = _rounded(self.b_dev * cfg.vocab * 4)
        self.output_exact = logits_bytes
        self.grad_exact = 0
        self.inside_full = logits_bytes
        self.static = _tensors(params, cache, inputs)
        self.tokens = B
        self.model_flops = 2.0 * cfg.active_param_count() * self.tokens
        window = spec["window"]

        def fn():
            return model.decode_step(params, token, cache, pos,
                                     window=window)[0]
        self.fn = fn


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

def _resolve_shape(shape: Union[str, InputShape]) -> InputShape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _trace_once(step: Step) -> dict:
    """Run the step once on its device with the hooks installed, under the
    live-bytes tracker: its FLOPs, the activation bytes it held at its
    peak (the tracker's peak less what it held of gradients, outputs and a
    prefill's cache) and the hooks' record."""
    grad = torch.enable_grad() if step.spec["kind"] == "train" \
        else torch.no_grad()
    with activation_sharding(step.hooks.get("sharding"),
                             qkv=step.hooks.get("qkv"),
                             logits=step.hooks.get("logits"),
                             batch_scale=step.dp) as record, \
            grad, LiveBytes(static=step.static) as live:
        out = step.fn()
        del out
    return {"flops": live.flops,
            "activations": max(0, live.peak - step.inside_full),
            "peak": live.peak, "record": record}


def depth_plan(cfg: ModelConfig):
    """(configs to trace, their depth features, the full config's
    features): FLOPs and activation bytes are linear in the features,
    since every layer of a stack runs the same ops on the same shapes, so
    the full depth is the combination of the traced ones that matches its
    features. Features are (1, layers); for a hybrid (1, layers,
    shared-block calls), traced at attn_every 1 and 2; for an
    encoder-decoder (1, decoder layers, encoder layers). A stack of at most
    two layers is traced as it is."""
    import dataclasses
    rep = dataclasses.replace
    if cfg.arch_type == "hybrid":
        pts = ((1, 1), (2, 1), (2, 2))          # (layers, attn_every)
        every = cfg.attn_every or cfg.n_layers
        return ([rep(cfg, n_layers=n, attn_every=e) for n, e in pts],
                [(1, n, n // e) for n, e in pts],
                (1, cfg.n_layers, cfg.n_layers // every))
    if cfg.arch_type == "encdec":
        pts = ((1, 1), (2, 1), (1, 2))          # (layers, encoder layers)
        return ([rep(cfg, n_layers=n, encoder_layers=e) for n, e in pts],
                [(1, n, e) for n, e in pts],
                (1, cfg.n_layers, cfg.encoder_layers))
    if cfg.n_layers <= 2:
        return [cfg], [(1, cfg.n_layers)], (1, cfg.n_layers)
    return ([rep(cfg, n_layers=n) for n in (1, 2)],
            [(1, 1), (1, 2)], (1, cfg.n_layers))


def _combine(feats, target) -> list[float]:
    """Weights w with Σ w_i·feats_i = target (one solution of a square
    system, or 1 for a single point)."""
    import numpy as np
    if len(feats) == 1:
        return [1.0]
    return list(np.linalg.solve(np.array(feats, dtype=np.float64).T,
                                np.array(target, dtype=np.float64)))


def _trace_depth(cfg: ModelConfig, step: Step) -> dict:
    """One depth's trace. A chunked prefill of n windows runs one window
    and two, into the full cache: every window runs the same ops on the
    same shapes (the plain attention reads every slot), so the n-window
    FLOPs are f₁ + (n − 1)(f₂ − f₁) and its activations those of either.
    A train step of m > 2 micro-steps runs two (the same ops on the same
    shapes each, the running gradient sum held as in the full step) and
    its FLOPs scale by m / 2."""
    S = step.shape.seq_len
    n = S // PREFILL_CHUNK
    if step.spec["kind"] == "train":
        short = Step(cfg, step.shape, step.mesh, "meta", trace_micro=2)
        out = _trace_once(short)
        out["flops"] *= short.flops_scale
        return out
    if step.spec["kind"] != "prefill" or S % PREFILL_CHUNK or n <= 2:
        return _trace_once(Step(cfg, step.shape, step.mesh, "meta"))
    one, two = (_trace_once(Step(cfg, step.shape, step.mesh, "meta",
                                 prefill_chunks=k)) for k in (1, 2))
    return {"flops": one["flops"] + (n - 1) * (two["flops"] - one["flops"]),
            "activations": max(one["activations"], two["activations"]),
            "record": two["record"]}


def _trace(step: Step) -> dict:
    """The full step's FLOPs and activation bytes from traces of
    :func:`depth_plan`'s shallow steps (one trace when the stack is
    shallow)."""
    t0 = time.perf_counter()
    cfgs, feats, target = depth_plan(step.cfg)
    traces = [_trace_depth(c, step) for c in cfgs]
    w = _combine(feats, target)
    return {"seconds": time.perf_counter() - t0,
            "flops": max(0.0, sum(wi * t["flops"]
                                  for wi, t in zip(w, traces))),
            "activations": max(0, int(sum(wi * t["activations"]
                                          for wi, t in zip(w, traces)))),
            "traced_depths": [c.n_layers for c in cfgs],
            "record": traces[-1]["record"]}


def estimate(step: Step, trace: dict) -> dict:
    """The per-device memory row of a traced step (module docstring)."""
    record = trace["record"]
    model_axis = step.mesh.shape.get("model", 1)
    parallel = "model" in record.axes_used("residual") | \
        record.axes_used("qkv")
    div = model_axis if parallel else 1
    activations = trace["activations"] // div
    temp = step.grad_exact + activations
    peak = step.argument_exact + step.output_exact + temp
    return {"argument_bytes": int(step.argument_exact),
            "output_bytes": int(step.output_exact),
            "temp_bytes": int(temp),
            "peak_estimate_bytes": int(peak),
            "gradient_bytes": int(step.grad_exact),
            "activation_bytes": int(activations),
            "activation_divisor": div,
            "exact": ["parameters", "moments", "gradients", "caches",
                      "inputs", "outputs"],
            "estimated": ["activations"]}


def run_one(arch: str, shape: Union[str, InputShape], mesh_kind: str,
            device: str = "meta") -> dict[str, Any]:
    """One row. ``device="meta"``: the estimate alone. ``device="cuda"``
    (mesh ``host``): the estimate from a meta run, then the same step run
    for real on the card, its ``max_memory_allocated`` from an empty
    allocator beside the estimate (``measured_peak_bytes``,
    ``estimate_ratio``). Any error is recorded in the row (``ok`` false);
    nothing else is swallowed."""
    shape = _resolve_shape(shape)
    mesh = make_mesh(mesh_kind)
    row: dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": mesh_kind, "devices": mesh.size,
                           "ok": False}
    try:
        cfg = get_config(arch)
        step = Step(cfg, shape, mesh, "meta")
        trace = _trace(step)
        memory = estimate(step, trace)
        capacity = H100_BYTES
        if device != "meta":
            capacity = torch.cuda.get_device_properties(0).total_memory
        row.update(
            ok=True,
            trace_s=round(trace["seconds"], 3),
            tokens=step.tokens,
            model_flops=step.model_flops,
            micro_steps=step.micro,
            per_device_batch=step.b_dev,
            flops_per_device=float(trace["flops"]) * step.dp / mesh.size,
            meta_flops=float(trace["flops"]),
            traced_depths=trace["traced_depths"],
            collectives=None,
            collectives_note=COLLECTIVES_NOTE,
            activation_specs=trace["record"].rows(),
            memory=memory,
            device_memory_bytes=int(capacity),
            fits=memory["peak_estimate_bytes"] <= capacity)
        del step, trace
        if device != "meta":
            row.update(_run_on_card(cfg, shape, mesh, device))
            row["estimate_ratio"] = (memory["peak_estimate_bytes"]
                                     / row["measured_peak_bytes"])
    except Exception as e:  # a failure here is a bug in the system
        row["ok"] = False
        row["error"] = f"{type(e).__name__}: {e}"[:2000]
    return row


def _run_on_card(cfg: ModelConfig, shape: InputShape, mesh: Mesh,
                 device: str) -> dict:
    """The step for real: weights, state, caches and inputs allocated from
    an empty allocator, one run, the allocator's peak."""
    dev = torch.device(device)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step = Step(cfg, shape, mesh, dev)
    grad = torch.enable_grad() if step.spec["kind"] == "train" \
        else torch.no_grad()
    with grad:
        out = step.fn()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    finite = bool(torch.isfinite(out.float()).all())
    del out, step
    torch.cuda.empty_cache()
    return {"measured_peak_bytes": int(peak), "run_s": round(seconds, 3),
            "finite": finite}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="all",
                    help="comma list or 'all' (assigned archs)")
    ap.add_argument("--shape", default="all",
                    help=f"comma list or 'all' ({','.join(SHAPES)})")
    ap.add_argument("--mesh", default="single,multi",
                    help=f"comma list of {','.join(MESHES)}")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = args.mesh.split(",")

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                row = run_one(arch, shape, mesh_kind)
                failures += not row["ok"]
                if not args.quiet:
                    print(format_row(row), flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    return 1 if failures else 0


def format_row(row: dict) -> str:
    head = f"{row['arch']:28s} {row['shape']:12s} {row['mesh']:6s}"
    if not row["ok"]:
        return f"[FAIL] {head} {row['error'][:160]}"
    m = row["memory"]
    return (f"[OK]   {head} trace={row['trace_s']:6.2f}s "
            f"peak/dev={m['peak_estimate_bytes'] / 2**30:7.2f}GiB "
            f"fits={row['fits']} micro={row['micro_steps']} "
            f"flops/dev={row['flops_per_device']:.3e} collectives=null")


if __name__ == "__main__":
    sys.exit(main())
