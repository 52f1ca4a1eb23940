"""Weights in the port's layout, drawn on the device from the seed.

The distributions are those of ``repro_torch``'s ``Model.init_params``,
copied here: every matrix N(0, 1/fan_in) in the served dtype, norms and
biases zero (RMSNorm scales by 1 + w), and for Mamba2 layers the float32
A_log = log(linspace(1, 16, heads)), D = 1 and dt_bias =
softplus^-1(linspace(1e-3, 1e-1, heads)). The draws are not the port's:
all matrices of one fan-in come from one ``normal_`` call into one flat
buffer, and the leaves are views of it, so a 36 GB pair takes a handful of
calls. The same dict goes to the program and, after the program is gone,
is drawn again for the plain reference.

Sizes come from a configuration file's ``port`` entry (the port's
``ModelConfig`` fields), read by :func:`sizes`."""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def sizes(c: dict) -> dict:
    """Derived sizes of one side's ``port`` entry, with the port's
    defaults for fields the entry leaves out."""
    d, H = c["d_model"], c.get("n_heads", 0)
    s = dict(family=c["arch_type"], L=c["n_layers"], d=d, H=H,
             Hkv=c.get("n_kv_heads", 0), hd=c.get("head_dim") or (d // H if H else 0),
             f=c.get("d_ff", 0), V=c["vocab"],
             qk_norm=bool(c.get("qk_norm", False)),
             qkv_bias=bool(c.get("qkv_bias", False)),
             theta=float(c.get("rope_theta", 10000.0)),
             eps=float(c.get("norm_eps", 1e-5)),
             tied=bool(c.get("tie_embeddings", False)),
             dtype=c.get("dtype", "bfloat16"),
             N=c.get("ssm_state", 0), K=c.get("ssm_conv", 4),
             every=c.get("attn_every", 0))
    s["din"] = c.get("ssm_expand", 2) * d
    s["nh"] = s["din"] // c.get("ssm_head_dim", 64)
    s["P"] = c.get("ssm_head_dim", 64)
    s["conv"] = s["din"] + 2 * s["N"]
    every = s["every"] or s["L"]
    s["n_seg"] = s["L"] // every if s["family"] == "hybrid" else 0
    return s


def layout(s: dict) -> dict:
    """The port's parameter tree as leaves ``(shape, init)``: init is
    ``("normal", fan_in)``, ``"zeros"``, or a float32 constant's name."""
    L, d, H, Hkv, hd, f, V = (s["L"], s["d"], s["H"], s["Hkv"], s["hd"],
                              s["f"], s["V"])

    def attn(n):
        lead = (n,) if n else ()
        p = {"wq": (lead + (d, H, hd), ("normal", d)),
             "wk": (lead + (d, Hkv, hd), ("normal", d)),
             "wv": (lead + (d, Hkv, hd), ("normal", d)),
             "wo": (lead + (H, hd, d), ("normal", H * hd))}
        if s["qkv_bias"]:
            p.update(bq=(lead + (H, hd), "zeros"),
                     bk=(lead + (Hkv, hd), "zeros"),
                     bv=(lead + (Hkv, hd), "zeros"))
        if s["qk_norm"]:
            p.update(q_norm=(lead + (hd,), "zeros"),
                     k_norm=(lead + (hd,), "zeros"))
        return p

    def block(n):
        lead = (n,) if n else ()
        return {"ln1": (lead + (d,), "zeros"), "ln2": (lead + (d,), "zeros"),
                "attn": attn(n),
                "mlp": {"w_gate": (lead + (d, f), ("normal", d)),
                        "w_up": (lead + (d, f), ("normal", d)),
                        "w_down": (lead + (f, d), ("normal", f))}}

    tree = {"embed": ((V, d), ("normal", d)), "final_norm": ((d,), "zeros")}
    if s["family"] in ("ssm", "hybrid"):
        din, N, nh, K, cd = s["din"], s["N"], s["nh"], s["K"], s["conv"]
        tree["layers"] = {
            "ln1": ((L, d), "zeros"),
            "ssm": {"in_proj": ((L, d, 2 * din + 2 * N + nh), ("normal", d)),
                    "conv_w": ((L, K, cd), ("normal", K)),
                    "conv_b": ((L, cd), "zeros"),
                    "A_log": ((L, nh), "A_log"), "D": ((L, nh), "D"),
                    "dt_bias": ((L, nh), "dt_bias"),
                    "norm": ((L, din), "zeros"),
                    "out_proj": ((L, din, d), ("normal", din))}}
    else:
        tree["layers"] = block(L)
    if not s["tied"]:
        tree["lm_head"] = ((d, V), ("normal", d))
    if s["family"] == "hybrid":
        tree["shared_attn"] = block(0)
    return tree


def _leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _constant(name: str, shape: tuple, device) -> torch.Tensor:
    L, nh = shape
    f32 = dict(dtype=torch.float32, device=device)
    if name == "A_log":
        row = torch.log(torch.linspace(1.0, 16.0, nh, **f32))
    elif name == "D":
        row = torch.ones(nh, **f32)
    elif name == "dt_bias":
        row = torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh, **f32)))
    else:
        raise ValueError(f"unknown constant {name!r}")
    return row.expand(L, nh).contiguous()


def draw(port: dict, seed: int, device) -> dict:
    """One side's parameters on ``device`` from ``seed``: one flat buffer
    per fan-in, drawn N(0, 1/fan_in) in one call, leaves as its views."""
    s = sizes(port)
    dt = DTYPES[s["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    leaves = list(_leaves(layout(s)))
    out: dict = {}
    by_fan: dict = {}
    for path, (shape, init) in leaves:
        if isinstance(init, tuple):
            by_fan.setdefault(init[1], []).append((path, shape))
        elif init == "zeros":
            _put(out, path, torch.zeros(shape, dtype=dt, device=device))
        else:
            _put(out, path, _constant(init, shape, device))
    for fan in sorted(by_fan):
        group = by_fan[fan]
        flat = torch.empty(sum(math.prod(sh) for _, sh in group), dtype=dt,
                           device=device)
        flat.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)
        off = 0
        for path, shape in group:
            n = math.prod(shape)
            _put(out, path, flat[off:off + n].view(shape))
            off += n
    return out


def side_seeds(seed: int) -> dict:
    """The seeds of the draft's and the target's weights, from the run's."""
    import numpy as np
    ss = np.random.SeedSequence(abs(int(seed)))
    a, b = ss.spawn(2)
    return {"draft": int(a.generate_state(1, np.uint64)[0] >> 1),
            "target": int(b.generate_state(1, np.uint64)[0] >> 1)}
