"""Worker hosts: one draft or target process per node (the port of the
reference ``repro/distributed/host.py``).

``python -m repro_torch.distributed.host --role {draft,target} --topology
cluster.json --pair pair0 [--device cpu]`` runs ONE side of a draft–target
pair in its own OS process with its own device context (the card unless
``--device cpu``): the paper's Fig. 1b deployment with a real process
boundary. The two sides connect over the two TCP streams of a
:class:`~repro_torch.distributed.SocketTransport` (windows one way,
verdicts the other, control frames on both) and exchange exactly the bytes
:mod:`repro_torch.distributed.wire` frames — the reference's frames, so a
port host and a reference host read each other.

Weights: each host holds ONE model, its own side's, drawn from the
topology's seed with :func:`repro_torch.topology.init_node_params` (the
function :func:`~repro_torch.topology.build_deployment` uses, so a host
builds the weights of the in-process deployment of the same spec);
overridden configs travel as JSON and overridden parameters as an npz of
the port's own tensors (:func:`save_params`), both written by
:func:`spawn_pair`. The session a host runs needs a model on the other side
too (its cache and its prefill at admission); that is :func:`peer_stub`, the
other side's family and vocabulary at one layer of width 64, whose outputs
are never read. So a pair's two hosts hold the pair's weights once, not
twice as the reference's hosts do (each of which builds both models).

Each wave both hosts admit the SAME prompts into one persistent session per
wave geometry (the session's captured insert step; each side prefills its
own model — the admission cost of not shipping KV). The anchor token is
the target's: the target host replies with its anchors and the draft host
takes them (its own prefill computed the stub's). The reference's
anchor-drift check has nothing to compare here: no model exists twice.
Per round the draft host proposes γ_max tokens from its OWN committed
state (:meth:`~repro_torch.core.session.DecodeSession.propose_window`) and
ships the window; the target host verifies and commits on its session (the
output buffers live target-side) and ships the verdict; the draft host
applies the verdict it received (:meth:`~repro_torch.core.session.
DecodeSession.apply_verdict`: ``pos += num_new``, the committed last token,
a recurrent draft re-advanced). Every round program is a captured step of
the host's session on the card.

Steady-state waves (after the first, which builds and captures every step)
run under :func:`~repro_torch.analysis.sanitize.capture_guard`: a host
whose second or later wave captures a graph or builds a new step raises
and exits non-zero instead of silently timing captures. The first wave must admit at least two requests
and run at least two rounds, so that every step is captured in it.

The parent side (:func:`spawn_pair` → :class:`PairHostHandle`) is what
:func:`~repro_torch.topology.build_deployment` uses for ``process: true``
pairs: it builds the kernel library (on the card) before it spawns
anything, launches the two hosts, handshakes their ports over stdout and
drives waves over a framed control connection to the draft host.
Process-backed pairs are greedy, static-window, distributed-mode only
(:func:`validate_process_pair`), as in the reference.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import select
import socket
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..analysis.sanitize import capture_guard
from ..kernels import LAUNCHES
from .socket_transport import (FRAME_CONTROL, SocketTransport, recv_frame,
                               send_frame)
from .transport import CONTROL_PAYLOAD_BYTES
from .wire import TransportProtocolError, WindowMsg

_HELLO = {b"W": "window", b"V": "verdict"}
_READY_TIMEOUT_S = 600.0     # engine build (weights drawn on the device)


# --------------------------------------------------------------------------
# config / param shipping (overrides only; defaults rebuild from the seed)
# --------------------------------------------------------------------------

def save_model_config(cfg, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f)


def load_model_config(path: str):
    from ..configs.base import ModelConfig
    with open(path) as f:
        return ModelConfig(**json.load(f))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, name + "/")
        else:
            yield name, v


def save_params(params: dict, path: str) -> None:
    """A nested dict of port tensors as an npz, one entry per leaf keyed by
    its path (``layers/attn/wq``) and dtype (bfloat16 leaves travel as
    their int16 bits)."""
    out = {}
    for name, t in _leaves(params):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            out[f"{name}:bfloat16"] = t.view(torch.int16).numpy()
        else:
            out[f"{name}:"] = t.numpy()
    np.savez(path, **out)


def load_params(path: str, device) -> dict:
    """:func:`save_params`'s file back as the nested dict, on ``device``."""
    params: dict = {}
    with np.load(path) as z:
        for key in z.files:
            name, _, dt = key.rpartition(":")
            t = torch.from_numpy(np.array(z[key]))
            if dt == "bfloat16":
                t = t.view(torch.bfloat16)
            node = params
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = t.to(device)
    return params


# --------------------------------------------------------------------------
# shared host plumbing
# --------------------------------------------------------------------------

def peer_stub(cfg):
    """The other side of a host's session at the least size a session can
    hold: ``cfg``'s family (it decides the pair's step: fused or split),
    vocabulary and dtype, one layer (a hybrid: one segment) of width 64
    (one attention head of 64, a head size the attention kernels take).
    Its caches and prefill run; nothing it computes is read."""
    kw = dict(name=f"{cfg.name}-peer-stub", d_model=64, d_ff=128, n_heads=1,
              n_kv_heads=1, head_dim=64, n_layers=1)
    if cfg.arch_type in ("ssm", "hybrid"):
        kw.update(ssm_head_dim=16, ssm_state=16, ssm_chunk=16)
    if cfg.arch_type == "hybrid":
        kw.update(n_layers=2, attn_every=2)
    return dataclasses.replace(cfg, **kw)


def _parse_kv(entries) -> dict:
    out = {}
    for e in entries or []:
        k, _, v = e.partition("=")
        if not k or not v:
            raise SystemExit(f"expected NAME=PATH, got {e!r}")
        out[k] = v
    return out


class _HostContext:
    """Everything one host process shares across waves: the resolved
    spec/pair, the engine (whose pools keep each wave geometry's captured
    steps), and the geometries already served."""

    def __init__(self, args):
        from ..kernels import resolve_device
        from ..topology import ClusterSpec, TopologyError
        self.args = args
        self.spec = ClusterSpec.load(args.topology).validate()
        for p in self.spec.pairs:
            if p.id == args.pair:
                self.pair = p
                break
        else:
            raise TopologyError(f"unknown pair id {args.pair!r}")
        validate_process_pair(self.spec, self.pair)
        self.device = resolve_device(args.device)
        self.model_configs = {
            name: load_model_config(path)
            for name, path in _parse_kv(args.model_config).items()}
        self.node_param_paths = _parse_kv(args.node_params)
        self.role = args.role
        self.node = self.spec.node(self.pair.draft if self.role == "draft"
                                   else self.pair.target)
        self.engine = None
        self.wave_index = 0
        self._warm: set = set()          # wave geometries served before
        # the host's rounds and accept counts over every wave so far (each
        # wave's session counts its own)
        self.served = {"iterations": 0, "proposed": 0, "accepted": 0}

    def build_engine(self):
        """The pair's engine: this host's node by
        :func:`~repro_torch.topology.build_deployment`'s construction rule,
        the other side a :func:`peer_stub` with weights from a fixed
        seed."""
        from ..core.engine import SpecDecodeEngine
        from ..models.model import build_model
        from ..topology import init_node_params, node_configs
        spec, s, pair = self.spec, self.spec.serving, self.pair
        configs = node_configs(spec, self.model_configs,
                               reduced=not self.args.full_size)
        cfg = {"draft": configs[pair.draft], "target": configs[pair.target]}
        params = {}
        for role, nid in (("draft", pair.draft), ("target", pair.target)):
            if role != self.role:
                cfg[role] = peer_stub(cfg[role])
                params[role] = build_model(cfg[role], self.device
                                           ).init_params(0)
            elif nid in self.node_param_paths:
                params[role] = load_params(self.node_param_paths[nid],
                                           self.device)
            else:
                params[role] = init_node_params(spec, nid, cfg[role],
                                                self.device)
        self.engine = SpecDecodeEngine(
            cfg["draft"], cfg["target"], draft_params=params["draft"],
            target_params=params["target"], temperature=s.temperature,
            rtt_ms=s.rtt_ms, gamma_max=s.gamma_max, sync_every=s.sync_every,
            device=self.device)
        return self.engine

    def wave_session(self, capacity: int, max_new_cap: int, pad_len: int):
        """One wave's session, closed by the caller at the wave's end:
        waves admit through the captured insert of the engine's pool of
        their geometry, so after a geometry's first wave they only
        replay. Returns (session, guard): :func:`capture_guard` for a
        geometry served before, none for its first wave, which builds and
        captures every step."""
        from ..core.session import DecodeSession
        s = self.spec.serving
        sess = DecodeSession(self.engine, capacity=capacity,
                             max_new_cap=max_new_cap, max_prompt_len=pad_len,
                             gamma_max=s.gamma_max, sync_every=s.sync_every,
                             eos_id=s.eos_id, log_gamma=False,
                             mode_policy="distributed")
        geom = (capacity, max_new_cap, pad_len)
        if geom not in self._warm:
            self._warm.add(geom)
            return sess, contextlib.nullcontext()
        return sess, capture_guard(
            self.engine,
            f"{self.role} host steady-state wave {self.wave_index}")


def validate_process_pair(spec, pair) -> None:
    """The restrictions a pair must satisfy before a process boundary can
    split it (raises :class:`repro_torch.topology.TopologyError`)."""
    from ..topology import TopologyError
    if spec.serving.temperature > 0.0:
        raise TopologyError(
            f"pair {pair.id!r}: process-backed pairs are greedy-only "
            "(temperature 0) — q_probs never crosses the byte seam")
    if pair.mode_policy != "distributed":
        raise TopologyError(
            f"pair {pair.id!r}: process-backed pairs need "
            f"mode_policy='distributed' (got {pair.mode_policy!r}); "
            "fused flushes and pipelined rollback are not split yet")
    if pair.window.kind != "static":
        raise TopologyError(
            f"pair {pair.id!r}: process-backed pairs need a static window "
            f"policy (got {pair.window.kind!r}); feature-driven policies "
            "would need feature mirroring across the boundary")


def _admit_wave(sess, prompts, lens, max_new, request_ids) -> None:
    """Admit one wave slot by slot; free slots are taken in ascending
    order, so slot i holds request i on both hosts."""
    ids = request_ids if request_ids is not None else list(range(len(lens)))
    for i in range(prompts.shape[0]):
        sess.admit(prompts[i, :int(lens[i])], int(max_new[i]),
                   request_id=int(ids[i]))


def _retire_wave(sess) -> None:
    for j in list(sess.occupied):
        sess.retire(j)


def _log(role: str, msg: str) -> None:
    print(msg, flush=True)
    print(f"[{role}-host] {msg}", file=sys.stderr, flush=True)


def _link(ctx):
    link = ctx.pair.link
    return link if (link is not None and link.rtt_ms > 0) else None


# --------------------------------------------------------------------------
# target host
# --------------------------------------------------------------------------

def run_target(args) -> int:
    """Accept the two streams, build the engine, then serve verify/commit
    rounds and control commands until ``shutdown``."""
    ctx = _HostContext(args)
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    port = (ctx.node.port or 0) if args.listen_port is None \
        else args.listen_port
    lst.bind((args.bind_host, port))
    lst.listen(2)
    _log("target", f"listening port={lst.getsockname()[1]}")
    lst.settimeout(args.timeout_s)
    streams = {}
    for _ in range(2):
        conn, _addr = lst.accept()
        conn.settimeout(args.timeout_s)
        hello = conn.recv(1)
        tag = _HELLO.get(hello)
        if tag is None or tag in streams:
            raise TransportProtocolError(f"bad stream hello {hello!r}")
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        streams[tag] = conn
    lst.close()
    ep = SocketTransport.target_endpoint(
        streams["window"], streams["verdict"], link=_link(ctx),
        seed=ctx.spec.seed, timeout_s=args.timeout_s)
    ctx.build_engine()
    _log("target", "ready")

    sess = None
    guard = contextlib.nullcontext()
    r_in_chunk = 0
    chunk_gammas: list[int] = []
    chunk_t0 = time.perf_counter()

    def flush_attribution():
        nonlocal r_in_chunk, chunk_gammas, chunk_t0
        if sess is not None and r_in_chunk:
            sess._sync_and_attribute(r_in_chunk, chunk_gammas, chunk_t0)
        r_in_chunk, chunk_gammas = 0, []
        chunk_t0 = time.perf_counter()

    while True:
        item, _w = ep.recv_window()
        if isinstance(item, dict):
            cmd = item.get("cmd")
            if cmd == "admit":
                prompts = np.asarray(item["prompts"], np.int32)
                sess, guard = ctx.wave_session(prompts.shape[0],
                                               int(item["max_new_cap"]),
                                               prompts.shape[1])
                guard.__enter__()
                _admit_wave(sess, prompts,
                            np.asarray(item["prompt_lens"], np.int32),
                            np.asarray(item["max_new"], np.int32),
                            item.get("request_ids"))
                r_in_chunk, chunk_gammas = 0, []
                chunk_t0 = time.perf_counter()
                anchors = sess._state.last_token.cpu().numpy()
                ep._post("verdict", {"cmd": "admitted",
                                     "last_token": anchors.tolist()},
                         CONTROL_PAYLOAD_BYTES)
            elif cmd == "fetch":
                flush_attribution()
                tokens, stats = sess.snapshot()
                for k in ctx.served:
                    ctx.served[k] += getattr(sess, k)
                guard.__exit__(None, None, None)
                guard = contextlib.nullcontext()
                ep._post("verdict", {
                    "cmd": "tokens",
                    "tokens": tokens.tolist(),
                    "produced": np.asarray(stats.produced).tolist(),
                    "acceptance_seqs": [list(map(int, b))
                                        for b in stats.acceptance_seqs],
                    "stats": {**ctx.served,
                              "prefill_s": sess.prefill_s,
                              "captured_graphs": ctx.engine.graphs.captured,
                              "graph_replays": ctx.engine.graphs.replays,
                              "launches": dict(LAUNCHES)},
                }, CONTROL_PAYLOAD_BYTES)
                ctx.wave_index += 1
                _retire_wave(sess)
                sess.close()
            elif cmd == "shutdown":
                ep._post("verdict", {"cmd": "bye"}, CONTROL_PAYLOAD_BYTES)
                ep.close()
                return 0
            else:
                raise TransportProtocolError(f"unknown control {item!r}")
            continue

        msg: WindowMsg = item
        ep.post_verdict(sess.verify_window(msg, r_in_chunk))
        chunk_gammas.append(msg.gamma)
        sess.iterations += 1
        r_in_chunk += 1
        if r_in_chunk >= sess.sync_every:
            flush_attribution()


# --------------------------------------------------------------------------
# draft host
# --------------------------------------------------------------------------

def run_draft(args) -> int:
    """Connect the two streams to the target host, build the engine, then
    serve framed control commands (``run``/``stats``/``shutdown``) from
    the parent over a local TCP control port."""
    ctx = _HostContext(args)
    # the control listener first, so the parent reads its port while the
    # target host is still building
    ctrl_lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ctrl_lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ctrl_lst.bind((args.bind_host, args.listen_port or 0))
    ctrl_lst.listen(1)
    _log("draft", f"listening port={ctrl_lst.getsockname()[1]}")
    ctrl_lst.settimeout(_READY_TIMEOUT_S)

    if args.connect:
        host, _, port_s = args.connect.rpartition(":")
        t_addr = (host or "127.0.0.1", int(port_s))
    else:
        t_node = ctx.spec.node(ctx.pair.target)
        t_addr = (t_node.address or "127.0.0.1", t_node.port)
    socks = {}
    for hello in (b"W", b"V"):
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.settimeout(args.timeout_s)
        s.connect(t_addr)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(hello)
        socks[hello] = s
    ep = SocketTransport.draft_endpoint(
        socks[b"W"], socks[b"V"], link=_link(ctx), seed=ctx.spec.seed,
        timeout_s=args.timeout_s)
    ctx.build_engine()
    gamma = min(ctx.pair.window.gamma, ctx.engine.gamma_max)
    _log("draft", "ready")

    ctrl, _addr = ctrl_lst.accept()
    ctrl.settimeout(args.timeout_s)
    ctrl_lst.close()
    round_seq = 0

    def run_wave(cmd: dict) -> dict:
        nonlocal round_seq
        prompts = np.asarray(cmd["prompts"], np.int32)
        lens = np.asarray(cmd["prompt_lens"], np.int32)
        max_new = np.asarray(cmd["max_new"], np.int32)
        max_new_cap = int(cmd["max_new_cap"])
        B = prompts.shape[0]
        sess, guard = ctx.wave_session(B, max_new_cap, prompts.shape[1])
        with guard:
            t_admit0 = time.perf_counter()
            _admit_wave(sess, prompts, lens, max_new, cmd.get("request_ids"))
            prefill_s = time.perf_counter() - t_admit0
            ep._post("window", {"cmd": "admit", "prompts": prompts.tolist(),
                                "prompt_lens": lens.tolist(),
                                "max_new": max_new.tolist(),
                                "max_new_cap": max_new_cap,
                                "request_ids": cmd.get("request_ids")},
                     CONTROL_PAYLOAD_BYTES)
            reply, _ = ep.recv_verdict()
            if not (isinstance(reply, dict)
                    and reply.get("cmd") == "admitted"):
                raise TransportProtocolError(
                    f"expected admitted, got {reply!r}")
            # the anchors are the target's (this host's prefill ran the
            # peer stub)
            sess._state.last_token.copy_(torch.as_tensor(
                np.asarray(reply["last_token"], np.int32)))
            done = np.zeros(B, bool)
            rounds, cap = 0, 2 * max_new_cap + 4
            t_decode0 = time.perf_counter()
            while not done.all() and rounds < cap:
                msg = sess.propose_window(gamma, int(B - done.sum()),
                                          round_seq)
                round_seq += 1
                ep.post_window(msg)
                verdict, _w = ep.recv_verdict()
                sess.apply_verdict(verdict)
                done = np.asarray(verdict.done, bool)
                rounds += 1
            decode_s = time.perf_counter() - t_decode0
            ep._post("window", {"cmd": "fetch"}, CONTROL_PAYLOAD_BYTES)
            result, _ = ep.recv_verdict()
        if not (isinstance(result, dict) and result.get("cmd") == "tokens"):
            raise TransportProtocolError(f"expected tokens, got {result!r}")
        ctx.wave_index += 1
        _retire_wave(sess)
        sess.close()
        result.update(cmd="result", rounds=rounds, prefill_s=prefill_s,
                      decode_s=decode_s, link_stats=transport_stats(ep),
                      draft_graphs=ctx.engine.graphs.captured,
                      draft_launches=dict(LAUNCHES))
        return result

    while True:
        kind, payload, _r, _d = recv_frame(ctrl)
        if kind != FRAME_CONTROL:
            raise TransportProtocolError(
                f"parent control channel got frame kind {kind}")
        cmd = json.loads(payload.decode("utf-8"))
        op = cmd.get("cmd")
        if op == "run":
            out = run_wave(cmd)
        elif op == "stats":
            out = {"cmd": "stats", "link_stats": transport_stats(ep),
                   "waves": ctx.wave_index}
        elif op == "shutdown":
            ep._post("window", {"cmd": "shutdown"}, CONTROL_PAYLOAD_BYTES)
            ep.recv_verdict()
            ep.close()
            send_frame(ctrl, FRAME_CONTROL,
                       json.dumps({"cmd": "bye"}).encode("utf-8"))
            ctrl.close()
            return 0
        else:
            raise TransportProtocolError(f"unknown parent command {cmd!r}")
        send_frame(ctrl, FRAME_CONTROL, json.dumps(out).encode("utf-8"))


def transport_stats(tr: SocketTransport) -> dict:
    return {"bytes_sent": tr.bytes_sent, "wire_bytes": tr.wire_bytes,
            "messages_sent": tr.messages_sent,
            "recent_rtt_ms": tr.recent_rtt_ms,
            "transport": tr.describe()}


# --------------------------------------------------------------------------
# parent side: spawn + drive a process-backed pair
# --------------------------------------------------------------------------

def _read_line(proc: subprocess.Popen, match: str, timeout_s: float,
               who: str) -> str:
    """Read stdout lines until one starts with ``match`` (deadline-bound,
    non-blocking, so a wedged child cannot hang the parent)."""
    fd = proc.stdout.fileno()
    os.set_blocking(fd, False)
    deadline = time.monotonic() + timeout_s
    buf = b""
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"{who} exited with code {proc.returncode} before "
                f"printing {match!r}")
        r, _, _ = select.select([fd], [], [], 0.25)
        if not r:
            continue
        chunk = os.read(fd, 4096)
        if not chunk:
            continue
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            text = line.decode("utf-8", "replace").strip()
            if text.startswith(match):
                return text
    raise TimeoutError(f"{who} did not print {match!r} in {timeout_s:.0f}s")


def _ctrl_call(sock: socket.socket, cmd: dict) -> dict:
    send_frame(sock, FRAME_CONTROL, json.dumps(cmd).encode("utf-8"))
    kind, payload, _r, _d = recv_frame(sock)
    if kind != FRAME_CONTROL:
        raise TransportProtocolError(f"control reply had frame kind {kind}")
    return json.loads(payload.decode("utf-8"))


@dataclass
class PairHostHandle:
    """Parent-side handle to one process-backed pair: the two host
    processes plus the framed control connection to the draft host."""
    pair_id: str
    procs: list
    ctrl: socket.socket
    capacity: int
    max_new_cap: int
    pad_to: int = 16
    workdir: str = ""
    _last_stats: dict = dataclasses.field(default_factory=dict)
    _waves: int = 0
    _draft_rounds: int = 0

    def run_wave(self, prompts: np.ndarray, prompt_lens: np.ndarray,
                 max_new, request_ids=None) -> dict:
        prompts = np.asarray(prompts, np.int32)
        B = prompts.shape[0]
        mn = np.broadcast_to(np.asarray(max_new, np.int32), (B,))
        try:
            out = _ctrl_call(self.ctrl, {
                "cmd": "run", "prompts": prompts.tolist(),
                "prompt_lens": np.asarray(prompt_lens, np.int32).tolist(),
                "max_new": mn.tolist(), "max_new_cap": self.max_new_cap,
                "request_ids": (list(map(int, request_ids))
                                if request_ids is not None else None)})
        except TransportProtocolError as e:
            raise RuntimeError(f"pair {self.pair_id}: the draft host broke "
                               f"off the wave ({e}); {self.log_tails()}"
                               ) from e
        if out.get("cmd") != "result":
            raise RuntimeError(f"pair {self.pair_id}: bad wave reply {out!r}")
        self._last_stats = out
        self._waves += 1
        self._draft_rounds += int(out["rounds"])
        return out

    def serve(self, reqs) -> list:
        """Drive a request bucket wave by wave (a process-backed pair's
        share of ``SpecDecodeServer.run``); returns
        :class:`repro_torch.serving.ServeResult` rows, each with its
        request's class and SLOs."""
        from ..serving.server import wave_results
        results = []
        t_start = time.perf_counter()
        for w0 in range(0, len(reqs), self.capacity):
            wave = list(reqs[w0:w0 + self.capacity])
            n_real = len(wave)
            while len(wave) < self.capacity:   # pad short waves; extras
                wave.append(wave[-1])          # decode but are dropped
            q = self.pad_to
            maxlen = max(len(r.prompt) for r in wave)
            maxlen = ((maxlen + q - 1) // q) * q
            prompts = np.zeros((self.capacity, maxlen), np.int32)
            lens = np.zeros(self.capacity, np.int32)
            for i, r in enumerate(wave):
                prompts[i, :len(r.prompt)] = r.prompt
                lens[i] = len(r.prompt)
            mn = np.array([r.max_new_tokens for r in wave], np.int32)
            wave_t0 = time.perf_counter() - t_start
            out = self.run_wave(prompts, lens, mn,
                                request_ids=[r.request_id for r in wave])
            wave_t1 = time.perf_counter() - t_start
            tokens = np.asarray(out["tokens"], np.int64)
            produced = np.minimum(np.asarray(out["produced"], np.int64),
                                  self.max_new_cap)
            seqs = out.get("acceptance_seqs") or []
            rows = [(tokens[i, :produced[i]], seqs[i] if i < len(seqs)
                     else []) for i in range(n_real)]
            done = wave_results(
                wave[:n_real], rows, wave_t0,
                wave_t0 + float(out.get("prefill_s", 0.0)), wave_t1,
                pair_id=self.pair_id)
            for res, r in zip(done, wave):   # fleet class and SLOs ride along
                res.request_class = r.request_class
                res.slo_ttft_ms, res.slo_tpot_ms = r.slo_ttft_ms, r.slo_tpot_ms
            results += done
        return results

    def stats(self) -> dict:
        return _ctrl_call(self.ctrl, {"cmd": "stats"})

    def log_tails(self, n_bytes: int = 2000) -> str:
        """The end of each host's stderr log (in ``workdir``)."""
        out = []
        for role in ("target", "draft"):
            try:
                with open(os.path.join(self.workdir,
                                       f"{role}.stderr.log"), "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - n_bytes))
                    text = f.read().decode("utf-8", "replace")
            except OSError as e:
                text = f"(no log: {e})"
            out.append(f"{role} host stderr: ...{text}")
        return "\n".join(out)

    def summary(self) -> dict:
        """``SpecDecodeServer.pair_summaries``-shaped row for this pair,
        with the hosts' graph counts and kernel launches (each host's
        :data:`repro_torch.kernels.LAUNCHES` since it started), the target
        host's rounds and accept counts and the draft host's rounds, all
        over every wave so far."""
        st = self._last_stats.get("stats", {})
        link = self._last_stats.get("link_stats", {})
        return {"requests": self._waves * self.capacity,
                "iterations": st.get("iterations", 0),
                "acceptance_rate": round(
                    st.get("accepted", 0) / max(1, st.get("proposed", 0)), 4),
                "mode_policy": "distributed", "process": True,
                "waves": self._waves, "draft_rounds": self._draft_rounds,
                "target_graphs": st.get("captured_graphs", 0),
                "draft_graphs": self._last_stats.get("draft_graphs", 0),
                "target_launches": st.get("launches", {}),
                "draft_launches": self._last_stats.get("draft_launches", {}),
                **{k: link[k] for k in ("bytes_sent", "wire_bytes",
                                        "messages_sent", "transport")
                   if k in link}}

    def shutdown(self) -> None:
        """Stop both hosts and reap them: a polite ``shutdown`` over the
        control channel, then a kill for any host still running after 10 s;
        no child process outlives the call."""
        try:
            if self.ctrl is not None:
                _ctrl_call(self.ctrl, {"cmd": "shutdown"})
        except Exception:
            pass
        if self.ctrl is not None:
            self.ctrl.close()
        self.ctrl = None
        _reap(self.procs, 10.0)

    close = shutdown


def _reap(procs, grace_s: float) -> None:
    deadline = time.monotonic() + grace_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        if p.stdout is not None:
            p.stdout.close()


def spawn_pair(spec, pair, *, model_configs=None, node_params=None,
               workdir=None, timeout_s: float = 120.0,
               python: str = sys.executable, device: str = "cuda",
               full_size: bool = False) -> PairHostHandle:
    """Launch a target host and a draft host for one ``process: true``
    pair on localhost and hand back the driving handle. The topology,
    overridden model configs and overridden node params (port tensors) are
    written to ``workdir`` (a new temporary directory by default) and
    shipped by path; everything else rebuilds from the spec's seed. On the
    card the kernel library is built here first, so the hosts load it and
    never build it concurrently."""
    import tempfile
    validate_process_pair(spec, pair)
    if device != "cpu":
        from ..kernels import build
        build()
    workdir = workdir or tempfile.mkdtemp(prefix=f"dsd-{pair.id}-")
    os.makedirs(workdir, exist_ok=True)
    topo_path = os.path.join(workdir, "topology.json")
    with open(topo_path, "w") as f:
        f.write(spec.to_json())
    flags = ["--device", device] + (["--full-size"] if full_size else [])
    for name, cfg in (model_configs or {}).items():
        path = os.path.join(workdir, f"cfg_{name}.json")
        save_model_config(cfg, path)
        flags += ["--model-config", f"{name}={path}"]
    for node_id, params in (node_params or {}).items():
        path = os.path.join(workdir, f"params_{node_id}.npz")
        save_params(params, path)
        flags += ["--node-params", f"{node_id}={path}"]

    env = dict(os.environ)
    src_dir = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    prev = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = src_dir + (os.pathsep + prev if prev else "")

    def launch(role, extra):
        with open(os.path.join(workdir, f"{role}.stderr.log"), "wb") as err:
            return subprocess.Popen(
                [python, "-m", "repro_torch.distributed.host", "--role",
                 role, "--topology", topo_path, "--pair", pair.id,
                 "--timeout-s", str(timeout_s)] + flags + extra,
                stdout=subprocess.PIPE, stderr=err, env=env)

    procs = []
    try:
        # an ephemeral stream port, read back from the host: the node's
        # fixed port may be held by another deployment on this machine
        tgt = launch("target", ["--listen-port", "0"])
        procs.append(tgt)
        line = _read_line(tgt, "listening port=", 120.0,
                          f"target host ({pair.id})")
        t_port = int(line.split("=", 1)[1])
        drf = launch("draft", ["--connect", f"127.0.0.1:{t_port}"])
        procs.append(drf)
        line = _read_line(drf, "listening port=", 120.0,
                          f"draft host ({pair.id})")
        c_port = int(line.split("=", 1)[1])
        _read_line(tgt, "ready", _READY_TIMEOUT_S,
                   f"target host ({pair.id})")
        _read_line(drf, "ready", _READY_TIMEOUT_S,
                   f"draft host ({pair.id})")
        ctrl = socket.create_connection(("127.0.0.1", c_port),
                                        timeout=timeout_s)
        ctrl.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        ctrl.settimeout(max(timeout_s, 600.0))
    except BaseException:
        for p in procs:
            p.kill()
        _reap(procs, 0.0)
        raise
    s = spec.serving
    return PairHostHandle(pair_id=pair.id, procs=procs, ctrl=ctrl,
                          capacity=s.max_batch,
                          max_new_cap=s.max_new_cap or spec.workload.max_new,
                          pad_to=s.pad_to, workdir=workdir)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.distributed.host",
        description="Run one side of a draft-target pair in this process.")
    ap.add_argument("--role", required=True, choices=("draft", "target"))
    ap.add_argument("--topology", required=True,
                    help="ClusterSpec JSON path")
    ap.add_argument("--pair", required=True, help="pair id in the topology")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the card (default) or the CPU's plain path")
    ap.add_argument("--full-size", action="store_true",
                    help="published configs instead of the reduced ones")
    ap.add_argument("--listen-port", type=int, default=None,
                    help="target: stream listen port (default: the target "
                         "node's port); draft: control port; 0 = "
                         "ephemeral; printed as 'listening port=N'")
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--connect", default="",
                    help="draft only: HOST:PORT of the target host "
                         "(default: the target node's address/port)")
    ap.add_argument("--model-config", action="append", default=[],
                    metavar="NAME=PATH",
                    help="override a model name with a ModelConfig JSON")
    ap.add_argument("--node-params", action="append", default=[],
                    metavar="NODE=PATH",
                    help="override a node's params with an npz file")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    args = ap.parse_args(argv)
    try:
        if args.role == "target":
            return run_target(args)
        return run_draft(args)
    except TransportProtocolError as e:
        print(f"[{args.role}-host] protocol error: {e}", file=sys.stderr,
              flush=True)
        return 2


if __name__ == "__main__":
    sys.exit(main())
