"""Process-backed pairs of the port (``repro_torch.distributed.host``) on
the CPU: worker hosts spawned with ``--device cpu``, tiny configs shipped as
JSON and bridged weights as an npz of the port's own tensors.

- The ``cluster_2pair_procs.json`` shape (two pairs, four host processes,
  20 ms links, two waves per pair; the two target nodes on one set of
  weights, the two drafts on their own) serves the tokens of the
  REFERENCE's in-process deployment of the same spec; every host's second
  wave ran under the capture guard; shutdown leaves no child process.
- A bad stream hello makes the target host exit 2 naming it.
- The param npz round-trips f32 and bf16 leaves; the capture guard
  raises on a step built after the first wave.

Every test that starts processes bounds itself with an alarm.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import topology as jtopo
from repro.configs.base import ModelConfig as JCfg
from repro.models.model import Model as JModel
from repro.serving import ServeRequest as JRequest
from repro_torch import topology as ttopo
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.capture import GraphCounts
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.distributed import InProcessTransport, host
from repro_torch.kernels.decode_attn.decode_attn import HEAD_DIMS
from repro_torch.serving import ServeRequest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TARGET = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
              dtype="float32", remat=False, qk_norm=True)
DRAFT = dict(TARGET, name="d", n_layers=1, n_kv_heads=2, qk_norm=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny models: faster than many,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def alarm():
    """Fail a test that outlives its budget instead of hanging the run."""
    def expired(*_):
        raise TimeoutError("process test exceeded its 120 s budget")
    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(120)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _spec(pkg, process: bool):
    spec = pkg.ClusterSpec.load(str(ROOT / "examples"
                                    / "cluster_2pair_procs.json"))
    for p in spec.pairs:
        p.process = process
    spec.serving.max_new_cap = 8
    return spec


def _requests(make, n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [make(i, rng.integers(0, 128, int(rng.integers(5, 14)))
                 .astype(np.int32), int(rng.integers(3, 9)))
            for i in range(n)]


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.request_id: np.asarray(r.tokens).tolist()
            for r in server.run()}


def _children() -> set:
    """Live child processes of this test process (from /proc)."""
    me, out = os.getpid(), set()
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.add(int(d.name))
    return out


def test_process_pairs_match_reference_deployment(alarm):
    jcfgs = {"qwen2.5-3b": JCfg(**DRAFT), "qwen3-14b": JCfg(**TARGET)}
    tcfgs = {"qwen2.5-3b": TCfg(**DRAFT), "qwen3-14b": TCfg(**TARGET)}
    jspec = _spec(jtopo, process=False)
    jp, tp = {}, {}
    for i, n in enumerate(jspec.nodes):
        # the two target nodes share weights, so a request's greedy tokens
        # do not depend on which pair served it (the in-process router and
        # the hosts' round-robin buckets place requests differently)
        k = 30 if n.role == "target" else 20 + i
        p = jax.device_get(JModel(jcfgs[n.model]).init_params(
            jax.random.PRNGKey(k)))
        jp[n.id] = jax.tree.map(jnp.asarray, p)
        tp[n.id] = params_from_numpy(p, "cpu")
    jdep = jtopo.build_deployment(jspec, model_configs=jcfgs, node_params=jp,
                                  sleep_links=False)
    ref = _serve(jdep.build_server(), _requests(JRequest))

    tspec = _spec(ttopo, process=True)
    held = []
    for n in tspec.nodes:
        # each target node's own port is taken (as by another deployment
        # on this machine): the spawned hosts must bind ephemeral ports
        if n.role == "target":
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.bind(("127.0.0.1", 0))
            s.listen(1)
            held.append(s)
            n.port = s.getsockname()[1]
    before = _children()
    try:
        dep = ttopo.build_deployment(tspec, model_configs=tcfgs,
                                     node_params=tp, device="cpu",
                                     host_timeout_s=60.0)
    finally:
        for s in held:
            s.close()
    try:
        assert len(_children() - before) == 4
        server = dep.build_server()
        ours = _serve(server, _requests(ServeRequest))
        rows = server.pair_summaries()
    finally:
        dep.shutdown()
    assert ours == ref
    assert sorted(rows) == ["proc-a", "proc-b"]
    for row in rows.values():
        # two waves per pair; the second ran under the capture guard
        assert row["process"] and row["waves"] == 2
        assert row["requests"] == 4 and row["messages_sent"] > 0
        # both hosts count the rounds of both waves (a wave's session
        # counts only its own)
        assert row["iterations"] == row["draft_rounds"] > 0
    assert all(p.poll() is not None for pair in dep.pairs
               for p in pair.host.procs)
    assert _children() - before == set()


def test_bad_stream_hello_exits_naming_it(alarm, tmp_path):
    spec = _spec(ttopo, process=True)
    topo = tmp_path / "topology.json"
    topo.write_text(spec.to_json())
    for name, kw in (("qwen2.5-3b", DRAFT), ("qwen3-14b", TARGET)):
        host.save_model_config(TCfg(**kw), str(tmp_path / f"{name}.json"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.distributed.host", "--role",
         "target", "--topology", str(topo), "--pair", "proc-a", "--device",
         "cpu", "--listen-port", "0", "--timeout-s", "30",
         "--model-config", f"qwen2.5-3b={tmp_path / 'qwen2.5-3b.json'}",
         "--model-config", f"qwen3-14b={tmp_path / 'qwen3-14b.json'}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    try:
        port = int(host._read_line(proc, "listening port=", 60.0,
                                   "target host").split("=", 1)[1])
        with socket.create_connection(("127.0.0.1", port)) as s:
            s.sendall(b"X")
            rc = proc.wait(timeout=60)
        assert rc == 2
        assert b"bad stream hello" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_param_npz_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn(4, 3, generator=gen),
              "layers": {"attn": {"wq": torch.randn(2, 3, 3, generator=gen)
                                  .to(torch.bfloat16)},
                         "ln1": torch.zeros(2, 3)}}
    path = str(tmp_path / "p.npz")
    host.save_params(params, path)
    back = host.load_params(path, "cpu")
    assert back["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert back["layers"]["attn"]["wq"].equal(params["layers"]["attn"]["wq"])
    assert back["embed"].equal(params["embed"])
    assert back["layers"]["ln1"].equal(params["layers"]["ln1"])


class _Engine:
    def __init__(self):
        self.graphs = GraphCounts()
        self.step_keys = set()

    def step_programs(self):
        return len(self.step_keys)


def test_capture_guard_raises_on_a_new_graph_or_step():
    eng = _Engine()
    with host.capture_guard(eng, "wave 1"):
        pass                                  # replays only: quiet
    with pytest.raises(RuntimeError, match="wave 2: captured 1"):
        with host.capture_guard(eng, "wave 2"):
            eng.graphs.captured += 1
    with pytest.raises(RuntimeError, match="built 1 step"):
        with host.capture_guard(eng, "wave 3"):
            eng.step_keys.add(("dw_propose", 4))


STUB_NVCC = """#!{python}
# stands in for nvcc: an object is written in two halves with a pause
# between them; the link refuses an object that is not whole and one
# build's own
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-shared" in args:
    parts = []
    for o in (a for a in args if a.endswith(".o")):
        text = open(o).read()
        lines = text.split("\\n")
        if not (len(lines) == 3 and lines[0].startswith("BEGIN ")
                and lines[1] == "END " + lines[0][6:]):
            print("half-written object", o, repr(text))
            sys.exit(1)
        parts.append(text)
    open(out, "w").write("".join(parts))
else:
    with open(out, "w") as f:
        f.write("BEGIN %d\\n" % os.getpid())
        f.flush()
        time.sleep(2.0)
        f.write("END %d\\n" % os.getpid())
"""


def test_concurrent_kernel_builds(alarm, tmp_path):
    """Two processes build the kernel library at once into one directory
    (worker hosts at first use) with a stub in place of ``nvcc``: both
    succeed with the same library, whose every object is whole, and no
    build leftovers remain."""
    cuda = tmp_path / "cuda" / "bin"
    cuda.mkdir(parents=True)
    (cuda / "nvcc").write_text(STUB_NVCC.format(python=sys.executable))
    (cuda / "nvcc").chmod(0o755)
    out = tmp_path / "build"
    code = ("import sys\nfrom pathlib import Path\n"
            "from repro_torch.kernels import build\n"
            "print(build(Path(sys.argv[1])))\n")
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "CUDA_HOME": str(tmp_path / "cuda")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env, text=True) for _ in range(2)]
    res = [p.communicate(timeout=90) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], res
    paths = {r[0].strip() for r in res}
    assert len(paths) == 1
    lib = Path(paths.pop())
    n_src = len(list((SRC / "repro_torch" / "csrc").glob("*.cu")))
    assert lib.read_text().count("BEGIN") == n_src
    assert sorted(p.name for p in out.iterdir()) == [".build.lock", lib.name]


FAMILIES = {"dense": TARGET,
            "ssm": dict(name="s", arch_type="ssm", n_layers=2, d_model=64,
                        n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
                        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                        dtype="float32", remat=False, tie_embeddings=True),
            "hybrid": dict(name="h", arch_type="hybrid", n_layers=4,
                           d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                           head_dim=16, vocab=128, ssm_state=16,
                           ssm_head_dim=16, ssm_chunk=8, attn_every=2,
                           dtype="float32", remat=False)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_peer_stub_keeps_the_pair_step(family):
    """A host's stand-in for the other side keeps that side's family (so
    the engine picks the pair's step) and vocabulary, and a session over
    it admits and proposes: a draft host whose target is a stub."""
    real = TCfg(**FAMILIES[family])
    stub = host.peer_stub(real)
    assert (stub.arch_type, stub.vocab, stub.dtype) == \
        (real.arch_type, real.vocab, real.dtype)
    # a head size the card's attention kernels take (B1/B2)
    assert stub.head_dim in HEAD_DIMS
    eng = SpecDecodeEngine(TCfg(**DRAFT), stub, device="cpu")
    ref = SpecDecodeEngine(TCfg(**DRAFT), real, device="cpu")
    assert eng._target_attention == ref._target_attention
    sess = DecodeSession(eng, capacity=2, max_new_cap=6, max_prompt_len=8,
                         gamma_max=4, mode_policy="distributed",
                         transport=InProcessTransport())
    sess.admit(np.arange(5, dtype=np.int32), 6)
    msg = sess.propose_window(3, 1, 0)
    assert msg.tokens.shape == (2, 4)
