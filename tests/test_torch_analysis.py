"""repro_torch.analysis, the port's form of ``tests/test_analysis.py``:
each DSD0xx rule flags its seeded-bad torch fixture and passes the
minimally-fixed twin, the engine's CLI/baseline contract, the self-scan
(``src/repro_torch`` and ``chip_smoke.py`` stay clean or baselined), the
capture_guard sentry and the CheckedTransport protocol state machine over
the port's transports."""

import contextlib
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (CaptureGuard, CheckedTransport,
                                  ProtocolViolation, RecaptureError,
                                  capture_guard)
from repro_torch.analysis import lint
from repro_torch.core.capture import CapturedStep, GraphCounts

REPO = Path(__file__).resolve().parents[1]


def lint_snippet(tmp_path, source, name="snippet.py"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    return lint.run_paths([p])


def codes(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------- DSD001

BAD_TENSOR_IF = """
    import torch
    from repro_torch.core.capture import CapturedStep

    def build(x, counts):
        def body():
            y = torch.cumsum(x, 0)
            if y.sum() > 0:
                x.copy_(y)
        return CapturedStep(body, {}, counts, capture=True)
"""

FIXED_TENSOR_IF = """
    import torch
    from repro_torch.core.capture import CapturedStep

    def build(x, counts):
        def body():
            y = torch.cumsum(x, 0)
            x.copy_(torch.where(y.sum() > 0, y, x))
        return CapturedStep(body, {}, counts, capture=True)
"""

BAD_HOST_SYNCS = """
    import numpy as np
    import torch
    from repro_torch.core.capture import CapturedStep

    def build(x, out, counts):
        body = lambda: helper(torch.cumsum(x, 0), out)
        return CapturedStep(body, {}, counts, capture=True)

    def helper(y, out):
        n = int(y.sum())            # host-forcing cast
        z = np.asarray(y)           # numpy on a tensor
        out.fill_(y.max().item() + n + z.sum())
"""

FIXED_HOST_SYNCS = """
    import torch
    from repro_torch.core.capture import CapturedStep

    def build(x, out, counts):
        body = lambda: helper(torch.cumsum(x, 0), out)
        return CapturedStep(body, {}, counts, capture=True)

    def helper(y, out):
        out.copy_(y.max() + y.sum())
"""


def test_dsd001_flags_tensor_if(tmp_path):
    findings = lint_snippet(tmp_path, BAD_TENSOR_IF)
    assert codes(findings) == ["DSD001"]
    assert "control flow" in findings[0].message


def test_dsd001_fixed_twin_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_TENSOR_IF) == []


def test_dsd001_flags_host_syncs_in_reachable_helper(tmp_path):
    findings = lint_snippet(tmp_path, BAD_HOST_SYNCS)
    assert codes(findings) == ["DSD001"]
    msgs = " | ".join(f.message for f in findings)
    assert "int()" in msgs and ".item()" in msgs and "numpy" in msgs
    assert all("helper" in f.message for f in findings)


def test_dsd001_fixed_helper_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_HOST_SYNCS) == []


def test_dsd001_ignores_code_no_captured_step_reaches(tmp_path):
    # the same syncs, but no CapturedStep body reaches this function
    assert lint_snippet(tmp_path, """
        import numpy as np
        import torch

        def postprocess(y: torch.Tensor):
            if y.sum() > 0:
                return int(y.sum())
            torch.cuda.synchronize()
            return np.asarray(y)
    """) == []


# ---------------------------------------------------------------- DSD002

BAD_REPLAY = """
    from repro_torch.core.capture import CapturedStep

    def run(body, ins, counts):
        step = CapturedStep(body, ins, counts, capture=True)
        step()
        first = ins["out"]          # a view of the static output buffer
        step()                      # the replay overwrites it in place
        return first.sum()
"""

FIXED_REPLAY = """
    from repro_torch.core.capture import CapturedStep

    def run(body, ins, counts):
        step = CapturedStep(body, ins, counts, capture=True)
        step()
        first = ins["out"].clone()  # copied before the next call
        step()
        return first.sum()
"""


def test_dsd002_flags_static_output_read_after_replay(tmp_path):
    findings = lint_snippet(tmp_path, BAD_REPLAY)
    assert codes(findings) == ["DSD002"]
    assert "`first`" in findings[0].message


def test_dsd002_fixed_twin_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_REPLAY) == []


# ---------------------------------------------------------------- DSD003

BAD_WIRE = """
    import dataclasses

    @dataclasses.dataclass
    class PingMsg:
        token: int
        round_id: int
        flags: int

    def encode_ping(msg):
        return bytes([msg.token, msg.round_id])     # drops flags

    def decode_ping(blob):
        return PingMsg(token=blob[0], round_id=blob[1], flags=0)
"""

FIXED_WIRE = """
    import dataclasses

    @dataclasses.dataclass
    class PingMsg:
        token: int
        round_id: int
        flags: int

    def encode_ping(msg):
        return bytes([msg.token, msg.round_id, msg.flags])

    def decode_ping(blob):
        return PingMsg(token=blob[0], round_id=blob[1], flags=blob[2])
"""

PASSTHROUGH_WIRE = """
    import dataclasses

    @dataclasses.dataclass
    class PingMsg:
        token: int
        device_blob: object = None   # wire-passthrough: stays on device

    def encode_ping(msg):
        return bytes([msg.token])

    def decode_ping(blob):
        return PingMsg(token=blob[0])
"""


def test_dsd003_flags_dropped_field(tmp_path):
    findings = lint_snippet(tmp_path, BAD_WIRE)
    assert codes(findings) == ["DSD003"]
    assert any("encode_ping" in f.message and "flags" in f.message
               for f in findings)


def test_dsd003_fixed_twin_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_WIRE) == []


def test_dsd003_passthrough_comment_exempts(tmp_path):
    assert lint_snippet(tmp_path, PASSTHROUGH_WIRE) == []


BAD_FRAMING = """
    FRAME_WINDOW = 1
    FRAME_VERDICT = 2
    FRAME_CONTROL = 3

    def encode_window(msg):
        return b"w"

    def decode_window(blob):
        return None

    FRAME_ENCODERS = {FRAME_WINDOW: encode_window, FRAME_VERDICT: encode_window}
    FRAME_DECODERS = {FRAME_WINDOW: decode_window, FRAME_VERDICT: decode_window}
"""

FIXED_FRAMING = """
    FRAME_WINDOW = 1
    FRAME_VERDICT = 2
    FRAME_CONTROL = 3

    def enc(msg):
        return b"w"

    def dec(blob):
        return None

    FRAME_ENCODERS = {FRAME_WINDOW: enc, FRAME_VERDICT: enc,
                      FRAME_CONTROL: enc}
    FRAME_DECODERS = {FRAME_WINDOW: dec, FRAME_VERDICT: dec,
                      FRAME_CONTROL: dec}
"""


def test_dsd003_frame_kind_missing_from_codec_tables(tmp_path):
    findings = lint_snippet(tmp_path, BAD_FRAMING)
    assert codes(findings) == ["DSD003"]
    msgs = [f.message for f in findings]
    assert any("FRAME_ENCODERS" in m and "FRAME_CONTROL" in m for m in msgs)
    assert any("FRAME_DECODERS" in m and "FRAME_CONTROL" in m for m in msgs)


def test_dsd003_frame_tables_absent_entirely(tmp_path):
    findings = lint_snippet(tmp_path, """
        FRAME_PING = 9

        def anything():
            pass
    """)
    assert codes(findings) == ["DSD003"]
    assert any("no FRAME_ENCODERS" in f.message for f in findings)
    assert any("no FRAME_DECODERS" in f.message for f in findings)


def test_dsd003_complete_frame_tables_pass(tmp_path):
    assert lint_snippet(tmp_path, FIXED_FRAMING) == []


def test_dsd003_missing_decode_flagged(tmp_path):
    findings = lint_snippet(tmp_path, """
        import dataclasses

        @dataclasses.dataclass
        class PingMsg:
            token: int

        def encode_ping(msg):
            return bytes([msg.token])
    """)
    assert codes(findings) == ["DSD003"]
    assert "no decode_ping" in findings[0].message


# ---------------------------------------------------------------- DSD004

BAD_ROUTING = """
    from repro_torch.kernels import count_launch, library

    def my_call(x, out):
        if x.device.type == "cpu":
            return plain(x)
        library().my_kernel_launch(x.data_ptr(), out.data_ptr(), x.numel())
        count_launch("my_kernel")
        return out

    def plain(x):
        return x * 2
"""

FIXED_ROUTING = """
    from repro_torch.kernels import count_launch, library

    def my_call(x, out):
        if x.device.type == "cpu":
            return plain(x)
        if x.device.type == "meta":
            return plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"my_call runs on cuda or cpu, not {x.device}")
        library().my_kernel_launch(x.data_ptr(), out.data_ptr(), x.numel())
        count_launch("my_kernel")
        return out

    def plain(x):
        return x * 2
"""


def test_dsd004_flags_unrouted_wrapper(tmp_path):
    findings = lint_snippet(tmp_path, BAD_ROUTING)
    assert codes(findings) == ["DSD004"]
    msgs = " | ".join(f.message for f in findings)
    assert "meta" in msgs and "raises" in msgs


def test_dsd004_fixed_twin_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_ROUTING) == []


def test_dsd004_launch_in_a_falling_back_try_flagged(tmp_path):
    findings = lint_snippet(tmp_path, FIXED_ROUTING.replace(
        '''        library().my_kernel_launch(x.data_ptr(), out.data_ptr(), x.numel())
        count_launch("my_kernel")
        return out''',
        '''        try:
            library().my_kernel_launch(x.data_ptr(), out.data_ptr(),
                                       x.numel())
        except RuntimeError:
            return plain(x)
        return out'''))
    assert codes(findings) == ["DSD004"]
    msgs = " | ".join(f.message for f in findings)
    assert "falls back" in msgs and "count_launch" in msgs


# ---------------------------------------------------------------- DSD005

BAD_GRID = """
    from repro_torch.kernels import count_launch, library

    def my_call(x, tile):
        if x.device.type in ("cpu", "meta"):
            return x
        if x.device.type != "cuda":
            raise ValueError(x.device)
        V = x.shape[0]
        blocks = V // tile
        library().my_kernel_launch(x.data_ptr(), blocks)
        count_launch("my_kernel")
        return x
"""

FIXED_GRID = BAD_GRID.replace(
    "        blocks = V // tile\n",
    "        assert V % tile == 0, (V, tile)\n        blocks = V // tile\n")

CEIL_GRID = BAD_GRID.replace("blocks = V // tile", "blocks = -(-V // tile)")


def test_dsd005_flags_tiled_launch_without_check(tmp_path):
    findings = lint_snippet(tmp_path, BAD_GRID)
    assert codes(findings) == ["DSD005"]


def test_dsd005_fixed_twin_passes(tmp_path):
    assert lint_snippet(tmp_path, FIXED_GRID) == []
    assert lint_snippet(tmp_path, CEIL_GRID) == []


def test_dsd005_untiled_launch_needs_no_check(tmp_path):
    # one block per row needs no divisibility check
    assert lint_snippet(tmp_path, BAD_GRID.replace("blocks = V // tile",
                                                   "blocks = V")) == []


# ------------------------------------------------------- engine + baseline

def test_noqa_suppresses(tmp_path):
    src = BAD_TENSOR_IF.replace("if y.sum() > 0:",
                                "if y.sum() > 0:  # noqa: DSD001")
    assert lint_snippet(tmp_path, src) == []
    other = BAD_TENSOR_IF.replace("if y.sum() > 0:",
                                  "if y.sum() > 0:  # noqa: DSD004")
    assert codes(lint_snippet(tmp_path, other)) == ["DSD001"]


def test_cli_exit_codes_and_baseline(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent(BAD_TENSOR_IF))
    baseline = tmp_path / "baseline.json"

    assert lint.main([str(bad), "--baseline", str(baseline)]) == 1
    out = capsys.readouterr().out
    assert "DSD001" in out and "bad.py" in out

    assert lint.main([str(bad), "--baseline", str(baseline),
                      "--write-baseline"]) == 0
    assert baseline.exists()
    # baselined findings no longer fail the run...
    assert lint.main([str(bad), "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    # ...but a NEW finding in the same file still does
    bad.write_text(textwrap.dedent(BAD_TENSOR_IF) + textwrap.dedent("""
        def build2(x, counts):
            def body2():
                q = torch.cumsum(x, 0)
                if q.sum() < 0:
                    x.copy_(q)
            return CapturedStep(body2, {}, counts, capture=True)
    """))
    assert lint.main([str(bad), "--baseline", str(baseline)]) == 1


def test_select_filters_rules(tmp_path):
    bad = tmp_path / "both.py"
    bad.write_text(textwrap.dedent(BAD_TENSOR_IF)
                   + textwrap.dedent(BAD_REPLAY))
    assert codes(lint.run_paths([bad])) == ["DSD001", "DSD002"]
    only = lint.run_paths([bad], select={"DSD002"})
    assert codes(only) == ["DSD002"]


def test_self_scan_port_clean_or_baselined():
    """src/repro_torch and chip_smoke.py stay lint-clean, or every finding
    is baselined in the port's baseline file: the CLI's contract
    (``python -m repro_torch.analysis.lint src/repro_torch
    chip_smoke.py``)."""
    project = lint.load_project([REPO / "src" / "repro_torch",
                                 REPO / "chip_smoke.py"])
    assert len(project.modules) > 80
    findings = lint.run_project(project)
    baseline = lint.load_baseline(lint.DEFAULT_BASELINE)
    fps = lint._fingerprints(findings, project)
    fresh = [f.format() for f, fp in zip(findings, fps) if fp not in baseline]
    assert fresh == []


# ----------------------------------------------------------- capture_guard

class _StandInGraph:
    def replay(self):
        pass

    def register_generator_state(self, generator):
        pass


class _StandInStep(CapturedStep):
    """A CapturedStep whose graph API is a stand-in (the CPU has none):
    the capture runs the body eagerly, replays run nothing."""

    def _new_graph(self):
        return _StandInGraph()

    def _capturing(self, graph):
        return contextlib.nullcontext()

    def _on_side_stream(self):
        return contextlib.nullcontext()


def _step(counts=None):
    x = torch.zeros(())
    return _StandInStep(lambda: x.add_(1), {}, counts or GraphCounts(),
                        capture=True)


def test_capture_guard_steady_state_clean():
    step = _step()
    step()                                         # warm-up
    step()                                         # capture + replay
    with capture_guard(allowed=0, what="steady") as g:
        for _ in range(3):
            step()                                 # replays only
    assert g.count == 0 and g.graphs == 0


def test_capture_guard_raises_on_recapture():
    step = _step()
    step()                                         # warm-up, outside
    with pytest.raises(RecaptureError, match="capture-once"):
        with capture_guard(allowed=0):
            step()                                 # captures a graph


def test_capture_guard_count_only_mode():
    step = _step()
    with capture_guard(allowed=None, what="warmup") as g:
        step()
        step()
    assert g.count >= 1 and isinstance(g, CaptureGuard)


def test_capture_guard_does_not_mask_exceptions():
    step = _step()
    step()
    with pytest.raises(ValueError, match="inner"):
        with capture_guard(allowed=0):
            step()                                 # would trip the guard...
            raise ValueError("inner")              # ...but this wins


def test_tracked_guard_counts_an_engines_graphs_and_steps():
    """With ``track``, the guard counts the tracked engines' graphs and
    step programs (what the worker hosts run their waves under); the
    process-wide count moves with every capture."""
    from repro_torch.analysis import total_graphs_captured

    class Engine:
        def __init__(self):
            self.graphs = GraphCounts()
            self.step_keys = set()

        def step_programs(self):
            return len(self.step_keys)

    eng = Engine()
    steps = [_step(eng.graphs), _step(eng.graphs)]
    before = total_graphs_captured()
    with pytest.raises(RecaptureError, match="wave 2: captured 2"):
        with capture_guard(eng, "wave 2"):
            for s in steps:
                s()
                s()
    assert total_graphs_captured() == before + 2
    with capture_guard(eng, "wave 3 replays"):
        for s in steps:
            s()
    with pytest.raises(RecaptureError, match="built 1 step"):
        with capture_guard([eng], "wave 4"):
            eng.step_keys.add(("dw_propose", 4))


# ------------------------------------------------------- CheckedTransport

def _win(rid, spec=False):
    from repro_torch.distributed.wire import WindowMsg
    return WindowMsg(tokens=np.zeros((1, 2), np.int32), gamma=2, n_active=1,
                     round_id=rid, speculative=spec)


def _verd(rid):
    from repro_torch.distributed.wire import VerdictMsg
    z = np.zeros(1, np.int32)
    return VerdictMsg(n_accepted=z, num_new=z, next_token=z, last_token=z,
                      done=np.zeros(1, bool), gamma=2, n_active=1,
                      round_id=rid)


def _checked():
    from repro_torch.distributed.transport import InProcessTransport
    return CheckedTransport(InProcessTransport())


def test_checked_transport_happy_path_transparent():
    tr = _checked()
    tr.post_window(_win(0))
    msg, waited = tr.recv_window()
    assert msg.round_id == 0 and waited == 0.0
    tr.post_verdict(_verd(0))
    tr.recv_verdict()
    tr.send_window(_win(1))
    tr.send_verdict(_verd(1))
    tr.post_window(_win(2, spec=True))
    tr.discard_window()
    tr.assert_drained()
    assert tr.in_flight == 0                       # delegated accounting
    assert tr.messages_sent == 5
    assert tr.discarded_messages == 1


def test_checked_transport_verdict_before_window():
    tr = _checked()
    tr.post_window(_win(0))                        # posted but NOT received
    with pytest.raises(ProtocolViolation, match="before its window"):
        tr.post_verdict(_verd(0))


def test_checked_transport_double_recv():
    tr = _checked()
    tr.post_window(_win(0))
    tr.recv_window()
    with pytest.raises(ProtocolViolation, match="no window in flight"):
        tr.recv_window()


def test_checked_transport_double_verdict():
    tr = _checked()
    tr.send_window(_win(0))
    tr.send_verdict(_verd(0))
    with pytest.raises(ProtocolViolation, match="posted twice"):
        tr.post_verdict(_verd(0))


def test_checked_transport_discard_rules():
    tr = _checked()
    with pytest.raises(ProtocolViolation, match="no window in flight"):
        tr.discard_window()
    tr.post_window(_win(0))                        # non-speculative
    with pytest.raises(ProtocolViolation, match="NON-speculative"):
        tr.discard_window()


def test_checked_transport_undrained_speculative_window():
    tr = _checked()
    tr.post_window(_win(0, spec=True))
    with pytest.raises(ProtocolViolation, match="never discarded"):
        tr.assert_drained()


def test_checked_transport_duplicate_round_id():
    tr = _checked()
    tr.send_window(_win(0))
    with pytest.raises(ProtocolViolation, match="posted twice"):
        tr.post_window(_win(0))
