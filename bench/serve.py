"""The timed path: the port's deployment serving a request stream through
``build_deployment(...).build_server(...)`` → ``SpecDecodeServer.run``,
with the harness's spans around the calls into the session layer.

The harness wraps each session the server opens (``admit``, ``run_chunk``,
``retire`` and the window decision) and times them on the host's clock;
it reads the session's host records and, after each chunk (which ends in
the session's own sync), the chunk's per-round stats rows. When the chunk
that crosses the window's end returns (in a traced run, the last chunk of
the profiled stretch after it), the next call into the session raises
:class:`Closed`: the run stops there without draining what is in
flight, and ``run`` in the server closes its sessions on the way out."""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np

from window import AdmitRecord, ChunkRecord, RequestRecord, Window


class Closed(Exception):
    """The measured window has closed."""


class Recorder:
    """Spans and records of one served stream. ``ramp_s``: serving time
    before the window; ``trace_chunks`` > 0 profiles that many chunks
    right after the window, so that the window holds no profiler work
    (starting and stopping a profiler stalls the host for seconds, and the
    stream's arrivals do not wait)."""

    def __init__(self, requests, ramp_s: float, seconds: float,
                 trace_chunks: int = 0):
        self.requests = {r.request_id: RequestRecord(
            r.request_id, float(r.arrival_s), len(r.prompt), r.max_new)
            for r in requests}
        self.arrival = {r.request_id: float(r.arrival_s) for r in requests}
        self.ramp_s, self.seconds = ramp_s, seconds
        self.trace_left = trace_chunks
        self.chunks: list[ChunkRecord] = []
        self.admits: list[AdmitRecord] = []
        self.t0 = None
        self.w0 = self.w1 = None
        self.stop = False
        self.prof = None
        self.tracing = False
        self.slot_req: dict[int, int] = {}
        self._gammas: list = []

    # -- clock and window --------------------------------------------------

    def started(self, t0: float) -> None:
        """The serve loop's clock started at ``t0``: due times follow."""
        self.t0 = t0
        for rid, r in self.requests.items():
            r.due = t0 + self.arrival[rid]

    def window(self) -> Window:
        return Window(self.w0, self.w1)

    def _boundary(self, t: float) -> None:
        """A chunk ended at t: open the window, close it, or (traced runs)
        end the profiled stretch that follows the window."""
        if self.w0 is None:
            if t >= self.t0 + self.ramp_s:
                self.w0 = t
        elif self.w1 is None:
            if t >= self.w0 + self.seconds:
                self.w1 = t
                if self.trace_left > 0:
                    self._start_trace()
                else:
                    self.stop = True
        elif self.tracing:
            self.trace_left -= 1
            if self.trace_left == 0:
                self._stop_trace()
                self.stop = True

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.tracing = True

    def _stop_trace(self) -> None:
        self.prof.stop()
        self.tracing = False

    def _span(self, name: str):
        if not self.tracing:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    # -- the session's calls -------------------------------------------------

    def instrument(self, sess):
        """Wrap one session's calls into the session layer."""
        admit, run_chunk, retire = sess.admit, sess.run_chunk, sess.retire
        decide = sess._decide

        def admit_w(prompt, max_new, request_id=0):
            if self.stop:
                raise Closed
            with self._span("bench.admit"):
                t_a = time.perf_counter()
                j = admit(prompt, max_new, request_id=request_id)
                t_b = time.perf_counter()
            r = self.requests[request_id]
            r.admit_start, r.first = t_a, t_b
            self.slot_req[j] = request_id
            self.admits.append(AdmitRecord(t_a, t_b, len(prompt),
                                           self.tracing))
            return j

        def decide_w(policy, q_depth):
            gamma, fused = decide(policy, q_depth)
            self._gammas.append(gamma)
            return gamma, fused

        def run_chunk_w(policy, max_iters=None, q_depth=0.0):
            if self.stop:
                raise Closed
            slots = sess._slots
            occ = [j for j in range(len(slots)) if slots[j] is not None]
            before = {j: slots[j].produced for j in occ}
            self._gammas = []
            traced = self.tracing
            with self._span("bench.chunk"):
                t_a = time.perf_counter()
                n = run_chunk(policy, max_iters=max_iters, q_depth=q_depth)
                t_b = time.perf_counter()
            nn = sess._nn[:n].cpu().numpy() if n else np.zeros((0, 0))
            nacc = sess._nacc[:n].cpu().numpy() if n else nn
            # one decision per round; a round the policy was not asked
            # about (a broken step) reads -1
            gammas = [int(g) for g in self._gammas][:n]
            gammas += [-1] * (n - len(gammas))
            tokens, work = 0, []
            for j in occ:
                r = self.requests[self.slot_req[j]]
                tokens += min(slots[j].produced, r.budget) \
                    - min(before[j], r.budget)
                r.rounds_resident += n
                r.rounds.extend((gammas[i], int(nacc[i, j]), int(nn[i, j]))
                                for i in range(n))
                cached = r.prompt_len + before[j] - 1
                for i in range(n):
                    if nn[i, j] > 0:
                        work.append((cached, gammas[i], int(nn[i, j])))
                        cached += int(nn[i, j])
            self.chunks.append(ChunkRecord(t_a, t_b, n, gammas, tokens, work,
                                           traced))
            self._boundary(t_b)
            return n

        def retire_w(slot, scrub=False):
            with self._span("bench.retire"):
                tokens, rec = retire(slot, scrub=scrub)
                t_b = time.perf_counter()
            r = self.requests[rec.request_id]
            r.retire, r.tokens = t_b, np.asarray(tokens)
            self.slot_req.pop(slot, None)
            return tokens, rec

        sess.admit, sess.run_chunk, sess.retire = admit_w, run_chunk_w, \
            retire_w
        sess._decide = decide_w
        return sess


def serve_requests(deployment, server_kw: dict, requests) -> list:
    """Serve a stream to its end, untimed (the warm-up)."""
    from repro_torch.serving import ServeRequest
    server = deployment.build_server(**server_kw)
    for r in requests:
        server.submit(ServeRequest(r.request_id, r.prompt, r.max_new,
                                   arrival_s=r.arrival_s))
    return server.run()


def serve_window(deployment, server_kw: dict, requests, ramp_s: float,
                 seconds: float, trace_chunks: int = 0) -> Recorder:
    """Serve ``requests`` (due times relative to the serve loop's start)
    through a new server of the deployment until the window has closed."""
    import repro_torch.serving.server as srv
    from repro_torch.serving import ServeRequest
    rec = Recorder(requests, ramp_s, seconds, trace_chunks)
    server = deployment.build_server(**server_kw)
    for r in requests:
        server.submit(ServeRequest(r.request_id, r.prompt, r.max_new,
                                   arrival_s=r.arrival_s))
    open_session, clock = srv.open_session, srv._ArrivalClock

    class Clock(clock):
        def __init__(self):
            super().__init__()
            rec.started(self._t0)

    srv.open_session = lambda cfg, pair, pending: rec.instrument(
        open_session(cfg, pair, pending))
    srv._ArrivalClock = Clock
    try:
        server.run()
    except Closed:
        pass
    finally:
        srv.open_session, srv._ArrivalClock = open_session, clock
        if rec.tracing:
            rec._stop_trace()
    if rec.w1 is None:
        raise RuntimeError("the stream ran out before the window closed: "
                           "the mix needs more requests")
    return rec
