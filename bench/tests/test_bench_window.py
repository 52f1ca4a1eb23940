"""The end-to-end arithmetic over a run's records, at the window's edges."""

import numpy as np
import pytest

from window import (AdmitRecord, ChunkRecord, RequestRecord, Window,
                    percentile, queue_length, queue_samples_ms,
                    tpot_samples_ms, ttft_samples_ms, window_tokens)

WIN = Window(10.0, 20.0)


def req(rid, due, admit=None, first=None, retire=None, n=0):
    r = RequestRecord(rid, due, 8, 32, admit_start=admit, first=first,
                      retire=retire)
    r.tokens = np.zeros(n, np.int64) if retire is not None else None
    return r


def test_ttft_counts_every_request_due_in_the_window_censored_at_its_end():
    reqs = [req(0, 9.0, 9.5, 9.6),            # due before: not counted
            req(1, 10.0, 10.5, 10.7),         # 700 ms
            req(2, 19.0),                     # waiting at the end: 1000 ms
            req(3, 19.5, 20.5, 20.6),         # admitted after w1: 500 ms
            req(4, 20.0, 20.1, 20.2)]         # due at w1: not counted
    assert ttft_samples_ms(reqs, WIN) == pytest.approx([700, 1000, 500])
    assert queue_samples_ms(reqs, WIN) == pytest.approx([500, 1000, 500])


def test_tpot_counts_retirements_in_the_window_with_two_tokens_or_more():
    reqs = [req(0, 1.0, 1.0, 2.0, 10.0, 9),   # retired at w0: not counted
            req(1, 1.0, 1.0, 2.0, 12.0, 11),  # 1000 ms per token
            req(2, 1.0, 1.0, 19.0, 19.5, 1),  # one token: no TPOT
            req(3, 1.0, 1.0, 15.0, 20.0, 6),  # at w1: 1000 ms
            req(4, 1.0, 1.0, 15.0, 20.1, 6)]  # after w1: not counted
    assert tpot_samples_ms(reqs, WIN) == pytest.approx([1000, 1000])


def test_tokens_at_the_window_edges():
    chunks = [ChunkRecord(9.0, 10.0, 8, [], 100, []),    # before
              ChunkRecord(10.0, 11.0, 8, [], 40, []),    # in
              ChunkRecord(19.0, 20.0, 8, [], 30, []),    # in, at w1
              ChunkRecord(20.0, 21.0, 8, [], 70, [])]    # after
    admits = [AdmitRecord(9.9, 10.0, 5), AdmitRecord(11.0, 11.1, 5),
              AdmitRecord(19.95, 20.05, 5)]
    assert window_tokens(chunks, admits, WIN) == 40 + 30 + 1


def test_percentile_and_queue_length():
    assert percentile([], 90) is None
    assert percentile(list(range(11)), 90) == pytest.approx(9.0)
    assert percentile([1.0, 2.0], 50) == pytest.approx(1.5)
    reqs = [req(0, 1.0, 2.0, 2.1), req(1, 1.5), req(2, 3.0, 3.5, 3.6)]
    assert queue_length(reqs, 1.8) == 2
    assert queue_length(reqs, 2.5) == 1
    assert queue_length(reqs, 3.2) == 2
