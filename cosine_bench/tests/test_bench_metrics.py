"""The readers' arithmetic on hand-made stamps and records."""
import math

import pytest

from cosine_bench import spec, traffic
from cosine_bench.metrics import nearest_rank
from cosine_bench.serve import Sent

import numpy as np


def _sent(sent, stamps, prompt=4, failed=False):
    return Sent(0, traffic.RequestSpec(np.zeros(prompt, np.int32), 8, "d0"),
                0, sent, stamps=list(stamps), tokens=[1] * len(stamps),
                failed=failed)


def _run(sent, **kw):
    run = dict(t_open=10.0, t_close=20.0, window_s=10.0, sent=sent,
               records=[], timeline=[], memory_peak_bytes=0, profile=None,
               setup_s=3.5)
    run.update(kw)
    return run


def test_nearest_rank():
    assert nearest_rank([], 0.5) is None
    assert nearest_rank([3, 1, 2], 0.5) == 2
    assert nearest_rank([1, 2, 3, 4], 0.5) == 2
    assert nearest_rank(list(range(1, 101)), 0.95) == 95
    assert nearest_rank([1, math.inf, math.inf], 0.5) == math.inf


def test_tokens_per_s_counts_the_window_only():
    sent = [_sent(5.0, [9.0, 10.0, 10.5, 12.0]), _sent(11.0, [19.0, 20.0,
                                                                20.5])]
    # in (10, 20]: 10.5, 12.0, 19.0, 20.0
    assert spec.reader("tokens_per_s")(_run(sent)) == pytest.approx(0.4)


def test_ttft_median_with_failed_and_censored():
    sent = [_sent(5.0, [6.0]),                 # sent before the window
            _sent(11.0, [11.5]),               # 0.5 s
            _sent(12.0, [14.0]),               # 2.0 s
            _sent(18.0, []),                   # still waiting: 2.0 s so far
            _sent(13.0, [], failed=True),      # inf
            _sent(15.0, [15.1, 15.2])]         # 0.1 s
    # waits 0.5, 2.0, 2.0, inf, 0.1 -> sorted 0.1 0.5 2.0 2.0 inf
    assert spec.reader("ttft_p50_ms")(_run(sent)) == pytest.approx(2000.0)
    assert spec.reader("ttft_p50_ms")(_run(sent[:1])) is None


def test_token_gap_p95():
    stamps = [10.0 + 0.1 * i for i in range(1, 21)]
    stamps[10] += 5.0                          # one long gap ... and after
    stamps = sorted(stamps)
    s = _sent(9.0, stamps)
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    want = sorted(gaps)[math.ceil(0.95 * len(gaps)) - 1] * 1e3
    assert spec.reader("token_gap_p95_ms")(_run([s])) == pytest.approx(want)


def test_engine_and_pipeline_readers():
    recs = [dict(batch=16, committed=16, verify_idle_ms=500.0),
            dict(batch=8, committed=12, verify_idle_ms=1500.0)]
    tl = [dict(kind="prefill", t0=11.0, t1=11.2),
          dict(kind="prefill", t0=12.0, t1=12.5),
          dict(kind="verify", t0=13.0, t1=13.4),
          dict(kind="verify", t0=14.0, t1=14.2),
          dict(kind="commit", t0=15.0, t1=16.0)]
    run = _run([], records=recs, timeline=tl, memory_peak_bytes=2.5e9)
    assert spec.reader("commit_per_req_iter")(run) == pytest.approx(28 / 24)
    assert spec.reader("verify_idle_frac")(run) == pytest.approx(20.0)
    assert spec.reader("prefill_ms_p50")(run) == pytest.approx(200.0)
    assert spec.reader("verify_ms")(run) == pytest.approx(300.0)
    assert spec.reader("peak_mem_gb")(run) == pytest.approx(2.5)
    assert spec.reader("setup_s")(run) == 3.5


def test_device_readers():
    prof = dict(window_s=2.0, busy_s=0.5, attn_calls=10, attn_device_s=0.2,
                attn_bound_s=0.05, moe_calls=4, moe_device_s=0.1,
                served_flops=67e12 * 0.01)
    run = _run([], profile=prof)
    assert spec.reader("device_idle_frac")(run) == pytest.approx(75.0)
    assert spec.reader("attn_roofline")(run) == pytest.approx(25.0)
    assert spec.reader("moe_device_share")(run) == pytest.approx(20.0)
    assert spec.reader("mfu")(run) == pytest.approx(0.5)
    for name in ("device_idle_frac", "attn_roofline", "moe_device_share",
                 "mfu"):
        assert spec.reader(name)(_run([])) is None
    assert spec.reader("moe_device_share")(
        _run([], profile=dict(window_s=1.0, busy_s=0.5))) is None
