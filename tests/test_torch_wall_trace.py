"""The wall-clock backend's own tracing on the CPU: wall spans of the
engine thread and the verification server (`obs.wall.WallTracer.wall`),
the `admit` instant and the host-read counters
(`obs.wall.note_host_read`).

Tiny torch-only models (the shapes of `test_torch_async.py`: a dense or
MoE target, a random drafter and a perfect one sharing the target's
weights), served on `backend="async"` with `device="cpu"`:

  * one serial `step()` records one `draft.step` span per drafter step
    (steps x active drafters), each inside the `draft` span, with
    0 <= cpu_ms <= wall (to the step of the host's thread CPU clock);
  * every server task is a `<kind>.launch` and a `<kind>.sync` span
    carrying the cohort of the engine span that queued it;
  * one `admit` per request, between its arrival and its first token;
  * `host.syncs` counts every logits copy, verify read and MoE
    group-size read, by site and writing thread;
  * under a CPU `torch.profiler` the spans open `repro_torch:` ranges,
    and none is opened without one;
  * with `enable_tracing=False` nothing of this is recorded, and the
    tokens are those of the traced run;
  * two threads writing spans lose none and share no `seq`;
  * the Perfetto export shows the wall spans on a track a thread, with
    what a span's self time needs, and the summarizer reads the trace;
  * `tools/wall_trace.py` reads its six numbers from hand-made spans and
    counter snapshots, and none where there is nothing to read.
"""
import importlib.util
import io
import json
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from repro_torch.config import CoSineConfig, ModelConfig, MoEConfig
from repro_torch.models import model as TM
from repro_torch.models import moe as moe_mod
from repro_torch.obs import summarize
from repro_torch.obs.export import build_trace
from repro_torch.obs.trace import STAGE
from repro_torch.obs.wall import ENGINE, SERVER, WALL, WallTracer
from repro_torch.serving import backend as backend_mod
from repro_torch.serving.engine import SpeculativeEngine
from repro_torch.serving.runner import ModelRunner

_spec = importlib.util.spec_from_file_location(
    "wall_trace", Path(__file__).resolve().parents[1] / "tools"
    / "wall_trace.py")
wall_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wall_trace)

MAX_LEN = 96
NEW = 8
COMMON = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              d_ff=128, vocab=50, tie_embeddings=True, dtype="float32")


@pytest.fixture(scope="module")
def models():
    """{"dense" | "moe": (target, drafters)}: a random drafter and a
    perfect one (the target's weights) per target."""
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=50, tie_embeddings=True,
                       dtype="float32")
    dp = TM.init_params(dcfg, seed=1, device="cpu")
    cfgs = {"dense": ModelConfig(name="tiny-attn", family="dense", **COMMON),
            "moe": ModelConfig(name="tiny-moe", family="moe",
                               moe=MoEConfig(n_routed=4, top_k=2, d_ff=32,
                                             n_shared=1, shared_d_ff=32),
                               **COMMON)}
    out = {}
    for name, cfg in cfgs.items():
        tp = TM.init_params(cfg, seed=0, device="cpu")
        out[name] = ((cfg, tp), [(dcfg, dp, "d0"), (cfg, tp, "d1")])
    return out


def _engine(side, **cos):
    target, drafters = side
    base = dict(n_drafters=2, draft_len=4, drafters_per_request=2,
                tree_width=2)
    base.update(cos)
    return SpeculativeEngine(target, drafters, CoSineConfig(**base),
                             strategy="cosine", max_len=MAX_LEN, seed=0,
                             backend="async", device="cpu")


def _submit(eng, n=4, seed=3):
    rng = np.random.default_rng(seed)
    return [eng.submit(rng.integers(1, 50, int(k)).tolist(),
                       max_new_tokens=NEW, arrival_ms=eng.backend.now_ms())
            for k in rng.integers(4, 14, n)]


def _serve(side, **cos):
    eng = _engine(side, **cos)
    reqs = _submit(eng)
    try:
        eng.run()
    finally:
        eng.backend.shutdown()
    return eng, reqs


def _cpu_clock_step_ms():
    """The smallest advance of this host's thread CPU clock: ns on most
    hosts, a scheduler tick where CPU time is accounted by ticks."""
    steps = []
    for _ in range(5):
        t = time.thread_time_ns()
        while (u := time.thread_time_ns()) == t:
            pass
        steps.append(u - t)
    return min(steps) / 1e6


CPU_STEP_MS = _cpu_clock_step_ms()


def _host_counters(eng):
    return {k: v for k, v in eng.metrics.to_dict()["counters"].items()
            if k.startswith("host.")}


@pytest.fixture(scope="module")
def served(models):
    """One traced run of the dense target, to completion."""
    return _serve(models["dense"])


def test_one_step_records_a_draft_step_per_drafter_step(models):
    eng = _engine(models["dense"])
    eng.executor.overlap = False       # one cohort drafted per step
    _submit(eng)
    decodes = []
    orig = eng.backend.draft_decode

    def counted(di, rids, tokens, snap):
        decodes.append((di, len(rids)))
        return orig(di, rids, tokens, snap)

    eng.backend.draft_decode = counted
    try:
        with eng.backend.engine_stream():
            rec = eng.step()
    finally:
        eng.backend.shutdown()
    walls = eng.tracer.wall_spans()
    steps = [s for s in walls if s.name == "draft.step"]
    drafts = {s.seq: s for s in walls if s.name == "draft"}
    assert len(drafts) == 1
    (draft,) = drafts.values()
    assert draft.cat == STAGE and draft.cohort == rec.cohort
    # every request is routed to both drafters: draft_len steps of each
    assert len(steps) == len(decodes) == 4 * 2
    assert Counter(s.get("drafter") for s in steps) == {0: 4, 1: 4}
    assert [(s.get("drafter"), s.get("rows")) for s in
            sorted(steps, key=lambda s: s.seq)] == decodes
    for s in steps:
        assert s.track == ENGINE and s.cat == WALL
        assert s.get("parent") == draft.seq
        assert draft.t0_ms <= s.t0_ms <= s.t1_ms <= draft.t1_ms
        assert 0.0 <= s.get("cpu_ms") <= s.dur_ms + CPU_STEP_MS
    (it,) = [s for s in walls if s.name == "iteration"]
    assert it.get("parent") == -1 and it.cohort == rec.cohort
    for name in ("draft", "wait.verify", "walk", "commit.drafters"):
        (s,) = [s for s in walls if s.name == name]
        assert s.get("parent") == it.seq, name


def test_server_spans_split_launch_and_sync_with_the_queuing_cohort(served):
    eng, _ = served
    walls = eng.tracer.wall_spans()
    by_seq = {s.seq: s for s in walls}
    server = [s for s in walls if s.track == SERVER]
    kinds = Counter(s["kind"] for s in eng.backend.timeline)
    assert set(kinds) >= {"prefill", "verify", "commit", "drop"}
    for kind, n in kinds.items():
        launch = [s for s in server if s.name == kind + ".launch"]
        sync = [s for s in server if s.name == kind + ".sync"]
        assert len(launch) == len(sync) == n, kind
        for a, b in zip(launch, sync):
            assert a.t1_ms <= b.t0_ms
            assert (a.cohort, a.get("cause")) == (b.cohort, b.get("cause"))
            assert 0.0 <= a.get("cpu_ms") <= a.dur_ms + CPU_STEP_MS
    # a server span's cohort is that of the engine span that queued it
    for s in server:
        cause = by_seq[s.get("cause")]
        assert cause.track == ENGINE and s.cohort == cause.cohort
    verify_cohorts = [s.cohort for s in server if s.name == "verify.launch"]
    assert verify_cohorts == [r.cohort for r in eng.stats.records]
    (pre,) = [s for s in server if s.name == "prefill.launch"]
    assert by_seq[pre.get("cause")].name == "prefill"


def test_admit_once_per_request_between_arrival_and_first_token(served):
    eng, reqs = served
    marks = {}
    for s in eng.tracer.spans:
        if s.rid >= 0:
            marks.setdefault((s.rid, s.name), []).append(s.t0_ms)
    for r in reqs:
        (admit,) = marks[(r.rid, "admit")]
        (arrival,) = marks[(r.rid, "arrival")]
        (first,) = marks[(r.rid, "first_token")]
        assert arrival <= admit <= first


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_host_syncs_count_every_host_read(models, monkeypatch, family):
    calls = Counter()

    def counting(owner, name, site):
        orig = getattr(owner, name)

        def wrapped(*a, **kw):
            calls[site] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)

    counting(ModelRunner, "_host", "logits")
    counting(moe_mod, "group_sizes_host", "moe_sizes")
    counting(backend_mod, "_verify_to_host", "verify")
    eng, _ = _serve(models[family])
    got = _host_counters(eng)
    sites = Counter()
    for k, v in got.items():
        if k.startswith("host.syncs"):
            sites[k.split("site=")[1].split(",")[0]] += v
    assert sites == calls
    assert (calls["moe_sizes"] > 0) == (family == "moe")
    # the verify read is the engine's; logits (and, with the perfect MoE
    # drafter, group sizes) are read on both threads
    assert {k.split("thread=")[1] for k in got if "site=verify" in k} \
        == {"engine}"}
    assert {k.split("thread=")[1] for k in got if "site=logits" in k} \
        == {"engine}", "server}"}
    vocab = models[family][0][0].vocab
    n_verify = got["host.syncs{site=verify,thread=engine}"]
    assert got["host.d2h_bytes{site=verify,thread=engine}"] \
        >= n_verify * vocab * 4


def test_profiler_ranges_only_while_a_profiler_records(models, monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    import torch.profiler as tprof
    opened = Counter()
    orig = tprof.record_function

    class Counted(orig):
        def __init__(self, name, *a, **kw):
            opened[name] += 1
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(tprof, "record_function", Counted)
    _serve(models["dense"])
    assert not opened
    eng = _engine(models["dense"])
    _submit(eng, n=1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.step()
    finally:
        eng.backend.shutdown()
    n_steps = sum(1 for s in eng.tracer.wall_spans()
                  if s.name == "draft.step")
    assert opened["repro_torch: draft.step"] == n_steps > 0
    names = Counter(e.name() for e in
                    prof.profiler.kineto_results.events())
    assert names["repro_torch: draft.step"] == n_steps


def test_untraced_run_records_nothing_and_serves_the_same_tokens(models,
                                                                 served):
    eng, reqs = served
    off, off_reqs = _serve(models["dense"], enable_tracing=False)
    assert [r.generated for r in off_reqs] == [r.generated for r in reqs]
    assert not off.tracer.spans and not off.tracer.wall_spans()
    assert not _host_counters(off)
    assert _host_counters(eng) and eng.tracer.wall_spans()


def test_two_threads_writing_spans_lose_none():
    tr = WallTracer(clock=lambda: 0.0)
    n = 500
    start = threading.Barrier(2)

    def write(track):
        start.wait()
        for i in range(n):
            with tr.wall("outer", track, i=i):
                with tr.wall("inner", track, i=i):
                    pass
                tr.mark("arrival", i, 0.0)

    threads = [threading.Thread(target=write, args=(t,))
               for t in (ENGINE, SERVER)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = list(tr.spans)
    assert len(spans) == 2 * 3 * n
    assert len({s.seq for s in spans}) == len(spans)
    assert sorted(s.seq for s in spans) == list(range(len(spans)))
    by_seq = {s.seq: s for s in spans}
    for s in tr.wall_spans():
        if s.name == "inner":
            parent = by_seq[s.get("parent")]
            assert parent.name == "outer" and parent.track == s.track
            assert parent.get("i") == s.get("i")


def test_export_shows_wall_spans_per_thread(served):
    eng, _ = served
    trace = build_trace(eng.tracer)
    events = trace["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("name") == "thread_name"}
    # (the spans that cover requests are also projected onto theirs)
    walls = [e for e in events if e.get("cat") == WALL
             and "stage" not in e["args"]]
    assert {names[e["tid"]] for e in walls} == {ENGINE, SERVER}
    for e in walls:
        assert names[e["tid"]] == e["args"]["track"]
        assert {"cpu_ms", "parent", "seq"} <= set(e["args"])
    # self time: an iteration's wall time less its children's
    child = Counter()
    for e in events:
        if "cpu_ms" in e.get("args", {}) and "stage" not in e["args"]:
            child[e["args"]["parent"]] += e["dur"]
    its = [e for e in walls if e["name"] == "iteration"]
    assert len(its) == len(eng.stats.records) + 1
    assert all(0 <= e["dur"] - child[e["args"]["seq"]] < e["dur"]
               for e in its if child[e["args"]["seq"]])
    out = io.StringIO()
    summarize.summarize(json.loads(json.dumps(trace)), out=out)
    assert "verify" in out.getvalue() and "draft" in out.getvalue()


def _w(name, t0, t1, cpu_ms=None, track=ENGINE, seq=0, parent=-1, rid=-1):
    d = dict(name=name, track=track, t0=t0, t1=t1, seq=seq, parent=parent,
             rid=rid)
    if cpu_ms is not None:
        d["cpu_ms"] = cpu_ms
    return d


def test_wall_trace_readings_on_hand_made_records():
    spans = [_w("draft.step", 9.0, 9.1, 100.0),          # before the window
             _w("draft.step", 10.0, 10.04, 30.0),
             _w("draft.step", 11.0, 11.06, 30.0),
             _w("draft.step", 12.0, 12.05, 40.0),
             _w("draft.step", 19.5, 19.6, 100.0),         # profiled stretch
             _w("verify.launch", 10.0, 10.4, 100.0, SERVER),
             _w("arrival", 9.0, 9.0, rid=0), _w("admit", 9.5, 9.5, rid=0),
             _w("arrival", 11.0, 11.0, rid=1), _w("admit", 13.0, 13.0, rid=1),
             _w("arrival", 12.0, 12.0, rid=2), _w("admit", 12.5, 12.5, rid=2),
             _w("arrival", 17.0, 17.0, rid=3),            # waits to 18.0
             _w("arrival", 17.5, 17.5, rid=4)]            # waits 0.5 s
    syncs = "host.syncs{site=logits,thread=engine}"
    snaps = [(9.9, {syncs: 100.0}), (12.0, {syncs: 160.0}),
             (15.0, {syncs: 200.0, "host.syncs{site=verify,thread="
                     "engine}": 30.0}), (19.0, {syncs: 999.0})]
    got = wall_trace.readings(spans, snaps, 10.0, 18.0,
                              {"draft.step": (4, 6000.0)})
    assert got["draft_step_ms_p50"] == pytest.approx(50.0)
    assert got["draft_offcpu_frac"] == pytest.approx(100 * (1 - 100 / 150))
    assert got["verify_offcpu_frac"] == pytest.approx(75.0)
    assert got["host_syncs_per_iter"] == pytest.approx(130 / 2)
    # waits 2.0, 0.5, 1.0, 0.5 -> nearest-rank median 0.5 s
    assert got["admit_wait_p50_ms"] == pytest.approx(500.0)
    assert got["draft_step_device_ms"] == pytest.approx(1.5)
    table = wall_trace.span_table(spans, 10.0, 18.0)
    assert table[f"{ENGINE}/draft.step"][:2] == [3, pytest.approx(150.0)]
    # a run of a program without wall spans or counters: nothing to read
    bare = [_w("arrival", 11.0, 11.0, rid=1)]
    none = wall_trace.readings(bare, [(9.0, {}), (12.0, {})], 10.0, 18.0)
    assert all(v is None for v in none.values()), none
