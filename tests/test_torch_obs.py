"""The port's trace export and summarizer against the JAX package's.

* Identity contract (DESIGN.md §2.7): the port's simulated engine and
  the JAX engine, given the same numpy-bridged tiny weights, seed,
  prompts and arrivals, export byte-identical trace and metrics JSON
  through `export_engine_trace` — every span, instant, counter and
  decision-log entry agrees to the last serialized digit — for every
  strategy, for each ablation switch (sub-batch drafting, routing,
  fusion, burst prefill), for the `drop` straggler policy and for SLO
  admission that sheds and preempts; each policy case also shows that
  its policy acted.
* The port's `summarize` prints exactly what the reference's prints on
  that trace (stage totals, bubble causes, waterfalls).
* It also reads a trace of the port's wall-clock backend: the verify
  track's busy and bubble spans add up to the run's `ServeStats`.
"""
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig
from repro.core.latency_model import DrafterProfile
from repro.models import model as JM
from repro.obs import summarize as j_summarize
from repro.obs.export import export_engine_trace as j_export
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.core import latency_model as tlatency
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import summarize as t_summarize
from repro_torch.obs.export import export_engine_trace as t_export
from repro_torch.serving.engine import SpeculativeEngine

MAX_LEN = 96
NEW = 8
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def sides():
    tcfg = tiny_model_cfg("attn")
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=50, tie_embeddings=True,
                       dtype="float32")
    tp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), tcfg))
    dp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), dcfg))
    ttp = params_from_numpy(tp, _tcfg(tcfg), "cpu")
    tdp = params_from_numpy(dp, _tcfg(dcfg), "cpu")
    jax_side = ((tcfg, tp), [(dcfg, dp, "d0"), (tcfg, tp, "d1")])
    torch_side = ((_tcfg(tcfg), ttp),
                  [(_tcfg(dcfg), tdp, "d0"), (_tcfg(tcfg), ttp, "d1")])
    return jax_side, torch_side


COS = dict(n_drafters=2, draft_len=4, drafters_per_request=2, tree_width=2,
           enable_admission=True)
ARRIVALS = [0.0, 40.0, 200.0]


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(1, 50, n).tolist() for n in (8, 5, 13)]


def _serve(engine_cls, side, strategy, cos, arrivals=ARRIVALS,
           priorities=(1, 1, 1), slos=(None, None, None), **kw):
    eng = engine_cls(side[0], side[1], cos, strategy=strategy,
                     max_len=MAX_LEN, seed=0, **kw)
    for p, t, pr, slo in zip(_prompts(), arrivals, priorities, slos):
        eng.submit(p, max_new_tokens=NEW, arrival_ms=t, priority=pr,
                   slo_ms=slo)
    eng.run()
    return eng


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# node 1 is eight times slower and straggles in every job: the cluster
# cuts its chains (DrafterProfile's fields: speed, straggle_prob,
# straggle_factor)
STRAGGLER = ((1.0, 0.0, 4.0), (8.0, 1.0, 5.0))
# strategy, CoSineConfig overrides, and `_serve`'s other arguments (the
# first two requests arrive together where a case needs a burst or a
# full batch; the urgent third one brings its own deadline)
CASES = {
    "cosine": ("cosine", {}, {}),
    "pipeinfer": ("pipeinfer", {}, {}),
    "specinfer": ("specinfer", {}, {}),
    "ar": ("ar", {}, {}),
    "vanilla": ("vanilla", {}, {}),
    "no-subbatch": ("cosine", dict(subbatch_drafting=False,
                                   drafters_per_request=1), {}),
    "no-routing": ("cosine", dict(enable_routing=False,
                                  drafters_per_request=1), {}),
    "no-fusion": ("cosine", dict(enable_fusion=False), {}),
    "burst-prefill": ("cosine", dict(batched_prefill=True),
                      dict(arrivals=(0.0, 0.0, 40.0))),
    "straggler-drop": ("cosine", dict(straggler_policy="drop"),
                       dict(profiles=STRAGGLER)),
    "admission-shed-preempt": (
        "cosine", dict(max_batch=1, admit_queue_cap=1, default_slo_ms=50.0),
        dict(arrivals=(0.0, 0.0, 40.0), priorities=(2, 2, 0),
             slos=(None, None, 1e9))),
}


def _case_serve(engine_cls, side, case, cos_cls, profile_cls, **kw):
    strategy, over, extra = CASES[case]
    extra = dict(extra)
    profiles = extra.pop("profiles", None)
    if profiles is not None:
        kw["drafter_profiles"] = [
            profile_cls(speed=v, straggle_prob=p, straggle_factor=f)
            for v, p, f in profiles]
    return _serve(engine_cls, side, strategy, cos_cls(**{**COS, **over}),
                  **extra, **kw)


def _port_twin(torch_side, case, **over):
    """The port's run of a case with some of its overrides changed."""
    strategy, base, extra = CASES[case]
    return _serve(SpeculativeEngine, torch_side, strategy,
                  tconfig.CoSineConfig(**{**COS, **base, **over}),
                  device="cpu", **extra)


def _policy_acted(case, eng, trace, torch_side):
    """Each case's own evidence that its strategy or policy acted."""
    st = eng.stats
    fresh = np.random.default_rng(0).bit_generator.state
    if case == "ar":
        # no drafter ran, not even a prefill
        assert st.draft_calls == 0
        assert [d.n_prefill_writes for d in eng.drafters] == [0, 0]
    elif case == "vanilla":
        assert st.node_drafted[0] > 0 and st.node_drafted[1:] == [0]
    elif case == "no-subbatch":
        # every drafter decodes every request of the cohort: twice the
        # routed sub-batches' decodes at one drafter a request
        routed = _port_twin(torch_side, case, subbatch_drafting=True)
        assert st.node_drafted[0] == st.node_drafted[1]
        assert st.draft_calls == 2 * routed.stats.draft_calls
    elif case == "no-routing":
        # the engine drew the drafters at random; the router drew nothing
        assert eng.rng.bit_generator.state != fresh
        assert eng.router.rng.bit_generator.state == fresh
    elif case == "no-fusion":
        fused = _port_twin(torch_side, case, enable_fusion=True)
        assert [r.committed for r in st.records] \
            != [r.committed for r in fused.stats.records]
    elif case == "burst-prefill":
        # the two requests that arrive together: one masked write
        assert eng.target.n_prefill_writes == 2
        assert [d.n_prefill_writes for d in eng.drafters] == [2, 2]
    elif case == "straggler-drop":
        assert eng.executor.cluster.n_dropped > 0
        assert any(e.get("name") == "drop" for e in trace["traceEvents"])
        assert any(ev.kind == "straggler_cut" and "dropped" in ev.info
                   for ev in eng.executor.log.events)
    elif case == "admission-shed-preempt":
        assert st.n_shed > 0 and st.n_preempted > 0


@pytest.mark.parametrize("case", list(CASES))
def test_export_byte_identical_to_jax_engine(sides, tmp_path, case):
    jax_side, torch_side = sides
    jeng = _case_serve(JaxEngine, jax_side, case, CoSineConfig,
                       DrafterProfile)
    teng = _case_serve(SpeculativeEngine, torch_side, case,
                       tconfig.CoSineConfig, tlatency.DrafterProfile,
                       device="cpu")
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    j_export(jeng, str(jpath))
    t_export(teng, str(tpath))
    assert _read(tpath) == _read(jpath)
    assert _read(tmp_path / "torch.metrics.json") \
        == _read(tmp_path / "jax.metrics.json")
    trace = json.loads(_read(tpath))
    assert any(e.get("name") == "verify" for e in trace["traceEvents"])
    # the summarizer prints the reference's report on the same trace
    a, b = io.StringIO(), io.StringIO()
    t_summarize.summarize(trace, out=a)
    j_summarize.summarize(trace, out=b)
    assert a.getvalue() == b.getvalue() and "verify" in a.getvalue()
    assert t_summarize.stage_totals(trace["traceEvents"]) \
        == j_summarize.stage_totals(trace["traceEvents"])
    _policy_acted(case, teng, trace, torch_side)


def test_summarize_reads_an_async_trace(sides, tmp_path):
    _, torch_side = sides
    eng = _serve(SpeculativeEngine, torch_side, "cosine",
                 tconfig.CoSineConfig(**COS), backend="async", device="cpu")
    eng.backend.shutdown()
    stats = eng.stats
    path = tmp_path / "async.json"
    t_export(eng, str(path))
    metrics = json.loads(_read(tmp_path / "async.metrics.json"))
    assert metrics and "obs.events_dropped" not in json.dumps(metrics)
    # the CLI, as a user runs it
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.summarize", str(path),
         "--requests", "3"], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(SRC)})
    assert run.returncode == 0, run.stderr
    assert "== stage occupancy ==" in run.stdout and "req 2:" in run.stdout
    totals = t_summarize.stage_totals(json.loads(_read(path))["traceEvents"])
    busy, idle = totals["verify"]
    # verify-track spans: measured verifications and prefills are busy,
    # bubbles idle; the trace's microseconds are the records' ms, rounded
    want_busy = sum(r.verify_ms + r.prefill_ms for r in stats.records)
    assert busy == pytest.approx(want_busy * 1e3, abs=1.0 * len(
        stats.records) + 1.0)
    assert idle == pytest.approx(stats.verifier_idle_ms * 1e3,
                                 abs=1.0 * len(stats.records) + 1.0)
    assert totals["draft"][0] > 0
