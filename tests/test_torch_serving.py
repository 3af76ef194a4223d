"""The port's serving engine against the JAX engine, end to end on the CPU.

Both engines get the same numpy-bridged tiny weights, the same seed and
the same prompts, with two drafters: a random one and a "perfect" one
that shares the target's weights, so trees really get accepted. For
every strategy (`cosine`, the main path, and the paper's four
baselines: `ar`, `vanilla`, `specinfer`, `pipeinfer`; the two
single-drafter baselines draft with the perfect drafter):

  * every committed stream equals the port's own greedy reference
    (`prefill` + `decode_step`) token for token — the losslessness
    invariant, which is exact;
  * the streams equal the JAX engine's;
  * `ServeStats.total_committed` and the per-iteration committed counts
    are equal, i.e. the two engines drafted, verified and accepted the
    same trees.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig
from repro.models import model as JM
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine

MAX_LEN = 96
NEW = 12


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
def models():
    tcfg = tiny_model_cfg("attn")
    dcfg = ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                       d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                       d_ff=96, vocab=50, tie_embeddings=True,
                       dtype="float32")
    tp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), tcfg))
    dp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), dcfg))
    jax_side = ((tcfg, tp), [(dcfg, dp, "d0"), (tcfg, tp, "d1")])
    ttp = params_from_numpy(tp, _tcfg(tcfg), "cpu")
    tdp = params_from_numpy(dp, _tcfg(dcfg), "cpu")
    torch_side = ((_tcfg(tcfg), ttp),
                  [(_tcfg(dcfg), tdp, "d0"), (_tcfg(tcfg), ttp, "d1")])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 50, n).tolist() for n in (8, 5, 13)]
    return jax_side, torch_side, prompts


def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    last = lg[0, -1, : cfg.vocab]
    out = []
    for _ in range(n):
        t = int(torch.argmax(last))
        out.append(t)
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[t]]), cache)
        last = lg[0, 0, : cfg.vocab]
    return out


def _serve(engine_cls, target, drafters, cos, strategy, prompts, **kw):
    eng = engine_cls(target, drafters, cos, strategy=strategy,
                     max_len=MAX_LEN, seed=0, **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            [rec.committed for rec in stats.records], stats, eng)


@pytest.mark.parametrize("strategy", ["cosine", "specinfer", "ar",
                                      "vanilla", "pipeinfer"])
def test_engine_matches_reference_and_jax(models, strategy):
    (jt, jd), (tt, td), prompts = models
    if strategy in ("vanilla", "pipeinfer"):
        # they draft with drafter 0 alone: make it the perfect one
        jd, td = jd[::-1], td[::-1]
    cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                       tree_width=2)
    t_streams, t_iters, t_stats, t_eng = _serve(
        SpeculativeEngine, tt, td, _tcfg(cos), strategy, prompts,
        device="cpu")
    for stream, p in zip(t_streams, prompts):
        assert stream == _greedy(tt[0], tt[1], p, NEW)
    j_streams, j_iters, j_stats, _ = _serve(JaxEngine, jt, jd, cos,
                                            strategy, prompts)
    assert t_streams == j_streams
    assert t_stats.total_committed == j_stats.total_committed
    assert t_iters == j_iters
    if strategy == "ar":
        # one token a request an iteration, and no drafter ran (not
        # even a prefill)
        assert all(rec.committed == rec.batch for rec in t_stats.records)
        assert t_stats.draft_calls == 0
        assert [d.n_prefill_writes for d in t_eng.drafters] == [0, 0]
    else:
        # the perfect drafter makes speculation pay off
        assert t_stats.mean_acceptance > 1.0


def test_burst_prefill_matches_per_request(models):
    """`prefill_requests` (one masked write for several cold requests)
    gives each request the logits and routing prior of its own
    `prefill_request`, and the slots then decode identically."""
    from repro_torch.serving.runner import ModelRunner

    _, ((cfg, params), _), prompts = models
    burst = ModelRunner(cfg, params, MAX_LEN, device="cpu")
    single = ModelRunner(cfg, params, MAX_LEN, device="cpu")
    got = burst.prefill_requests(dict(enumerate(prompts)))
    assert burst.n_prefill_writes == 1
    for rid, p in enumerate(prompts):
        lg, ll = single.prefill_request(rid, p)
        np.testing.assert_allclose(got[rid][0], lg, rtol=1e-5, atol=1e-5)
        assert abs(got[rid][1] - ll) < 1e-5
    rids = list(range(len(prompts)))
    toks = np.array([3, 4, 5])
    a, _ = burst.decode(rids, toks)
    b, _ = single.decode(rids, toks)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert [burst.length(r) for r in rids] == [len(p) + 1 for p in prompts]
