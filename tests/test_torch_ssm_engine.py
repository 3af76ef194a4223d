"""The port's engine on SSM and hybrid targets against the JAX engine, on
the CPU.

Tiny SSM and hybrid targets, with dense and with SSM drafters (one
random, one sharing the target's weights): for `cosine` and `specinfer`
the port's engine commits the JAX engine's streams with its totals and
per-iteration commits, on the resident and on the paged pool (held
against the JAX resident engine: the JAX paged path's own bitwise hybrid
test fails in `test_paged_pool.py` here), verifies chains only, and each
stream is the port's own greedy decode.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig, SSMConfig
from repro.models import model as JM
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro_torch import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 96


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _drafter_cfg(kind):
    common = dict(n_layers=1, d_model=48, n_heads=2, n_kv_heads=2,
                  head_dim=16, d_ff=96, vocab=50, tie_embeddings=True,
                  dtype="float32")
    if kind == "dense":
        return ModelConfig(name="tiny-draft", family="dense", **common)
    return ModelConfig(name="tiny-ssm-draft", family="ssm",
                       ssm=SSMConfig(d_state=8, head_dim=16, chunk_size=8),
                       **common)


@pytest.fixture(scope="module", params=["ssm-dense", "ssm-ssm",
                                        "hybrid-dense", "hybrid-ssm"])
def engine_models(request):
    target, drafter = request.param.split("-")
    tcfg = tiny_model_cfg(target)
    dcfg = _drafter_cfg(drafter)
    tp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), tcfg))
    dp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1), dcfg))
    jax_side = ((tcfg, tp), [(dcfg, dp, "d0"), (tcfg, tp, "d1")])
    ttp = params_from_numpy(tp, _tcfg(tcfg), "cpu")
    tdp = params_from_numpy(dp, _tcfg(dcfg), "cpu")
    torch_side = ((_tcfg(tcfg), ttp),
                  [(_tcfg(dcfg), tdp, "d0"), (_tcfg(tcfg), ttp, "d1")])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 50, n).tolist() for n in (8, 21, 5)]
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
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    stats = eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            [rec.committed for rec in stats.records], stats, eng)


@pytest.mark.parametrize("strategy", ["cosine", "specinfer"])
def test_engine_matches_jax_resident_and_paged(engine_models, strategy):
    (jt, jd), (tt, td), prompts = engine_models
    cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                       tree_width=2)
    j_streams, j_iters, j_stats, _ = _serve(JaxEngine, jt, jd, cos,
                                            strategy, prompts)
    for paged in (False, True):
        tcos = dataclasses.replace(cos, paged_pool=paged, page_size=16,
                                   pool_pages=4)
        streams, iters, stats, eng = _serve(
            SpeculativeEngine, tt, td, _tcfg(tcos), strategy, prompts,
            device="cpu")
        assert not eng.tree_capable              # chain-only verification
        assert streams == j_streams
        assert stats.total_committed == j_stats.total_committed
        assert iters == j_iters
        if paged:
            assert eng.target.slots.pages_held() == 0   # all released
    for stream, p in zip(streams, prompts):
        assert stream == _greedy(tt[0], tt[1], p, 12)
    # the drafter sharing the target's weights makes speculation pay off
    assert stats.mean_acceptance > 1.0
