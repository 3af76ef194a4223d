"""Package rules of the PyTorch port (`src/repro_torch`).

* No module of the port, not `chip_smoke.py` and not the port's examples
  (`examples/torch_*.py`) imports `jax`, the JAX package `repro` or
  `msgpack` (the card's machine has none of them; an AST scan of every
  import).
* The framework-free modules are copies: each equals its original token
  for token, comments aside, once the package name in its import lines
  is mapped back and the deliberate changes `_copied_patches.py` lists
  are made to the original, and so do its public names and dataclass
  fields.
* The entry points run on CUDA by default: without CUDA they raise unless
  the caller asks for the CPU.
* The plans the port once refused (cross-attention blocks, on attention
  and on SSM layers) now build their parameters and run `apply`.
"""
import ast
import dataclasses
import importlib
import io
import re
import tokenize
from pathlib import Path

import numpy as np
import pytest
import torch

from _copied_patches import PATCHES

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

COPIED = ["config", "configs.drafters", "configs.qwen1_5_4b",
          "configs.qwen2_0_5b", "configs.mamba2_130m",
          "configs.jamba_v0_1_52b", "configs.qwen2_moe_a2_7b",
          "configs.qwen3_32b", "configs.deepseek_v3_671b",
          "configs.h2o_danube3_4b", "configs.llama_3_2_vision_11b",
          "configs.whisper_small", "core.tree", "core.request_pool",
          "core.latency_model", "core.routing", "core.scheduler",
          "core.admission", "obs.metrics", "obs.trace", "obs.export",
          "obs.summarize", "data.synthetic", "serving.events",
          "serving.cluster", "serving.pipeline", "serving.async_loop",
          "analysis.analytic"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_reference():
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 25
    assert {f.name for f in examples} == {"torch_quickstart.py",
                                          "torch_serve_online.py",
                                          "torch_train_drafters.py"}
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"models/ssm.py", "kernels/ssd_scan/ops.py",
            "kernels/ssd_scan/__init__.py", "configs/mamba2_130m.py",
            "configs/jamba_v0_1_52b.py", "serving/async_loop.py",
            "serving/backend.py", "core/speculative.py", "obs/export.py",
            "obs/summarize.py", "data/synthetic.py", "models/moe.py",
            "configs/qwen2_moe_a2_7b.py", "configs/qwen3_32b.py",
            "configs/deepseek_v3_671b.py", "launch/train.py",
            "launch/serve.py", "optim/optimizers.py",
            "checkpoint/store.py", "checkpoint/codec.py"} <= scanned
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro", "flax", "msgpack")}
    assert not bad, bad


def _code_tokens(src: str):
    """The source's tokens without comments (docstrings and layout stay)."""
    return [(t.type, t.string) for t in
            tokenize.generate_tokens(io.StringIO(src).readline)
            if t.type not in (tokenize.COMMENT, tokenize.NL)]




@pytest.mark.parametrize("name", COPIED)
def test_copied_module_equals_original(name):
    rel = Path(*name.split(".")).with_suffix(".py")
    port_src = (PORT / rel).read_text()
    orig_src = (ROOT / "src" / "repro" / rel).read_text()
    for was, now in PATCHES.get(name, ()):
        assert orig_src.count(was) == 1
        orig_src = orig_src.replace(was, now)
    assert _code_tokens(re.sub(r"\brepro_torch\.", "repro.", port_src)) \
        == _code_tokens(orig_src)
    port = importlib.import_module(f"repro_torch.{name}")
    orig = importlib.import_module(f"repro.{name}")
    names = sorted(n for n in vars(orig) if not n.startswith("_"))
    assert sorted(n for n in vars(port) if not n.startswith("_")) == names
    for n in names:
        o, p = getattr(orig, n), getattr(port, n)
        if isinstance(o, type) and dataclasses.is_dataclass(o):
            assert [(f.name, str(f.type)) for f in dataclasses.fields(p)] \
                == [(f.name, str(f.type)) for f in dataclasses.fields(o)]


@pytest.mark.parametrize("name", ["mamba2_130m", "jamba_v0_1_52b",
                                  "qwen2_moe_a2_7b", "qwen3_32b",
                                  "deepseek_v3_671b", "h2o_danube3_4b",
                                  "llama_3_2_vision_11b", "whisper_small"])
def test_copied_config_fields_equal_original(name):
    """The SSM, hybrid, MoE, qwen3, DeepSeek-V3, h2o-danube3,
    llama-3.2-vision and whisper configs the port serves hold the
    reference's values, field by field (nested SSM, MoE and MLA configs
    included, each of the port's own class)."""
    port = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    orig = importlib.import_module(f"repro.configs.{name}").CONFIG
    assert dataclasses.asdict(port) == dataclasses.asdict(orig)
    for sub, cls in (("ssm", "SSMConfig"), ("moe", "MoEConfig"),
                     ("mla", "MLAConfig")):
        if getattr(orig, sub) is not None:
            assert type(getattr(port, sub)).__name__ == cls
            assert type(getattr(port, sub)).__module__ == "repro_torch.config"
    from repro_torch.configs import ARCHS
    assert ARCHS[orig.name] is port


def _tiny():
    from repro_torch.config import ModelConfig
    return ModelConfig(name="t", family="dense", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                       vocab=40, tie_embeddings=True, dtype="float32")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.config import CoSineConfig
    from repro_torch.models import model as M
    from repro_torch.serving.engine import SpeculativeEngine
    from repro_torch.serving.runner import ModelRunner

    cfg = _tiny()
    cpu_params = M.init_params(cfg, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelRunner(cfg, cpu_params, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpeculativeEngine((cfg, cpu_params), [(cfg, cpu_params, "d")],
                          CoSineConfig(n_drafters=1), max_len=16)
    from repro_torch.checkpoint.store import load_checkpoint
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.launch.train import train_model
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_model(cfg, SyntheticCorpus(cfg.vocab), None, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint("absent.msgpack", cfg)
    # asked for explicitly, the CPU works
    runner = ModelRunner(cfg, cpu_params, 16, device="cpu")
    lg, _ = runner.prefill_request(1, np.array([1, 2, 3]))
    assert lg.shape == (cfg.vocab,) and np.isfinite(lg).all()
    eng = SpeculativeEngine((cfg, cpu_params), [(cfg, cpu_params, "d")],
                            CoSineConfig(n_drafters=1), max_len=16,
                            device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.run().total_committed == 4


def _formerly_refused():
    """The calls that refused cross-attention plans before it was ported:
    each config and the frontend its `apply` takes."""
    from repro_torch.config import SSMConfig

    cfg = _tiny()
    return {
        # cross-attention blocks on SSM layers
        "ssm": cfg.with_overrides(family="ssm", ssm=SSMConfig(),
                                  cross_attn_period=1, n_frontend_tokens=4),
        "cross-attention": cfg.with_overrides(cross_attn_period=1,
                                              n_frontend_tokens=4),
    }


BRANCHES = ["ssm", "cross-attention"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_formerly_refused_branches_build_and_apply(branch):
    """`init_params` builds the cross sub-blocks the reference builds and
    `apply` with a frontend gives finite logits that depend on it."""
    from repro_torch.models import model as M

    cfg = _formerly_refused()[branch]
    params = M.init_params(cfg, 0, device="cpu")
    assert all({"ln_cross", "cross"} <= set(layer)
               for layer in params["layers"])
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 5), generator=gen)
    fe = torch.randn((2, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    logits, _, _ = M.apply(params, cfg, toks, frontend=fe)
    assert logits.shape == (2, 5, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
    other, _, _ = M.apply(params, cfg, toks, frontend=fe * 2)
    assert not torch.equal(logits, other)
