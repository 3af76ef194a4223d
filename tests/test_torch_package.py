"""Package rules of the PyTorch port (`src/repro_torch`).

* No module of the port, not `chip_smoke.py` and not the port's examples
  (`examples/torch_*.py`) imports `jax` or the JAX package `repro` (an
  AST scan of every import).
* The framework-free modules are copies: each equals its original token
  for token, comments aside, once the package name in its import lines
  is mapped back, and so do its public names and dataclass fields.
* The entry points run on CUDA by default: without CUDA they raise unless
  the caller asks for the CPU.
* Branches not ported yet raise `NotImplementedError` naming their
  ROADMAP item instead of quietly doing something else.
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

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

COPIED = ["config", "configs.drafters", "configs.qwen1_5_4b",
          "configs.qwen2_0_5b", "configs.mamba2_130m",
          "configs.jamba_v0_1_52b", "core.tree", "core.request_pool",
          "core.latency_model", "core.routing", "core.scheduler",
          "core.admission", "obs.metrics", "obs.trace", "obs.export",
          "obs.summarize", "data.synthetic", "serving.events",
          "serving.cluster", "serving.pipeline", "serving.async_loop"]


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
                                          "torch_serve_online.py"}
    scanned = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    assert {"models/ssm.py", "kernels/ssd_scan/ops.py",
            "kernels/ssd_scan/__init__.py", "configs/mamba2_130m.py",
            "configs/jamba_v0_1_52b.py", "serving/async_loop.py",
            "serving/backend.py", "core/speculative.py", "obs/export.py",
            "obs/summarize.py", "data/synthetic.py"} <= scanned
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "repro", "flax")}
    assert not bad, bad


def _code_tokens(src: str):
    """The source's tokens without comments (docstrings and layout stay)."""
    return [(t.type, t.string) for t in
            tokenize.generate_tokens(io.StringIO(src).readline)
            if t.type not in (tokenize.COMMENT, tokenize.NL)]


# the one deliberate change to a copy, as (original, port) source: the
# reference's `build_metrics` reads `engine.executor.log`, which the
# wall-clock executor does not have, so exporting an async engine's
# metrics fails there
PATCHED = {"obs.export": (
    """    if engine.executor is not None:
        m.set_gauge("obs.events_dropped", engine.executor.log.n_dropped)""",
    """    log = getattr(engine.executor, "log", None)
    if log is not None:
        m.set_gauge("obs.events_dropped", log.n_dropped)""")}


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_equals_original(name):
    rel = Path(*name.split(".")).with_suffix(".py")
    port_src = (PORT / rel).read_text()
    orig_src = (ROOT / "src" / "repro" / rel).read_text()
    if name in PATCHED:
        was, now = PATCHED[name]
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


@pytest.mark.parametrize("name", ["mamba2_130m", "jamba_v0_1_52b"])
def test_copied_config_fields_equal_original(name):
    """The SSM and hybrid configs the port serves hold the reference's
    values, field by field (nested SSM and MoE configs included)."""
    port = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    orig = importlib.import_module(f"repro.configs.{name}").CONFIG
    assert dataclasses.asdict(port) == dataclasses.asdict(orig)
    assert type(port.ssm).__name__ == type(orig.ssm).__name__ == "SSMConfig"
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
    # asked for explicitly, the CPU works
    runner = ModelRunner(cfg, cpu_params, 16, device="cpu")
    lg, _ = runner.prefill_request(1, np.array([1, 2, 3]))
    assert lg.shape == (cfg.vocab,) and np.isfinite(lg).all()
    eng = SpeculativeEngine((cfg, cpu_params), [(cfg, cpu_params, "d")],
                            CoSineConfig(n_drafters=1), max_len=16,
                            device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.run().total_committed == 4


def _refusals():
    from repro_torch.config import MLAConfig, MoEConfig, SSMConfig
    from repro_torch.models import model as M

    cfg = _tiny()
    return {
        # SSM and hybrid plans are served; what they may still carry that
        # is not ported is refused: cross-attention blocks on SSM layers,
        # and jamba's MoE FFNs
        "ssm": (lambda: M.init_params(cfg.with_overrides(
            family="ssm", ssm=SSMConfig(), cross_attn_period=1,
            n_frontend_tokens=4), 0, device="cpu"), "queue 1 item 11"),
        "hybrid": (lambda: M.init_cache(cfg.with_overrides(
            family="hybrid", hybrid_attn_period=2, n_layers=2,
            ssm=SSMConfig(), moe=MoEConfig(n_routed=2, top_k=1, d_ff=8,
                                           layer_offset=1)), 1, 8,
            device="cpu"), "queue 1 item 11"),
        "mla": (lambda: M.init_params(cfg.with_overrides(
            attention="mla", mla=MLAConfig()), 0, device="cpu"),
            "queue 1 item 11"),
        "moe": (lambda: M.init_params(cfg.with_overrides(
            family="moe", moe=MoEConfig(n_routed=2, top_k=1, d_ff=8)), 0,
            device="cpu"), "queue 1 item 11"),
        "cross-attention": (lambda: M.init_params(cfg.with_overrides(
            cross_attn_period=1, n_frontend_tokens=4), 0, device="cpu"),
            "queue 1 item 11"),
        "int8 kv": (lambda: M.init_cache(cfg.with_overrides(kv_dtype="int8"),
                                         1, 8, device="cpu"),
                    "queue 1 item 11"),
    }


BRANCHES = ["ssm", "hybrid", "mla", "moe", "cross-attention", "int8 kv"]


@pytest.mark.parametrize("branch", BRANCHES)
def test_unported_branches_refuse(branch):
    call, item = _refusals()[branch]
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        call()
