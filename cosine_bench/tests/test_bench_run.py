"""A whole run of the tiny cell on the CPU: the last line's keys, the
import check, and what happens without a device."""
import ast
import json

import pytest

from cosine_bench import run as run_mod
from tiny import ROOT, bench, run

PER_LAYER = ["commit_per_req_iter", "token_gap_p95_ms", "verify_idle_frac",
             "prefill_ms_p50", "peak_mem_gb", "verify_ms", "mfu",
             "device_idle_frac", "attn_roofline", "moe_device_share"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(trace):
    b = bench("moe", per_layer=PER_LAYER)
    res, err = run(trace=trace, bench=b, seconds=3.0)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 4
    for v in res["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    assert err[-1].startswith("compared ")
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert "commit_per_req_iter" in res["metrics"]
        assert "tokens_per_s" not in res["metrics"]
    else:
        assert set(res["metrics"]) == {"tokens_per_s", "ttft_p50_ms",
                                       "setup_s"}
    json.dumps(res)


def test_forbidden_modules_compared_whole():
    f = run_mod.forbidden_modules
    assert f(["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
              "flaxen"]) == []
    assert f(["repro.models.model", "numpy"]) == ["repro"]
    assert f(["jax", "jax.numpy", "jaxlib.xla", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_harness_imports_neither_jax_nor_the_jax_package():
    for path in (ROOT / "cosine_bench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in run_mod.FORBIDDEN, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "cosine_bench" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("torch", "__future__"), (path, name)


def test_no_device_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert run_mod.main(["--workload", "qwen1.5-4b.chat16", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""
