"""Checkpoints of the PyTorch port against the JAX package's (CPU).

* `models.convert.reference_tree` restacks the port's per-layer
  parameters into the reference's `init_params` layout: the same flat
  keys (lists and tuples where the reference has them), shapes and
  dtypes as `jax.eval_shape(init_params)` on eight architectures and on
  int8-quantized drafters, and `params_from_numpy` undoes it bit for bit.
* A file the JAX package writes loads in the port bit for bit (and
  `apply` gives the reference's logits from it, at float32 within 1e-4);
  a file the port writes loads in the JAX package bit for bit, bfloat16
  and int8 leaves included.
* The port's msgpack codec writes `msgpack.packb`'s bytes (skipped where
  the `msgpack` package is absent) and reads them back.
* `load_checkpoint(..., quantize="int8")` equals `quantize_params` of the
  loaded tree.
* `launch/serve.py` end to end: a few training steps a model, the
  checkpoints written and read back, a CoSine serve from them.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JS
from repro.configs import ARCHS
from repro.models import model as JM
from repro.models import quantize as JQ
from repro_torch import config as tconfig
from repro_torch.checkpoint import codec
from repro_torch.checkpoint import store as TS
from repro_torch.launch import serve as TSV
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.quantize import quantize_params
from repro_torch.optim.optimizers import tree_leaves, tree_map

NAMES = ["qwen2-0.5b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
         "h2o-danube3-4b", "mamba2-130m", "jamba-v0.1-52b",
         "llama-3.2-vision-11b", "whisper-small"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one intra-op thread: the whole suite runs in several
    pytest-xdist workers at once, and under that load torch's OpenMP pool
    on every core made the small operations here up to ~100x slower (the
    serve test took 115 s on a loaded host at the default thread count,
    15 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **kw):
    cfg = ARCHS[name].reduced().with_overrides(dtype="float32", **kw)
    return cfg, tconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(cfg)})


def _layout(tree):
    """flat key -> (shape, dtype name) of a tree of arrays or shapes."""
    return {k: (tuple(v.shape), str(v.dtype))
            for k, v in JS._flatten(tree).items()}


def _equal_trees(a, b):
    """Two port trees hold the same keys and the same bits."""
    assert len(tree_leaves(a)) == len(tree_leaves(b))
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0),
             a, b)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_reference_tree_is_the_reference_layout(name, quant):
    cfg, tcfg = _cfgs(name)
    params = TM.init_params(tcfg, 0, device="cpu")

    def ref_init(key):
        tree = JM.init_params(key, cfg)
        return JQ.quantize_params(tree, cfg) if quant else tree

    if quant and cfg.attention == "mla":
        # both packages refuse to quantize MLA's latent projections
        with pytest.raises(ValueError):
            jax.eval_shape(ref_init, jax.random.PRNGKey(0))
        with pytest.raises(ValueError):
            quantize_params(params)
        return

    if quant:
        params = quantize_params(params)
    want = _layout(jax.eval_shape(ref_init, jax.random.PRNGKey(0)))
    tree = params_to_numpy(params, tcfg)
    assert _layout(tree) == want
    _equal_trees(params_from_numpy(tree, tcfg, "cpu"), params)


def _jax_tree(name, seed=0, **kw):
    """A reference-layout numpy tree (the port's init restacked) and its
    configs."""
    cfg, tcfg = _cfgs(name, **kw)
    return cfg, tcfg, params_to_numpy(TM.init_params(tcfg, seed, "cpu"),
                                      tcfg)


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "whisper-small",
                                  "jamba-v0.1-52b"])
def test_reference_file_loads_in_port(tmp_path, name):
    _, tcfg, tree = _jax_tree(name, seed=3)
    path = str(tmp_path / "ref.msgpack")
    JS.save_checkpoint(path, tree, meta={"step": 7, "domain": "piqa"})
    params, meta = TS.load_checkpoint(path, tcfg, "cpu")
    assert meta == {"step": 7, "domain": "piqa"}
    _equal_trees(params, params_from_numpy(tree, tcfg, "cpu"))


def test_reference_file_gives_reference_logits(tmp_path):
    cfg, tcfg, tree = _jax_tree("qwen2-0.5b", seed=4)
    path = str(tmp_path / "ref.msgpack")
    JS.save_checkpoint(path, tree)
    params, _ = TS.load_checkpoint(path, tcfg, "cpu")
    jparams, _ = JS.load_checkpoint(path)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 9))
    toks = toks.astype(np.int32)
    lj, _, _ = JM.apply(jparams, cfg, jnp.asarray(toks))
    lt, _, _ = TM.apply(params, tcfg, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("kind", ["float32", "int8", "bfloat16"])
def test_port_file_loads_in_reference(tmp_path, kind):
    """The port writes; the JAX package reads the same bits under the
    same keys (`params_to_numpy`'s tree is the reference's layout)."""
    cfg, tcfg = _cfgs("whisper-small" if kind == "float32"
                      else "qwen2-0.5b")
    params = TM.init_params(tcfg, 5, device="cpu")
    if kind == "int8":
        params = quantize_params(params)
    path = str(tmp_path / "port.msgpack")
    if kind == "bfloat16":
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
        want = {k: v.view(torch.int16).numpy() for k, v in
                TS._flatten(TS.reference_tree(params, tcfg)).items()}
    else:
        want = JS._flatten(params_to_numpy(params, tcfg))
    TS.save_checkpoint(path, params, tcfg, meta={"kind": kind})
    jparams, meta = JS.load_checkpoint(path)
    assert meta == {"kind": kind}
    got = JS._flatten(jparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        if kind == "bfloat16":
            assert str(g.dtype) == "bfloat16"
            g = g.view(np.int16)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)
    # and back: the port reads its own file bit for bit
    again, _ = TS.load_checkpoint(path, tcfg, "cpu")
    _equal_trees(again, params)


def test_reference_bfloat16_file_loads_in_port(tmp_path):
    """bfloat16 leaves (numpy's extension dtype on the JAX side) come back
    through `torch.frombuffer`."""
    _, tcfg, tree = _jax_tree("qwen2-0.5b", seed=6)
    tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)
    path = str(tmp_path / "ref_bf16.msgpack")
    JS.save_checkpoint(path, tree)
    params, _ = TS.load_checkpoint(path, tcfg, "cpu")
    flat = TS._flatten(TS.reference_tree(params, tcfg))
    for k, v in JS._flatten(tree).items():
        assert flat[k].dtype == torch.bfloat16
        assert np.array_equal(flat[k].view(torch.int16).numpy(),
                              v.view(np.int16))


def test_codec_writes_msgpack_bytes():
    msgpack = pytest.importorskip("msgpack")
    rng = np.random.default_rng(0)
    payload = {
        "__meta__": {"step": 12, "lr": 3e-3, "name": "x" * 31,
                     "long": "y" * 40, "longer": "z" * 300, "none": None,
                     "flags": [True, False], "ints": [
                         0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                         -1, -32, -33, -128, -129, -32768, -32769,
                         -2 ** 31 - 1]},
        "empty": {"dtype": "float32", "shape": [0], "data": b""},
        "small": {"dtype": "int8", "shape": [5], "data": bytes(range(5))},
        "bin16": {"data": rng.bytes(300)},
        "bin32": {"data": rng.bytes(70000)},
        "map16": {f"k{i}": i for i in range(20)},
        "array16": list(range(20)),
    }
    raw = codec.packb(payload)
    assert raw == msgpack.packb(payload, use_bin_type=True)
    back = codec.unpackb(raw)
    assert back == msgpack.unpackb(raw, raw=False)


def test_quantize_on_load(tmp_path):
    _, tcfg = _cfgs("qwen2-0.5b")
    params = TM.init_params(tcfg, 8, device="cpu")
    path = str(tmp_path / "p.msgpack")
    TS.save_checkpoint(path, params, tcfg)
    loaded, _ = TS.load_checkpoint(path, tcfg, "cpu")
    q, _ = TS.load_checkpoint(path, tcfg, "cpu", quantize="int8")
    _equal_trees(q, quantize_params(loaded))
    # an int8 checkpoint passes through unchanged
    TS.save_checkpoint(path, q, tcfg)
    q2, _ = TS.load_checkpoint(path, tcfg, "cpu", quantize="int8")
    _equal_trees(q2, q)
    with pytest.raises(ValueError):
        TS.load_checkpoint(path, tcfg, "cpu", quantize="fp8")


def test_serve_launcher_end_to_end(tmp_path, monkeypatch):
    """Inline training (two steps a model), the checkpoints written and
    read back bit for bit, then `main()` serving from them on the CPU."""
    corpus = TSV.SyntheticCorpus(TSV.VOCAB, seed=0, sharpness=120.0,
                                 support=5)
    (tcfg, tparams), drafters = TSV.build_models(None, corpus, 2,
                                                 device="cpu")
    TS.save_checkpoint(str(tmp_path / "target.msgpack"), tparams, tcfg)
    for dcfg, dp, dom in drafters:
        TS.save_checkpoint(str(tmp_path / f"drafter_{dom}.msgpack"), dp,
                           dcfg)
    (_, tp2), drafters2 = TSV.build_models(str(tmp_path), corpus, 2,
                                           device="cpu")
    _equal_trees(tp2, tparams)
    for (_, a, da), (_, b, db) in zip(drafters, drafters2):
        assert da == db
        _equal_trees(a, b)
    monkeypatch.setattr("sys.argv", [
        "serve", "--device", "cpu", "--ckpt-dir", str(tmp_path),
        "--requests", "3", "--max-new", "5", "--mode", "volatile"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TSV.main()
    assert "strategy=cosine requests=3 tokens=15" in out.getvalue()
