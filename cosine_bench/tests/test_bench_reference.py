"""The plain references against the program's forward, at a tiny size on
the CPU, on the same seeded weights; the weights' layout against the
program's at every configuration's full size."""
import json

import numpy as np
import pytest
import torch

from cosine_bench import spec, weights
from cosine_bench.reference import dense
from cosine_bench.serve import _model_config
from tiny import DATA


def _program_logits(conf, params, tokens):
    from repro_torch.models import model as M
    cfg = _model_config(conf["program"]["target"])
    logits, _, _ = M.apply(params, cfg, tokens[None])
    return logits[0, :, : conf["vocab_size"]]


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_reference_matches_program_forward(family):
    conf = json.loads((DATA / f"tiny-{family}.json").read_text())
    ref = weights.reference_module(conf["reference"])
    params = weights.build(torch, conf, conf["reference"], 2 ** 33 + 1,
                           weights.TARGET_ROLE, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, conf["vocab_size"], 48))
    with torch.no_grad():
        want = _program_logits(conf, params, tokens)
        got = ref.forward(conf, params, tokens, torch.arange(48))
    if conf["dtypes"]["activations"] == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        # bf16 residuals: the two sum in other orders, so a rounding
        # decision can differ; the logits stay within a few bf16 steps
        assert (got - want).abs().max() < 0.05
        assert (got.argmax(-1) == want.argmax(-1)).float().mean() > 0.9


def test_drafter_reference_matches_program_forward():
    conf = json.loads((DATA / "tiny-dense.json").read_text())
    dconf = dict(conf["drafters"]["config"])
    params = weights.build(torch, dconf, "dense", 7, weights.drafter_role(0),
                           "cpu")
    from repro_torch.models import model as M
    cfg = _model_config(conf["program"]["drafter"])
    tokens = torch.arange(40) * 7 % dconf["vocab_size"]
    with torch.no_grad():
        want = M.apply(params, cfg, tokens[None])[0][0, :, :512]
        got = dense.forward(dconf, params, tokens, torch.arange(40))
    assert (got - want).abs().max() < 0.05


@pytest.mark.parametrize("conf_file", [c["file"] for c in spec.load()["configs"]])
def test_layout_matches_the_program(conf_file):
    """Every leaf the reference lays out has the shape the program's own
    initialiser gives it, at the configuration's full size (meta
    tensors: no memory)."""
    from repro_torch.models import model as M
    conf = json.loads((spec.ROOT / conf_file).read_text())
    for model, prog, fam in (
            (conf, conf["program"]["target"], conf["reference"]),
            (conf["drafters"]["config"], conf["program"]["drafter"],
             conf["drafters"]["reference"])):
        want = M.init_params(_model_config(prog), device="meta")
        for path, shape, _ in weights.reference_module(fam).param_specs(model):
            node = want
            for key in path:
                node = node[key]
            assert tuple(node.shape) == tuple(shape), path
        n = sum(1 for _ in weights.reference_module(fam).param_specs(model))
        assert n == len(_leaves(want))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_weights_are_seeded():
    conf = json.loads((DATA / "tiny-moe.json").read_text())
    a = weights.build(torch, conf, "moe", 2 ** 31 + 3, 0, "cpu")
    b = weights.build(torch, conf, "moe", 2 ** 31 + 3, 0, "cpu")
    c = weights.build(torch, conf, "moe", 2 ** 31 + 4, 0, "cpu")
    assert torch.equal(a["layers"][1]["ffn"]["w_up"], b["layers"][1]["ffn"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
    scale = a["layers"][0]["ln1"]["scale"]
    assert abs(float(scale.mean()) - 1.0) < 0.02


def test_controls_round_as_stated():
    x = torch.randn(64, 128)
    t = dense.tf32(x)
    assert torch.equal(t.view(torch.int32) & 0x1FFF,
                       torch.zeros_like(t.view(torch.int32)))
    assert ((t - x).abs() <= x.abs() * 2 ** -11).all()
    num = dense.Numerics(torch.bfloat16, "fp8")
    y = num.act(x)
    rel = ((y - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel < 2 ** -4
    with pytest.raises(ValueError):
        dense.Numerics(torch.float32, "int4")


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_tree_forward_is_each_path_forward(family):
    """A draft tree after its context (`check.tree_layout`): each node's
    logits are those of a causal forward over the context and the node's
    path, whatever its siblings and cousins hold."""
    from cosine_bench import check
    conf = dict(json.loads((DATA / f"tiny-{family}.json").read_text()))
    conf["dtypes"] = dict(conf["dtypes"], activations="float32")
    ref = weights.reference_module(conf["reference"])
    params = weights.build(torch, conf, conf["reference"], 31,
                           weights.TARGET_ROLE, "cpu")
    rng = np.random.default_rng(1)
    ctx = rng.integers(0, conf["vocab_size"], 20)
    parent = np.array([-1, 0, 1, -1, 3, 0, 5])
    nodes = rng.integers(0, conf["vocab_size"], len(parent))
    pos, allowed = check.tree_layout(parent, len(ctx))
    tt = torch.as_tensor(np.concatenate([ctx, nodes]))
    with torch.no_grad():
        tree = ref.forward(conf, params, tt, torch.arange(20, 27),
                           positions=torch.as_tensor(pos),
                           allowed=torch.as_tensor(allowed))
        for i in range(len(parent)):
            path, p = [], i
            while p >= 0:
                path.insert(0, int(nodes[p]))
                p = int(parent[p])
            seq = torch.as_tensor(np.concatenate([ctx, path]))
            want = ref.forward(conf, params, seq,
                               torch.tensor([len(seq) - 1]))[0]
            torch.testing.assert_close(tree[i], want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        check.tree_layout(np.array([-1, 2, 0]), 4)
