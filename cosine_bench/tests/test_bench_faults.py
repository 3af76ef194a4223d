"""The run's check sees a broken timed path: the tiny cell on the CPU,
with the program broken underneath, comes out not correct. One fault of
each kind a serving cell on one chip can have (it has no exchange
between chips): a step that returns its state unchanged, half of the
batch left out and filled with the mean of the rest, a token altered
where it is produced. With random drafters almost no draft token is
accepted, so the served tokens come from the commit forward's tail
logits (and the prefill's): the faults are planted in that step, where
the served tokens are made."""
import json

import numpy as np
import pytest

from repro_torch.core import tree as tree_mod
from repro_torch.serving.runner import ModelRunner
from tiny import DATA, run

#: the tiny configurations' targets, by name (the drafters run unbroken)
TARGETS = {json.loads((DATA / f"tiny-{f}.json").read_text())
           ["program"]["target"]["name"] for f in ("dense", "moe")}


def _state_unchanged(monkeypatch):
    orig = ModelRunner.extend_committed

    def frozen(self, rid_tokens):
        if self.cfg.name not in TARGETS:
            return orig(self, rid_tokens)
        cache = self.slots.cache
        leaves = [t for layer in cache["layers"] for sub in layer.values()
                  for t in sub.values()] + [cache["lengths"]]
        saved = [t.clone() for t in leaves]
        out = orig(self, rid_tokens)
        for t, s in zip(leaves, saved):
            t.copy_(s)
        return out

    monkeypatch.setattr(ModelRunner, "extend_committed", frozen)


def _half_batch(monkeypatch):
    orig = ModelRunner.extend_committed

    def half(self, rid_tokens):
        out = orig(self, rid_tokens)
        rids = sorted(out)
        if self.cfg.name in TARGETS and len(rids) >= 2:
            keep = (len(rids) + 1) // 2
            mean = sum(out[r] for r in rids[:keep]) / keep
            for r in rids[keep:]:
                out[r] = mean
        return out

    monkeypatch.setattr(ModelRunner, "extend_committed", half)


def _token_altered(monkeypatch):
    orig = tree_mod.accept_tree_greedy

    def altered(*a, **kw):
        acc, nodes, corr = orig(*a, **kw)
        return acc, nodes, (int(corr) + 1) % 512

    monkeypatch.setattr(tree_mod, "accept_tree_greedy", altered)


def _verify_logits_altered(monkeypatch):
    orig = ModelRunner.verify_device

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        if self.cfg.name not in TARGETS:
            return out
        return out.roll(1, dims=-1)

    monkeypatch.setattr(ModelRunner, "verify_device", altered)


def _tree_mask_causal(monkeypatch):
    orig = ModelRunner.verify_device

    def causal(self, rids, tokens, rel_pos, seg_mask):
        if self.cfg.name in TARGETS:
            G = seg_mask.shape[-1]
            seg_mask = np.broadcast_to(np.tril(np.ones((G, G), bool)),
                                       seg_mask.shape).copy()
        return orig(self, rids, tokens, rel_pos, seg_mask)

    monkeypatch.setattr(ModelRunner, "verify_device", causal)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered, _verify_logits_altered,
                                   _tree_mask_causal])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_fault_is_not_correct(monkeypatch, fault, family):
    fault(monkeypatch)
    res, err = run(family=family, seconds=1.0)
    assert not res["correct"], err[-2:]
    assert any(v["value"] > v["limit"] for v in res["compared"].values())
