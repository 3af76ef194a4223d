"""Whether what the timed path served is right: the comparison that
decides `correct`.

Once the window has closed and the program's state is freed, the plain
reference (`reference/<family>.py`) reads two samples, both drawn from
the seed:

* delivered tokens: requests that were served tokens, always holding the
  one with the longest sequence; one causal forward over each prompt
  with its delivered tokens;
* verification rows: trees the window's verification forwards scored
  (`serve.VerifyRecorder`: one request of each acceptance walk), each
  with the token the program's logits rank first at every node; one
  forward over the request's prompt, its tokens delivered by then and
  the tree, each node seeing the context, its ancestors and itself at
  the context's length plus its depth (its parents as the tree gives
  them; mask and positions made here).

For each token, delivered or ranked first at a node, the gap by which
the reference's logit of it lies below the reference's best logit at its
position (0 where they agree). The two samples' gaps are pooled: the
run's numbers are the widest gap and the share of tokens that are not
the reference's first (a gap above 0), in %. Only greedy tokens are
served, so this is valid for every token. With random drafters a draft
is almost never accepted, so the delivered tokens come from the commit
forward's and the prefill's logits; the verification rows are what
holds the tree-verification forward (and kernel 1's tree-masked form)
to the reference.

Each configuration names the numbers it compares and their limits
(`correct.limits`), and its control (`correct.control`): the reference
itself in the place of the program, computed in the next precision below
one the configuration states ("tf32" products, or "fp8" activations; see
`reference/dense.py`), which at each position of the same prompts and
tokens reads the gap of the token that the lower precision ranks first.
The benchmark's runs do not compute the control (`control.py` does).
"""
from __future__ import annotations

import numpy as np

from cosine_bench import weights

#: served tokens the sample holds at least (where the run served so many)
SAMPLE_TOKENS = 400
#: seed stream of the sample's draw
SAMPLE_STREAM = 11
#: verification rows the check compares at most (a seeded draw of those
#: recorded)
VERIFY_SAMPLE = 16


def sample(sent, seed: int, min_tokens: int = SAMPLE_TOKENS):
    """Requests to compare: the one with the longest sequence, then a
    seeded draw of the others that were delivered tokens, until the
    sample holds `min_tokens` delivered tokens or every such request."""
    cands = [s for s in sent if s.tokens]
    if not cands:
        return []
    longest = max(cands, key=lambda s: len(s.spec.prompt) + len(s.tokens))
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), SAMPLE_STREAM])
    rest = [cands[i] for i in rng.permutation(len(cands))
            if cands[i] is not longest]
    out, n = [longest], len(longest.tokens)
    for s in rest:
        if n >= min_tokens:
            break
        out.append(s)
        n += len(s.tokens)
    return out


#: the numbers a configuration may compare, from the gaps of a sample
NUMBERS = {
    "max_logit_gap": lambda g: float(g.max()),
    "mismatch_share": lambda g: 100.0 * float((g > 0).mean()),
}


def gaps(torch, conf: dict, params, reqs, device, control=None):
    """Per request, the gaps (float32 numpy) of its delivered tokens
    below the reference's best logit; under `control` ("tf32", "fp8"),
    the reference's gaps of the tokens its lower-precision twin ranks
    first."""
    ref = weights.reference_module(conf["reference"])
    out = []
    with torch.no_grad():
        for s in reqs:
            toks = np.concatenate([s.spec.prompt, np.asarray(s.tokens[:-1],
                                                             np.int32)])
            P = len(s.spec.prompt)
            tt = torch.as_tensor(toks, dtype=torch.long, device=device)
            at = torch.arange(P - 1, P - 1 + len(s.tokens), device=device)
            lg = ref.forward(conf, params, tt, at)
            if control:
                pick = ref.forward(conf, params, tt, at,
                                   control=control).argmax(-1)
            else:
                pick = torch.as_tensor(s.tokens, dtype=torch.long,
                                       device=device)
            g = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
            out.append(g.cpu().numpy())
    return out


def sample_rows(rows, seed: int, n: int = VERIFY_SAMPLE):
    """A seeded draw of at most `n` of the recorded verification rows,
    in the order they were recorded."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), SAMPLE_STREAM,
                                 1])
    keep = sorted(rng.permutation(len(rows))[:n].tolist())
    return [rows[i] for i in keep]


def tree_layout(parent: np.ndarray, ctx: int):
    """(positions, allowed) of a forward over `ctx` context tokens and a
    tree of `len(parent)` nodes (parent -1: on the context) that the
    context precedes: the context causal at 0 .. ctx-1, each node at ctx
    plus its depth, seeing the context, its ancestors and itself."""
    n = len(parent)
    depth = np.zeros(n, np.int64)
    allowed = np.zeros((ctx + n, ctx + n), bool)
    allowed[:ctx, :ctx] = np.tril(np.ones((ctx, ctx), bool))
    allowed[ctx:, :ctx] = True
    for i in range(n):
        p = int(parent[i])
        if not -1 <= p < i:
            raise ValueError(f"node {i} has parent {p}: not a tree")
        depth[i] = 0 if p < 0 else depth[p] + 1
        allowed[ctx + i, ctx + i] = True
        while p >= 0:
            allowed[ctx + i, ctx + p] = True
            p = int(parent[p])
    pos = np.concatenate([np.arange(ctx), ctx + depth])
    return pos, allowed


def verify_gaps(torch, conf: dict, params, rows, by_rid, device,
                control=None):
    """Per verification row, the gaps (float32 numpy) of the tokens the
    program ranks first at its nodes below the reference's best logit;
    under `control`, of the tokens the reference's lower-precision twin
    ranks first. `by_rid` maps a request id to its `serve.Sent`."""
    ref = weights.reference_module(conf["reference"])
    out = []
    with torch.no_grad():
        for row in rows:
            s = by_rid[row["rid"]]
            if len(s.tokens) < row["n_gen"]:
                raise ValueError(f"request {row['rid']} was verified after "
                                 f"{row['n_gen']} tokens, delivered "
                                 f"{len(s.tokens)}")
            ctx = np.concatenate([s.spec.prompt, np.asarray(
                s.tokens[: row["n_gen"]], np.int32)]).astype(np.int64)
            pos, allowed = tree_layout(row["parent"], len(ctx))
            tt = torch.as_tensor(np.concatenate([ctx, row["tokens"]]),
                                 dtype=torch.long, device=device)
            kw = dict(positions=torch.as_tensor(pos, device=device),
                      allowed=torch.as_tensor(allowed, device=device))
            at = torch.arange(len(ctx), len(tt), device=device)
            lg = ref.forward(conf, params, tt, at, **kw)
            if control:
                pick = ref.forward(conf, params, tt, at, control=control,
                                   **kw).argmax(-1)
            else:
                pick = torch.as_tensor(row["picks"], dtype=torch.long,
                                       device=device)
            g = lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]
            out.append(g.cpu().numpy())
    return out


def reference_params(torch, conf: dict, seed: int, device):
    """The target's weights for the reference: made again from the seed
    (the program's copy is freed by now)."""
    return weights.build(torch, conf, conf["reference"], seed,
                         weights.TARGET_ROLE, device)


def compare(torch, conf: dict, sent, seed: int, device, rows=()):
    """(correct, {"delivered": tokens, "verified": node rows} compared,
    {name: {"value", "limit"}}) for the numbers the configuration
    compares, over the delivered tokens of `sent` and the verification
    `rows` (`serve.VerifyRecorder`); a run that delivered no token or
    recorded no verification row compares nothing and is not correct."""
    reqs = sample(sent, seed)
    rows = sample_rows(list(rows), seed)
    limits = conf["correct"]["limits"]
    if not reqs or not rows:
        return False, {"delivered": 0, "verified": 0}, {
            k: {"value": None, "limit": v} for k, v in limits.items()}
    params = reference_params(torch, conf, seed, device)
    gd = np.concatenate(gaps(torch, conf, params, reqs, device))
    gv = np.concatenate(verify_gaps(torch, conf, params, rows,
                                    {s.rid: s for s in sent}, device))
    del params
    g = np.concatenate([gd, gv])
    nums = {k: {"value": NUMBERS[k](g), "limit": v} for k, v in limits.items()}
    return (all(n["value"] <= n["limit"] for n in nums.values()),
            {"delivered": int(gd.size), "verified": int(gv.size),
             "delivered_max_gap": float(gd.max()),
             "verified_max_gap": float(gv.max())}, nums)
