"""Draft token trees (paper §4.2, Fig. 5).

CoSine's cooperative generation produces, per request, a *fused main chain*
(the confidence-selected token x*_i at each depth) plus per-drafter *side
candidates* at each depth (the tokens the other drafters proposed, kept as
single-node branches — Eq. (4)'s dual dependency). The tree is linearized
into fixed-size arrays for one batched tree-attention verification pass.

Tree construction/acceptance is host-side numpy (this is the central
node's orchestration logic — microseconds); verification compute is the
batched JAX `verify_chunk` with the ancestor mask.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class TokenTree:
    """Linearized draft tree for one request.

    tokens[i], parent[i] (-1 = attaches to committed context), depth[i],
    prob[i] (drafter confidence), drafter[i] (proposing drafter id;
    -1 = fused main chain).
    Node 0..chain_len-1 is the fused main chain (parent i-1).
    """
    tokens: np.ndarray
    parent: np.ndarray
    depth: np.ndarray
    prob: np.ndarray
    drafter: np.ndarray
    chain_len: int

    @property
    def n_nodes(self) -> int:
        return len(self.tokens)

    def ancestor_mask(self) -> np.ndarray:
        """mask[i, j] = True iff j is an ancestor of i or j == i."""
        n = self.n_nodes
        m = np.eye(n, dtype=bool)
        for i in range(n):
            p = self.parent[i]
            while p >= 0:
                m[i, p] = True
                p = self.parent[p]
        return m


def build_tree(chain_tokens, chain_probs, side_tokens, side_probs,
               side_drafters, tree_width: int, max_nodes: int = 0) -> TokenTree:
    """Build the CoSine draft tree.

    chain_tokens/probs: (K,) fused main chain.
    side_tokens/probs/drafters: (K, N) per-depth per-drafter proposals
      (entries equal to the fused token are deduplicated away).
    tree_width: max side branches kept per depth (by confidence).
    """
    K = len(chain_tokens)
    toks: List[int] = list(map(int, chain_tokens))
    parent = list(range(-1, K - 1))
    depth = list(range(K))
    prob = list(map(float, chain_probs))
    drafter = [-1] * K

    for d in range(K):
        cand = {}
        for n in range(side_tokens.shape[1]):
            p = float(side_probs[d, n])
            if p < 0.0:
                # masked column (non-participant / dropped chain): its
                # token is not a proposal and must not leak into the
                # tree, even when fewer than tree_width real candidates
                # exist at this depth
                continue
            t = int(side_tokens[d, n])
            if t == int(chain_tokens[d]):
                continue
            if t not in cand or p > cand[t][0]:
                cand[t] = (p, int(side_drafters[d, n]))
        best = sorted(cand.items(), key=lambda kv: -kv[1][0])[: tree_width]
        for t, (p, dr) in best:
            toks.append(t)
            parent.append(d - 1)       # branches off the fused prefix
            depth.append(d)
            prob.append(p)
            drafter.append(dr)

    if max_nodes and len(toks) > max_nodes:
        # keep the main chain + highest-confidence side nodes
        side_idx = sorted(range(K, len(toks)), key=lambda i: -prob[i])
        keep = sorted(list(range(K)) + side_idx[: max_nodes - K])
        remap = {old: new for new, old in enumerate(keep)}
        toks = [toks[i] for i in keep]
        parent = [remap.get(parent[i], parent[i]) if parent[i] >= 0 else -1
                  for i in keep]
        depth = [depth[i] for i in keep]
        prob = [prob[i] for i in keep]
        drafter = [drafter[i] for i in keep]

    return TokenTree(tokens=np.asarray(toks, np.int32),
                     parent=np.asarray(parent, np.int32),
                     depth=np.asarray(depth, np.int32),
                     prob=np.asarray(prob, np.float32),
                     drafter=np.asarray(drafter, np.int32),
                     chain_len=K)


def chain_tree(tokens, probs=None, drafter: int = -1) -> TokenTree:
    """Degenerate tree = a single chain (vanilla speculation / SSM verify)."""
    K = len(tokens)
    probs = np.ones(K, np.float32) if probs is None else np.asarray(probs)
    return TokenTree(tokens=np.asarray(tokens, np.int32),
                     parent=np.arange(-1, K - 1, dtype=np.int32),
                     depth=np.arange(K, dtype=np.int32),
                     prob=probs.astype(np.float32),
                     drafter=np.full(K, drafter, np.int32),
                     chain_len=K)


def pad_trees(trees: List[TokenTree], n_nodes: int):
    """Batch trees into fixed arrays for one verification pass.

    Returns dict of np arrays:
      tokens (B, M), rel_pos (B, M) = depth, mask (B, M, M), valid (B, M).
    """
    B = len(trees)
    M = n_nodes
    tokens = np.zeros((B, M), np.int32)
    rel = np.zeros((B, M), np.int32)
    mask = np.zeros((B, M, M), bool)
    valid = np.zeros((B, M), bool)
    for b, t in enumerate(trees):
        n = min(t.n_nodes, M)
        tokens[b, :n] = t.tokens[:n]
        rel[b, :n] = t.depth[:n]
        mask[b, :n, :n] = t.ancestor_mask()[:n, :n]
        valid[b, :n] = True
    # padded nodes attend only to themselves (keeps softmax well-formed)
    for b in range(B):
        for i in range(M):
            if not valid[b, i]:
                mask[b, i, i] = True
    return {"tokens": tokens, "rel_pos": rel, "mask": mask, "valid": valid}


def accept_tree_greedy(tree: TokenTree, node_argmax: np.ndarray,
                       entry_argmax: int):
    """Greedy acceptance walk over the tree.

    node_argmax[i]: target argmax token AFTER node i's path.
    entry_argmax: target argmax for the first position (before any node).
    Returns (accepted_tokens list, accepted_node_ids list, correction_token).
    The output committed tokens = accepted + [correction]; losslessness:
    identical to incremental greedy decoding of the target.
    """
    children = {}
    for i in range(tree.n_nodes):
        children.setdefault(int(tree.parent[i]), []).append(i)

    path, path_tokens = [], []
    want = int(entry_argmax)          # token the target wants at this point
    cur = -1
    while True:
        nxt = None
        for c in children.get(cur, []):
            if int(tree.tokens[c]) == want:
                nxt = c
                break
        if nxt is None:
            break
        path.append(nxt)
        path_tokens.append(int(tree.tokens[nxt]))
        want = int(node_argmax[nxt])
        cur = nxt
    return path_tokens, path, want
