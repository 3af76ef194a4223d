"""The port's `core/speculative.py` (torch tensors, `torch.Generator`)
against the reference's (JAX), on the cases of `tests/test_speculative.py`.

Deterministic cases (greedy verification, acceptance counts, the all-
rejected / all-accepted / identical-model edge cases, greedy sampling)
must agree with the reference output for output. The stochastic ones
draw from another generator than JAX's, so they are held in
distribution: the first output token's marginal is the target's, and so
is the second token's conditional, within ~4 sigma of a multinomial
proportion — the reference's own bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:     # declared dep; degrade so collection never hard-fails
    from _hypothesis_fallback import given, settings, st

from repro.core import speculative as J
from repro_torch.core import speculative as T


def _j(a):
    return np.asarray(a)


def test_verify_greedy_all_accept_and_reject_middle():
    draft = np.array([[3, 1, 2]])
    for mid in (1, 0):          # target agrees at position 1, or not
        tl = np.full((1, 3, 5), -10.0, np.float32)
        tl[0, 0, 3] = tl[0, 1, mid] = tl[0, 2, 2] = 0.0
        bonus = np.full((1, 5), -10.0, np.float32)
        bonus[0, 4] = 0.0
        out, n = T.verify_greedy(torch.tensor(draft), torch.tensor(tl),
                                 torch.tensor(bonus))
        jout, jn = J.verify_greedy(jnp.asarray(draft), jnp.asarray(tl),
                                   jnp.asarray(bonus))
        assert out.tolist() == _j(jout).tolist()
        assert n.tolist() == _j(jn).tolist() == ([4] if mid == 1 else [2])


@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 6), st.integers(2, 8))
@settings(max_examples=20, deadline=None)
def test_greedy_acceptance_counts_and_verify_match_reference(seed, G, V):
    rng = np.random.default_rng(seed)
    draft = rng.integers(0, V, (3, G))
    tgt = rng.integers(0, V, (3, G))
    n = T.accept_counts_greedy(torch.tensor(draft), torch.tensor(tgt))
    assert n.tolist() == _j(J.accept_counts_greedy(
        jnp.asarray(draft), jnp.asarray(tgt))).tolist()
    tl = rng.standard_normal((3, G, V)).astype(np.float32)
    bonus = rng.standard_normal((3, V)).astype(np.float32)
    out, n_out = T.verify_greedy(torch.tensor(draft), torch.tensor(tl),
                                 torch.tensor(bonus))
    jout, jn = J.verify_greedy(jnp.asarray(draft), jnp.asarray(tl),
                               jnp.asarray(bonus))
    assert out.tolist() == _j(jout).tolist()
    assert n_out.tolist() == _j(jn).tolist()


def _log_softmax(x):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(x), -1))


def test_rejection_all_rejected_rows_emit_one_residual_token():
    V, G, B = 4, 3, 5
    q_logits = np.array([0.0, -1e9, -1e9, -1e9], np.float32)
    p_logits = np.array([-1e9, -1e9, 0.0, -1e9], np.float32)
    draft = np.zeros((B, G), np.int32)
    draft_lp = np.broadcast_to(_log_softmax(q_logits), (B, G, V)).copy()
    tl = np.broadcast_to(p_logits, (B, G, V)).copy()
    bonus = np.broadcast_to(p_logits, (B, V)).copy()
    out, n = T.verify_rejection(torch.Generator().manual_seed(3),
                                torch.tensor(draft), torch.tensor(draft_lp),
                                torch.tensor(tl), torch.tensor(bonus))
    jout, jn = J.verify_rejection(jax.random.PRNGKey(3), jnp.asarray(draft),
                                  jnp.asarray(draft_lp), jnp.asarray(tl),
                                  jnp.asarray(bonus))
    assert n.tolist() == _j(jn).tolist() == [1] * B
    assert out[:, 0].tolist() == _j(jout)[:, 0].tolist() == [2] * B


@pytest.mark.parametrize("bonus_kind", ["one-hot", "same"])
def test_rejection_all_accepted_rows_match_reference(bonus_kind):
    """q == p and drafts at the mode accept every position; the extra
    token comes from the bonus distribution (one-hot: fixed; the
    identical-model case compares the accepted prefix and counts)."""
    V, G, B = 6, 4, 7
    logits = _j(jax.random.normal(jax.random.PRNGKey(4), (B, G, V)))
    q = _log_softmax(logits)
    draft = logits.argmax(-1)
    if bonus_kind == "one-hot":
        bonus = np.full((B, V), -1e9, np.float32)
        bonus[:, 5] = 0.0
    else:
        bonus = logits[:, -1]
    out, n = T.verify_rejection(torch.Generator().manual_seed(5),
                                torch.tensor(draft), torch.tensor(q),
                                torch.tensor(logits), torch.tensor(bonus))
    jout, jn = J.verify_rejection(jax.random.PRNGKey(5), jnp.asarray(draft),
                                  jnp.asarray(q), jnp.asarray(logits),
                                  jnp.asarray(bonus))
    assert n.tolist() == _j(jn).tolist() == [G + 1] * B
    assert out[:, :G].tolist() == _j(jout)[:, :G].tolist() == draft.tolist()
    if bonus_kind == "one-hot":
        assert out[:, G].tolist() == _j(jout)[:, G].tolist() == [5] * B


@pytest.mark.parametrize("seed", [0, 1])
def test_rejection_sampling_preserves_target_distribution(seed):
    """The first output token's marginal equals the target distribution,
    whatever the drafter (drafts sampled from q, batched N rows)."""
    V, G, N = 5, 3, 4000
    # the reference's inputs, made as it makes them
    kq, kp, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    q_logits = _j(jax.random.normal(kq, (V,)) * 1.5)
    p_logits = _j(jax.random.normal(kp, (V,)) * 1.5)
    gen = torch.Generator().manual_seed(seed)
    q = torch.softmax(torch.tensor(q_logits), -1)
    p = torch.softmax(torch.tensor(p_logits), -1).numpy()
    draft = torch.multinomial(q.expand(N * G, V), 1, replacement=True,
                              generator=gen).reshape(N, G)
    draft_lp = torch.log(q).expand(N, G, V)
    tl = torch.tensor(p_logits).expand(N, G, V)
    bonus = torch.tensor(p_logits).expand(N, V)
    out, _ = T.verify_rejection(gen, draft, draft_lp, tl, bonus)
    emp = np.bincount(out[:, 0].numpy(), minlength=V) / N
    tol = 4 * np.sqrt(p * (1 - p) / N) + 0.01
    assert np.all(np.abs(emp - p) < tol), (emp, p)


def test_rejection_conditional_next_token_matches_target():
    """Conditioned on the first draft token being accepted with value x,
    the second output token is distributed as the target's p2(. | x)."""
    V, N = 3, 6000
    # the reference's inputs, made as it makes them
    k1, k2, k3, k4, _ = jax.random.split(jax.random.PRNGKey(6), 5)
    q1 = jax.random.normal(k1, (V,))
    p1 = _j(q1 + 0.3 * jax.random.normal(k2, (V,)))
    Q2 = jax.random.normal(k3, (V, V))
    P2 = _j(Q2 + 0.3 * jax.random.normal(k4, (V, V)))
    q1, Q2 = _j(q1), _j(Q2)
    gen = torch.Generator().manual_seed(6)
    q1t, Q2t = torch.tensor(q1), torch.tensor(Q2)
    d0 = torch.multinomial(torch.softmax(q1t, -1).expand(N, V), 1,
                           generator=gen)[:, 0]
    d1 = torch.multinomial(torch.softmax(Q2t[d0], -1), 1, generator=gen)[:, 0]
    draft = torch.stack([d0, d1], 1)
    draft_lp = torch.stack([torch.log_softmax(q1t, -1).expand(N, V),
                            torch.log_softmax(Q2t[d0], -1)], 1)
    tl = torch.stack([torch.tensor(p1).expand(N, V), torch.tensor(P2)[d0]], 1)
    out, n = T.verify_rejection(gen, draft, draft_lp, tl,
                                torch.tensor(p1).expand(N, V))
    outs, ns = out.numpy(), n.numpy()
    p2 = torch.softmax(torch.tensor(P2), -1).numpy()
    for x in range(V):
        sel = (ns >= 2) & (outs[:, 0] == x)     # draft token x accepted
        n_x = int(sel.sum())
        assert n_x > 100, "acceptance too low for a meaningful check"
        emp = np.bincount(outs[sel, 1], minlength=V) / n_x
        tol = 4 * np.sqrt(p2[x] * (1 - p2[x]) / n_x) + 0.01
        assert np.all(np.abs(emp - p2[x]) < tol), (x, emp, p2[x])


def test_sample_from_logits():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((4, 3, 9)).astype(np.float32)
    greedy = T.sample_from_logits(None, torch.tensor(logits))
    assert greedy.tolist() == _j(J.sample_from_logits(
        jax.random.PRNGKey(0), jnp.asarray(logits))).tolist()
    # temperature > 0: a categorical draw per row, in distribution
    V, N = 4, 8000
    row = rng.standard_normal(V).astype(np.float32)
    draws = T.sample_from_logits(torch.Generator().manual_seed(1),
                                 torch.tensor(row).expand(N, V), 0.7)
    assert draws.shape == (N,)
    p = torch.softmax(torch.tensor(row) / 0.7, -1).numpy()
    emp = np.bincount(draws.numpy(), minlength=V) / N
    assert np.all(np.abs(emp - p) < 4 * np.sqrt(p * (1 - p) / N) + 0.01)
