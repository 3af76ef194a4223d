"""The traffic generator: a seed fixes the requests; every seed serves the
same sizes."""
import numpy as np
import pytest

from cosine_bench import traffic

DOMAINS = ["d0", "d1", "d2", "d3"]
#: a mix whose lengths spread (the committed mixes give every request the
#: same lengths)
SPREAD = {"clients": 8, "requests": 400,
          "prompt": {"median": 256, "sigma": 0.8, "min": 32, "max": 1024},
          "output": {"median": 96, "sigma": 0.7, "min": 16, "max": 384},
          "domains": {"zipf": 1.0}}


def _sizes(plan):
    return sorted((len(r.prompt), r.max_new) for r in plan.requests)


def test_same_seed_same_requests():
    mix = traffic.load("chat16")
    a = traffic.generate(mix, 2 ** 31 + 9, 151936, DOMAINS)
    b = traffic.generate(mix, 2 ** 31 + 9, 151936, DOMAINS)
    assert len(a.requests) == mix["requests"]
    for x, y in zip(a.requests, b.requests):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new, x.domain) == (y.max_new, y.domain)


def test_seeds_share_sizes_in_another_order():
    mix = SPREAD
    a = traffic.generate(mix, 1, 151936, DOMAINS)
    b = traffic.generate(mix, 2, 151936, DOMAINS)
    assert _sizes(a) == _sizes(b)
    assert [len(r.prompt) for r in a.requests] != \
        [len(r.prompt) for r in b.requests]
    assert sorted(r.domain for r in a.requests) == \
        sorted(r.domain for r in b.requests)


def test_in_flight_sizes_do_not_depend_on_the_seed():
    """Each block of `clients` consecutive requests holds the same sizes
    for every seed: the requests in flight are alike."""
    mix = traffic.load("chat16")
    k = mix["clients"]
    a = traffic.generate(mix, 11, 151936, DOMAINS).requests
    b = traffic.generate(mix, 12, 151936, DOMAINS).requests
    for i in range(0, len(a), k):
        assert sorted((len(r.prompt), r.max_new) for r in a[i: i + k]) == \
            sorted((len(r.prompt), r.max_new) for r in b[i: i + k])
    assert [len(r.prompt) for r in a[:k]] != [len(r.prompt) for r in b[:k]]


def test_lengths_follow_the_mix():
    mix = SPREAD
    p = traffic.generate(mix, 3, 151936, DOMAINS)
    rest = p.requests[mix["clients"]:]
    pl = np.array([len(r.prompt) for r in rest])
    ol = np.array([r.max_new for r in rest])
    assert abs(np.median(pl) - 256) <= 8 and abs(np.median(ol) - 96) <= 4
    assert pl.min() >= 32 and pl.max() <= 1024
    assert ol.min() >= 16 and ol.max() <= 384
    assert all(0 <= int(r.prompt.max()) < 151936 for r in p.requests)
    counts = [sum(r.domain == d for r in p.requests) for d in DOMAINS]
    assert counts == sorted(counts, reverse=True) and counts[0] > counts[-1]


@pytest.mark.parametrize("name", ["chat16"])
def test_clients_start_out_of_phase(name):
    """Each client's first request is joined part way: the tokens it
    still waits for spread evenly over its output length, and its prompt
    carries the ones served before."""
    mix = traffic.load(name)
    k, P, L = mix["clients"], mix["prompt"]["median"], mix["output"]["median"]
    p = traffic.generate(mix, 2 ** 31 + 5, 151936, DOMAINS)
    head, rest = p.requests[:k], p.requests[k:]
    left = sorted(r.max_new for r in head)
    assert left == sorted(max(1, round(L * (i + 0.5) / k)) for i in range(k))
    assert all(len(r.prompt) + r.max_new == P + L for r in head)
    assert all((len(r.prompt), r.max_new) == (P, L) for r in rest)
