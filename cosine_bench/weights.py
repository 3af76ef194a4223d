"""Seeded random weights for a configuration, made on the device.

A model's parameters are one float32 buffer drawn by a single
`torch.randn` call from a generator on the device, seeded from the run's
seed and the model's role; each leaf is a contiguous view into it (its
offset aligned to 256 bytes), shaped and laid out as the program reads
its parameter tree (the reference module's `param_specs`), then scaled
in place by its kind:

  dense   N(0, 1) / sqrt(fan-in), the fan-in being the input axis
  embed   N(0, 0.02)                 (embedding and output head)
  router  N(0, 0.02)
  norm    1 + N(0, 0.02)             (RMSNorm scales)
  bias    N(0, 0.02)

Biases and norm scales are random, not 0 and 1, so that a fault in
either path shows in the comparison. The same seed gives the same
tensors on the same device; the program and the reference are handed
the same trees, or the reference a second build from the same seed.
"""
from __future__ import annotations

import importlib
import math

import numpy as np

#: elements of float32 per 256 bytes: each leaf starts on such a boundary
ALIGN = 64

#: role numbers mixed into a model's seed: the target, then drafter i
TARGET_ROLE = 0


def drafter_role(i: int) -> int:
    """Seed role of drafter `i` (each drafter has weights of its own)."""
    return 1 + i


def model_seed(seed: int, role: int) -> int:
    """A 63-bit generator seed for (run seed, role): any whole seed, also
    past 32 bits, maps to a distinct stream."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), role])
    return int(state.generate_state(1, np.uint64)[0] >> 1)


def reference_module(name: str):
    """The plain reference `reference/<name>.py` of a model family."""
    return importlib.import_module(f"cosine_bench.reference.{name}")


def _set(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def build(torch, model: dict, family: str, seed: int, role: int, device):
    """The parameter tree of `model` (a configuration's published keys)
    for (seed, role) on `device`, float32."""
    specs = reference_module(family).param_specs(model)
    offsets, n = [], 0
    for _, shape, _ in specs:
        offsets.append(n)
        n += -(-math.prod(shape) // ALIGN) * ALIGN
    gen = torch.Generator(device=device)
    gen.manual_seed(model_seed(seed, role))
    buf = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    for (path, shape, kind), off in zip(specs, offsets):
        leaf = buf[off: off + math.prod(shape)].view(shape)
        if kind == "dense":
            leaf.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "norm":
            leaf.mul_(0.02).add_(1.0)
        else:
            leaf.mul_(0.02)
        _set(tree, path, leaf)
    return tree
