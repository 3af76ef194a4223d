#!/usr/bin/env python3
"""Where phase R's bf16 gradient error comes from, on one card.

`chip_smoke.py`'s phase R holds one training step of mamba2-130m (full
width, phase R's weights and first batch) with every SSD scan on the
kernel (`SSDScanFunction`: the kernel forward, `ssd_grad` backward)
against the plain oracle (autograd through `ssd_chunked`). At bf16
activations the gradients differ by a few hundredths of a leaf's norm.
This script measures, with `chip_smoke.py`'s own `grad_check` pieces,
the same error under three pairings of routes, at depths cut from 24
layers (width unchanged; `DEPTHS`), at f32 and bf16 activations:

  kernel-128 vs plain-128  the gated pairing (the config's chunk, 128);
  plain-64 vs plain-128    two plain routes that differ only in where
                           their f32 sums split the sequence (chunks of
                           64 against 128): the size of an error that no
                           kernel makes;
  kernel-64 vs plain-64    the kernel (its own 64-token chunks) with
                           `ssd_grad` at chunk 64 against the plain route
                           at 64: what is left when the chunk lengths
                           agree.

For each it prints and records the largest relative error over leaves,
by max and by norm (`chip_smoke.py::grad_error`), and the leaf that
gives the norm's. Needs a CUDA card; the report also goes to
`chiprun_out/grad_margin.json`.

    python3 tools/grad_margin.py
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
#: the depths mamba2-130m is cut to (its 24 layers the last)
DEPTHS = (1, 2, 4, 8, 12, 24)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leaf_names(tree) -> list:
    """'/'-joined paths of `tree`'s leaves, in `tree_leaves`' order."""
    from repro_torch.distributed.sharding import map_with_path
    from repro_torch.optim.optimizers import tree_leaves
    return tree_leaves(map_with_path(
        lambda path, t: "/".join(map(str, path)), tree))


def grads_of(smoke, attn, fa, cfg, params, tokens, plain: bool):
    """(loss, gradient leaves) of one step, on the kernels or (`plain`)
    through the plain oracle."""
    if not plain:
        return smoke.loss_and_grads(cfg, params, tokens)
    with smoke.plain_oracle(attn, fa):
        return smoke.loss_and_grads(cfg, params, tokens)


def worst_leaf(got, want, names) -> tuple:
    """(name, ||got - want|| / ||want||) of the leaf where it is
    largest."""
    errs = [(float((g - w).float().reshape(-1).norm())
             / max(float(w.float().reshape(-1).norm()), 1e-30), n)
            for g, w, n in zip(got, want, names)]
    err, name = max(errs)
    return name, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("grad_margin: no CUDA device", file=sys.stderr)
        return 2
    smoke = _load_smoke()
    from repro_torch.configs import MAMBA2_130M
    from repro_torch.data.synthetic import SyntheticCorpus, token_batches
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = smoke.nvidia_smi_line()
    print(smi, flush=True)
    first = next(token_batches(SyntheticCorpus(smoke.TRAIN_VOCAB, seed=0),
                               smoke.TRAIN_DOMAIN, smoke.TRAIN_BATCH,
                               smoke.TRAIN_SEQ, 1))
    tokens = torch.as_tensor(first, device=dev)
    rows = []
    t0 = time.perf_counter()
    for depth in DEPTHS:
        base = MAMBA2_130M.with_overrides(n_layers=depth)
        # phase R's weights (seed 42), cut to `depth` layers
        params = M.init_params(base, seed=42, device=dev)
        for dtype in ("float32", "bfloat16"):
            c128 = base.with_overrides(dtype=dtype)
            c64 = c128.with_overrides(
                ssm=dataclasses.replace(c128.ssm, chunk_size=64))
            sd.LAUNCHES = 0
            loss_k128, g_k128 = grads_of(smoke, attn, fa, c128, params,
                                         tokens, False)
            launches = sd.LAUNCHES
            loss_p128, g_p128 = grads_of(smoke, attn, fa, c128, params,
                                         tokens, True)
            loss_p64, g_p64 = grads_of(smoke, attn, fa, c64, params,
                                       tokens, True)
            loss_k64, g_k64 = grads_of(smoke, attn, fa, c64, params,
                                       tokens, False)
            if sd.LAUNCHES != 2 * launches or launches != depth:
                smoke.fail(f"depth {depth}: {sd.LAUNCHES} SSD launches, "
                           f"{depth} a kernel step expected")
            names = leaf_names(params)
            pairs = {"kernel-128 vs plain-128": (g_k128, g_p128,
                                                 loss_k128, loss_p128),
                     "plain-64 vs plain-128": (g_p64, g_p128, loss_p64,
                                               loss_p128),
                     "kernel-64 vs plain-64": (g_k64, g_p64, loss_k64,
                                               loss_p64)}
            for pair, (got, want, lg, lw) in pairs.items():
                err = smoke.grad_error(got, want)
                leaf, l2 = worst_leaf(got, want, names)
                rows.append(dict(depth=depth, dtype=dtype, pair=pair,
                                 max=err["max"], l2=err["l2"],
                                 worst_leaf=leaf, worst_leaf_l2=l2,
                                 loss_got=lg, loss_want=lw))
                print(f"depth {depth:2d} {dtype:8s} {pair:24s} max "
                      f"{err['max']:.4g} l2 {err['l2']:.4g} (worst leaf "
                      f"{leaf}) loss {lg:.6f} vs {lw:.6f}", flush=True)
            del g_k128, g_p128, g_p64, g_k64
        del params
        torch.cuda.empty_cache()
    out = dict(device=smi, model=MAMBA2_130M.name, batch=smoke.TRAIN_BATCH,
               tokens=smoke.TRAIN_SEQ + 1, rows=rows,
               seconds=time.perf_counter() - t0)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "grad_margin.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
