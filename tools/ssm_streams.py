#!/usr/bin/env python3
"""Where two builds of the port commit different SSM/hybrid streams,
show what the target's logits say at the first differing token.

A diagnostic beside `chip_smoke.py`, off the served path. It serves
`chip_smoke.py`'s phases E (mamba2-130m) and F (jamba widths, 8 layers)
with the same weights, prompts and engine settings in several runs, each
in a process of its own:

  kernel        this checkout, the SSD scan on its CUDA kernel;
  plain         this checkout, the scan replaced by its plain f32 version
                (`ssd_chunked`) in the running process only;
  other-kernel  another checkout (`--other`, e.g. the parent commit from
                `git archive`), on its kernel;
  other-plain   that checkout with its plain f32 scan;
  chunk-kernel  this checkout, the kernel where its plan takes the chunk
                path (prefill chunks) and the plain scan elsewhere;
  rec-kernel    the kernel where its plan takes the recurrence, the plain
                scan on prefill chunks;
  plain-noise   the plain scan, with the y and the written state rows of
                every call the kernel's plan would give the chunk path
                scaled by 1 + e z, z standard normal (`--noise e ...`): the
                size of the chunk path's error without its kernel.

The kernel run of this checkout also holds every call against the plain
version on the same inputs (a copy of the state) and reports, per path, the
largest error of y and of the written state rows beside their largest
magnitude (padding rows, which share a scratch slot, left out).

Each run records per phase the forwards (calls of `model.apply`), engine
iterations, mean acceptance and the committed streams; the split noise
of each prompt: the largest logit difference at its last position
between one prefill of the prompt (the target's way) and a prefill of
all but its last token followed by one decode step (a drafter's way, one
token behind), on the run's scan; and it teacher-forces
every stream it knows (its own and the earlier runs') through one prefill
on its own scan: the top logits at each committed position. For each
request where two runs' streams differ, the report gives the first
differing token, both candidate tokens, and their logits under every
run's scan at the shared prefix. The two plain runs share no kernel, so
their agreement shows what the rest of the two checkouts computes.

    python3 tools/ssm_streams.py [--other DIR] [--noise E ...] [--out FILE]

`--cpu` runs the same steps at a few narrow layers on the CPU (the
kernel runs then also take the plain version): a try-out of the script,
not a measurement.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NEW_TOKENS, MAX_LEN, TOP = 32, 1024, 8
PROMPT_LENS = (64, 200, 350, 600)
PHASES = ("E", "F")


def _setup(small: bool):
    """Phase configs, weights' seeds and drafters as `chip_smoke.py`."""
    from repro_torch.configs import JAMBA_V0_1_52B, MAMBA2_130M
    mcfg = MAMBA2_130M
    hcfg = JAMBA_V0_1_52B.with_overrides(n_layers=8, moe=None)
    if small:
        mcfg = mcfg.with_overrides(n_layers=2, d_model=128, n_heads=4,
                                   n_kv_heads=4, vocab=512)
        hcfg = hcfg.with_overrides(d_model=256, n_heads=4, n_kv_heads=2,
                                   head_dim=64, d_ff=512, vocab=512)
    return {"E": (mcfg, 10, 11), "F": (hcfg, 20, None)}


def _real_rows(slot_idx, b):
    """Rows of a call whose slot no other row shares (padding rows
    share the scratch slot)."""
    if slot_idx is None:
        return list(range(b)), list(range(b))
    s = slot_idx.tolist()
    rows = [i for i in range(b) if s.count(s[i]) == 1]
    return rows, [s[i] for i in rows]


def _patch_plain(sd, keep=None, noise=0.0):
    """Route the mixer's scan to the plain f32 chunked scan (this
    process only), except calls whose plan takes path `keep`; with
    `noise`, perturb the chunk-path calls' results. Both checkouts'
    module layouts (only this one's has plans)."""
    import torch
    gen = torch.Generator().manual_seed(0)

    def jitter(t):
        z = torch.randn(t.shape, generator=gen).to(t.device)
        return t * (1 + noise * z)

    if hasattr(sd, "ssd_slots"):
        kernel = sd.ssd_slots

        def slots(x, dt, A, B, C, chunk, state, slot_idx=None, write=True):
            path = sd.plan_for(x, B).path
            if keep is not None and path == keep:
                return kernel(x, dt, A, B, C, chunk, state, slot_idx, write)
            y = sd.ssd_slots_plain(x, dt, A, B, C, chunk, state, slot_idx,
                                   write)
            if noise and path == "chunk":
                y = jitter(y.float()).to(y.dtype)
                if write and state is not None:
                    _, slots_ = _real_rows(slot_idx, x.shape[0])
                    state[slots_] = jitter(state[slots_])
            return y
        sd.ssd_slots = slots
    sd.ssd = lambda x, dt, A, B, C, chunk, init=None: sd.ssd_chunked(
        x, dt, A, B, C, chunk, init)


def _patch_check(sd, errors):
    """Hold every kernel call against the plain version on a copy of
    the state; `errors[path]` collects the largest errors and values."""
    kernel = sd.ssd_slots

    def slots(x, dt, A, B, C, chunk, state, slot_idx=None, write=True):
        path = sd.plan_for(x, B).path
        before = None if state is None else state.clone()
        y = kernel(x, dt, A, B, C, chunk, state, slot_idx, write)
        yp = sd.ssd_slots_plain(x, dt, A, B, C, chunk, before, slot_idx,
                                write)
        rows, slots_ = _real_rows(slot_idx, x.shape[0])
        e = errors.setdefault(path, dict(calls=0, y_err=0.0, y_max=0.0,
                                         state_err=0.0, state_max=0.0))
        e["calls"] += 1
        yk, yp = y[rows].float(), yp[rows].float()
        e["y_err"] = max(e["y_err"], float((yk - yp).abs().max()))
        e["y_max"] = max(e["y_max"], float(yp.abs().max()))
        if write and state is not None:
            sk, sp = state[slots_], before[slots_]
            e["state_err"] = max(e["state_err"],
                                 float((sk - sp).abs().max()))
            e["state_max"] = max(e["state_max"], float(sp.abs().max()))
        return y
    sd.ssd_slots = slots


def worker(a) -> int:
    sys.path.insert(0, a.src)
    import numpy as np
    import torch
    from repro_torch.config import CoSineConfig
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models import model as M
    from repro_torch.serving.engine import SpeculativeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errors = {}
    if a.scan != "kernel":
        _patch_plain(sd, {"plain": None, "plain-noise": None,
                          "chunk-kernel": "chunk", "rec-kernel": "rec"}[
                              a.scan],
                     a.noise[0] if a.scan == "plain-noise" else 0.0)
    elif hasattr(sd, "ssd_slots"):
        _patch_check(sd, errors)
    dev = "cpu" if a.cpu else "cuda"
    known = json.loads(Path(a.teacher).read_text()) if a.teacher else {}
    lens = (9, 30, 51, 70) if a.cpu else PROMPT_LENS
    n_new = 8 if a.cpu else NEW_TOKENS
    out = {"src": a.src, "scan": a.scan, "phases": {}}
    orig_apply = M.apply
    forwards = [0]

    def apply(*args, **kw):
        forwards[0] += 1
        return orig_apply(*args, **kw)

    for ph, (cfg, seed_t, seed_d) in _setup(a.cpu).items():
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens]
        tp = M.init_params(cfg, seed=seed_t, device=dev)
        drafters = ([(cfg, tp, "m0"),
                     (cfg, M.init_params(cfg, seed=seed_d, device=dev), "m1")]
                    if seed_d is not None
                    else [(cfg, tp, f"h{i}") for i in range(2)])
        cos = CoSineConfig(n_drafters=2, drafters_per_request=2,
                           tree_width=2, paged_pool=False, page_size=64,
                           pool_pages=16)
        eng = SpeculativeEngine((cfg, tp), drafters, cos, strategy="cosine",
                                max_len=MAX_LEN, seed=0, device=dev)
        reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
        forwards[0] = 0
        M.apply = apply
        t0 = time.perf_counter()
        errors.clear()
        stats = eng.run()
        wall = time.perf_counter() - t0
        M.apply = orig_apply
        checked = {k: dict(v) for k, v in errors.items()}
        eng.backend.shutdown()
        streams = [list(map(int, r.generated)) for r in reqs]
        noise = []
        for p in prompts:
            c1 = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                              device=dev)
            c2 = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                              device=dev)
            with torch.no_grad():
                whole = M.prefill(tp, cfg, torch.tensor([p], device=dev),
                                  c1)[0][0, -1, : cfg.vocab]
                _, c2, _ = M.prefill(tp, cfg, torch.tensor([p[:-1]],
                                                           device=dev), c2)
                step = M.decode_step(tp, cfg, torch.tensor([[p[-1]]],
                                                           device=dev),
                                     c2)[0][0, 0, : cfg.vocab]
            noise.append(float((whole.float() - step.float()).abs().max()))
        runs = dict(known.get(ph, {}))
        runs[a.name] = streams
        # teacher-forced top logits of every known stream on this scan
        tf = {}
        for name, sts in runs.items():
            rows = []
            for p, toks in zip(prompts, sts):
                c = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32,
                                 device=dev)
                with torch.no_grad():
                    lg, _, _ = M.prefill(
                        tp, cfg, torch.tensor([p + toks], device=dev), c)
                lg = lg[0, len(p) - 1: len(p) - 1 + len(toks), : cfg.vocab]
                v, i = torch.topk(lg.float(), TOP, dim=-1)
                rows.append([list(zip(ii, vv)) for ii, vv in
                             zip(i.tolist(), v.tolist())])
            tf[name] = rows
        out["phases"][ph] = dict(
            forwards=forwards[0], iterations=len(stats.records),
            mean_acceptance=stats.mean_acceptance, wall_s=wall,
            split_noise=noise, checked=checked, streams=streams,
            teacher_forced=tf)
        print(f"[{a.name}] phase {ph}: {forwards[0]} forwards, "
              f"{len(stats.records)} iterations, mean acceptance "
              f"{stats.mean_acceptance:.3f}, split noise "
              f"{[round(n, 5) for n in noise]}", flush=True)
        del eng, tp, drafters
        if dev == "cuda":
            torch.cuda.empty_cache()
    Path(a.out).write_text(json.dumps(out))
    return 0


def _logit(top, tok):
    """Logit of `tok` in one position's top list, or None."""
    for i, v in top:
        if i == tok:
            return v
    return None


def report(results) -> dict:
    """First differing token of each pair of runs, with both candidates'
    logits under every run's scan at the shared prefix."""
    names = list(results)
    rows = []
    for ph in PHASES:
        for ia, ra in enumerate(names):
            for rb in names[ia + 1:]:
                sa = results[ra]["phases"][ph]["streams"]
                sb = results[rb]["phases"][ph]["streams"]
                for r, (ta, tb) in enumerate(zip(sa, sb)):
                    k = next((i for i, (x, y) in enumerate(zip(ta, tb))
                              if x != y), None)
                    if k is None:
                        continue
                    under = {}
                    for rn in names:
                        tfs = results[rn]["phases"][ph]["teacher_forced"]
                        # the prefix up to k is shared: any stream with
                        # it gives the logits at k
                        src = ra if ra in tfs else rb if rb in tfs else None
                        if src is None:
                            continue
                        top = tfs[src][r][k]
                        la, lb = _logit(top, ta[k]), _logit(top, tb[k])
                        under[rn] = dict(
                            top1=top[0][0], top1_logit=top[0][1],
                            logit_a=la, logit_b=lb,
                            gap_a_minus_b=(None if la is None or lb is None
                                           else la - lb))
                    rows.append(dict(phase=ph, request=r, runs=[ra, rb],
                                     token=k, a=ta[k], b=tb[k], under=under))
    return dict(divergences=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout's root to compare")
    ap.add_argument("--out", default=str(ROOT / "build" /
                                         "ssm_streams.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="narrow widths and few layers on the CPU (a "
                         "try-out)")
    ap.add_argument("--noise", type=float, nargs="*", default=[],
                    help="also plain runs with chunk-path results "
                         "perturbed by these relative sizes")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--scan", choices=("kernel", "plain", "chunk-kernel",
                                       "rec-kernel", "plain-noise"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--teacher", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        return worker(a)
    if not a.cpu:
        import torch
        if not torch.cuda.is_available():
            print("ssm_streams: no CUDA device", file=sys.stderr)
            return 2
    runs = [(m, ROOT, m) for m in ("kernel", "plain", "chunk-kernel",
                                   "rec-kernel")]
    runs += [(f"plain-noise {e:g}", ROOT, f"plain-noise {e!r}")
             for e in (a.noise if not a.worker else [])]
    if a.other:
        other = Path(a.other).resolve()
        runs += [("other-kernel", other, "kernel"),
                 ("other-plain", other, "plain")]
    results, known = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, root, scan in runs:
            teacher = Path(tmp) / "teacher.json"
            teacher.write_text(json.dumps(known))
            out = Path(tmp) / f"{name}.json"
            scan, _, eps = scan.partition(" ")
            cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
                   "--src", str(root / "src"), "--scan", scan, "--name",
                   name, "--teacher", str(teacher), "--out", str(out),
                   ] + (["--cpu"] if a.cpu else [])
            cmd += ["--noise", eps] if eps else []
            # the other checkout's modules only: no PYTHONPATH of ours
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            rc = subprocess.run(cmd, cwd=root, env=env).returncode
            if rc != 0:
                print(f"ssm_streams: run {name} failed ({rc})",
                      file=sys.stderr)
                return 1
            results[name] = json.loads(out.read_text())
            for ph, d in results[name]["phases"].items():
                known.setdefault(ph, {})[name] = d["streams"]
    rep = report(results)
    for name, res in results.items():
        for ph, d in res["phases"].items():
            print(f"{name} phase {ph}: forwards {d['forwards']}, iterations "
                  f"{d['iterations']}, mean acceptance "
                  f"{d['mean_acceptance']:.3f}, wall {d['wall_s']:.2f} s, "
                  f"split noise by prompt "
                  f"{' '.join(f'{n:.4g}' for n in d['split_noise'])}")
            for path, e in d["checked"].items():
                print(f"{name} phase {ph} {path} calls vs plain: {e}")
    for d in rep["divergences"]:
        ra, rb = d["runs"]
        cells = "; ".join(
            f"{rn}: a-b {u['gap_a_minus_b']:+.4g}" if u["gap_a_minus_b"]
            is not None else f"{rn}: a {u['logit_a']} b {u['logit_b']} "
            f"(one outside the top {TOP})" for rn, u in d["under"].items())
        print(f"phase {d['phase']} request {d['request']}: {ra} vs {rb} "
              f"first differ at token {d['token']} (a={d['a']}, "
              f"b={d['b']}); logit gap {cells}")
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(dict(
        runs={n: {ph: {k: v for k, v in d.items() if k != "teacher_forced"}
                  for ph, d in r["phases"].items()}
              for n, r in results.items()}, **rep)))
    print(f"ssm_streams: wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
