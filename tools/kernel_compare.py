#!/usr/bin/env python3
"""Time this checkout's kernels beside another checkout's on one card.

`chip_smoke.py` times each kernel of the port at the serving shapes in
one run of one tree. To compare two trees (a change and its parent) the
numbers must come from one card in one call, in turns. This script runs
each tree's own `chip_smoke.py` kernel phases in a process of its own,
in the order other, this, this, other, and prints per shape both trees'
times (the mean of their two runs) and their ratio:

  kernels  kernels 1 and 2 (f32 / bf16 K/V), their latent form (MLA),
           the int8 GEMV at phase D's default row counts and the SSD
           scan (`kernel_phase`, `paged_kernel_phase`, `mla_kernel_phase`,
           `int8_kernel_phase`, `ssd_kernel_phase`);
  int8kv   the int8 K/V forms of kernels 1 and 2 (`int8kv_kernel_phase`;
           a tree that serves int8 K/V at head width 120 times those
           shapes too, which the other tree may lack);
  d120     kernels 1 and 2 at head width 120, phase M's shapes
           (`d120_kernel_phase`);
  noncausal  kernel 1's non-causal reads: cross reads and the Whisper
           encoder (`noncausal_kernel_phase`);
  crossover  (this tree only) kernels 1 and 2's two forms of f32 / bf16
           K/V, the GQA form and the many-row form, each forced at
           every R of `CROSSOVER_R` (B 4, Hkv 8, a commit-like causal
           read over 630 held keys; D 64, 120, 128): where the many-row
           form starts to win, `ops.py::R_MMA`;
  profile  a `torch.profiler` window over 5 iterations of phase K (int8
           KV caches) on each tree's package, measured by this checkout's
           `profile_int8kv_window`: the int8 forms' share of the device's
           busy time;
  host     the host cost of one call (microseconds, enqueue only: the
           median of `HOST_REPS` rounds of `chip_smoke.py::_host_us`) of
           the wrappers as the serving path calls them at decode:
           `attend_partial` (kernel 1, phase A's drafter decode),
           `blocked_attention` (a self-contained read, the target's
           10-node verification segment), `quantize.qdot` on int8
           weights (kernel 3, qwen2-0.5b's wq at 4 rows) and `ssd_slots`
           (the mamba2 decode of phase E);
  sass     the SASS of every kernel both trees' attention libraries
           (kernels 1 and 2) define under one (mangled) name, compared
           function by function (`cuobjdump -sass`): which compiled to
           the same instructions.

    python3 tools/kernel_compare.py --other DIR [--phases int8kv,...]

DIR is another checkout with its own `chip_smoke.py` and `src/` (e.g. the
parent commit unpacked by `git archive` into a git-ignored directory);
each tree builds its kernels into its own `build/kernels/`. Needs a CUDA
card; the report also goes to `chiprun_out/kernel_compare.json`.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("kernels", "int8kv", "d120", "noncausal", "crossover", "profile",
          "host", "sass")
#: the query rows a (request, KV head) of the crossover phase
CROSSOVER_R = (4, 8, 12, 16, 17, 20, 24, 32, 40, 64, 128, 512, 2048)
#: the row counts `chip_smoke.py` gives the int8 GEMV when phase D has
#: not run (its defaults)
GEMV_ROWS = (4, 24, 512)
#: rounds of the host phase, each `HOST_CALLS` calls
HOST_REPS, HOST_CALLS = 7, 500


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_keys(row):
    """A row's measured times: `ms` and every other number named *_ms
    (yardsticks, the plain version, V out of K)."""
    return {k: v for k, v in row.items()
            if k.endswith("ms") and isinstance(v, (int, float))}


def _sass(lib: Path) -> dict:
    """{mangled function name: its SASS instructions} of a library (the
    instruction text without its address comments)."""
    cuobjdump = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(cuobjdump if cuobjdump.exists()
                              else "cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and "/*" in line:
            text = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line).strip()
            text = re.sub(r"/\*.*?\*/", "", text).strip()
            if text:
                funcs[name].append(text)
    return {k: "\n".join(v) for k, v in funcs.items()}


def crossover(torch, fa, pa, smoke):
    """Both forms of kernels 1 and 2 for f32 / bf16 K/V at D 64, 120 and
    128 over R = T x G query rows (G 4 where 4 divides R, else 1), B 4
    requests holding 630 keys each in 64-key pages (kernel 1 on the same
    keys as a slot pool), Hkv 8, causal with the rows at the end of the
    held keys: each form forced through `R_MMA` (the plan is re-made for
    it), timed by `chip_smoke._graph_ms`. Returns rows (D, dtype, R,
    partial_ms, many_ms, paged_partial_ms, paged_many_ms)."""
    saved = fa.R_MMA
    gen = torch.Generator(device="cuda").manual_seed(22)
    B, H, held, ps = 4, 8, 630, 64
    rows = []
    try:
        for D in (64, 120, 128):
            for dtype in (torch.float32, torch.bfloat16):
                k = torch.randn((9, 1024, H, D), generator=gen,
                                device="cuda").to(dtype)
                v = torch.randn((9, 1024, H, D), generator=gen,
                                device="cuda").to(dtype)
                kpos = torch.full((9, 1024), -1, dtype=torch.int32,
                                  device="cuda")
                kpos[1:5, :held] = torch.arange(held, dtype=torch.int32,
                                                device="cuda")
                sidx = torch.arange(1, 5, dtype=torch.int32, device="cuda")
                # the same keys on pages: request b's page j is 16 b + j
                pk = k[1:5].reshape(B * 16, ps, H, D)
                pv = v[1:5].reshape(B * 16, ps, H, D)
                ppos = kpos[1:5].reshape(B * 16, ps)
                tbl = torch.arange(B * 16, dtype=torch.int32,
                                   device="cuda").reshape(B, 16)
                for R in CROSSOVER_R:
                    G = 4 if R % 4 == 0 else 1
                    T = R // G
                    q = torch.randn((B, T, H, G, D), generator=gen,
                                    device="cuda")
                    qp = (held - T + torch.arange(
                        T, dtype=torch.int32, device="cuda")).repeat(B, 1)
                    row = dict(D=D, dtype=str(dtype).split(".")[-1],
                               R=T * G)
                    for name, r_mma in (("partial", 1 << 30), ("many", 1)):
                        fa.R_MMA = r_mma
                        fa.plan_splits.cache_clear()
                        row[f"{name}_ms"] = smoke._graph_ms(
                            torch, lambda: fa.attend_partial(
                                q, k, v, qp, kpos, scale=D ** -0.5,
                                slot_idx=sidx))
                        row[f"paged_{name}_ms"] = smoke._graph_ms(
                            torch, lambda: pa.paged_attend_partial(
                                q, pk, pv, qp, ppos, tbl, scale=D ** -0.5))
                    print(f"crossover D {D} {row['dtype']} R {row['R']}: "
                          f"partial {row['partial_ms']:.4f} many "
                          f"{row['many_ms']:.4f} ms (many/partial "
                          f"{row['many_ms'] / row['partial_ms']:.3f}); "
                          f"paged {row['paged_partial_ms']:.4f} / "
                          f"{row['paged_many_ms']:.4f}", flush=True)
                    rows.append(row)
                del k, v, pk, pv
    finally:
        fa.R_MMA = saved
        fa.plan_splits.cache_clear()
    return rows


def host_costs(torch, fa, attn, quantize, sd, own) -> dict:
    """{wrapper: [host us per call of each round]} at the serving path's
    decode shapes (see the module's `host`)."""
    gen = torch.Generator(device="cuda").manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    # phase A's drafter decode over the 9-slot pool, f32 K/V
    lens = torch.tensor([0, 80, 230, 380, 630, 0, 0, 0, 0], device="cuda")
    k_pos = torch.where(
        torch.arange(own.MAX_LEN, device="cuda")[None] < lens[:, None],
        torch.arange(own.MAX_LEN, device="cuda")[None], -1).to(torch.int32)
    slot_idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    q_pos = (lens[slot_idx.long()] - 1)[:, None].to(torch.int32)
    q, k, v = rnd(4, 1, 2, 7, 64), rnd(9, own.MAX_LEN, 2, 64), rnd(
        9, own.MAX_LEN, 2, 64)
    # the target's verification segment: 10 tree nodes, Hkv 20, D 128
    sq, sk, sv = rnd(4, 10, 20, 1, 128), rnd(4, 10, 20, 128), rnd(
        4, 10, 20, 128)
    s_pos = torch.arange(10, dtype=torch.int32, device="cuda").expand(4, 10)
    tree = own._tree_mask(torch).expand(4, 10, 10).contiguous()
    # qwen2-0.5b's wq quantized, 4 decode rows
    x = rnd(4, 896).to(torch.bfloat16)
    w8 = quantize.quantize_weight(rnd(896, 896))
    # the mamba2 decode of phase E
    xs, dt, A, Bm, Cm, _ = own._ssd_inputs(torch, gen, 4, 1, 24, 64, 1, 128)
    pool = torch.zeros((16, 24, 64, 128), device="cuda")
    idx = torch.tensor([5, 11, 2, 8], dtype=torch.int32, device="cuda")
    calls = {
        "attend_partial": lambda: fa.attend_partial(
            q, k, v, q_pos, k_pos, scale=64 ** -0.5, slot_idx=slot_idx),
        "blocked_attention": lambda: attn.blocked_attention(
            sq, sk, sv, s_pos, s_pos, scale=128 ** -0.5, extra_mask=tree),
        "int8_qdot": lambda: quantize.qdot(x, w8),
        "ssd_slots": lambda: sd.ssd_slots(xs, dt, A, Bm, Cm, 128, pool,
                                          idx),
    }
    return {name: [own._host_us(torch, fn, n=HOST_CALLS)
                   for _ in range(HOST_REPS)] for name, fn in calls.items()}


def worker(tree: Path, phases, out: Path) -> None:
    """One tree's run: its own `chip_smoke.py` phases on its own package."""
    import numpy as np
    import torch

    smoke = _load(tree / "chip_smoke.py", "tree_smoke")
    own = _load(ROOT / "chip_smoke.py", "own_smoke")
    # both modules put their tree's src first: the package is the tree's
    for p in (str(ROOT / "src"), str(tree / "src")):
        while p in sys.path:
            sys.path.remove(p)
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.int8_gemv import ops as ig
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models import attention as attn
    from repro_torch.models import quantize
    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve()), \
        fa.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    libraries = [fa.LIBRARY, pa.LIBRARY, ig.LIBRARY, sd.LIBRARY]
    build.build_all(libraries)
    res = dict(tree=str(tree), device=smoke.nvidia_smi_line(), rows={})

    def keep(group, rows):
        for r in rows:
            res["rows"][f"{group}/{r['name']}"] = _time_keys(r)

    if "kernels" in phases:
        keep("kernel1", smoke.kernel_phase(torch, fa)[0])
        keep("kernel2", smoke.paged_kernel_phase(torch, fa, pa))
        fam, pam, _ = smoke.mla_kernel_phase(torch, fa, pa)
        keep("kernel1-mla", fam)
        keep("kernel2-mla", pam)
        keep("int8_gemv", smoke.int8_kernel_phase(torch, ig, quantize,
                                                  GEMV_ROWS)[0])
        keep("ssd", smoke.ssd_kernel_phase(torch, sd)[0])
    if "int8kv" in phases:
        r8, p8, _ = smoke.int8kv_kernel_phase(torch, fa, pa, attn)
        keep("kernel1-int8kv", r8)
        keep("kernel2-int8kv", p8)
    if "d120" in phases:
        r120, p120 = smoke.d120_kernel_phase(torch, fa, pa)
        keep("kernel1-d120", r120)
        keep("kernel2-d120", p120)
    if "noncausal" in phases:
        keep("kernel1-noncausal", smoke.noncausal_kernel_phase(torch, fa))
    if "crossover" in phases:
        res["crossover"] = crossover(torch, fa, pa, smoke)
    if "profile" in phases:
        from repro_torch.configs import QWEN1_5_4B, QWEN2_0_5B
        from repro_torch.models import model as M
        kcfg = QWEN1_5_4B.with_overrides(kv_dtype="int8")
        kdcfg = QWEN2_0_5B.with_overrides(kv_dtype="int8")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, kcfg.vocab, n).tolist()
                   for n in own.PROMPT_LENS]
        target = (kcfg, M.init_params(QWEN1_5_4B, seed=0, device="cuda"))
        drafters = [(kdcfg, M.init_params(QWEN2_0_5B, seed=1 + i,
                                          device="cuda"), f"d{i}")
                    for i in range(2)]

        def int8kv(name):
            # the int8 form is `int8_kernel`, or (in trees where it is an
            # instantiation of the GQA kernel) `partial_kernel` over
            # signed char K/V
            return own.is_int8kv_kernel(name) or (
                "partial_kernel" in name and "signed char" in name)

        res["profile"] = own.profile_int8kv_window(torch, target, drafters,
                                                   prompts, match=int8kv)
    if "host" in phases:
        res["host"] = host_costs(torch, fa, attn, quantize, sd, own)
    if "sass" in phases:
        res["sass"] = {lib.name: _sass(lib.library_path())
                       for lib in (fa.LIBRARY, pa.LIBRARY)}
    out.write_text(json.dumps(res))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout")
    ap.add_argument("--phases", default="int8kv",
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--json", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    phases = a.phases.split(",")
    if any(p not in PHASES for p in phases):
        ap.error(f"--phases takes {PHASES}")
    if a.worker is not None:
        worker(a.worker, phases, a.json)
        return 0
    if a.other is None:
        ap.error("--other DIR is required")
    trees = {"other": a.other.resolve(), "this": ROOT}
    runs = {"other": [], "this": []}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for i, who in enumerate(("other", "this", "this", "other")):
            out = Path(tmp) / f"{i}.json"
            # the SASS and the profiler window once per tree, the
            # crossover once, on this tree
            ph = [p for p in phases
                  if p in ("kernels", "int8kv", "d120", "noncausal", "host")
                  or (len(runs[who]) == 0
                      and (p != "crossover" or who == "this"))]
            if not ph:
                continue
            print(f"run {i}: {who} ({trees[who]}): {','.join(ph)}",
                  flush=True)
            rc = subprocess.run([sys.executable, __file__, "--worker",
                                 str(trees[who]), "--phases", ",".join(ph),
                                 "--json", str(out)]).returncode
            if rc != 0:
                print(f"run {i} ({who}) failed: exit {rc}", file=sys.stderr)
                return 1
            runs[who].append(json.loads(out.read_text()))
    report = dict(device=[r["device"] for r in runs["this"]],
                  rows={}, profile={}, sass={})
    names = [k for k in runs["this"][0]["rows"]
             if k in runs["other"][0]["rows"]]
    for name in names:
        cell = {}
        for key in runs["this"][0]["rows"][name]:
            vals = {who: [r["rows"][name][key] for r in runs[who]
                          if key in r["rows"].get(name, {})]
                    for who in runs}
            if not all(vals.values()):
                continue
            o = sum(vals["other"]) / len(vals["other"])
            t = sum(vals["this"]) / len(vals["this"])
            cell[key] = dict(other=vals["other"], this=vals["this"],
                             ratio=t / o if o else None)
        report["rows"][name] = cell
        c = cell.get("ms")
        if c:
            print(f"{name:70s} other {c['other']} this {c['this']} "
                  f"this/other {c['ratio']:.4f}", flush=True)
    groups = sorted({n.split("/")[0] for n in names})
    for g in groups:
        o = sum(sum(report["rows"][n]["ms"]["other"]) /
                len(report["rows"][n]["ms"]["other"])
                for n in names if n.startswith(g + "/"))
        t = sum(sum(report["rows"][n]["ms"]["this"]) /
                len(report["rows"][n]["ms"]["this"])
                for n in names if n.startswith(g + "/"))
        report.setdefault("sums", {})[g] = dict(other=o, this=t,
                                                ratio=t / o)
        print(f"sum {g}: other {o:.4f} ms, this {t:.4f} ms, this/other "
              f"{t / o:.4f}", flush=True)
    for r in runs["this"]:
        if "crossover" in r:
            report["crossover"] = r["crossover"]
    if "host" in phases:
        report["host"] = {}
        for name in runs["this"][0]["host"]:
            med = {who: sorted(u for r in runs[who] for u in r["host"][name])
                   for who in runs}
            med = {who: v[len(v) // 2] for who, v in med.items()}
            report["host"][name] = dict(
                other=[r["host"][name] for r in runs["other"]],
                this=[r["host"][name] for r in runs["this"]],
                median_other_us=med["other"], median_this_us=med["this"],
                ratio=med["this"] / med["other"])
            print(f"host {name}: median other {med['other']:.2f} us, this "
                  f"{med['this']:.2f} us, this/other "
                  f"{med['this'] / med['other']:.4f}", flush=True)
    for who in runs:
        if "profile" in runs[who][0]:
            report["profile"][who] = runs[who][0]["profile"]
            print(f"profile {who}: {runs[who][0]['profile']}", flush=True)
    if "sass" in phases:
        for lib, funcs in runs["this"][0]["sass"].items():
            theirs = runs["other"][0]["sass"].get(lib, {})
            same = sorted(f for f in funcs if theirs.get(f) == funcs[f])
            diff = sorted(f for f in funcs if f in theirs
                          and theirs[f] != funcs[f])
            for f in diff:
                a, b = theirs[f].splitlines(), funcs[f].splitlines()
                k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                print(f"  {f}: {len(a)} / {len(b)} instructions, first "
                      f"difference at {k}: {a[k:k + 1]} / {b[k:k + 1]}",
                      flush=True)
            report["sass"][lib] = dict(
                same=same, differ=diff,
                only_this=sorted(set(funcs) - set(theirs)),
                only_other=sorted(set(theirs) - set(funcs)))
            print(f"sass {lib}: {len(same)} functions the same, "
                  f"{len(diff)} differ {diff}, only here "
                  f"{len(set(funcs) - set(theirs))}, only there "
                  f"{len(set(theirs) - set(funcs))}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_compare.json").write_text(json.dumps(report,
                                                           indent=1))
    print(f"device: {report['device']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
