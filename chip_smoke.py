#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the hand-written Hopper flash-attention kernel from the sources
in the checkout, holds it against its plain PyTorch version at the
serving path's own shapes (timing both, with the work's lower bound and
one `scaled_dot_product_attention` call as a yardstick), then serves the
CoSine main path end to end through `SpeculativeEngine.submit/run`:

  phase A  qwen1.5-4b target + two qwen2-0.5b drafters, full width,
           random f32 weights from a seed, max_len 1024, 4 requests
           (prompts of 64..600 tokens) of 32 new tokens each;
  phase B  the same target with two "perfect" drafters that share its
           weights (mean acceptance must exceed 1).

Each committed stream is held against the port's own greedy reference
(`prefill` + `decode_step`), and the kernel's launch counter must show
that every attention of the run went through the kernel. The last line is
`{"ok": true, "device": {...}}`; any failure exits non-zero before it.
Without CUDA, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 dense
# kernel vs plain version on the same inputs: the kernel sums keys in
# tiles of 32 and the plain version in one block, both in f32 with K/V
# converted exactly from their stored dtype, so the only difference is
# f32 summation order: relative ~1e-6, on partials (acc, l) that grow to
# O(100) over ~600 keys and on O(1) normalised outputs
KERNEL_TOL = 1e-4
MAX_LEN = 1024
NEW_TOKENS = 32
PROMPT_LENS = (64, 200, 350, 600)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# =====================================================================
# kernel phase
# =====================================================================

def _graph_ms(torch, fn, reps: int = 20, rounds: int = 3) -> float:
    """Device time of one `fn()` call: `reps` calls captured in a CUDA
    graph (no host gaps between launches), replayed `rounds` times
    between CUDA events after a warm-up replay."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(rounds):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    del g
    return t0.elapsed_time(t1) / (reps * rounds)


def _work(torch, q, k, v, q_pos, k_pos, slot_idx, mask, causal):
    """Bytes that the function must move and operations it must do on
    these inputs: valid (row, key) pairs only, K/V rows that hold a key."""
    B, T, H, G, D = q.shape
    kp = k_pos if slot_idx is None else k_pos[slot_idx.long()]   # (B, S)
    valid = (kp >= 0)[:, None, :].expand(B, T, kp.shape[1])
    if causal:
        valid = valid & (kp[:, None, :] <= q_pos[:, :, None])
    if mask is not None:
        valid = valid & mask
    pairs = int(valid.sum()) * H * G
    rows_read = int((kp >= 0).sum())
    kv_bytes = rows_read * H * D * k.element_size() * 2
    other = (q.numel() * q.element_size() + kp.numel() * 4
             + q_pos.numel() * 4 + (0 if mask is None else mask.numel())
             + B * T * H * G * (D + 2) * 4)
    flops = 4 * pairs * D
    return kv_bytes + other, flops


def kernel_phase(torch, fa):
    """Kernel vs plain version at the main path's shapes; returns rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def pool_pos(P, S, lens):
        pos = torch.full((P, S), -1, dtype=torch.int32, device="cuda")
        for slot, n in enumerate(lens):
            pos[slot, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
        return pos

    # slot lengths as phase A leaves them mid-run (slot 0 is scratch)
    lens = [0, 80, 230, 380, 630, 0, 0, 0, 0]
    slot_idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    cur = torch.tensor(lens, device="cuda")[slot_idx.long()]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"
        # drafter decode: B=4, Hkv=2, G=7, D=64 over the 9-slot pool
        kp = pool_pos(9, MAX_LEN, lens)
        cases.append(dict(
            name=f"drafter_decode_B4_H2_G7_D64_{dn}",
            q=rnd((4, 1, 2, 7, 64), torch.float32),
            k=rnd((9, MAX_LEN, 2, 64), dtype), v=rnd((9, MAX_LEN, 2, 64), dtype),
            q_pos=(cur - 1)[:, None].to(torch.int32), k_pos=kp,
            slot_idx=slot_idx, mask=None, causal=True))
        # target tree verification, cache pass + segment pass: Hkv=20,
        # G=1, D=128, a 10-node tree (fused chain of 5 + side branches)
        T = 10
        parent = [-1, 0, 1, 2, 3, 0, 1, 2, 3, 4]
        depth = [0, 1, 2, 3, 4, 1, 2, 3, 4, 5]
        tree = torch.zeros((T, T), dtype=torch.bool)
        for i in range(T):
            j = i
            while j >= 0:
                tree[i, j] = True
                j = parent[j]
        rel = torch.tensor(depth, dtype=torch.int32, device="cuda")
        qpos = (cur[:, None] + rel[None, :]).to(torch.int32)
        kpt = pool_pos(9, MAX_LEN, lens)
        cases.append(dict(
            name=f"target_verify_cache_B4_T10_H20_D128_{dn}",
            q=rnd((4, T, 20, 1, 128), torch.float32),
            k=rnd((9, MAX_LEN, 20, 128), dtype),
            v=rnd((9, MAX_LEN, 20, 128), dtype),
            q_pos=qpos, k_pos=kpt, slot_idx=slot_idx, mask=None,
            causal=True))
        cases.append(dict(
            name=f"target_verify_segment_B4_T10_H20_D128_{dn}",
            q=rnd((4, T, 20, 1, 128), torch.float32),
            k=rnd((4, T, 20, 128), dtype), v=rnd((4, T, 20, 128), dtype),
            q_pos=qpos, k_pos=qpos.clone(), slot_idx=None,
            mask=tree.to("cuda").expand(4, T, T).contiguous(),
            causal=True))
        # a 512-row causal prefill chunk of the target, written into slot 1
        P = 512
        kpp = pool_pos(9, MAX_LEN, [0, P, 0, 0, 0, 0, 0, 0, 0])
        cases.append(dict(
            name=f"target_prefill_B1_T512_H20_D128_{dn}",
            q=rnd((1, P, 20, 1, 128), torch.float32),
            k=rnd((9, MAX_LEN, 20, 128), dtype),
            v=rnd((9, MAX_LEN, 20, 128), dtype),
            q_pos=torch.arange(P, dtype=torch.int32, device="cuda")[None],
            k_pos=kpp, slot_idx=slot_idx[:1].clone(), mask=None,
            causal=True))

    rows = []
    for c in cases:
        kw = dict(scale=c["q"].shape[-1] ** -0.5, causal=c["causal"],
                  window=0, mask=c["mask"], slot_idx=c["slot_idx"])
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"])
        got = fa.attend_partial(*args, **kw)
        want = fa.attend_partial_plain(*args, **kw)
        torch.cuda.synchronize()
        for part, a, b in zip(("m", "l", "acc"), got, want):
            if not torch.isfinite(a).all():
                fail(f"{c['name']}: kernel {part} not finite")
            if not torch.allclose(a, b, rtol=KERNEL_TOL, atol=KERNEL_TOL):
                fail(f"{c['name']}: kernel {part} vs plain max |err| "
                     f"{float((a - b).abs().max()):.3e} outside rtol=atol="
                     f"{KERNEL_TOL}")
        # reported error: the normalised attention output
        err = float((fa.finalize(got) - fa.finalize(want)).abs().max())
        if err > KERNEL_TOL:
            fail(f"{c['name']}: normalised output max |err| {err:.3e} > "
                 f"{KERNEL_TOL}")
        ms = _graph_ms(torch, lambda: fa.attend_partial(*args, **kw))
        plain_ms = _graph_ms(torch, lambda: fa.attend_partial_plain(
            *args, **kw), reps=3)
        lib_ms = _library_ms(torch, c)
        nbytes, flops = _work(torch, *args, c["slot_idx"], c["mask"],
                              c["causal"])
        kv_type = "bfloat16" if c["k"].dtype == torch.bfloat16 else "float32"
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[kv_type] * 1e3
        rows.append(dict(name=c["name"], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", library_ms=lib_ms,
                         bytes=nbytes, flops=flops))
        print(f"kernel {c['name']}: max|err| {err:.2e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {max(t_bytes, t_ops):.4f} ms "
              f"({rows[-1]['bound_by']})  sdpa {lib_ms:.4f} ms", flush=True)
    return rows


def _library_ms(torch, c):
    """One scaled_dot_product_attention call computing the normalised
    output on the same inputs (gathered, GQA-expanded K/V and a boolean
    mask prepared outside the timed call). A yardstick only."""
    import torch.nn.functional as F
    q, k, v = c["q"], c["k"], c["v"]
    B, T, H, G, D = q.shape
    kp = c["k_pos"]
    if c["slot_idx"] is not None:
        idx = c["slot_idx"].long()
        k, v, kp = k[idx], v[idx], kp[idx]
    valid = (kp >= 0)[:, None, :] & (kp[:, None, :] <= c["q_pos"][:, :, None])
    if c["mask"] is not None:
        valid = valid & c["mask"]
    qs = q.to(k.dtype).reshape(B, T, H * G, D).transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    am = valid[:, None].expand(B, H * G, T, kp.shape[1]).contiguous()
    return _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am, scale=D ** -0.5))


# =====================================================================
# serving phases
# =====================================================================

class AttentionCalls:
    """Counts the model's attention calls (by form) and any call of the
    plain version, to hold the kernel's launch counter against them."""

    def __init__(self, attn_mod, fa):
        self.attn_mod, self.fa = attn_mod, fa
        self.orig = attn_mod.attend_partial
        self.orig_plain = fa.attend_partial_plain
        self.by_form = {}
        self.plain_calls = 0

    def __enter__(self):
        def counted(q, k, v, q_pos, k_pos, **kw):
            T = q.shape[1]
            form = ("segment" if kw.get("extra_mask") is not None
                    else "decode" if T == 1
                    else "prefill" if T > 64 else "commit/verify")
            self.by_form[form] = self.by_form.get(form, 0) + 1
            return self.orig(q, k, v, q_pos, k_pos, **kw)

        def plain(*a, **kw):
            self.plain_calls += 1
            return self.orig_plain(*a, **kw)

        self.attn_mod.attend_partial = counted
        self.fa.attend_partial_plain = plain
        self.fa.LAUNCHES = 0
        return self

    def __exit__(self, *exc):
        self.attn_mod.attend_partial = self.orig
        self.fa.attend_partial_plain = self.orig_plain

    @property
    def calls(self):
        return sum(self.by_form.values())


def greedy_reference(torch, M, cfg, params, prompt, n):
    """Port's own greedy decode; returns tokens and top-1/top-2 gaps."""
    cache = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cuda")
    lg, cache, _ = M.prefill(params, cfg, torch.tensor([prompt],
                                                       device="cuda"), cache)
    last = lg[0, -1, : cfg.vocab]
    toks, gaps = [], []
    for _ in range(n):
        top2 = torch.topk(last, 2).values
        gaps.append(float(top2[0] - top2[1]))
        t = int(torch.argmax(last))
        toks.append(t)
        lg, cache, _ = M.decode_step(params, cfg,
                                     torch.tensor([[t]], device="cuda"), cache)
        last = lg[0, 0, : cfg.vocab]
    return toks, gaps


def path_noise(torch, M, cfg, params, prompt, toks):
    """Max |logit| difference between two exact-arithmetic-equal paths
    of the port: the greedy decode steps and one prefill over the whole
    sequence (different batch shapes, cuBLAS algorithms and bf16 residual
    roundings). Sets the scale of an allowed near-tie divergence."""
    seq = list(prompt) + toks
    c1 = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cuda")
    lg_full, _, _ = M.prefill(params, cfg, torch.tensor([seq], device="cuda"),
                              c1)
    c2 = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cuda")
    lg, c2, _ = M.prefill(params, cfg, torch.tensor([prompt], device="cuda"),
                          c2)
    diffs = [float((lg[0, -1, : cfg.vocab]
                    - lg_full[0, len(prompt) - 1, : cfg.vocab]).abs().max())]
    for i, t in enumerate(toks[:-1]):
        lg, c2, _ = M.decode_step(params, cfg,
                                  torch.tensor([[t]], device="cuda"), c2)
        diffs.append(float((lg[0, 0, : cfg.vocab]
                            - lg_full[0, len(prompt) + i, : cfg.vocab]
                            ).abs().max()))
    return max(diffs)


def teacher_forced_gaps(torch, M, cfg, params, prompt, toks):
    """For each committed token, how far its logit falls below the top
    logit of the target given the committed prefix (one prefill over
    prompt + toks); 0 where the token is the argmax."""
    c = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cuda")
    lg, _, _ = M.prefill(params, cfg,
                         torch.tensor([list(prompt) + list(toks)],
                                      device="cuda"), c)
    rows = lg[0, len(prompt) - 1: len(prompt) - 1 + len(toks), : cfg.vocab]
    picked = rows.gather(1, torch.tensor(toks, device="cuda")[:, None])[:, 0]
    return (rows.max(dim=1).values - picked).tolist()


def serve_phase(torch, label, target, drafters, prompts, kernel_err):
    from repro_torch.config import CoSineConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as M
    from repro_torch.serving.engine import SpeculativeEngine

    cos = CoSineConfig(n_drafters=len(drafters), drafters_per_request=2,
                       tree_width=2)
    t0 = time.perf_counter()
    eng = SpeculativeEngine(target, drafters, cos, strategy="cosine",
                            max_len=MAX_LEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    with AttentionCalls(attn_mod, fa) as calls:
        t0 = time.perf_counter()
        stats = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fa.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches == 0 or launches != calls.calls or calls.plain_calls:
        fail(f"{label}: {launches} kernel launches for {calls.calls} "
             f"attention calls ({calls.plain_calls} plain-version calls)")
    if stats.total_committed != len(prompts) * NEW_TOKENS:
        fail(f"{label}: committed {stats.total_committed} tokens, expected "
             f"{len(prompts) * NEW_TOKENS}")

    tcfg, tparams = target
    results = []
    for r, p in zip(reqs, prompts):
        gen = list(map(int, r.generated))
        if len(gen) != NEW_TOKENS:
            fail(f"{label}: request {r.rid} generated {len(gen)} tokens")
        ref, gaps = greedy_reference(torch, M, tcfg, tparams, p, NEW_TOKENS)
        noise = path_noise(torch, M, tcfg, tparams, p, ref)
        # a divergence is accepted only at a near-tie of the reference:
        # its top-1/top-2 gap must be under 4x the measured logit noise
        # between two of the port's own paths (that noise, not the
        # kernel's error, is what differs between batched verification
        # and single-token decode) and at least 100x the kernel's error
        tie_tol = max(4.0 * noise, 100.0 * kernel_err)
        matched = 0
        while matched < NEW_TOKENS and gen[matched] == ref[matched]:
            matched += 1
        note = "exact"
        if matched < NEW_TOKENS:
            gap = gaps[matched]
            if gap >= tie_tol:
                fail(f"{label}: request {r.rid} diverges from the greedy "
                     f"reference at token {matched} (gap {gap:.4g} >= "
                     f"tolerance {tie_tol:.4g})")
            note = (f"near-tie divergence at token {matched} (gap "
                    f"{gap:.4g} < tolerance {tie_tol:.4g})")
        # past a divergence the streams no longer share a context, so every
        # committed token is also held against the target given the
        # committed prefix itself: it must be the argmax or a near-tie
        tf = teacher_forced_gaps(torch, M, tcfg, tparams, p, gen)
        n_argmax = sum(1 for g in tf if g == 0.0)
        if max(tf) >= tie_tol:
            fail(f"{label}: request {r.rid} committed token "
                 f"{tf.index(max(tf))} sits {max(tf):.4g} below the "
                 f"target's top logit (tolerance {tie_tol:.4g})")
        results.append(dict(rid=r.rid, prompt_len=len(p), matched=matched,
                            path_noise=noise, tie_tol=tie_tol, note=note,
                            teacher_forced_argmax=n_argmax,
                            teacher_forced_max_gap=max(tf)))
        print(f"{label} request {r.rid} (prompt {len(p)}): {matched}/"
              f"{NEW_TOKENS} tokens match the greedy reference; {note}; "
              f"teacher-forced: {n_argmax}/{NEW_TOKENS} are the target's "
              f"argmax, every token within {max(tf):.3g} of it; path "
              f"noise {noise:.3g}", flush=True)

    summary = dict(
        phase=label, requests=len(prompts), new_tokens=NEW_TOKENS,
        committed=stats.total_committed, iterations=len(stats.records),
        mean_acceptance=stats.mean_acceptance,
        wall_s=wall, wall_tokens_per_s=stats.total_committed / wall,
        sim_ms=stats.sim_ms, sim_throughput_tps=stats.throughput_tps,
        kernel_launches=launches, attention_calls_by_form=calls.by_form,
        setup_s=t_setup, peak_mem_gb=peak_gb, requests_detail=results)
    print(f"{label}: wall clock {wall:.2f} s for {stats.total_committed} "
          f"tokens ({stats.total_committed / wall:.1f} tokens/s on the "
          f"card); simulated-clock throughput {stats.throughput_tps:.1f} "
          f"tokens/s (the engine's latency model, not a measurement); "
          f"mean acceptance {stats.mean_acceptance:.3f}; kernel launches "
          f"{launches} = attention calls {calls.by_form}", flush=True)
    eng.backend.shutdown()
    return summary, launches


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import QWEN1_5_4B, QWEN2_0_5B
        from repro_torch.kernels.flash_attention import build
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.models import model as M
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    # float32 products stay float32 (also set by repro_torch.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    print(f"device: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build+load {time.perf_counter() - t0:.1f} s", flush=True)
    if build.build_log:
        # ptxas report per instantiation: registers, shared memory, spills
        for line in build.build_log.splitlines():
            if "Used" in line or "spill" in line:
                print(line.strip(), flush=True)

    rows = kernel_phase(torch, fa)
    kernel_err = max(r["max_abs_err"] for r in rows)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, QWEN1_5_4B.vocab, n).tolist()
               for n in PROMPT_LENS]

    # phase A: qwen1.5-4b target + two qwen2-0.5b drafters
    t0 = time.perf_counter()
    tparams = M.init_params(QWEN1_5_4B, seed=0, device="cuda")
    drafters = [(QWEN2_0_5B, M.init_params(QWEN2_0_5B, seed=1 + i,
                                           device="cuda"), f"d{i}")
                for i in range(2)]
    torch.cuda.synchronize()
    print(f"phase A weights {time.perf_counter() - t0:.1f} s", flush=True)
    sum_a, launches_a = serve_phase(torch, "phase A", (QWEN1_5_4B, tparams),
                                    drafters, prompts, kernel_err)
    del drafters
    gc.collect()
    torch.cuda.empty_cache()

    # phase B: perfect drafters sharing the target's weights
    perfect = [(QWEN1_5_4B, tparams, f"p{i}") for i in range(2)]
    sum_b, launches_b = serve_phase(torch, "phase B", (QWEN1_5_4B, tparams),
                                    perfect, prompts, kernel_err)
    if not sum_b["mean_acceptance"] > 1.0:
        fail(f"phase B mean acceptance {sum_b['mean_acceptance']:.3f} <= 1")
    del perfect, tparams
    gc.collect()
    torch.cuda.empty_cache()

    print(json.dumps({"serving": [sum_a, sum_b]}), flush=True)
    tot = {k: sum(r[k] for r in rows)
           for k in ("ms", "plain_ms", "library_ms")}
    t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["flops"] / PEAK_FLOPS["bfloat16" if "bf16" in r["name"]
                                       else "float32"] for r in rows) * 1e3
    kernel = dict(
        name="flash_attention_partial", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention.cu",
        replaces="src/repro/kernels/common.py:139",
        launches=launches_a + launches_b, max_abs_err=kernel_err,
        ms=tot["ms"], plain_ms=tot["plain_ms"],
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=tot["library_ms"],
        note="times are sums over one call of each shape below",
        shapes=rows)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
