#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's four hand-written Hopper kernels from the sources
in the checkout (one `nvcc` each, in parallel), holds each against its
plain PyTorch version at the serving path's own shapes (timing both, with
the work's lower bound and, where one PyTorch call computes the same
function, that call as a yardstick; the int8 GEMV after phase D, at the
row counts phase D gave it, with its CUDA-core paths (split-K, and the
rows kernel for the head) and wgmma side by side at 4-64 rows; the SSD
scan at phases E-F's shapes on the path its plan takes and on the other
one, in place with scrambled slot indices (unnamed rows and write=False
leave the pool bitwise unchanged), and both paths across sequence
lengths; the host cost of one call of the attention, int8 and SSD
wrappers), then serves the CoSine path end to end through
`SpeculativeEngine.submit/run`:

  phase A  qwen1.5-4b target + two qwen2-0.5b drafters, full width,
           random f32 weights from a seed, max_len 1024, 4 requests
           (prompts of 64..600 tokens) of 32 new tokens each;
  phase B  the same target with two "perfect" drafters that share its
           weights (mean acceptance must exceed 1);
  phase C  phase A on the paged KV pool (page_size 64, a pool of 16
           pages per model that must grow): every pool read goes through
           the paged-attention kernel, and the committed streams equal
           phase A's;
  phase D  phase A with drafter 0 as int8 weights beside a
           full-precision drafter 1: every quantized product goes
           through the int8 GEMV kernel (launches printed by row count);
  phase E  a mamba2-130m target (24 SSD layers, full width, random f32
           weights, bf16 activations) with two mamba2-130m drafters, one
           sharing its weights, on the resident pool; chain-only
           verification; every SSM layer of every forward goes through
           the SSD scan kernel (launches counted by form: decode, the
           recurrence above one token, the chunk path) and no attention
           kernel launches;
  phase F  a hybrid target at jamba-v0.1-52b's widths, cut to 8 layers
           (one 1:7 period, attention at layer 4) with the dense FFN in
           place of the MoE, with two drafters sharing its weights, on
           the resident pool;
  phase G  phase F on the paged pool: its streams equal phase F's;
  phase H  phase A on the wall-clock backend (`backend="async"`): the
           target verifies on a server thread with a CUDA stream of its
           own while the engine thread drafts the next cohort on another
           stream; every forward must run on its side's stream (neither
           the legacy default one), no `torch.cuda.synchronize` may run
           during the serve, and `overlap_frac` (the share of cohorts
           whose drafting began before the previous verification ended)
           must reach 0.5;
  phase H-serial  the same engine with `executor.overlap = False`, the
           reference's serial twin; then a `torch.profiler` window over a
           few of phase H's iterations (device busy share, top device
           operations, the longest device-idle gaps with what each host
           thread was doing);
  phase I  phase E on the wall-clock backend (the target's SSM state
           written in place on the server's stream).

Each committed stream is held against the port's own greedy reference
(`prefill` + `decode_step`), and each kernel's launch counter must equal
the model's calls of that kernel in the phase (counted under a lock: on
the wall-clock backend two threads launch). Phases H, H-serial and I
print their wall tokens/s beside their simulated twin's (A, E), the
verifier idle fractions and their ratio `idle_ratio` (reported, not
gated), the draft-ahead outcomes and the server's spans by kind. The
last line is
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
# the SSD chunk path's products on the tensor cores: 3xTF32, each product
# three TF32 passes at 495 TFLOP/s
TF32X3_FLOPS = 495e12 / 3
# kernel vs plain version on the same inputs: the kernel sums keys in
# tiles of 32 and the plain version in one block, both in f32 with K/V
# converted exactly from their stored dtype, so the only difference is
# f32 summation order: relative ~1e-6, on partials (acc, l) that grow to
# O(100) over ~600 keys and on O(1) normalised outputs
KERNEL_TOL = 1e-4
# int8 GEMV vs its plain version: the same exact int8 -> f32 and bf16 ->
# f32 conversions and f32 products, summed in another order over K <=
# 4864 terms: relative ~1e-6 on outputs of O(1)
INT8_TOL = 1e-4
# SSD scan kernel vs its plain version on the same inputs: both in f32,
# the kernel in chunks of <= 64 tokens and the plain version in chunks of
# 128, so the sums (and the decays, exp of cumulative sums) are taken in
# another order: the reference's own test tolerance, on y and states of
# O(1)
SSD_TOL = 2e-4
MAX_LEN = 1024
NEW_TOKENS = 32
PROMPT_LENS = (64, 200, 350, 600)
PAGE_SIZE = 64
POOL_PAGES = 16
KERNEL_SOURCES = {
    "flash_attention_partial": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    "paged_flash_decode": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:127"),
    "int8_gemv_call": (
        "src/repro_torch/kernels/int8_gemv/csrc/int8_gemv.cu",
        "src/repro/kernels/int8_gemv/kernel.py:51"),
    "ssd_scan_pallas": (
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:74"),
}


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


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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
        tree = _tree_mask(torch)
        rel = torch.tensor(TREE_DEPTH, dtype=torch.int32, device="cuda")
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
            mask=tree.expand(4, T, T).contiguous(), causal=True))
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
        cases += _hybrid_attention_cases(torch, rnd, pool_pos, lens,
                                         slot_idx, cur, dn, dtype)

    rows = []
    host = None
    for c in cases:
        kw = dict(scale=c["q"].shape[-1] ** -0.5, causal=c["causal"],
                  window=0, mask=c["mask"], slot_idx=c["slot_idx"])
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"])
        got = fa.attend_partial(*args, **kw)
        want = fa.attend_partial_plain(*args, **kw)
        torch.cuda.synchronize()
        err = _check_partials(torch, fa, c["name"], got, want)
        ms = _graph_ms(torch, lambda: fa.attend_partial(*args, **kw))
        plain_ms = _graph_ms(torch, lambda: fa.attend_partial_plain(
            *args, **kw), reps=3)
        lib_ms = _library_ms(torch, c["q"], c["k"], c["v"], c["q_pos"],
                             c["k_pos"], c["slot_idx"], c["mask"])
        nbytes, flops = _work(torch, *args, c["slot_idx"], c["mask"],
                              c["causal"])
        kv_type = "bfloat16" if c["k"].dtype == torch.bfloat16 else "float32"
        bound, by = _bound(nbytes, flops, kv_type)
        rows.append(dict(name=c["name"], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=lib_ms, bytes=nbytes, flops=flops,
                         dtype=kv_type))
        print(f"kernel {c['name']}: splits {fa.plan_splits(*_bhrs(c))}  "
              f"max|err| {err:.2e}  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
              f"sdpa {lib_ms:.4f} ms", flush=True)
        if host is None:      # the first case: drafter decode, f32 K/V
            host = dict(shape=c["name"], attend_partial_us=_host_us(
                torch, lambda: fa.attend_partial(*args, **kw)))
            print(f"host cost per call ({c['name']}): attend_partial "
                  f"{host['attend_partial_us']:.1f} us (enqueue only)",
                  flush=True)
    return rows, host


def _bhrs(c):
    """(B, Hkv, R, S) of a kernel-1 case, as `plan_splits` takes them."""
    B, T, H, G, _ = c["q"].shape
    return B, H, T * G, c["k"].shape[1]


# phases F and G's attention layer (jamba widths: Hkv 8, G 4, D 128) and
# its chain verification: the last committed token and draft_len = 5
# drafts, T = 6 rows
HYB_H, HYB_G, HYB_D, CHAIN_T = 8, 4, 128, 6


def _hybrid_attention_cases(torch, rnd, pool_pos, lens, slot_idx, cur, dn,
                            dtype):
    """Kernel 1's forms at phases F and G's attention shapes: decode in
    the slot pool and on a drafter's snapshot (no slot_idx), the chain's
    cache pass and segment pass, a commit of T = 6 rows and a 512-row
    prefill chunk."""
    H, G, D, T = HYB_H, HYB_G, HYB_D, CHAIN_T
    tag = f"B4_H{H}_G{G}_D{D}_{dn}"
    ar = torch.arange(T, dtype=torch.int32, device="cuda")
    qpos = (cur[:, None] + ar[None]).to(torch.int32)
    kp = pool_pos(9, MAX_LEN, lens)
    k, v = rnd((9, MAX_LEN, H, D), dtype), rnd((9, MAX_LEN, H, D), dtype)
    snap = slot_idx.long()
    kp_commit = pool_pos(9, MAX_LEN, [n + T if n else 0 for n in lens])
    P = 512
    kpp = pool_pos(9, MAX_LEN, [0, P, 0, 0, 0, 0, 0, 0, 0])
    return [
        dict(name=f"hybrid_decode_T1_{tag}",
             q=rnd((4, 1, H, G, D), torch.float32), k=k, v=v,
             q_pos=(cur - 1)[:, None].to(torch.int32), k_pos=kp,
             slot_idx=slot_idx, mask=None, causal=True),
        dict(name=f"hybrid_snapshot_decode_T1_{tag}",
             q=rnd((4, 1, H, G, D), torch.float32),
             k=k[snap].contiguous(), v=v[snap].contiguous(),
             q_pos=(cur - 1)[:, None].to(torch.int32),
             k_pos=kp[snap].contiguous(), slot_idx=None, mask=None,
             causal=True),
        dict(name=f"hybrid_verify_cache_T{T}_{tag}",
             q=rnd((4, T, H, G, D), torch.float32), k=k, v=v, q_pos=qpos,
             k_pos=kp, slot_idx=slot_idx, mask=None, causal=True),
        dict(name=f"hybrid_verify_segment_T{T}_{tag}",
             q=rnd((4, T, H, G, D), torch.float32),
             k=rnd((4, T, H, D), dtype), v=rnd((4, T, H, D), dtype),
             q_pos=qpos, k_pos=qpos.clone(), slot_idx=None,
             mask=torch.tril(torch.ones((T, T), dtype=torch.bool,
                                        device="cuda")).expand(
                                            4, T, T).contiguous(),
             causal=True),
        dict(name=f"hybrid_commit_T{T}_{tag}",
             q=rnd((4, T, H, G, D), torch.float32), k=k, v=v, q_pos=qpos,
             k_pos=kp_commit, slot_idx=slot_idx, mask=None, causal=True),
        dict(name=f"hybrid_prefill_B1_T512_H{H}_G{G}_D{D}_{dn}",
             q=rnd((1, P, H, G, D), torch.float32), k=k, v=v,
             q_pos=torch.arange(P, dtype=torch.int32, device="cuda")[None],
             k_pos=kpp, slot_idx=slot_idx[:1].clone(), mask=None,
             causal=True),
    ]


# a 10-node tree as phase A verifies: a fused chain of 5 + side branches
TREE_PARENT = [-1, 0, 1, 2, 3, 0, 1, 2, 3, 4]
TREE_DEPTH = [0, 1, 2, 3, 4, 1, 2, 3, 4, 5]


def _tree_mask(torch):
    T = len(TREE_PARENT)
    tree = torch.zeros((T, T), dtype=torch.bool)
    for i in range(T):
        j = i
        while j >= 0:
            tree[i, j] = True
            j = TREE_PARENT[j]
    return tree.to("cuda")


def _check_partials(torch, fa, name, got, want):
    """Every partial finite and within KERNEL_TOL of the plain version;
    returns the max |error| of the normalised output."""
    for part, a, b in zip(("m", "l", "acc"), got, want):
        if not torch.isfinite(a).all():
            fail(f"{name}: kernel {part} not finite")
        if not torch.allclose(a, b, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            fail(f"{name}: kernel {part} vs plain max |err| "
                 f"{float((a - b).abs().max()):.3e} outside rtol=atol="
                 f"{KERNEL_TOL}")
    err = float((fa.finalize(got) - fa.finalize(want)).abs().max())
    if err > KERNEL_TOL:
        fail(f"{name}: normalised output max |err| {err:.3e} > "
             f"{KERNEL_TOL}")
    return err


def _library_ms(torch, q, k, v, q_pos, k_pos, slot_idx, mask):
    """One scaled_dot_product_attention call computing the normalised
    output on the same inputs (gathered, GQA-expanded K/V and a boolean
    mask prepared outside the timed call). A yardstick only."""
    import torch.nn.functional as F
    B, T, H, G, D = q.shape
    kp = k_pos
    if slot_idx is not None:
        idx = slot_idx.long()
        k, v, kp = k[idx], v[idx], kp[idx]
    valid = (kp >= 0)[:, None, :] & (kp[:, None, :] <= q_pos[:, :, None])
    if mask is not None:
        valid = valid & mask
    qs = q.to(k.dtype).reshape(B, T, H * G, D).transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    am = valid[:, None].expand(B, H * G, T, kp.shape[1]).contiguous()
    return _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=am, scale=D ** -0.5))


def paged_kernel_phase(torch, fa, pa):
    """The paged kernel at phase C's pool reads: against its plain version
    and, bit for bit, against the flash-attention kernel on the gathered
    view; returns rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    perm = torch.Generator().manual_seed(7)
    lens = [80, 230, 380, 630]           # phase A's requests mid-run

    def pool(H, D, held, rows_per_req):
        """A page pool holding positions [0, held[b]) of request b on
        pages handed out in a scrambled order, with the view of
        `rows_per_req` columns per request (power of two pages, NULL
        filler), as the runner builds it."""
        n_req_pages = [-(-n // PAGE_SIZE) for n in held]
        P = 2 + sum(n_req_pages) + 8
        k = torch.randn((P, PAGE_SIZE, H, D), generator=gen, device="cuda")
        v = torch.randn((P, PAGE_SIZE, H, D), generator=gen, device="cuda")
        pos = torch.full((P, PAGE_SIZE), -1, dtype=torch.int32,
                         device="cuda")
        need = max(-(-n // PAGE_SIZE) for n in rows_per_req)
        nv = 1 << (need - 1).bit_length()
        tbl = torch.ones((len(held), nv), dtype=torch.int32, device="cuda")
        free = (torch.randperm(P - 2, generator=perm) + 2).tolist()
        for b, n in enumerate(held):
            for j in range(n_req_pages[b]):
                page = free.pop()
                cnt = min(PAGE_SIZE, n - j * PAGE_SIZE)
                pos[page, :cnt] = j * PAGE_SIZE + torch.arange(
                    cnt, dtype=torch.int32, device="cuda")
                tbl[b, j] = page
        return k, v, pos, tbl

    def rows_from(start, T):
        return torch.tensor([[s + t for t in range(T)] for s in start],
                            dtype=torch.int32, device="cuda")

    cases = []
    # decode, one token per request: written at position lens[b], then
    # read with the lens[b] keys before it (target, then drafter)
    held = [n + 1 for n in lens]
    for H, G, D, who in ((20, 1, 128, "target"), (2, 7, 64, "drafter")):
        k, v, pos, tbl = pool(H, D, held, held)
        cases.append(dict(
            name=f"{who}_decode_B4_T1_H{H}_G{G}_D{D}_f32",
            q=torch.randn((4, 1, H, G, D), generator=gen, device="cuda"),
            k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(lens, 1)))
    # target verification, cache pass: the pool as it was (write=0 view)
    k, v, pos, tbl = pool(20, 128, lens, lens)
    cases.append(dict(
        name="target_verify_cache_B4_T10_H20_D128_f32",
        q=torch.randn((4, 10, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl,
        q_pos=(torch.tensor(lens, device="cuda")[:, None]
               + torch.tensor(TREE_DEPTH, device="cuda")[None]).to(
                   torch.int32)))
    # target commit of 5 accepted tokens: written first, then read
    held = [n + 5 for n in lens]
    k, v, pos, tbl = pool(20, 128, held, held)
    cases.append(dict(
        name="target_commit_B4_T5_H20_D128_f32",
        q=torch.randn((4, 5, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(lens, 5)))
    # a 512-row target prefill chunk on the pool
    k, v, pos, tbl = pool(20, 128, [512], [512])
    cases.append(dict(
        name="target_prefill_B1_T512_H20_D128_f32",
        q=torch.randn((1, 512, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from([0], 512)))
    # a drafter commit (one-behind: the previous token + 4 accepted)
    k, v, pos, tbl = pool(2, 64, held, held)
    cases.append(dict(
        name="drafter_commit_B4_T5_H2_G7_D64_f32",
        q=torch.randn((4, 5, 2, 7, 64), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(lens, 5)))
    # phase G's attention layer (jamba widths): decode, the chain's cache
    # pass (the pool as it was), a commit of T = 6 rows, a prefill chunk
    H, G, D, T = HYB_H, HYB_G, HYB_D, CHAIN_T
    tag = f"H{H}_G{G}_D{D}_f32"
    for name, held, start, rows in (
            (f"hybrid_decode_B4_T1_{tag}", [n + 1 for n in lens], lens, 1),
            (f"hybrid_verify_cache_B4_T{T}_{tag}", lens, lens, T),
            (f"hybrid_commit_B4_T{T}_{tag}", [n + T for n in lens], lens, T),
            (f"hybrid_prefill_B1_T512_{tag}", [512], [0], 512)):
        k, v, pos, tbl = pool(H, D, held, held)
        cases.append(dict(
            name=name, q=torch.randn((len(held), rows, H, G, D),
                                     generator=gen, device="cuda"),
            k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(start, rows)))

    rows = []
    for c in cases:
        D = c["q"].shape[-1]
        args = (c["q"], c["k"], c["v"], c["q_pos"], c["pos"], c["tbl"])
        kw = dict(scale=D ** -0.5)
        got = pa.paged_attend_partial(*args, **kw)
        want = pa.paged_attend_partial_plain(*args, **kw)
        kv = pa.gather_view(c["k"], c["tbl"])
        vv = pa.gather_view(c["v"], c["tbl"])
        kpv = pa.gather_view(c["pos"], c["tbl"])
        k1_args = (c["q"], kv, vv, c["q_pos"], kpv)
        k1 = fa.attend_partial(*k1_args, **kw)
        torch.cuda.synchronize()
        err = _check_partials(torch, fa, c["name"], got, want)
        vs_k1 = max(float((a - b).abs().max()) for a, b in zip(got, k1))
        ms = _graph_ms(torch, lambda: pa.paged_attend_partial(*args, **kw))
        plain_ms = _graph_ms(torch, lambda: pa.paged_attend_partial_plain(
            *args, **kw), reps=3)
        k1_ms = _graph_ms(torch, lambda: fa.attend_partial(*k1_args, **kw))
        lib_ms = _library_ms(torch, c["q"], kv, vv, c["q_pos"], kpv, None,
                             None)
        nbytes, flops = _work(torch, *k1_args, None, None, True)
        nbytes += c["tbl"].numel() * 4
        bound, by = _bound(nbytes, flops, "float32")
        rows.append(dict(name=c["name"], max_abs_err=err,
                         max_abs_diff_vs_kernel1=vs_k1, ms=ms,
                         plain_ms=plain_ms, kernel1_gathered_ms=k1_ms,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms,
                         bytes=nbytes, flops=flops, dtype="float32"))
        B_, T_, H_, G_, _ = c["q"].shape
        print(f"kernel paged {c['name']}: splits "
              f"{fa.plan_splits(B_, H_, T_ * G_, kv.shape[1])}  "
              f"max|err| {err:.2e}  |paged - "
              f"kernel 1 on the gathered view| {vs_k1:.3g}  kernel "
              f"{ms:.4f} ms  plain {plain_ms:.4f} ms  kernel 1 gathered "
              f"{k1_ms:.4f} ms  bound {bound:.4f} ms ({by})  sdpa "
              f"{lib_ms:.4f} ms", flush=True)
    return rows


def _host_us(torch, fn, n: int = 200) -> float:
    """Host cost of one call: `n` calls enqueued back to back, timed on the
    host clock with the synchronize outside the timer (the device may
    still be running them), in microseconds."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# int8 launches of phase D by rows: decode (<= 8 rows), extend / commit
# (9-63 rows) and prefill (>= 64 rows)
def int8_row_class(m: int) -> str:
    return "decode" if m <= 8 else "extend" if m < 64 else "prefill"


def int8_kernel_phase(torch, ig, quantize, row_counts):
    """The int8 GEMV at qwen2-0.5b's quantized products (wq/wo, wk/wv,
    wg/wu, wd and the tied-logits head through the transposed table) at
    the row counts phase D gives them (decode, its most frequent extend
    count, a 512-row prefill chunk), against its plain version, and the
    model's wrapper `int8_gemv` against the kernel's f32 output cast to
    bf16 (bit for bit); then split-K (dense) or the rows kernel (head)
    and wgmma side by side at 4-32 rows (the head to 64), and the host
    cost of one quantized product against one full-precision product.
    Returns (rows, crossover, host)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(99)
    V = 151936
    products = []
    for K, N, what in ((896, 896, "wq/wo"), (896, 128, "wk/wv"),
                       (896, 4864, "wg/wu"), (4864, 896, "wd")):
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        q = quantize.quantize_weight(w)
        products.append(dict(what=what, K=K, N=N, w8=q["w8"],
                             scale=q["scale"], w=w,
                             dense=quantize.dequantize_weight(
                                 q, torch.bfloat16)))
    emb = torch.randn((V, 896), generator=gen, device="cuda") * 0.02
    q = quantize.quantize_weight(emb, axis=-1)
    products.append(dict(what="tied_logits", K=896, N=V, w8=q["w8"].t(),
                         scale=q["scale"], w=None,
                         dense=quantize.dequantize_weight(
                             q, torch.bfloat16).t()))
    del emb, q

    rows = []
    for c in products:
        K, N = c["K"], c["N"]
        for M_ in row_counts:
            name = f"{c['what']}_M{M_}_K{K}_N{N}_bf16"
            x = torch.randn((M_, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            got = ig._launch(x, c["w8"], c["scale"])
            want = ig.int8_gemv_plain(x, c["w8"], c["scale"])
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"int8 {name}: kernel output not finite")
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=INT8_TOL, atol=INT8_TOL):
                fail(f"int8 {name}: kernel vs plain max |err| {err:.3e} "
                     f"outside rtol=atol={INT8_TOL}")
            wrapped = ig.int8_gemv(x, c["w8"], c["scale"])
            torch.cuda.synchronize()
            if wrapped.dtype != x.dtype or not torch.equal(
                    wrapped, got.to(x.dtype)):
                fail(f"int8 {name}: the wrapper int8_gemv differs from the "
                     "kernel's output cast to bf16")
            ms = _graph_ms(torch, lambda: ig._launch(x, c["w8"], c["scale"]))
            plain_ms = _graph_ms(torch, lambda: ig.int8_gemv_plain(
                x, c["w8"], c["scale"]), reps=3)
            dense = c["dense"]
            lib_ms = _graph_ms(torch, lambda: torch.matmul(x, dense))
            nbytes = K * N + 4 * N + x.numel() * 2 + 4 * M_ * N
            bound, by = _bound(nbytes, 2 * M_ * K * N, "bfloat16")
            rows_layout = c["w8"].stride(1) != 1
            plan = ig.plan(M_, K, N, rows_layout, True,
                           torch.cuda.get_device_properties(
                               0).multi_processor_count)
            rows.append(dict(name=name, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                             library_ms=lib_ms, bytes=nbytes,
                             flops=2 * M_ * K * N, dtype="bfloat16",
                             layout="rows" if rows_layout else "cols",
                             rows_class=int8_row_class(M_),
                             path=plan._asdict()))
            print(f"kernel int8 {name}: path {plan.path}  max|err| "
                  f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bound:.4f} ms ({by})  bf16 matmul {lib_ms:.4f} ms",
                  flush=True)

    # the CUDA-core paths against wgmma where they meet (TC_MIN_ROWS):
    # each plan launched through `launch_plan`, whichever one `plan`
    # would pick
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    crossover = []
    for c in products:
        K, N = c["K"], c["N"]
        table = c["w8"].stride(1) != 1
        counts = (4, 5, 6, 7, 8, 16, 32) + ((64,) if table else ())
        for M_ in counts:
            x = torch.randn((M_, K), generator=gen,
                            device="cuda").to(torch.bfloat16)
            scale = c["scale"].contiguous()
            want = ig.int8_gemv_plain(x, c["w8"], scale)
            plans = (ig.rows_plan(M_, K, n_sm) if table
                     else ig.splitk_plan(M_, K, N), ig.tc_plan(M_, K, N, n_sm))
            t = {}
            for p in plans:
                got = ig.launch_plan(x, c["w8"], scale, p)
                if not torch.allclose(got, want, rtol=INT8_TOL,
                                      atol=INT8_TOL):
                    fail(f"int8 crossover {c['what']} M{M_} {p.path}: "
                         "outside the tolerance")
                t[p.path] = _graph_ms(torch, lambda: ig.launch_plan(
                    x, c["w8"], scale, p))
            core = plans[0].path
            crossover.append(dict(what=c["what"], M=M_, K=K, N=N,
                                  core_path=core, core_ms=t[core],
                                  tc_ms=t["tc"]))
            print(f"int8 crossover {c['what']} M{M_}: {core} "
                  f"{t[core]:.4f} ms  wgmma {t['tc']:.4f} ms", flush=True)

    # host cost of one product as the model calls it (quantize.qdot): the
    # int8 drafter's against the full-precision drafter's f32 weight
    c = products[0]
    x = torch.randn((row_counts[0], c["K"]), generator=gen,
                    device="cuda").to(torch.bfloat16)
    qw = {"w8": c["w8"], "scale": c["scale"]}
    host = dict(int8_qdot_us=_host_us(torch, lambda: quantize.qdot(x, qw)),
                f32_qdot_us=_host_us(torch, lambda: quantize.qdot(x, c["w"])),
                shape=f"{c['what']} M{row_counts[0]}")
    print(f"host cost per call ({host['shape']}): int8 qdot "
          f"{host['int8_qdot_us']:.1f} us, f32 qdot {host['f32_qdot_us']:.1f}"
          " us (enqueue only; device time in the rows above)", flush=True)
    del products
    return rows, crossover, host


def _dual_ops(r, n, P, N):
    """(tensor-core, f32) operations of the SSD dual form over r tokens in
    chunks of n. Per chunk of c tokens, on tensor cores: the causal half
    of the scores C_i . B_j (c(c+1)/2 dots of N) and of their product with
    dt x (of P), the inter-chunk term C_i state (2 c P N) and the state's
    update (2 c P N); in f32: dt x (c P) and the state's decay (P N)."""
    def chunk(c):
        return c * (c + 1) * (N + P) + 4 * c * P * N, P * N + c * P
    k, rem = divmod(r, n)
    tc, f32 = (k * v for v in chunk(n))
    if rem:
        tc, f32 = tc + chunk(rem)[0], f32 + chunk(rem)[1]
    return tc, f32


def ssd_work(dt, H, P, G, N, x_bytes):
    """Bytes the scan must move (x, dt, B and C per group, A, the initial
    state in, y and the final state out) and the least time its
    operations can take on this run's data, whatever the kernel's
    chunking: for the r tokens of a (request, head) with dt != 0, the
    faster of the recurrence (per token y_t = state_t C_t, 2 P N; the
    decay and update state exp(dt A) + (dt x) Bᵀ, 3 P N; dt x, P; all f32
    on CUDA cores at 67 TFLOP/s) and the dual form at its best chunk
    length (`_dual_ops`: its products on tensor cores at the 3xTF32 rate,
    495 / 3 TFLOP/s, the rest at 67); each dt = 0 token needs only its y
    (2 P N: f32 for the recurrence, a product for the dual form).
    Multiply and add count as two; the exps are not counted. Returns
    (bytes, tensor-core ops, f32 ops, ops ms)."""
    b, L = dt.shape[:2]
    real = (dt != 0).sum(dim=1).flatten().tolist()          # r per (b, h)
    f32_rate = PEAK_FLOPS["float32"]
    tc_tot = f32_tot = 0
    for r in set(real):
        opts = [(0, r * (5 * P * N + P) + (L - r) * 2 * P * N)]
        for n in range(2, r + 1):
            tc, f32 = _dual_ops(r, n, P, N)
            opts.append((tc + (L - r) * 2 * P * N, f32))
        best = min(opts, key=lambda o: o[0] / TF32X3_FLOPS + o[1] / f32_rate)
        tc_tot += real.count(r) * best[0]
        f32_tot += real.count(r) * best[1]
    nbytes = (b * L * H * P * x_bytes * 2          # x in, y out
              + b * L * H * 4 + H * 4              # dt, A
              + 2 * b * L * G * N * x_bytes        # B, C
              + 2 * b * H * P * N * 4)             # state in and out
    ops_ms = (tc_tot / TF32X3_FLOPS + f32_tot / f32_rate) * 1e3
    return nbytes, tc_tot, f32_tot, ops_ms


def _ssd_inputs(torch, gen, b, L, H, P, G, N, real=None):
    """Scan inputs distributed as the mixer makes them (its activations
    are f32: the f32 in_proj product promotes bf16 inputs), dt = 0 past
    `real` tokens (a masked suffix), and an initial state."""
    import math
    dt_bias = math.log(math.expm1(0.01))
    silu = torch.nn.functional.silu
    x = silu(torch.randn((b, L, H, P), generator=gen, device="cuda"))
    dt = torch.nn.functional.softplus(
        torch.randn((b, L, H), generator=gen, device="cuda") + dt_bias)
    if real is not None:
        dt[:, real:] = 0.0
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    Bm = silu(torch.randn((b, L, G, N), generator=gen, device="cuda"))
    Cm = silu(torch.randn((b, L, G, N), generator=gen, device="cuda"))
    s0 = 0.1 * torch.randn((b, H, P, N), generator=gen, device="cuda")
    return x, dt, A, Bm, Cm, s0


def _ssd_other_plan(sd, p, b, L, H, P, N):
    """The path `plan` did not take at this shape."""
    return sd.chunk_plan(b, L, H, P, N, 4) if p.path == "rec" \
        else sd.rec_plan(P, N)


def _ssd_check(name, part, got, want):
    """max |got - want|, after failing unless got is finite and within
    SSD_TOL of want."""
    if not bool(got.isfinite().all()):
        fail(f"ssd {name}: kernel {part} not finite")
    if not got.allclose(want, rtol=SSD_TOL, atol=SSD_TOL):
        fail(f"ssd {name}: kernel {part} vs plain max |err| "
             f"{float((got - want).abs().max()):.3e} outside "
             f"rtol=atol={SSD_TOL}")
    return float((got - want).abs().max())


def ssd_kernel_phase(torch, sd):
    """The SSD scan kernel at the serving shapes of phases E and F (and a
    case with G > 1), each with an initial state as the mixer always
    passes one: the path `plan` takes and the other one, each against the
    plain version (chunk 128); then the in-place form at decode and
    verify shapes, the two paths across sequence lengths (the crossover)
    and the host cost of one `ssd_slots` call. Returns (rows, in-place
    checks, crossover, host cost)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2024)
    # (name, b, L, H, P, G, N, real tokens): mamba2-130m and jamba widths
    cases = [
        ("mamba2_prefill_b1_L512_H24_P64_N128", 1, 512, 24, 64, 1, 128, 512),
        ("mamba2_final_chunk_b1_L128_88real", 1, 128, 24, 64, 1, 128, 88),
        ("mamba2_verify_b4_L6", 4, 6, 24, 64, 1, 128, 6),
        ("mamba2_decode_b4_L1", 4, 1, 24, 64, 1, 128, 1),
        ("jamba_prefill_b1_L512_H128_P64_N16", 1, 512, 128, 64, 1, 16, 512),
        ("jamba_verify_b4_L6_H128", 4, 6, 128, 64, 1, 16, 6),
        ("jamba_decode_b4_L1_H128", 4, 1, 128, 64, 1, 16, 1),
        ("groups4_b2_L77_H24_P64_N128", 2, 77, 24, 64, 4, 128, 77),
    ]
    rows = []
    for name, b, L, H, P, G, N, real in cases:
        x, dt, A, Bm, Cm, s0 = _ssd_inputs(torch, gen, b, L, H, P, G, N,
                                           real)
        p = sd.plan(b, L, H, P, G, N, torch.float32)
        args = (x, dt, A, Bm, Cm, 128, s0)
        y, st = sd.ssd(*args)
        yp, sp = sd.ssd_chunked(*args)
        torch.cuda.synchronize()
        err_y = _ssd_check(name, "y", y, yp)
        err_s = _ssd_check(name, "state", st, sp)
        # the other path at the same shape, held to the same tolerance
        other = _ssd_other_plan(sd, p, b, L, H, P, N)
        fin = torch.empty_like(s0)
        yo = sd.launch_plan(x, dt, A, Bm, Cm, s0, fin, None, other)
        torch.cuda.synchronize()
        err_o = max(_ssd_check(f"{name} ({other.path})", "y", yo, yp),
                    _ssd_check(f"{name} ({other.path})", "state", fin, sp))
        ms = _graph_ms(torch, lambda: sd.ssd(*args))
        other_ms = _graph_ms(torch, lambda: sd.launch_plan(
            x, dt, A, Bm, Cm, s0, fin, None, other))
        plain_ms = _graph_ms(torch, lambda: sd.ssd_chunked(*args), reps=3)
        nbytes, tc, f32, ops_ms = ssd_work(dt, H, P, G, N, 4)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_bytes, ops_ms)
        by = "bytes" if t_bytes >= ops_ms else "operations"
        rows.append(dict(name=name, path=p.path, pb=p.pb, q=p.q,
                         max_abs_err=max(err_y, err_s, err_o),
                         max_abs_err_y=err_y, max_abs_err_state=err_s,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=None, bytes=nbytes,
                         flops=tc + f32, tc_flops=tc, f32_flops=f32,
                         ops_ms=ops_ms, dtype="float32",
                         other_path=dict(path=other.path, pb=other.pb,
                                         q=other.q, ms=other_ms,
                                         max_abs_err=err_o)))
        print(f"kernel ssd {name}: path {p.path} pb {p.pb} q {p.q}  "
              f"max|err| y {err_y:.2e} state {err_s:.2e}  kernel {ms:.4f} "
              f"ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by}: "
              f"bytes {t_bytes:.4f}, ops {ops_ms:.4f})  {other.path} path "
              f"pb {other.pb} q {other.q} {other_ms:.4f} ms (max|err| "
              f"{err_o:.2e})  library: none", flush=True)
    in_place = ssd_in_place_phase(torch, sd, gen)
    crossover = ssd_crossover(torch, sd, gen)
    x, dt, A, Bm, Cm, _ = _ssd_inputs(torch, gen, 4, 1, 24, 64, 1, 128)
    pool = torch.zeros((16, 24, 64, 128), device="cuda")
    idx = torch.tensor([5, 11, 2, 8], dtype=torch.int32, device="cuda")
    host = dict(ssd_slots_us=_host_us(torch, lambda: sd.ssd_slots(
        x, dt, A, Bm, Cm, 128, pool, idx)), shape="mamba2 decode b4 L1")
    print(f"host cost per call (mamba2 decode b4): ssd_slots "
          f"{host['ssd_slots_us']:.1f} us (enqueue only)", flush=True)
    return rows, in_place, crossover, host


def ssd_in_place_phase(torch, sd, gen):
    """The in-place form at the decode and verify shapes of phases E and
    F, on both paths, with slot_idx scrambled over a pool of 3b + 5 rows:
    the named rows hold what the plain version writes (SSD_TOL), every
    other row stays bitwise as it was, write=False leaves the whole pool
    bitwise unchanged, and the wrapper the mixer calls gives its path's
    bits."""
    out = []
    for name, b, L, H, N in (("mamba2_decode_b4_L1", 4, 1, 24, 128),
                             ("mamba2_verify_b4_L6", 4, 6, 24, 128),
                             ("jamba_decode_b4_L1", 4, 1, 128, 16),
                             ("jamba_verify_b4_L6", 4, 6, 128, 16)):
        P, G, rows = 64, 1, 3 * 4 + 5
        x, dt, A, Bm, Cm, _ = _ssd_inputs(torch, gen, b, L, H, P, G, N)
        pool = 0.1 * torch.randn((rows, H, P, N), generator=gen,
                                 device="cuda")
        perm = torch.randperm(rows, generator=gen, device="cuda")
        idx, others = perm[:b].to(torch.int32), perm[b:].long()
        ref = pool.clone()
        yp = sd.ssd_slots_plain(x, dt, A, Bm, Cm, 128, ref, idx)
        p = sd.plan(b, L, H, P, G, N, torch.float32)
        for path_plan in (p, _ssd_other_plan(sd, p, b, L, H, P, N)):
            for write in (False, True):
                st = pool.clone()
                y = sd.launch_plan(x, dt, A, Bm, Cm, st,
                                   st if write else None, idx, path_plan)
                torch.cuda.synchronize()
                label = f"{name} in place ({path_plan.path}, write={write})"
                err = _ssd_check(label, "y", y, yp)
                if write:
                    err = max(err, _ssd_check(label, "state",
                                              st[idx.long()],
                                              ref[idx.long()]))
                    if not torch.equal(st[others], pool[others]):
                        fail(f"ssd {label}: a row no request names changed")
                elif not torch.equal(st, pool):
                    fail(f"ssd {label}: write=False changed the pool")
                if path_plan == p and write:
                    st2 = pool.clone()
                    if not torch.equal(sd.ssd_slots(x, dt, A, Bm, Cm, 128,
                                                    st2, idx), y) \
                            or not torch.equal(st2, st):
                        fail(f"ssd {label}: ssd_slots differs from its "
                             "plan's launch")
                out.append(dict(case=name, path=path_plan.path, write=write,
                                max_abs_err=err))
                print(f"kernel ssd {label}: pool of {rows} rows, slots "
                      f"{idx.tolist()}; max|err| {err:.2e}; unnamed rows "
                      f"bitwise unchanged" + ("" if write else
                                              "; pool bitwise unchanged"),
                      flush=True)
    return out


def ssd_crossover(torch, sd, gen):
    """Device ms of the recurrence and the chunk path at 4 requests across
    sequence lengths, at mamba2-130m's and jamba's widths: where the
    chunk path starts to win sets `REC_MAX_L`."""
    out = {}
    for label, H, N in (("mamba2", 24, 128), ("jamba", 128, 16)):
        line = []
        for L in (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64):
            x, dt, A, Bm, Cm, s0 = _ssd_inputs(torch, gen, 4, L, H, 64, 1,
                                               N)
            fin = torch.empty_like(s0)
            t = {}
            for p in (sd.rec_plan(64, N), sd.chunk_plan(4, L, H, 64, N, 4)):
                t[p.path] = _graph_ms(torch, lambda: sd.launch_plan(
                    x, dt, A, Bm, Cm, s0, fin, None, p))
            line.append(dict(L=L, rec_ms=t["rec"], chunk_ms=t["chunk"]))
        out[label] = line
        faster = [r["L"] for r in line if r["chunk_ms"] < r["rec_ms"]]
        print(f"ssd crossover {label} b4 (ms rec / chunk): " + "  ".join(
            f"L{r['L']} {r['rec_ms']:.4f}/{r['chunk_ms']:.4f}"
            for r in line) + f"; chunk faster from L "
            f"{min(faster) if faster else 'never (to 64)'}; plan: rec up "
            f"to L {sd.rec_max_l(N)}", flush=True)
    return out


# =====================================================================
# serving phases
# =====================================================================

# SSD scan calls by form: decode, the recurrence above one token
# (verification, commits, drafter extends) and the chunk path (prefill)
SSD_FORMS = ("L = 1", "rec", "chunk")


class PathCounters:
    """Counts, during one serving run, the model's calls of each kernel —
    resident attention reads by form, page-pool reads by form, int8
    products (from the quantized leaves of each forward's params), SSM
    and attention layers of each forward — and the snapshot gathers of
    attention layers with their `take_rows` copies, to hold every
    kernel's launch counter against them; also counts any call of a
    plain version (there must be none). Every count is taken under one
    lock: on the async backend two threads run forwards at once. It also
    records the CUDA stream each thread ran its forwards on and counts
    calls of `torch.cuda.synchronize` (a device-wide wait that would
    serialize the two threads)."""

    def __init__(self):
        import threading

        import torch
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.int8_gemv import ops as ig
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.ssd_scan import ops as sd
        from repro_torch.models import attention as attn
        from repro_torch.models import model as M
        from repro_torch.models import quantize
        self.fa, self.pa, self.ig, self.attn, self.M = fa, pa, ig, attn, M
        self.sd = sd
        self.quantize = quantize
        self.resident, self.paged = {}, {}
        self.int8_products = 0
        self.int8_rows = {}
        self.int8_per_forward = {}
        self.forwards = 0
        self.ssm_layer_calls = 0
        self.attn_layer_calls = 0
        self.snapshots_layers = 0
        self.ssd_forms = dict.fromkeys(SSD_FORMS, 0)
        self.take_rows_calls = 0
        self.plain_calls = 0
        self.device_syncs = 0
        self.streams = {}
        self._torch = torch
        self._lock = threading.Lock()
        self._thread = threading.current_thread
        self._saved = []

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def _n_int8(self, params):
        key = id(params)
        n = self.int8_per_forward.get(key)
        if n is None:
            q = self.quantize.is_quantized
            n = sum(q(w) for layer in params["layers"]
                    for sub in ("mixer", "ffn")
                    for w in layer.get(sub, {}).values())
            n += q(params.get("head")) + q(params["embed"])
            with self._lock:
                self.int8_per_forward[key] = n
        return n

    def __enter__(self):
        orig_attend = self.attn.attend_partial
        orig_paged = self.pa.paged_attend_partial
        orig_apply = self.M.apply
        orig_gather = self.M.gather_paged_slots
        orig_take = self.attn.take_rows
        orig_int8 = self.ig.int8_gemv
        orig_slots = self.sd.ssd_slots
        orig_sync = self._torch.cuda.synchronize
        lock, cuda = self._lock, self._torch.cuda

        def attend(q, k, v, q_pos, k_pos, **kw):
            T = q.shape[1]
            form = ("segment" if kw.get("extra_mask") is not None
                    else "snapshot" if kw.get("slot_idx") is None
                    else "decode" if T == 1
                    else "prefill" if T > 64 else "commit/verify")
            with lock:
                self.resident[form] = self.resident.get(form, 0) + 1
            return orig_attend(q, k, v, q_pos, k_pos, **kw)

        def paged(q, *a, **kw):
            T = q.shape[1]
            form = ("decode" if T == 1 else "prefill" if T > 64
                    else "commit/verify")
            with lock:
                self.paged[form] = self.paged.get(form, 0) + 1
            return orig_paged(q, *a, **kw)

        def apply(params, *a, **kw):
            n_int8 = self._n_int8(params)
            n_ssm = sum("A_log" in layer["mixer"] for layer in params["layers"])
            where = (self._thread().name, cuda.current_stream().cuda_stream)
            with lock:
                self.int8_products += n_int8
                self.forwards += 1
                self.ssm_layer_calls += n_ssm
                self.attn_layer_calls += len(params["layers"]) - n_ssm
                self.streams[where] = self.streams.get(where, 0) + 1
            return orig_apply(params, *a, **kw)

        def gather(cfg, cache, *a, **kw):
            n = sum("slot_pos" in layer["self"] for layer in cache["layers"])
            with lock:
                self.snapshots_layers += n
            return orig_gather(cfg, cache, *a, **kw)

        def take(*a, **kw):
            with lock:
                self.take_rows_calls += 1
            return orig_take(*a, **kw)

        def int8(x, *a, **kw):
            m = x.numel() // x.shape[-1]
            with lock:
                self.int8_rows[m] = self.int8_rows.get(m, 0) + 1
            return orig_int8(x, *a, **kw)

        def slots(x, dt, A, B, C, *a, **kw):
            form = ("L = 1" if x.shape[1] == 1
                    else self.sd.plan_for(x, B).path)
            with lock:
                self.ssd_forms[form] += 1
            return orig_slots(x, dt, A, B, C, *a, **kw)

        def plain(orig):
            def call(*a, **kw):
                with lock:
                    self.plain_calls += 1
                return orig(*a, **kw)
            return call

        def sync(*a, **kw):
            with lock:
                self.device_syncs += 1
            return orig_sync(*a, **kw)

        self._patch(self.attn, "attend_partial", attend)
        self._patch(self.pa, "paged_attend_partial", paged)
        self._patch(self.M, "apply", apply)
        self._patch(self.M, "gather_paged_slots", gather)
        self._patch(self.attn, "take_rows", take)
        self._patch(self.ig, "int8_gemv", int8)
        self._patch(self.sd, "ssd_slots", slots)
        self._patch(cuda, "synchronize", sync)
        for mod, name in ((self.fa, "attend_partial_plain"),
                          (self.pa, "paged_attend_partial_plain"),
                          (self.ig, "int8_gemv_plain"),
                          (self.sd, "ssd_chunked"),
                          (self.sd, "ssd_slots_plain")):
            self._patch(mod, name, plain(getattr(mod, name)))
        self.fa.LAUNCHES = self.pa.LAUNCHES = self.ig.LAUNCHES = 0
        self.sd.LAUNCHES = 0
        return self

    def __exit__(self, *exc):
        self.launches = dict(flash_attention_partial=self.fa.LAUNCHES,
                             paged_flash_decode=self.pa.LAUNCHES,
                             int8_gemv_call=self.ig.LAUNCHES,
                             ssd_scan_pallas=self.sd.LAUNCHES)
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)

    def check(self, label, paged_path: bool, int8_path: bool,
              attention: bool = True, ssm: bool = False):
        """Launch counters against the model's calls; each kernel of the
        phase's path launched at least once, the others never. Every
        forward reads each attention layer's cache once (the resident or
        the paged kernel); verification adds a segment pass."""
        res, pag = sum(self.resident.values()), sum(self.paged.values())
        L = self.launches
        if self.plain_calls:
            fail(f"{label}: {self.plain_calls} plain-version calls")
        if L["flash_attention_partial"] != res or (res > 0) != attention:
            fail(f"{label}: {L['flash_attention_partial']} flash-attention "
                 f"launches for {res} resident attention calls")
        if L["paged_flash_decode"] != pag or (pag > 0) != paged_path:
            fail(f"{label}: {L['paged_flash_decode']} paged launches for "
                 f"{pag} pool reads")
        cache_reads = res - self.resident.get("segment", 0) + pag
        if cache_reads != self.attn_layer_calls:
            fail(f"{label}: {cache_reads} attention cache reads for "
                 f"{self.attn_layer_calls} attention layers of "
                 f"{self.forwards} forwards")
        if L["ssd_scan_pallas"] != self.ssm_layer_calls \
                or (self.ssm_layer_calls > 0) != ssm:
            fail(f"{label}: {L['ssd_scan_pallas']} SSD scan launches for "
                 f"{self.ssm_layer_calls} SSM layers of {self.forwards} "
                 "forwards")
        if sum(self.ssd_forms.values()) != L["ssd_scan_pallas"]:
            fail(f"{label}: SSD scan calls by form {self.ssd_forms} for "
                 f"{L['ssd_scan_pallas']} launches")
        if paged_path and set(self.resident) - {"segment", "snapshot"}:
            fail(f"{label}: resident reads {self.resident} on the paged "
                 "path (only segment passes and snapshots may use kernel 1)")
        if L["int8_gemv_call"] != self.int8_products \
                or (self.int8_products > 0) != int8_path:
            fail(f"{label}: {L['int8_gemv_call']} int8 GEMV launches for "
                 f"{self.int8_products} quantized products")
        if self.take_rows_calls != self.snapshots_layers:
            fail(f"{label}: {self.take_rows_calls} take_rows copies for "
                 f"{self.snapshots_layers} snapshot layer gathers (a pool "
                 "read went through a gathered copy)")


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


def target_references(torch, M, cfg, params, prompts):
    """Greedy reference, top-1/top-2 gaps and path noise of each prompt
    (shared by every phase: all serve the same target and prompts)."""
    out = []
    for p in prompts:
        ref, gaps = greedy_reference(torch, M, cfg, params, p, NEW_TOKENS)
        out.append(dict(ref=ref, gaps=gaps,
                        noise=path_noise(torch, M, cfg, params, p, ref)))
    return out


def make_engine(target, drafters, paged=False, backend=None):
    """The serving phases' engine: `cosine`, two drafters a request, tree
    width 2, on the card."""
    from repro_torch.config import CoSineConfig
    from repro_torch.serving.engine import SpeculativeEngine

    cos = CoSineConfig(n_drafters=len(drafters), drafters_per_request=2,
                       tree_width=2, paged_pool=paged, page_size=PAGE_SIZE,
                       pool_pages=POOL_PAGES)
    return SpeculativeEngine(target, drafters, cos, strategy="cosine",
                             max_len=MAX_LEN, seed=0, backend=backend,
                             device="cuda")


def serve_phase(torch, label, target, drafters, prompts, kernel_err, refs,
                paged=False, int8=False, observe=None, attention=True,
                ssm=False, backend=None, overlap=True):
    """Serve `prompts` through the engine and check the run; returns
    (summary, committed streams, launches by kernel). With
    `backend="async"` the run is also held to the wall-clock backend's
    contract (`check_async_run`) and its wall-clock quantities join the
    summary; `overlap=False` serves the serial twin (no draft-ahead)."""
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    eng = make_engine(target, drafters, paged=paged, backend=backend)
    if backend == "async":
        eng.executor.overlap = overlap
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in prompts]
    extra = observe(eng) if observe is not None else None
    torch.cuda.reset_peak_memory_stats()
    with PathCounters() as calls:
        t0 = time.perf_counter()
        try:
            stats = eng.run()
        finally:
            # the server is joined before anything else runs on the card
            eng.backend.shutdown()
        syncs_in_run = calls.device_syncs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls.check(label, paged, int8, attention=attention, ssm=ssm)
    if backend == "async":
        wallclock = check_async_run(torch, label, eng, stats, calls,
                                    syncs_in_run, overlap)
    if stats.total_committed != len(prompts) * NEW_TOKENS:
        fail(f"{label}: committed {stats.total_committed} tokens, expected "
             f"{len(prompts) * NEW_TOKENS}")

    tcfg, tparams = target
    results, streams = [], []
    for r, p, rf in zip(reqs, prompts, refs):
        gen = list(map(int, r.generated))
        streams.append(gen)
        if len(gen) != NEW_TOKENS:
            fail(f"{label}: request {r.rid} generated {len(gen)} tokens")
        ref, gaps, noise = rf["ref"], rf["gaps"], rf["noise"]
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
        kernel_launches=calls.launches, resident_attention_calls=calls.resident,
        pool_reads=calls.paged, int8_products=calls.int8_products,
        int8_calls_by_rows=dict(sorted(calls.int8_rows.items())),
        forwards=calls.forwards, ssm_layer_calls=calls.ssm_layer_calls,
        attention_layer_calls=calls.attn_layer_calls,
        int8_products_per_forward=sorted(set(
            calls.int8_per_forward.values())),
        snapshot_layer_gathers=calls.snapshots_layers,
        ssd_launches_by_form=calls.ssd_forms,
        setup_s=t_setup, peak_mem_gb=peak_gb, requests_detail=results)
    if extra is not None:
        summary.update(extra())
    if backend == "async":
        summary.update(wallclock)
    print(f"{label}: wall clock {wall:.2f} s for {stats.total_committed} "
          f"tokens ({stats.total_committed / wall:.1f} tokens/s on the "
          f"card); simulated-clock throughput {stats.throughput_tps:.1f} "
          f"tokens/s (the engine's latency model, not a measurement); "
          f"mean acceptance {stats.mean_acceptance:.3f}; launches "
          f"{calls.launches} = resident attention calls {calls.resident}, "
          f"pool reads {calls.paged}, int8 products {calls.int8_products}, "
          f"SSM layers {calls.ssm_layer_calls} of {calls.forwards} forwards "
          f"(SSD launches by form {calls.ssd_forms})", flush=True)
    return summary, streams, calls.launches


def check_async_run(torch, label, eng, stats, calls, syncs_in_run, overlap):
    """Hold a run of the wall-clock backend to its contract and gather
    the reference's wall-clock quantities (`benchmarks/wallclock.py`):
    the target's forwards ran on the server thread's stream and the
    drafters' on the engine thread's, two distinct streams, neither the
    legacy default one; no device-wide synchronize ran during the run.
    Returns overlap_frac (the share of cohorts whose drafting began
    before the previous verification finished), the verifier idle
    fraction, the draft-ahead outcomes and the server's spans summed by
    kind."""
    from repro_torch.serving.backend import AsyncTorchBackend

    b = eng.backend
    if not isinstance(b, AsyncTorchBackend):
        fail(f"{label}: the engine did not get the async backend")
    default = torch.cuda.default_stream().cuda_stream
    ts, ds = b.target_stream.cuda_stream, b.draft_stream.cuda_stream
    server, engine = set(), set()
    n_server = n_engine = 0
    for (thread, stream), n in calls.streams.items():
        if thread.startswith("verify-server"):
            server.add(stream)
            n_server += n
        else:
            engine.add(stream)
            n_engine += n
    if server != {ts} or engine != {ds} or ts == ds or default in (ts, ds):
        fail(f"{label}: forwards ran on streams {calls.streams} (server "
             f"{ts}, drafters {ds}, default {default})")
    if syncs_in_run:
        fail(f"{label}: {syncs_in_run} torch.cuda.synchronize calls during "
             "the run (a device-wide wait serializes the two threads)")
    rs = stats.records
    hits = sum(1 for prev, nxt in zip(rs, rs[1:])
               if nxt.draft_start_ms < prev.verify_start_ms + prev.verify_ms)
    overlap_frac = hits / max(len(rs) - 1, 1)
    busy, idle = stats.verifier_busy_ms, stats.verifier_idle_ms
    spans, tasks = {}, {}
    for sp in b.timeline:
        spans[sp["kind"]] = spans.get(sp["kind"], 0.0) + sp["t1"] - sp["t0"]
        tasks[sp["kind"]] = tasks.get(sp["kind"], 0) + 1
    out = dict(backend="async", overlap=overlap, overlap_frac=overlap_frac,
               verifier_busy_ms=busy, verifier_idle_ms=idle,
               verifier_idle_frac=idle / max(busy + idle, 1e-9),
               draft_ahead_survived=eng.executor.n_survived,
               draft_ahead_invalidated=eng.executor.n_invalidated,
               server_ms_by_kind=spans, server_tasks_by_kind=tasks,
               server_forwards=n_server,
               engine_forwards=n_engine)
    print(f"{label}: overlap_frac {overlap_frac:.3f} ({hits} of "
          f"{len(rs) - 1} cohorts began drafting before the previous "
          f"verification finished); verifier busy {busy:.1f} ms, idle "
          f"{idle:.1f} ms (idle fraction {out['verifier_idle_frac']:.3f}); "
          f"draft-ahead survived {eng.executor.n_survived}, invalidated "
          f"{eng.executor.n_invalidated}; server spans by kind (ms, tasks) "
          f"{ {k: (round(v, 1), tasks[k]) for k, v in spans.items()} }; "
          f"forwards on the "
          f"server's stream {n_server}, on the drafters' {n_engine}",
          flush=True)
    return out


class HostLog:
    """Wall intervals (perf_counter seconds) of labelled host work, per
    thread: wraps functions so that each call is recorded as (thread,
    label, t0, t1). Used by the profiler window to say what each host
    thread was doing while the device idled."""

    def __init__(self):
        import threading
        self.spans = []
        self._lock = threading.Lock()
        self._thread = threading.current_thread
        self._saved = []

    def wrap(self, owner, name, label):
        orig = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append((self._thread().name, label, t0, t1))

        self._saved.append((owner, name, orig))
        setattr(owner, name, timed)

    def restore(self):
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_async_window(torch, target, drafters, prompts, warm=4, steps=6):
    """`torch.profiler` over `steps` iterations of phase H's engine (after
    `warm` unprofiled ones): the device's busy share over the window (the
    union of its kernels, copies and sets), the device operations that
    took the most time, and the longest device-idle gaps with what each
    host thread was doing meanwhile (labelled wall intervals of the
    server's and the engine's calls). Returns a summary dict (not a trace
    file)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serving import backend as backend_mod

    eng = make_engine(target, drafters, backend="async")
    b = eng.backend
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    host = HostLog()
    host.wrap(b.target, "verify_device", "server: verify forward (enqueue)")
    host.wrap(b.target, "extend_committed", "server: commit forward")
    host.wrap(b.target, "prefill_requests", "server: target prefill")
    host.wrap(torch.cuda.Stream, "synchronize",
              "server: wait for its stream")
    for name in ("draft_snapshot", "draft_extend", "draft_decode",
                 "prefill_drafters", "commit_drafters"):
        host.wrap(b, name, f"engine: drafter {name.split('_', 1)[1]}")
    host.wrap(backend_mod.VerifyHandle, "result",
              "engine: wait for verification + logits to host")
    host.wrap(eng, "_resolve_tails", "engine: wait for commit tails")
    try:
        with b.engine_stream():
            for _ in range(warm):
                eng.step()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("chip_smoke anchor"):
                    t_anchor = time.perf_counter()
                t_w0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                t_w1 = time.perf_counter()
    finally:
        host.restore()
        b.shutdown()
    events = prof.events()
    anchor = [e for e in events if e.name == "chip_smoke anchor"]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not anchor or not dev:
        print("phase H profiler: torch.profiler recorded no device "
              "activity; device busy share not measured", flush=True)
        return dict(profiler="no device activity recorded")
    # profiler times are us from the trace's start; host spans are
    # perf_counter seconds: the anchor ties the two clocks
    off = anchor[0].time_range.start - t_anchor * 1e6

    def us(t):
        return t * 1e6 + off

    w0, w1 = us(t_w0), us(t_w1)
    ivals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in dev if e.time_range.end > w0 and e.time_range.start < w1]
    merged = _merge(ivals)
    busy = sum(b1 - b0 for b0, b1 in merged)
    by_name = {}
    for e in dev:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:5]
    spans = [(th, lab, us(a), us(bb)) for th, lab, a, bb in host.spans]
    threads = sorted({th for th, *_ in spans})
    gap_rows = []
    for length, g0, g1 in gaps:
        doing = {}
        for th in threads:
            acc = {}
            for th2, lab, a, bb in spans:
                ov = min(bb, g1) - max(a, g0)
                if th2 == th and ov > 0:
                    acc[lab] = acc.get(lab, 0.0) + ov
            acc["(unlabelled host work or idle)"] = max(
                0.0, length - sum(acc.values()))
            doing[th] = {k: round(v / 1e3, 3) for k, v in
                         sorted(acc.items(), key=lambda kv: -kv[1])}
        gap_rows.append(dict(ms=length / 1e3, starts_ms=(g0 - w0) / 1e3,
                             host=doing))
    window_ms = (w1 - w0) / 1e3
    out = dict(window_ms=window_ms, steps=steps,
               device_busy_ms=busy / 1e3, device_busy_share=busy / (w1 - w0),
               device_ops=len(ivals),
               top_device_ops=[dict(name=n, calls=c, ms=t / 1e3)
                               for n, (c, t) in top],
               longest_idle_gaps=gap_rows,
               profiled_cpu_threads=sorted({e.thread for e in events
                                            if e.device_type
                                            == DeviceType.CPU}))
    print(f"phase H profiler: {steps} iterations in {window_ms:.1f} ms; the "
          f"device was busy {busy / 1e3:.1f} ms ({out['device_busy_share']:.1%}"
          f" of the window) over {len(ivals)} device operations", flush=True)
    for row in out["top_device_ops"]:
        print(f"  device op {row['ms']:8.2f} ms {row['calls']:6d} calls  "
              f"{row['name'][:100]}", flush=True)
    for g in gap_rows:
        print(f"  device idle {g['ms']:.3f} ms from {g['starts_ms']:.2f} ms: "
              f"{g['host']}", flush=True)
    return out


def observe_pools(eng, label="phase C"):
    """Phases C and G: peak pages held by each model's pool, and pages
    held and fragmentation when the first request completes (all four
    live)."""
    from repro_torch.serving.runner import PagedSlotCacheManager
    names = ["target"] + [f"drafter {i}" for i in range(len(eng.drafters))]
    mgrs = [r.slots for r in [eng.target] + list(eng.drafters)]
    for m in mgrs:
        if not isinstance(m, PagedSlotCacheManager):
            fail(f"{label}: the runners did not get a paged pool")
    seen = {id(m): dict(peak=0, at_first_release=None) for m in mgrs}
    for m in mgrs:
        alloc, release = m._alloc_page, m.release

        def alloc_page(m=m, alloc=alloc):
            page = alloc()
            s = seen[id(m)]
            s["peak"] = max(s["peak"], m.pages_held() + 1)
            return page

        def rel(rid, m=m, release=release):
            s = seen[id(m)]
            if s["at_first_release"] is None:
                s["at_first_release"] = (m.pages_held(), m.fragmentation())
            return release(rid)

        m._alloc_page, m.release = alloc_page, rel

    def report():
        out = {}
        for name, m in zip(names, mgrs):
            s = seen[id(m)]
            held, frag = s["at_first_release"]
            out[name] = dict(page_size=m.page_size, pool_pages=m.n_pages,
                             pool_growths=m.n_page_growths,
                             peak_pages_held=s["peak"],
                             pages_held_at_first_completion=held,
                             fragmentation_at_first_completion=frag,
                             pages_held_at_end=m.pages_held())
            print(f"{label} {name} pool: page size {m.page_size}, "
                  f"{POOL_PAGES} -> {m.n_pages} pages ({m.n_page_growths} "
                  f"growths), peak {s['peak']} pages held; at the first "
                  f"completion {held} pages held, fragmentation "
                  f"{frag:.3f}; at the end {m.pages_held()}", flush=True)
            if m.n_page_growths < 1:
                fail(f"{label}: the {name} pool never grew")
        return dict(pools=out)

    return report


def observe_drafter_steps(eng):
    """Phase D: mean wall ms of each drafter's decode step (one batched
    snapshot decode, ending with the logits on the host)."""
    import torch
    times = [[] for _ in eng.drafters]
    for i, runner in enumerate(eng.drafters):
        orig = runner.decode

        def timed(*a, orig=orig, i=i, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            torch.cuda.synchronize()
            times[i].append((time.perf_counter() - t0) * 1e3)
            return out

        runner.decode = timed

    def report():
        means = [sum(t) / max(len(t), 1) for t in times]
        for i, (m, t) in enumerate(zip(means, times)):
            kind = "int8" if eng.drafters[i].cfg.quant == "int8" else "f32"
            print(f"phase D drafter {i} ({kind} weights): {len(t)} decode "
                  f"steps, mean {m:.3f} ms per step (host clock, logits on "
                  f"the host)", flush=True)
        return dict(drafter_decode_ms=means,
                    drafter_decode_steps=[len(t) for t in times])

    return report


def compare_wallclock(async_sum, serial_sum, sim_sum):
    """A wall-clock phase beside its simulated twin (phase A or E) and,
    where there is one, its serial twin: wall tokens/s of each, the
    verifier idle fractions and their ratio `idle_ratio` (the
    reference's `wallclock_serving` row; reported, not gated)."""
    label = async_sum["phase"]
    out = dict(phase=label,
               wall_tokens_per_s=async_sum["wall_tokens_per_s"],
               simulated_backend_wall_tokens_per_s=sim_sum[
                   "wall_tokens_per_s"],
               simulated_backend_phase=sim_sum["phase"],
               overlap_frac=async_sum["overlap_frac"],
               verifier_idle_frac=async_sum["verifier_idle_frac"])
    line = (f"{label}: wall {async_sum['wall_tokens_per_s']:.2f} tokens/s on "
            f"the async backend; {sim_sum['phase']} (simulated backend) "
            f"{sim_sum['wall_tokens_per_s']:.2f} tokens/s on the card")
    if serial_sum is not None:
        ratio = (async_sum["verifier_idle_frac"]
                 / max(serial_sum["verifier_idle_frac"], 1e-9))
        out.update(serial_wall_tokens_per_s=serial_sum["wall_tokens_per_s"],
                   serial_overlap_frac=serial_sum["overlap_frac"],
                   serial_verifier_idle_frac=serial_sum[
                       "verifier_idle_frac"],
                   idle_ratio=ratio)
        line += (f"; {serial_sum['phase']} "
                 f"{serial_sum['wall_tokens_per_s']:.2f} tokens/s; verifier "
                 f"idle fraction {async_sum['verifier_idle_frac']:.3f} "
                 f"(serial {serial_sum['verifier_idle_frac']:.3f}), "
                 f"idle_ratio {ratio:.3f} (reported, not gated)")
    print(line, flush=True)
    return out


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import (JAMBA_V0_1_52B, MAMBA2_130M,
                                         QWEN1_5_4B, QWEN2_0_5B)
        from repro_torch.configs.drafters import int8_variant
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.int8_gemv import ops as ig
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.ssd_scan import ops as sd
        from repro_torch.models import model as M
        from repro_torch.models import quantize
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

    t_start = time.perf_counter()
    t0 = time.perf_counter()
    libraries = [fa.LIBRARY, pa.LIBRARY, ig.LIBRARY, sd.LIBRARY]
    build.build_all(libraries)
    print(f"kernel build+load ({len(libraries)} nvcc in parallel) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libraries:
        # ptxas report per instantiation: registers, shared memory, spills
        for line in (lib.build_log or "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"{lib.name}: {line.strip()}", flush=True)

    fa_rows, fa_host = kernel_phase(torch, fa)
    pa_rows = paged_kernel_phase(torch, fa, pa)
    sd_rows, sd_in_place, sd_crossover, sd_host = ssd_kernel_phase(torch, sd)
    kernel_err = max(r["max_abs_err"] for r in fa_rows + pa_rows)
    ssm_kernel_err = max(kernel_err, max(r["max_abs_err"] for r in sd_rows))
    paged_exact = all(r["max_abs_diff_vs_kernel1"] == 0.0 for r in pa_rows)
    gc.collect()
    torch.cuda.empty_cache()

    def make_prompts(cfg):
        rng = np.random.default_rng(0)
        return [rng.integers(1, cfg.vocab, n).tolist() for n in PROMPT_LENS]

    launches = {name: 0 for name in KERNEL_SOURCES}
    ssd_forms = {}
    summaries = []

    def run(label, target, drafters, prompts, refs, err, **kw):
        summary, streams, counts = serve_phase(
            torch, label, target, drafters, prompts, err, refs, **kw)
        for name, n in counts.items():
            launches[name] += n
        if kw.get("ssm"):
            ssd_forms[label] = summary["ssd_launches_by_form"]
        summaries.append(summary)
        gc.collect()
        torch.cuda.empty_cache()
        return summary, streams

    def references(cfg, params, prompts):
        t0 = time.perf_counter()
        refs = target_references(torch, M, cfg, params, prompts)
        print(f"{cfg.name}: greedy references {time.perf_counter() - t0:.1f}"
              " s", flush=True)
        return refs

    # ---- phases A-D: qwen1.5-4b target, qwen2-0.5b drafters
    prompts = make_prompts(QWEN1_5_4B)
    t0 = time.perf_counter()
    tparams = M.init_params(QWEN1_5_4B, seed=0, device="cuda")
    dparams = [M.init_params(QWEN2_0_5B, seed=1 + i, device="cuda")
               for i in range(2)]
    torch.cuda.synchronize()
    print(f"weights {time.perf_counter() - t0:.1f} s", flush=True)
    refs = references(QWEN1_5_4B, tparams, prompts)
    target = (QWEN1_5_4B, tparams)
    dense = dict(target=target, prompts=prompts, refs=refs, err=kernel_err)

    # phase A: qwen1.5-4b target + two qwen2-0.5b drafters
    full = [(QWEN2_0_5B, dparams[i], f"d{i}") for i in range(2)]
    sum_a, streams_a = run("phase A", drafters=full, **dense)
    # phase B: perfect drafters sharing the target's weights
    sum_b, _ = run("phase B", drafters=[(QWEN1_5_4B, tparams, f"p{i}")
                                        for i in range(2)], **dense)
    if not sum_b["mean_acceptance"] > 1.0:
        fail(f"phase B mean acceptance {sum_b['mean_acceptance']:.3f} <= 1")
    # phase C: phase A on the paged KV pool
    _, streams_c = run("phase C", drafters=full, paged=True,
                       observe=observe_pools, **dense)
    same = sum(a == c for a, c in zip(streams_a, streams_c))
    print(f"phase C: {same}/{len(prompts)} committed streams equal phase "
          f"A's token for token (paged kernel bitwise equal to kernel 1 "
          f"on the gathered view: {paged_exact})", flush=True)
    if paged_exact and same != len(prompts):
        fail("phase C: the paged pool committed other tokens than the "
             "resident pool although the kernels agree bit for bit")
    # phase D: drafter 0 with int8 weights beside a full-precision drafter 1
    mixed = [(int8_variant(QWEN2_0_5B), dparams[0], "d0"),
             (QWEN2_0_5B, dparams[1], "d1")]
    sum_d, _ = run("phase D", drafters=mixed, int8=True,
                   observe=observe_drafter_steps, **dense)
    per_fwd = sum_d["int8_products_per_forward"]
    if per_fwd != [0, QWEN2_0_5B.n_layers * 7 + 1]:
        fail(f"phase D: quantized products per forward {per_fwd}, expected "
             f"0 and {QWEN2_0_5B.n_layers * 7 + 1}")
    by_rows = sum_d["int8_calls_by_rows"]
    int8_launch_classes = {k: 0 for k in ("decode", "extend", "prefill")}
    for m, n in by_rows.items():
        int8_launch_classes[int8_row_class(m)] += n
    print(f"phase D int8 launches by rows {by_rows}: {int8_launch_classes}",
          flush=True)
    # phases H and H-serial: phase A on the wall-clock backend, drafting
    # the next cohort while a verification is in flight, then its serial
    # twin (no draft-ahead); then a profiler window over phase H's loop
    sum_h, _ = run("phase H", drafters=full, backend="async", **dense)
    sum_hs, _ = run("phase H-serial", drafters=full, backend="async",
                    overlap=False, **dense)
    wallclock = compare_wallclock(sum_h, sum_hs, sum_a)
    if sum_h["overlap_frac"] < 0.5:
        fail(f"phase H: overlap_frac {sum_h['overlap_frac']:.3f} < 0.5 "
             "(drafting did not overlap verification: serialized)")
    wallclock["profile"] = profile_async_window(torch, target, full, prompts)
    gc.collect()
    torch.cuda.empty_cache()
    del tparams, dparams, full, mixed, target, dense
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 kernel at the row counts phase D gave it: its most frequent
    # decode and extend counts, and a full prefill chunk
    def most_frequent(lo, hi, default):
        seen = [(n, m) for m, n in by_rows.items() if lo <= m <= hi]
        return max(seen)[1] if seen else default
    int8_rows = (most_frequent(1, 8, 4), most_frequent(9, 63, 24), 512)
    ig_rows, crossover, ig_host = int8_kernel_phase(torch, ig, quantize,
                                                    int8_rows)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase E: mamba2-130m target and drafters (SSD layers only)
    mcfg = MAMBA2_130M
    mprompts = make_prompts(mcfg)
    mparams = M.init_params(mcfg, seed=10, device="cuda")
    mdraft = M.init_params(mcfg, seed=11, device="cuda")
    mrefs = references(mcfg, mparams, mprompts)
    sum_e, _ = run("phase E", target=(mcfg, mparams),
                   drafters=[(mcfg, mparams, "m0"), (mcfg, mdraft, "m1")],
                   prompts=mprompts, refs=mrefs, err=ssm_kernel_err,
                   attention=False, ssm=True)
    if not sum_e["mean_acceptance"] > 1.0:
        fail(f"phase E mean acceptance {sum_e['mean_acceptance']:.3f} <= 1")
    # phase I: phase E on the wall-clock backend (the target's SSM state
    # written in place on the server's stream, the drafters' on the
    # engine's)
    sum_i, _ = run("phase I", target=(mcfg, mparams),
                   drafters=[(mcfg, mparams, "m0"), (mcfg, mdraft, "m1")],
                   prompts=mprompts, refs=mrefs, err=ssm_kernel_err,
                   attention=False, ssm=True, backend="async")
    wallclock["phase I"] = compare_wallclock(sum_i, None, sum_e)
    for label, sm in (("phase E", sum_e), ("phase I", sum_i)):
        if sm["ssm_layer_calls"] != mcfg.n_layers * sm["forwards"]:
            fail(f"{label}: {sm['ssm_layer_calls']} SSM layer calls for "
                 f"{sm['forwards']} forwards of {mcfg.n_layers} layers")
    if not sum_i["mean_acceptance"] > 1.0:
        fail(f"phase I mean acceptance {sum_i['mean_acceptance']:.3f} <= 1")
    del mparams, mdraft
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phases F and G: jamba widths, 8 layers (attention at layer 4),
    # the dense FFN in place of the MoE (not ported)
    hcfg = JAMBA_V0_1_52B.with_overrides(n_layers=8, moe=None)
    n_ssm = sum(hcfg.layer_kind(i) == "ssm" for i in range(hcfg.n_layers))
    if (n_ssm, hcfg.layer_kind(4)) != (7, "attn"):
        fail(f"phase F: the cut plan has {n_ssm} SSM layers")
    hprompts = make_prompts(hcfg)
    t0 = time.perf_counter()
    hparams = M.init_params(hcfg, seed=20, device="cuda")
    torch.cuda.synchronize()
    print(f"jamba-width weights {time.perf_counter() - t0:.1f} s", flush=True)
    hrefs = references(hcfg, hparams, hprompts)
    hybrid = dict(target=(hcfg, hparams),
                  drafters=[(hcfg, hparams, f"h{i}") for i in range(2)],
                  prompts=hprompts, refs=hrefs, err=ssm_kernel_err, ssm=True)
    sum_f, streams_f = run("phase F", **hybrid)
    sum_g, streams_g = run("phase G", paged=True,
                           observe=lambda e: observe_pools(e, "phase G"),
                           **hybrid)
    for label, sm in (("phase F", sum_f), ("phase G", sum_g)):
        if not sm["mean_acceptance"] > 1.0:
            fail(f"{label} mean acceptance {sm['mean_acceptance']:.3f} <= 1")
        if sm["ssm_layer_calls"] != n_ssm * sm["forwards"] or \
                sm["attention_layer_calls"] != sm["forwards"]:
            fail(f"{label}: {sm['ssm_layer_calls']} SSM and "
                 f"{sm['attention_layer_calls']} attention layer calls for "
                 f"{sm['forwards']} forwards")
    same = sum(f == g for f, g in zip(streams_f, streams_g))
    print(f"phase G: {same}/{len(hprompts)} committed streams equal phase "
          "F's token for token", flush=True)
    if same != len(hprompts):
        fail("phase G: the paged pool committed other tokens than the "
             "resident pool")
    del hparams, hybrid
    gc.collect()
    torch.cuda.empty_cache()

    print(json.dumps({"serving": summaries}), flush=True)
    print(json.dumps({"wallclock": wallclock}), flush=True)
    kernels = []
    extra = {"flash_attention_partial": dict(host=fa_host),
             "int8_gemv_call": dict(host=ig_host, crossover=crossover,
                                    launches_by_rows=int8_launch_classes),
             "ssd_scan_pallas": dict(host=sd_host, crossover=sd_crossover,
                                     in_place=sd_in_place,
                                     rec_max_l={"N128": sd.rec_max_l(128),
                                                "N16": sd.rec_max_l(16)},
                                     launches_by_form=ssd_forms)}
    for name, rows in (("flash_attention_partial", fa_rows),
                       ("paged_flash_decode", pa_rows),
                       ("int8_gemv_call", ig_rows),
                       ("ssd_scan_pallas", sd_rows)):
        source, replaces = KERNEL_SOURCES[name]
        tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms")}
        lib = [r["library_ms"] for r in rows]
        t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        # (the SSD rows count their tensor-core operations at that unit's
        # rate: `ops_ms`)
        t_ops = sum(r.get("ops_ms", r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3)
                    for r in rows)
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if None in lib else sum(lib),
            **extra.get(name, {}),
            note="times are sums over one call of each shape below"
                 + ("; no PyTorch call computes the scan" if None in lib
                    else ""),
            shapes=rows))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
