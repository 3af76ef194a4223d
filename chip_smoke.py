#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's four hand-written Hopper kernels (kernels 1 and 2 with
their f32, bf16 and int8 K/V forms, their many-row form for f32 / bf16
K/V from `R_MMA` query rows a (request, KV head), their latent form for
MLA and their (120, 120) instantiation; kernel 1's non-causal form for
cross-attention and the Whisper encoder) from the sources
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
  phase B  the target's first 8 layers (`B_LAYERS`) with two "perfect"
           drafters that share its weights (mean acceptance must
           exceed 1);
  phase C  phase A on the paged KV pool (page_size 64, a pool of 16
           pages per model that must grow): every pool read goes through
           the paged-attention kernel, and the committed streams equal
           phase A's;
  phase D  phase A with drafter 0 as int8 weights beside a
           full-precision drafter 1: every quantized product goes
           through the int8 GEMV kernel (launches printed by row count);
  phase E  a mamba2-130m target (full width, cut to 8 of its 24 SSD
           layers, `E_LAYERS`; random f32 weights, bf16 activations)
           with two such mamba2-130m drafters, one
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
  phases T-ar, T-vanilla, T-specinfer, T-pipeinfer, T-ablate (phase A's
           models, prompts and references) the paper's baselines and the
           ablation switches on the simulated backend: `ar` (no drafter
           forward; the target's forwards are its iterations and prefill
           writes), `vanilla` (drafter 0 alone decodes, chain trees),
           `specinfer` (both drafters draft every request into one merged
           tree), `pipeinfer` (the pipelined executor; draft-ahead
           outcomes printed) and `cosine` with routing, fusion and
           sub-batch drafting off and the burst prefill on, one drafter
           a request (one masked prefill write for the burst, every
           drafter decoding every request);
  phases H-pipeinfer, H-paged, H-int8  the wall-clock backend serving
           `pipeinfer` (`overlap_frac` >= 0.5), phase H on the paged pool
           (streams equal phase H's; pages held and pool growths
           printed) and phase H with phase D's drafters (streams equal
           phase H's where phase D's equal A's; int8 launches by row
           count), each held to phase H's contract (`check_async_run`)
           and compared with its simulated twin (C, D: where the streams
           differ, the first token and the reference's gap there);
  phase I  phase E on the wall-clock backend (the target's SSM state
           written in place on the server's stream);
  phase K  phase A's models cut to their first 8 and 4 layers
           (`K_LAYERS`) with int8 KV caches (`kv_dtype="int8"`) for the
           target and both drafters: every cache read, snapshots
           included, goes
           through kernel 1's int8 K/V form (only verification's fresh
           segment, unquantized as in the reference, reads bf16 K/V);
  phase K-paged  phase K on the paged pool: every pool read through the
           paged kernel's int8 form, and the committed streams equal
           phase K's; then a `torch.profiler` window over 5 of phase K's
           iterations (the int8 forms' share of the device's busy time);
  phase J  a qwen2-moe-a2.7b target at full width (d_model 2048, MHA
           16 x 128 with QKV bias, 60 routed experts top-4 of width 1408
           and a shared expert of 5632 in every layer, vocab 151936), cut
           to 4 of its 24 layers (`J_LAYERS`; random f32 weights), with
           two qwen2-0.5b drafters cut to 4 of their 24 layers: every
           MoE layer of every forward counted with its
           one host read of the group sizes, the host wall time per MoE
           layer, and the router top-k sets that differ between a
           one-token decode and a batched prefill on the committed prefix;
  phase J-f32  phase J with f32 activations (the same weights), where the
           two paths agree closely enough for a tight tie rule;
  phase L  (last, after J's weights are released) a deepseek-v3-671b
           target at full width (d_model 7168, 128 MLA heads, q_lora
           1536, kv_lora 512, nope 128, rope 64, v 128, vocab 129280)
           cut to its own first 4 of 61 layers (dense FFN of 18432 in
           layers 0-2, 256 routed experts top-8 of 2048 and a shared
           expert in layer 3; the MTP subtree in the params; ~63 GB of
           random f32 weights), two drafters sharing its weights, phase
           A's requests: every attention call on the kernels' latent form
           (launches = MLA layers x cache reads + segment passes);
  phase L-paged  phase L on the paged pool (as phase C): every pool read
           on the paged kernel's latent form, streams equal phase L's;
  phase L-f32  phase L with f32 activations: the greedy streams committed
           exactly; then a `torch.profiler` window over a few of phase
           L's iterations (the latent kernels' and the MoE layer's share
           of the device's busy time);
  phase M  (after L's weights are released) an h2o-danube3-4b target at
           full width cut to 8 of its 24 layers (`M_LAYERS`; d_model
           3840, GQA 32/8 of head width 120, SWA 4096; random f32
           weights) with
           two llama-68m drafters (seeds 1 and 2): every cache read of
           the target on the kernels' (120, 120) instantiation;
  phase M-paged  phase M on the paged pool: streams equal phase M's;
  phase M-int8  phase M with int8 KV caches for the target and both
           drafters (resident): every D 120 cache read of the target on
           the kernels' int8 form, streams under the tie rule;
  phase N  llama-3.2-vision-11b at full width cut to 10 of its 40 layers
           (`N_LAYERS`; d_model 4096, GQA 32/8 of 128, cross-attention
           layers 3 and 8 over 1601 frontend rows; random f32 weights):
           first
           the image check (`image_check`: a seeded (4, 1601, 4096)
           frontend prefilled with the prompts, 16 batched greedy decodes
           reading the cross rows on kernel 1's non-causal form, held
           against `apply(frontend=...)` over each whole sequence), then
           a text-only serve (no frontend, as the reference's serving)
           with two drafters sharing its weights;
  phase O  whisper-small at full width and depth (12 encoder and 12
           decoder layers, d_model 768, MHA 12 x 64, 1500 encoder rows,
           LayerNorm, GELU, learned positions): the image check with
           seeded (4, 1500, 768) frames (the encoder on kernel 1,
           non-causal, T = S = 1500), then the text-only serve;
  phase P  training: qwen2-0.5b at full width and depth (24 layers, f32
           parameters, bf16 activations, vocab 151936) fine-tuned with
           `launch.train.train_model` (8 AdamW steps of 4 x 513 tokens
           of one domain of a 1024-token synthetic corpus): every
           attention forward on kernel 1 (its many-row form) with the
           gradient of `fa.attention`; the first step's loss and every
           gradient leaf held against the same step through autograd of
           the plain version (at f32 and at bf16 activations,
           `GRAD_TOL`); the loss must fall; the trained weights written
           to a msgpack checkpoint and read back bit for bit; step time,
           tokens/s, peak memory and the step's bound printed beside the
           card's name and power limit;
  phase Q  trained drafters served: `launch.serve.build_models` (the
           reference's recipe: a tiny target on the domain mixture and
           a tiny drafter a domain, vocab 96) trained on the card,
           written to checkpoints and read back, one drafter loaded
           int8-quantized (its products on kernel 3); 8 requests served
           with `cosine` under the tie rule, acceptance by domain, then
           the same configs at their untrained weights: mean acceptance
           must exceed 1 and the untrained twin's;
  phase R  training an SSM model: mamba2-130m at full width and depth
           (24 layers, d_model 768, 24 SSD heads of 64, d_state 128,
           vocab 50280; 168 M f32 parameters) fine-tuned as phase P: every
           SSD scan's forward on the SSD kernel's chunk path (24 launches
           a step) with the tensor-op gradient `ssd_grad`
           (`SSDScanFunction`); phase P's gates (gradient checks against
           the plain oracle's autograd through `ssd_chunked`, the loss
           falling, a bit-exact checkpoint);
  phase R-hybrid  jamba-v0.1-52b's widths cut to an SSM and an attention
           layer (dense FFNs, d_state 16): one step's gradient checks at
           f32 and bf16, the scan's and kernel 1's gradients in one loss;
  phase S  the sharding rules on the card: a world-size-1 NCCL group
           from an in-memory store, a (1, 1) ("data", "model")
           DeviceMesh, qwen2-0.5b's parameters placed by the serve rules
           (`distributed/sharding.py::distribute`): each local tensor
           bit for bit its original, its bytes the dry-run's reckoning;
           the group torn down after.

Before the serving phases the int8 K/V forms of kernels 1 and 2 (a
kernel of their own, `int8_kernel`, whose compiled registers and spills
are printed) are held against their plain versions (the reference's
dequantized bf16 view) at phases K and K-paged's shapes and timed beside
their bound (int8 K/V and two 4-byte scales per row and head; the
operations at the bf16 tensor-core rate their products run at) and a
dequantize + SDPA yardstick; the paged int8 form must equal kernel 1's
int8 form on the gathered view bit for bit; phase M-int8's target shapes
(Hkv 8, G 4, D 120) are held the same way. The latent form of both kernels (MLA's one KV
head: Dk 576, Dv 512, G 128) is held the same way at phase L's shapes
(decode, the tree's cache pass and segment, a T = 6 commit, a T = 512
prefill; f32 and bf16 K/V) beside SDPA over K/V expanded to 128 heads
(the backend it takes is printed), with a V of its own and with V = K's
first 512 columns (the served case, read out of K's tile: bitwise equal
to a clone of those columns, both timed), and its compiled shared memory
against `kernel_smem`. Kernels 1 and 2 at head width 120 are held the same
way at phase M's target shapes (Hkv 8, G 4; decode, the tree's cache pass
and segment, a T = 6 commit, a T = 512 prefill; f32 and bf16 K/V; paged
bitwise kernel 1), and kernel 1's non-causal form at phases N and O's
reads (one token over 1601 and 1500 cross rows, the encoder's T = S =
1500) beside SDPA with is_causal=False. Every kernel row prints the form
it launched (`launch_form`: the GQA form, the many-row form, int8,
latent); the many-row rows of all kernel phases make the kernels line's
`*_many_rows` entries, whose launches the serving phases count against
the model's reads at R >= R_MMA. The GQA rows' bound counts their
operations at the tensor-core rate of their K/V dtype (3xTF32 for f32,
bf16), beside the f32 CUDA-core rate (`bound_cuda_core_ms`).

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

import contextlib
import faulthandler
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's HBM rate and dense peaks (f32 CUDA cores; bf16; int8, the
# rate of an int8 K/V form's bound), from the port
try:
    from repro_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
except ImportError as e:
    sys.exit(f"chip_smoke: the port is not beside this script ({e})")
# the SSD chunk path's and the f32 latent form's products on the tensor
# cores: 3xTF32, each product three TF32 passes at 495 TFLOP/s
TF32X3_FLOPS = 495e12 / 3
# the latent form's operations bound, by K/V dtype: f32 at the 3xTF32 rate
# of the unit its products run on, bf16 at the bf16 rate
LATENT_FLOPS = {"float32": TF32X3_FLOPS, "bfloat16": PEAK_FLOPS["bfloat16"]}
# kernels 1 and 2's GQA heads: the bound at the tensor-core rate of the
# K/V dtype (the many-row form's units: 3xTF32 for f32, bf16), beside the
# one at the f32 CUDA-core rate (the GQA form's FMAs)
GQA_TC_FLOPS = LATENT_FLOPS
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
# phase P: qwen2-0.5b fine-tuned at full width on one domain of a corpus
# at a small vocabulary (`data/synthetic.py` builds a dense (V, V) table;
# its ids are valid input to the full-vocabulary model)
TRAIN_VOCAB = 1024
TRAIN_DOMAIN = "piqa"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 512, 8, 1e-3
# phase P's gradient check, kernel 1 against the plain oracle: at f32
# activations the largest error of a gradient leaf over that leaf's
# largest value ("max"): the two differ in the attention's f32 summation
# order (~1e-6 relative) carried through 24 layers; at bf16 activations
# such a difference also flips bf16 roundings (one step, 2^-8 relative)
# of the residual stream and of the gradients flowing back through it,
# which a single element shows in full: there the norm of a leaf's error
# over the leaf's norm ("l2"), a 24-layer random walk of such steps
# (~sqrt(24) x 2^-8 = 0.02) with room. The loss within the same bound.
GRAD_TOL = {"float32": ("max", 1e-3), "bfloat16": ("l2", 5e-2)}
# phase Q: training steps of each tiny drafter (the target takes twice)
SERVE_TRAIN_STEPS = 150
MAX_LEN = 1024
NEW_TOKENS = 32
PROMPT_LENS = (64, 200, 350, 600)
PAGE_SIZE = 64
# depth cuts of earlier phases, each model's first layers at full width,
# which keep the whole script inside its time limit: every serving phase
# is host-bound, so its seconds follow the layers it runs. Each cut model is a stack of one
# repeated block (qwen2-moe-a2.7b: one MoE block; mamba2-130m: one SSD
# block; llama-3.2-vision-11b: the period of 5 with its cross layer at 3,
# so 10 layers keep cross layers 3 and 8), so every structure a phase
# exercises stays. Phases A, C, D, H, H-serial and the baselines after
# them keep qwen1.5-4b's 40 layers and the drafters' 24.
B_LAYERS = 8        # phase B: qwen1.5-4b target = its perfect drafters
K_LAYERS = (8, 4)   # phases K, K-paged: qwen1.5-4b target, qwen2-0.5b drafters
E_LAYERS = 8        # phases E, I: mamba2-130m target and drafters
J_LAYERS = (4, 4)   # phases J, J-f32: qwen2-moe-a2.7b, qwen2-0.5b drafters
M_LAYERS = 8        # phases M, M-paged, M-int8: h2o-danube3-4b target
N_LAYERS = 10       # phase N: llama-3.2-vision-11b target = its drafters
# a traceback of every thread on standard error, and exit, this many
# seconds into a run that has not ended: just before an outside limit of
# 1200 s (which counts the interpreter's start too) stops it without one
WATCHDOG_S = 1180
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
    # the int8 K/V forms of kernels 1 and 2 (the same sources; their
    # launches are also counted in the two entries above)
    "flash_attention_partial_int8_kv": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    "paged_flash_decode_int8_kv": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:127"),
    # the latent form of kernels 1 and 2 (MLA: Dk 576, Dv 512, one KV
    # head; the same sources, launches also counted above)
    "flash_attention_partial_mla": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    "paged_flash_decode_mla": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:127"),
    # kernels 1 and 2 at head width 120 (h2o-danube3-4b: the (120, 120)
    # instantiation; launches also counted above)
    "flash_attention_partial_d120": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    "paged_flash_decode_d120": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:127"),
    # kernel 1 without the causal mask: cross-attention reads and the
    # Whisper encoder (launches also counted above)
    "flash_attention_partial_noncausal": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    # the many-row form of kernels 1 and 2 (f32 / bf16 K/V from R_MMA
    # query rows a (request, KV head): `rows_kernel`, 64 rows a tile on
    # tensor cores; the same sources, launches also counted above)
    "flash_attention_partial_many_rows": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/common.py:139"),
    "paged_flash_decode_many_rows": (
        "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:127"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def progress(msg: str) -> None:
    """A line on standard output and on standard error: how far a run
    got shows in the end of either stream."""
    print(msg, flush=True)
    print(msg, file=sys.stderr, flush=True)


def ptxas_report(log: str) -> dict:
    """{mangled kernel name: registers, spill store and load bytes} from
    the `-Xptxas -v` output of a build."""
    import re
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, dict(registers=None, spill_stores=None,
                                      spill_loads=None))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


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


def _work(torch, q, k, v, q_pos, k_pos, slot_idx, mask, causal,
          v_in_k=False):
    """Bytes that the function must move and operations it must do on
    these inputs: valid (row, key) pairs only, K/V rows that hold a key:
    Dk + Dv values each where V is its own tensor (GQA heads, and the
    latent form's general case), Dk values where `v_in_k` (V is K's first
    Dv columns, as MLA passes it)."""
    B, T, H, G, Dk = q.shape
    Dv = v.shape[-1]
    kp = k_pos if slot_idx is None else k_pos[slot_idx.long()]   # (B, S)
    valid = (kp >= 0)[:, None, :].expand(B, T, kp.shape[1])
    if causal:
        valid = valid & (kp[:, None, :] <= q_pos[:, :, None])
    if mask is not None:
        valid = valid & mask
    pairs = int(valid.sum()) * H * G
    rows_read = int((kp >= 0).sum())
    kv_bytes = rows_read * H * (Dk + (0 if v_in_k else Dv)) * k.element_size()
    other = (q.numel() * q.element_size() + kp.numel() * 4
             + q_pos.numel() * 4 + (0 if mask is None else mask.numel())
             + B * T * H * G * (Dv + 2) * 4)
    flops = 2 * pairs * (Dk + Dv)
    return kv_bytes + other, flops


def _bound(nbytes, flops, dtype_name, rate=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (rate or PEAK_FLOPS[dtype_name]) * 1e3
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

    rows = [kernel1_row(torch, fa, c) for c in cases]
    # host cost of a call at the first case: drafter decode, f32 K/V
    c = cases[0]
    host = dict(shape=c["name"], attend_partial_us=_host_us(
        torch, lambda: fa.attend_partial(*_args(c), **_kw(c))))
    print(f"host cost per call ({c['name']}): attend_partial "
          f"{host['attend_partial_us']:.1f} us (enqueue only)", flush=True)
    return rows, host


def _args(c):
    return c["q"], c["k"], c["v"], c["q_pos"], c["k_pos"]


def _kw(c):
    return dict(scale=c["q"].shape[-1] ** -0.5, causal=c["causal"],
                window=0, mask=c["mask"], slot_idx=c["slot_idx"])


def launch_form(fa, q, k, v, S, mask=None):
    """The form kernels 1 and 2 launch for these inputs and their (n_split,
    span, row tile) (`ops.py::launch_plan`, S logical keys)."""
    B, T, H, G, Dk = q.shape
    n, span, rows, many = fa.launch_plan(B, H, T, G, S, Dk, v.shape[-1],
                                         k.dtype, mask is not None)
    form = ("latent" if Dk != v.shape[-1] else "int8" if k.element_size() == 1
            else "many-row" if many else "gqa")
    return form, (n, span, rows)


def _gqa_bounds(nbytes, flops, kv_type):
    """A GQA row's bounds: at the tensor-core rate of its K/V dtype (the
    row's bound) and at the f32 CUDA-core rate."""
    bound, by = _bound(nbytes, flops, kv_type, GQA_TC_FLOPS[kv_type])
    cc, _ = _bound(nbytes, flops, kv_type, PEAK_FLOPS["float32"])
    return dict(bound_ms=bound, bound_by=by, bound_cuda_core_ms=cc,
                ops_ms=flops / GQA_TC_FLOPS[kv_type] * 1e3,
                cuda_core_ops_ms=flops / PEAK_FLOPS["float32"] * 1e3)


def kernel1_row(torch, fa, c):
    """Kernel 1 at one case: held against its plain version, timed beside
    it, its bounds and one SDPA call; returns the row (with the form it
    launched)."""
    args, kw = _args(c), _kw(c)
    got = fa.attend_partial(*args, **kw)
    want = fa.attend_partial_plain(*args, **kw)
    torch.cuda.synchronize()
    err = _check_partials(torch, fa, c["name"], got, want)
    ms = _graph_ms(torch, lambda: fa.attend_partial(*args, **kw))
    plain_ms = _graph_ms(torch, lambda: fa.attend_partial_plain(
        *args, **kw), reps=3)
    lib_ms = _library_ms(torch, *args, c["slot_idx"], c["mask"],
                         causal=c["causal"])
    nbytes, flops = _work(torch, *args, c["slot_idx"], c["mask"],
                          c["causal"])
    kv_type = "bfloat16" if c["k"].dtype == torch.bfloat16 else "float32"
    bd = _gqa_bounds(nbytes, flops, kv_type)
    form, plan = launch_form(fa, c["q"], c["k"], c["v"], c["k"].shape[1],
                             c["mask"])
    print(f"kernel {c['name']}: form {form}, (splits, span, row tile) "
          f"{plan}  max|err| {err:.2e}  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}; CUDA cores {bd['bound_cuda_core_ms']:.4f})  "
          f"sdpa {lib_ms:.4f} ms", flush=True)
    return dict(name=c["name"], form=form, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, bytes=nbytes,
                flops=flops, dtype=kv_type, **bd)


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


def _sdpa_call(torch, q, k, v, q_pos, k_pos, slot_idx, mask, scale=None,
               causal=True):
    """One scaled_dot_product_attention call computing the normalised
    output on the same inputs, as a callable: gathered K/V expanded over
    the query heads and a boolean mask, all prepared outside the call (a
    non-causal read of keys that are all valid takes no mask,
    is_causal=False)."""
    import torch.nn.functional as F
    B, T, H, G, D = q.shape
    kp = k_pos
    if slot_idx is not None:
        idx = slot_idx.long()
        k, v, kp = k[idx], v[idx], kp[idx]
    valid = (kp >= 0)[:, None, :].expand(B, T, kp.shape[1])
    if causal:
        valid = valid & (kp[:, None, :] <= q_pos[:, :, None])
    if mask is not None:
        valid = valid & mask
    qs = q.to(k.dtype).reshape(B, T, H * G, D).transpose(1, 2).contiguous()
    ks = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    vs = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    am = (None if not causal and bool(valid.all()) else
          valid[:, None].expand(B, H * G, T, kp.shape[1]).contiguous())
    scale = D ** -0.5 if scale is None else scale
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=am,
                                                  scale=scale)


def _library_ms(torch, q, k, v, q_pos, k_pos, slot_idx, mask, causal=True):
    """The time of `_sdpa_call`: a yardstick only."""
    return _graph_ms(torch, _sdpa_call(torch, q, k, v, q_pos, k_pos,
                                       slot_idx, mask, causal=causal))


def _paged_pool(torch, gen, perm, H, D, held, Dv=None):
    """A page pool holding positions [0, held[b]) of request b on pages
    handed out in a scrambled order (`perm`), with the view of those
    columns per request (power of two pages, NULL filler), as the runner
    builds it. Returns k, v (f32; v `Dv` wide, default D), positions and
    the block table."""
    n_req_pages = [-(-n // PAGE_SIZE) for n in held]
    P = 2 + sum(n_req_pages) + 8
    k = torch.randn((P, PAGE_SIZE, H, D), generator=gen, device="cuda")
    v = torch.randn((P, PAGE_SIZE, H, Dv or D), generator=gen, device="cuda")
    pos = torch.full((P, PAGE_SIZE), -1, dtype=torch.int32, device="cuda")
    nv = 1 << (max(n_req_pages) - 1).bit_length()
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


def paged_kernel_phase(torch, fa, pa):
    """The paged kernel at phase C's pool reads: against its plain version
    and, bit for bit, against the flash-attention kernel on the gathered
    view; returns rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    perm = torch.Generator().manual_seed(7)
    lens = [80, 230, 380, 630]           # phase A's requests mid-run

    def pool(H, D, held):
        return _paged_pool(torch, gen, perm, H, D, held)

    def rows_from(start, T):
        return torch.tensor([[s + t for t in range(T)] for s in start],
                            dtype=torch.int32, device="cuda")

    cases = []
    # decode, one token per request: written at position lens[b], then
    # read with the lens[b] keys before it (target, then drafter)
    held = [n + 1 for n in lens]
    for H, G, D, who in ((20, 1, 128, "target"), (2, 7, 64, "drafter")):
        k, v, pos, tbl = pool(H, D, held)
        cases.append(dict(
            name=f"{who}_decode_B4_T1_H{H}_G{G}_D{D}_f32",
            q=torch.randn((4, 1, H, G, D), generator=gen, device="cuda"),
            k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(lens, 1)))
    # target verification, cache pass: the pool as it was (write=0 view)
    k, v, pos, tbl = pool(20, 128, lens)
    cases.append(dict(
        name="target_verify_cache_B4_T10_H20_D128_f32",
        q=torch.randn((4, 10, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl,
        q_pos=(torch.tensor(lens, device="cuda")[:, None]
               + torch.tensor(TREE_DEPTH, device="cuda")[None]).to(
                   torch.int32)))
    # target commit of 5 accepted tokens: written first, then read
    held = [n + 5 for n in lens]
    k, v, pos, tbl = pool(20, 128, held)
    cases.append(dict(
        name="target_commit_B4_T5_H20_D128_f32",
        q=torch.randn((4, 5, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(lens, 5)))
    # a 512-row target prefill chunk on the pool
    k, v, pos, tbl = pool(20, 128, [512])
    cases.append(dict(
        name="target_prefill_B1_T512_H20_D128_f32",
        q=torch.randn((1, 512, 20, 1, 128), generator=gen, device="cuda"),
        k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from([0], 512)))
    # a drafter commit (one-behind: the previous token + 4 accepted)
    k, v, pos, tbl = pool(2, 64, held)
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
        k, v, pos, tbl = pool(H, D, held)
        cases.append(dict(
            name=name, q=torch.randn((len(held), rows, H, G, D),
                                     generator=gen, device="cuda"),
            k=k, v=v, pos=pos, tbl=tbl, q_pos=rows_from(start, rows)))

    return [paged_row(torch, fa, pa, c) for c in cases]


def paged_row(torch, fa, pa, c):
    """The paged kernel at one case: held against its plain version and,
    bit for bit, against kernel 1 on the gathered view, timed beside
    both, its bound and one SDPA call; returns the row."""
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
    lib_ms = _library_ms(torch, c["q"], kv, vv, c["q_pos"], kpv, None, None)
    nbytes, flops = _work(torch, *k1_args, None, None, True)
    nbytes += c["tbl"].numel() * 4
    kv_type = "bfloat16" if c["k"].dtype == torch.bfloat16 else "float32"
    bd = _gqa_bounds(nbytes, flops, kv_type)
    form, plan = launch_form(fa, c["q"], c["k"], c["v"], kv.shape[1])
    print(f"kernel paged {c['name']}: form {form}, (splits, span, row "
          f"tile) {plan}  max|err| {err:.2e}  |paged - "
          f"kernel 1 on the gathered view| {vs_k1:.3g}  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  kernel 1 gathered "
          f"{k1_ms:.4f} ms  bound {bd['bound_ms']:.4f} ms "
          f"({bd['bound_by']}; CUDA cores {bd['bound_cuda_core_ms']:.4f})  "
          f"sdpa {lib_ms:.4f} ms", flush=True)
    return dict(name=c["name"], form=form, max_abs_err=err,
                max_abs_diff_vs_kernel1=vs_k1, ms=ms, plain_ms=plain_ms,
                kernel1_gathered_ms=k1_ms, library_ms=lib_ms, bytes=nbytes,
                flops=flops, dtype=kv_type, **bd)


# phase M's target (h2o-danube3-4b): 8 KV heads, 4 query heads each, of
# width 120
D120_H, D120_G, D120_D = 8, 4, 120


def d120_kernel_phase(torch, fa, pa):
    """Kernels 1 and 2 at head width 120, phase M's target shapes, f32 and
    bf16 K/V: decode, the tree's cache pass (T = 10) and (kernel 1) its
    segment pass under the tree mask, a commit of T = 6 rows, a 512-row
    prefill; the paged kernel also bit for bit against kernel 1 on the
    gathered view. Returns (kernel 1 rows, paged rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(120)
    perm = torch.Generator().manual_seed(120)
    H, G, D, C = D120_H, D120_G, D120_D, CHAIN_T
    lens = [0, 80, 230, 380, 630, 0, 0, 0, 0]    # phase A's mid-run slots
    slot_idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    cur = torch.tensor(lens, device="cuda")[slot_idx.long()]
    T = len(TREE_PARENT)
    tree = _tree_mask(torch)
    qtree = (cur[:, None] + torch.tensor(TREE_DEPTH, device="cuda")[None]
             ).to(torch.int32)
    qcommit = (cur[:, None] + torch.arange(C, device="cuda")[None]).to(
        torch.int32)
    qpre = torch.arange(512, dtype=torch.int32, device="cuda")[None]

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def pool_pos(held):
        pos = torch.full((9, MAX_LEN), -1, dtype=torch.int32, device="cuda")
        for slot, n in enumerate(held):
            pos[slot, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
        return pos

    k1_cases, paged_cases = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"
        tag = f"H{H}_G{G}_D{D}_{dn}"
        k, v = rnd((9, MAX_LEN, H, D), dtype), rnd((9, MAX_LEN, H, D), dtype)
        common = dict(k=k, v=v, mask=None, causal=True)
        k1_cases += [
            dict(name=f"d120_decode_B4_T1_{tag}", q=rnd((4, 1, H, G, D)),
                 q_pos=(cur - 1)[:, None].to(torch.int32),
                 k_pos=pool_pos(lens), slot_idx=slot_idx, **common),
            dict(name=f"d120_verify_cache_B4_T{T}_{tag}",
                 q=rnd((4, T, H, G, D)), q_pos=qtree, k_pos=pool_pos(lens),
                 slot_idx=slot_idx, **common),
            dict(name=f"d120_verify_segment_B4_T{T}_{tag}",
                 q=rnd((4, T, H, G, D)), k=rnd((4, T, H, D), dtype),
                 v=rnd((4, T, H, D), dtype), q_pos=qtree,
                 k_pos=qtree.clone(), slot_idx=None,
                 mask=tree.expand(4, T, T).contiguous(), causal=True),
            dict(name=f"d120_commit_B4_T{C}_{tag}", q=rnd((4, C, H, G, D)),
                 q_pos=qcommit,
                 k_pos=pool_pos([n + C if n else 0 for n in lens]),
                 slot_idx=slot_idx, **common),
            dict(name=f"d120_prefill_B1_T512_{tag}",
                 q=rnd((1, 512, H, G, D)), q_pos=qpre,
                 k_pos=pool_pos([0, 512] + [0] * 7),
                 slot_idx=slot_idx[:1].clone(), **common)]
        req = lens[1:5]
        for name, held, q_pos in (
                (f"d120_decode_B4_T1_{tag}", [n + 1 for n in req],
                 cur[:, None].to(torch.int32)),
                (f"d120_verify_cache_B4_T{T}_{tag}", req, qtree),
                (f"d120_commit_B4_T{C}_{tag}", [n + C for n in req],
                 qcommit),
                (f"d120_prefill_B1_T512_{tag}", [512], qpre)):
            kp, vp, pos, tbl = _paged_pool(torch, gen, perm, H, D, held)
            paged_cases.append(dict(
                name=name, q=rnd((len(held), q_pos.shape[1], H, G, D)),
                k=kp.to(dtype), v=vp.to(dtype), pos=pos, tbl=tbl,
                q_pos=q_pos))
    return ([kernel1_row(torch, fa, c) for c in k1_cases],
            [paged_row(torch, fa, pa, c) for c in paged_cases])


# the non-causal reads phases N and O serve: a cross read of one token over
# llama-3.2-vision's 1601 image rows (Hkv 8, G 4, D 128) and over
# whisper-small's 1500 audio rows (Hkv 12, G 1, D 64), each in a slot pool
# through slot_idx, and whisper's encoder self-attention, T = S = 1500
NONCAUSAL_SHAPES = (("vision_cross_decode_B4_T1_S1601_H8_G4_D128", 4, 1,
                     8, 4, 128, 1601),
                    ("whisper_cross_decode_B4_T1_S1500_H12_G1_D64", 4, 1,
                     12, 1, 64, 1500),
                    ("whisper_encoder_B1_T1500_S1500_H12_G1_D64", 1, 1500,
                     12, 1, 64, 1500))


def noncausal_kernel_phase(torch, fa):
    """Kernel 1 without the causal mask at phases N and O's shapes (f32
    K/V, as the cross caches and the encoder hold them); returns rows."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1601)
    cases = []
    for name, B, T, H, G, D, S in NONCAUSAL_SHAPES:
        pool = T == 1                  # a cross read of a slot pool
        P = 9 if pool else B
        cases.append(dict(
            name=f"{name}_f32",
            q=torch.randn((B, T, H, G, D), generator=gen, device="cuda"),
            k=torch.randn((P, S, H, D), generator=gen, device="cuda"),
            v=torch.randn((P, S, H, D), generator=gen, device="cuda"),
            # a cross read's queries sit at position 0; the encoder's at
            # arange(T): neither is compared
            q_pos=(torch.zeros((B, T), dtype=torch.int32, device="cuda")
                   if pool else
                   torch.arange(T, dtype=torch.int32, device="cuda")[None]),
            k_pos=torch.arange(S, dtype=torch.int32,
                               device="cuda").repeat(P, 1),
            slot_idx=(torch.arange(1, B + 1, dtype=torch.int32,
                                   device="cuda") if pool else None),
            mask=None, causal=False))
    return [kernel1_row(torch, fa, c) for c in cases]


# the int8 K/V forms of kernels 1 and 2 at phases A and C's shapes
# (target Hkv 20, G 1, D 128; drafter Hkv 2, G 7, D 64) and phase
# M-int8's target (h2o-danube3-4b: Hkv 8, G 4, D 120): decode, the
# tree's cache pass (T = 10), a commit of T = 6 rows, a 512-row prefill
INT8KV_SHAPES = ((20, 1, 128, "target"), (2, 7, 64, "drafter"),
                 (D120_H, D120_G, D120_D, "danube"))
INT8KV_NO_LIBRARY = ("no one PyTorch call attends over int8 K/V with "
                     "scales; yardstick_ms times the dequantized bf16 view "
                     "and one scaled_dot_product_attention (two calls)")


def _d120_int8_sums(rows):
    """The int8 K/V rows at head width 120 (phase M-int8's shapes):
    summed times, bound and yardstick."""
    d = [r for r in rows if r["name"].startswith("danube_")]
    return dict(shapes=len(d), ms=sum(r["ms"] for r in d),
                plain_ms=sum(r["plain_ms"] for r in d),
                yardstick_ms=sum(r["yardstick_ms"] for r in d),
                bound_ms=max(sum(r["bytes"] for r in d) / HBM_BYTES_PER_S
                             * 1e3, sum(r["ops_ms"] for r in d)))


def _int8kv_forms(torch, lens):
    """(name, B, T, q_pos, held) of each form: the query positions and
    the keys each request holds when the kernel reads the pool."""
    cur = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ar = torch.arange(512, dtype=torch.int32, device="cuda")
    depth = torch.tensor(TREE_DEPTH, dtype=torch.int32, device="cuda")
    return [
        ("decode_T1", 4, 1, (cur - 1)[:, None], lens),
        ("verify_cache_T10", 4, 10, cur[:, None] + depth[None], lens),
        ("commit_T6", 4, 6, cur[:, None] + ar[None, :6],
         [n + 6 for n in lens]),
        ("prefill_T512", 1, 512, ar[None], [512]),
    ]


def _dequant_sdpa_ms(torch, fa, q, k8, ks, v8, vs, kp, q_pos):
    """The yardstick of an int8 form: the dequantized bf16 view and one
    scaled_dot_product_attention call over it, timed together (two calls:
    the dequantization and SDPA; the gather, GQA expansion and mask are
    made outside the timed region)."""
    import torch.nn.functional as F
    B, T, H, G, D = q.shape
    valid = (kp >= 0)[:, None, :] & (kp[:, None, :] <= q_pos[:, :, None])
    qs = q.to(torch.bfloat16).reshape(B, T, H * G, D).transpose(
        1, 2).contiguous()

    def heads(t):
        return t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()

    ke, ve, kse, vse = heads(k8), heads(v8), heads(ks), heads(vs)
    am = valid[:, None].expand(B, H * G, T, kp.shape[1]).contiguous()
    return _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qs, fa.dequantize_kv(ke, kse), fa.dequantize_kv(ve, vse),
        attn_mask=am, scale=D ** -0.5))


def int8kv_kernel_phase(torch, fa, pa, attn):
    """Kernel 1's and the paged kernel's int8 K/V forms at phases K and
    K-paged's shapes: each within KERNEL_TOL of its plain version (the
    reference's dequantized bf16 view through the plain partials), the
    paged form bit for bit kernel 1's int8 form on the gathered view;
    times against the bound (the bytes: int8 K/V and two 4-byte scales
    per row and head; the operations at the bf16 tensor-core rate) and
    the dequantize + SDPA yardstick. Returns (resident rows, paged rows,
    host cost of a cache write)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(808)
    perm = torch.Generator().manual_seed(9)
    lens = [80, 230, 380, 630]
    res_rows, pag_rows = [], []
    for H, G, D, who in INT8KV_SHAPES:
        k8, ks = attn._quantize(torch.randn((9, MAX_LEN, H, D), generator=gen,
                                            device="cuda"))
        v8, vs = attn._quantize(torch.randn((9, MAX_LEN, H, D), generator=gen,
                                            device="cuda"))
        slot_idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32,
                                device="cuda")
        for form, B, T, q_pos, held in _int8kv_forms(torch, lens):
            name = f"{who}_{form}_H{H}_G{G}_D{D}_int8"
            q = torch.randn((B, T, H, G, D), generator=gen, device="cuda")
            q_pos = q_pos.to(torch.int32).contiguous()
            # resident: slots 1..B hold positions [0, held[b])
            kp = torch.full((9, MAX_LEN), -1, dtype=torch.int32,
                            device="cuda")
            for b, n in enumerate(held):
                kp[1 + b, :n] = torch.arange(n, dtype=torch.int32,
                                             device="cuda")
            sidx = slot_idx[:B].clone()
            args = (q, k8, v8, q_pos, kp)
            kw = dict(scale=D ** -0.5, slot_idx=sidx, k_scale=ks, v_scale=vs)
            got = fa.attend_partial(*args, **kw)
            want = fa.attend_partial_plain(*args, **kw)
            torch.cuda.synchronize()
            err = _check_partials(torch, fa, f"int8 {name}", got, want)
            ms = _graph_ms(torch, lambda: fa.attend_partial(*args, **kw))
            plain_ms = _graph_ms(torch, lambda: fa.attend_partial_plain(
                *args, **kw), reps=3)
            idx = sidx.long()
            yard_ms = _dequant_sdpa_ms(torch, fa, q, k8[idx], ks[idx],
                                      v8[idx], vs[idx], kp[idx], q_pos)
            nbytes, flops = _work(torch, q, k8, v8, q_pos, kp, sidx, None,
                                  True)
            nbytes += int((kp[idx] >= 0).sum()) * H * 4 * 2
            bound, by = _bound(nbytes, flops, "bfloat16")
            res_rows.append(dict(
                name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                yardstick_ms=yard_ms, bytes=nbytes,
                flops=flops, dtype="int8",
                ops_ms=flops / PEAK_FLOPS["bfloat16"] * 1e3))
            print(f"kernel int8 K/V {name}: splits "
                  f"{fa.plan_splits(B, H, T * G, MAX_LEN, False, True)}  "
                  f"row tile {fa.tiling(False, True, T * G)[2]}  max|err| "
                  f"{err:.2e}  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bound:.4f} ms ({by})  dequantize + sdpa "
                  f"{yard_ms:.4f} ms", flush=True)

            # paged: the same held keys on scrambled pages
            pk, pv, ppos, tbl = _paged_pool(torch, gen, perm, H, D, held)
            pk8, pks = attn._quantize(pk)
            pv8, pvs = attn._quantize(pv)
            pargs = (q, pk8, pv8, q_pos, ppos, tbl)
            pkw = dict(scale=D ** -0.5, k_scale=pks, v_scale=pvs)
            pgot = pa.paged_attend_partial(*pargs, **pkw)
            pwant = pa.paged_attend_partial_plain(*pargs, **pkw)
            g = pa.gather_view
            k1_args = (q, g(pk8, tbl), g(pv8, tbl), q_pos, g(ppos, tbl))
            k1_kw = dict(scale=D ** -0.5, k_scale=g(pks, tbl),
                         v_scale=g(pvs, tbl))
            k1 = fa.attend_partial(*k1_args, **k1_kw)
            torch.cuda.synchronize()
            perr = _check_partials(torch, fa, f"int8 paged {name}", pgot,
                                   pwant)
            vs_k1 = max(float((a - b).abs().max()) for a, b in zip(pgot, k1))
            pms = _graph_ms(torch, lambda: pa.paged_attend_partial(
                *pargs, **pkw))
            pplain = _graph_ms(torch, lambda: pa.paged_attend_partial_plain(
                *pargs, **pkw), reps=3)
            pyard = _dequant_sdpa_ms(torch, fa, q, k1_args[1],
                                    k1_kw["k_scale"], k1_args[2],
                                    k1_kw["v_scale"], k1_args[4], q_pos)
            nb, fl = _work(torch, *k1_args, None, None, True)
            nb += int((k1_args[4] >= 0).sum()) * H * 4 * 2 + tbl.numel() * 4
            pbound, pby = _bound(nb, fl, "bfloat16")
            pag_rows.append(dict(
                name=name, max_abs_err=perr, max_abs_diff_vs_kernel1=vs_k1,
                ms=pms, plain_ms=pplain, bound_ms=pbound, bound_by=pby,
                library_ms=None, yardstick_ms=pyard,
                bytes=nb, flops=fl, dtype="int8",
                ops_ms=fl / PEAK_FLOPS["bfloat16"] * 1e3))
            print(f"kernel paged int8 K/V {name}: max|err| {perr:.2e}  "
                  f"|paged - kernel 1 on the gathered view| {vs_k1:.3g}  "
                  f"kernel {pms:.4f} ms  plain {pplain:.4f} ms  bound "
                  f"{pbound:.4f} ms ({pby})  dequantize + sdpa {pyard:.4f} "
                  "ms", flush=True)
            if vs_k1 != 0.0:
                fail(f"int8 paged {name}: not bitwise kernel 1's int8 form "
                     "on the gathered view")
    # host cost of one layer's cache write as the model makes it (kv_rows
    # then set_rows, a decode step of 4 requests at the target's widths):
    # the int8 cache quantizes K and V and writes five leaves, f32 three
    H, D = INT8KV_SHAPES[0][0], INT8KV_SHAPES[0][2]
    k_new = torch.randn((4, 1, H, D), generator=gen, device="cuda")
    v_new = torch.randn((4, 1, H, D), generator=gen, device="cuda")
    pos = torch.tensor([[n] for n in lens], dtype=torch.int32, device="cuda")
    sidx = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device="cuda")
    write = {}
    for name, quantized in (("int8", True), ("float32", False)):
        c = attn.make_kv_cache(9, MAX_LEN, H, D, dtype=torch.float32,
                               quantized=quantized, device="cuda")
        write[name] = _host_us(torch, lambda: attn.set_rows(
            c, attn.kv_rows(c, k_new, v_new, pos), pos, sidx))
    print(f"host cost of one KV cache write (kv_rows + set_rows, B4 H{H} "
          f"D{D}): int8 {write['int8']:.1f} us, f32 {write['float32']:.1f} us",
          flush=True)
    return res_rows, pag_rows, write


# the latent form of kernels 1 and 2 at phase L's shapes: deepseek-v3's
# absorbed MLA, one KV head of c_kv ++ k_pe (Dk 576) and c_kv (Dv 512)
# with all 128 query heads folded into G; the model's scale
MLA_G, MLA_DK, MLA_DV = 128, 576, 512
MLA_SCALE = (128 + 64) ** -0.5
# the pool slots of the latent kernel phase's requests, out of order
MLA_SLOTS = (6, 2, 8, 3)


MLA_NO_LIBRARY = ("scaled_dot_product_attention refused some of these "
                  "shapes (each shape's sdpa_error says why)")


def _sdpa_latent(torch, q, k, v, q_pos, k_pos, slot_idx, mask):
    """The yardstick of the latent form: `_sdpa_call` with K/V expanded
    over the 128 heads (Dk 576, Dv 512) and the model's scale. Returns (ms
    or None, the backend SDPA's dispatch takes — the first of its
    priority order that accepts the call — or "none", SDPA's errors, its
    normalised output (B, T, 1, G, Dv) f32 or None)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    B, T, H, G, _ = q.shape
    call = _sdpa_call(torch, q, k, v, q_pos, k_pos, slot_idx, mask,
                      scale=MLA_SCALE)
    members = {int(b): b for b in SDPBackend.__members__.values()}
    errors, backend = [], "none"
    for i in torch._C._get_sdp_priority_order():
        b = members.get(int(i))
        if b is None or b.name in ("ERROR", "OVERRIDEABLE"):
            continue
        try:
            with sdpa_kernel([b]):
                call()
            torch.cuda.synchronize()
            backend = b.name
            break
        except RuntimeError as e:
            errors.append(f"{b.name}: {str(e).strip().splitlines()[0][:200]}")
    if backend == "none":
        return None, backend, "; ".join(errors), None
    out = call().float().transpose(1, 2).reshape(B, T, H, G, -1)
    return _graph_ms(torch, call), backend, "; ".join(errors) or None, out


def _latent_sums(rows):
    """The latent rows' served case (V read out of K's tile), summed over
    the shapes as the `kernels` line sums the general case, and the
    general case's bound with the operations at the K/V dtype's peak
    (67 TFLOP/s for f32 on the CUDA cores: the basis of the bound before
    the form's products moved to the tensor cores)."""
    t_bytes = sum(r["v_in_k_bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
    t_ops = sum(r["ops_ms"] for r in rows)
    return dict(v_in_k_ms=sum(r["v_in_k_ms"] for r in rows),
                v_in_k_cloned_ms=sum(r["v_in_k_cloned_ms"] for r in rows),
                v_in_k_bound_ms=max(t_bytes, t_ops),
                v_in_k_bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_ms_dtype_peak=max(
                    sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3,
                    sum(r["ops_ms_dtype_peak"] for r in rows)))


def mla_kernel_phase(torch, fa, pa):
    """Kernel 1's and the paged kernel's latent form at phase L's shapes
    (decode, the tree's cache pass and its masked segment, a T = 6
    commit, a T = 512 prefill; S up to 1024), f32 and bf16 K/V, each
    twice: with a `v` of its own (the general case) and with
    `v = k[..., :Dv]`, the served case, which the kernel reads
    out of K's tile and which must give the bits of a clone of those
    columns (staged as a V tile of its own). Each within KERNEL_TOL of
    its plain version on a slot pool of 9 rows read through scrambled
    slot indices (`MLA_SLOTS`), the paged form bit for bit kernel 1's on
    the gathered view; CUDA-graph times beside the bound (latent K/V
    bytes — 576 + 512 values a held key, or 576 where V is read out of
    K — read once, and q over 3.35 TB/s against the operations at the
    peak of the unit they run on, `LATENT_FLOPS`; the K/V dtype's peak
    beside it, `ops_ms_dtype_peak`) and SDPA over K/V expanded to 128
    heads; shared memory of the compiled latent kernels against
    `kernel_smem`. Returns (resident rows, paged rows, shared-memory
    report)."""
    import ctypes
    from repro_torch.kernels.build import SMEM_LIMIT
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1808)
    perm = torch.Generator().manual_seed(13)
    lens = [80, 230, 380, 630]
    G, Dk, Dv = MLA_G, MLA_DK, MLA_DV
    kt = fa.key_tile(Dk, Dv)
    cur = torch.tensor(lens, dtype=torch.int32, device="cuda")
    depth = torch.tensor(TREE_DEPTH, dtype=torch.int32, device="cuda")
    seg_pos = (cur[:, None] + depth[None]).to(torch.int32).contiguous()
    res_rows, pag_rows = [], []

    def served(name, call, plain, args, kw):
        """The served case of one shape: `call` with v = K's first Dv
        columns against its plain version and, bit for bit, against a
        clone of those columns; returns (max |err|, partials, ms, cloned
        ms)."""
        k = args[1]
        va = k[..., :Dv]
        if not fa.v_in_k(k, va):
            fail(f"latent {name}: k[..., :Dv] is not seen as V in K")
        aargs = args[:2] + (va,) + args[3:]
        cargs = args[:2] + (va.clone(),) + args[3:]
        got = call(*aargs, **kw)
        cloned = call(*cargs, **kw)
        want = plain(*aargs, block=kt, **kw)
        torch.cuda.synchronize()
        err = _check_partials(torch, fa, f"latent v_in_k {name}", got, want)
        if not all(torch.equal(a, b) for a, b in zip(got, cloned)):
            fail(f"latent {name}: V read out of K's tile is not bitwise V "
                 "staged from a clone of the same columns")
        ms = _graph_ms(torch, lambda: call(*aargs, **kw))
        cms = _graph_ms(torch, lambda: call(*cargs, **kw))
        return err, got, ms, cms

    for dtype in (torch.float32, torch.bfloat16):
        dn = "f32" if dtype == torch.float32 else "bf16"
        kv_type = "float32" if dtype == torch.float32 else "bfloat16"
        k = torch.randn((9, MAX_LEN, 1, Dk), generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn((9, MAX_LEN, 1, Dv), generator=gen,
                        device="cuda").to(dtype)
        cases = []
        for form, B, T, q_pos, held in _int8kv_forms(torch, lens):
            # request b in pool slot MLA_SLOTS[b] (a scrambled slot pool)
            kp = torch.full((9, MAX_LEN), -1, dtype=torch.int32,
                            device="cuda")
            for slot, n in zip(MLA_SLOTS, held):
                kp[slot, :n] = torch.arange(n, dtype=torch.int32,
                                            device="cuda")
            sidx = torch.tensor(MLA_SLOTS[:B], dtype=torch.int32,
                                device="cuda")
            cases.append((form, B, T, q_pos.to(torch.int32).contiguous(),
                          held, k, v, kp, sidx, None))
        # the tree's fresh segment (its own 10 keys under the tree mask)
        cases.insert(2, ("verify_segment_T10", 4, 10, seg_pos, None,
                         torch.randn((4, 10, 1, Dk), generator=gen,
                                     device="cuda").to(dtype),
                         torch.randn((4, 10, 1, Dv), generator=gen,
                                     device="cuda").to(dtype),
                         seg_pos.clone(), None,
                         _tree_mask(torch).expand(4, 10, 10).contiguous()))
        for form, B, T, q_pos, held, kk, vv, kp, sidx, mask in cases:
            name = f"{form}_B{B}_H1_G{G}_Dk{Dk}_Dv{Dv}_{dn}"
            q = torch.randn((B, T, 1, G, Dk), generator=gen, device="cuda")
            args = (q, kk, vv, q_pos, kp)
            kw = dict(scale=MLA_SCALE, slot_idx=sidx, mask=mask)
            got = fa.attend_partial(*args, **kw)
            want = fa.attend_partial_plain(*args, block=kt, **kw)
            torch.cuda.synchronize()
            err = _check_partials(torch, fa, f"latent {name}", got, want)
            ms = _graph_ms(torch, lambda: fa.attend_partial(*args, **kw))
            plain_ms = _graph_ms(torch, lambda: fa.attend_partial_plain(
                *args, block=kt, **kw), reps=3)
            lib_ms, backend, sdpa_err, sdpa_out = _sdpa_latent(
                torch, q, kk, vv, q_pos, kp, sidx, mask)
            sdpa_diff = (None if sdpa_out is None else float(
                (sdpa_out - fa.finalize(got)).abs().max()))
            del sdpa_out
            nbytes, flops = _work(torch, *args, sidx, mask, True)
            rate = LATENT_FLOPS[kv_type]
            bound, by = _bound(nbytes, flops, kv_type, rate)
            aerr, _, ams, cms = served(name, fa.attend_partial,
                                       fa.attend_partial_plain, args, kw)
            anb, _ = _work(torch, *args, sidx, mask, True, v_in_k=True)
            abound, aby = _bound(anb, flops, kv_type, rate)
            res_rows.append(dict(
                name=name, max_abs_err=max(err, aerr), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, sdpa_backend=backend, sdpa_error=sdpa_err,
                sdpa_max_abs_diff=sdpa_diff, bytes=nbytes, flops=flops,
                dtype=kv_type, ops_ms=flops / rate * 1e3,
                ops_ms_dtype_peak=flops / PEAK_FLOPS[kv_type] * 1e3,
                v_in_k_ms=ams, v_in_k_cloned_ms=cms, v_in_k_bound_ms=abound,
                v_in_k_bound_by=aby, v_in_k_bytes=anb,
                splits=fa.plan_splits(B, 1, T * G, kk.shape[1], True)))
            print(f"kernel latent {name}: splits {res_rows[-1]['splits']}  "
                  f"max|err| {err:.2e} (v in k {aerr:.2e})  kernel "
                  f"{ms:.4f} ms, v in k {ams:.4f} (cloned {cms:.4f})  plain "
                  f"{plain_ms:.4f} ms  bound {bound:.4f} ms ({by}), v in k "
                  f"{abound:.4f} ({aby}), ops at the K/V dtype's peak "
                  f"{res_rows[-1]['ops_ms_dtype_peak']:.4f}  "
                  f"sdpa ({backend}) "
                  + (f"{lib_ms:.4f} ms, |sdpa - kernel| {sdpa_diff:.2e}"
                     if lib_ms is not None else f"refused: {sdpa_err}"),
                  flush=True)
            if held is None:
                continue
            # paged: the same held keys on scrambled pages of 64
            pk, pv, ppos, tbl = _paged_pool(torch, gen, perm, 1, Dk, held,
                                            Dv=Dv)
            pk, pv = pk.to(dtype), pv.to(dtype)
            pargs = (q, pk, pv, q_pos, ppos, tbl)
            pkw = dict(scale=MLA_SCALE)
            pgot = pa.paged_attend_partial(*pargs, **pkw)
            pwant = pa.paged_attend_partial_plain(*pargs, block=kt, **pkw)
            g = pa.gather_view
            gk = g(pk, tbl)
            k1_args = (q, gk, g(pv, tbl), q_pos, g(ppos, tbl))
            k1 = fa.attend_partial(*k1_args, **pkw)
            k1a = fa.attend_partial(q, gk, gk[..., :Dv], *k1_args[3:], **pkw)
            torch.cuda.synchronize()
            perr = _check_partials(torch, fa, f"latent paged {name}", pgot,
                                   pwant)
            vs_k1 = max(float((a - b).abs().max()) for a, b in zip(pgot, k1))
            paerr, pagot, pams, pcms = served(
                f"paged {name}", pa.paged_attend_partial,
                pa.paged_attend_partial_plain, pargs, pkw)
            vs_k1 = max(vs_k1, max(float((a - b).abs().max())
                                   for a, b in zip(pagot, k1a)))
            pms = _graph_ms(torch, lambda: pa.paged_attend_partial(
                *pargs, **pkw))
            pplain = _graph_ms(torch, lambda: pa.paged_attend_partial_plain(
                *pargs, block=kt, **pkw), reps=3)
            plib, pbackend, perr_sdpa, pout = _sdpa_latent(
                torch, q, k1_args[1], k1_args[2], q_pos, k1_args[4], None,
                None)
            del pout
            nb, fl = _work(torch, *k1_args, None, None, True)
            nb += tbl.numel() * 4
            pbound, pby = _bound(nb, fl, kv_type, rate)
            panb, _ = _work(torch, *k1_args, None, None, True, v_in_k=True)
            panb += tbl.numel() * 4
            pabound, paby = _bound(panb, fl, kv_type, rate)
            pag_rows.append(dict(
                name=name, max_abs_err=max(perr, paerr),
                max_abs_diff_vs_kernel1=vs_k1, ms=pms, plain_ms=pplain,
                bound_ms=pbound, bound_by=pby, library_ms=plib,
                sdpa_backend=pbackend, sdpa_error=perr_sdpa, bytes=nb,
                flops=fl, dtype=kv_type, ops_ms=fl / rate * 1e3,
                ops_ms_dtype_peak=fl / PEAK_FLOPS[kv_type] * 1e3,
                v_in_k_ms=pams, v_in_k_cloned_ms=pcms,
                v_in_k_bound_ms=pabound, v_in_k_bound_by=paby,
                v_in_k_bytes=panb))
            print(f"kernel latent paged {name}: max|err| {perr:.2e} (v in k "
                  f"{paerr:.2e})  |paged - kernel 1 on the gathered view| "
                  f"{vs_k1:.3g} (both v cases)  kernel {pms:.4f} ms, v in k "
                  f"{pams:.4f} (cloned {pcms:.4f})  plain {pplain:.4f} ms  "
                  f"bound {pbound:.4f} ms ({pby}), v in k {pabound:.4f} "
                  f"({paby})  sdpa ({pbackend}) "
                  + (f"{plib:.4f} ms" if plib is not None else "refused"),
                  flush=True)
            if vs_k1 != 0.0:
                fail(f"latent paged {name}: not bitwise kernel 1's latent "
                     "form on the gathered view")
            del gk, k1_args, k1, k1a, pk, pv
        del k, v, cases
    # shared memory of the compiled latent kernels against kernel_smem
    smem = {}
    for lib, fn in ((fa.LIBRARY, "fa_smem"), (pa.LIBRARY, "paged_smem")):
        f = getattr(lib.load(), fn)
        for q_bf16 in (0, 1):
            for kv_name, kv in (("float32", 0), ("bfloat16", 1)):
                out = [ctypes.c_int() for _ in range(3)]
                rc = f(Dk, Dv, q_bf16, kv, fa.LATENT_ROW_TILE,
                       *(ctypes.byref(o) for o in out))
                dyn, sta, lim = (o.value for o in out)
                want = fa.kernel_smem(Dk, Dv, 4 if kv == 0 else 2,
                                      2 if q_bf16 else 4)
                key = f"{fn}_q{'bf16' if q_bf16 else 'f32'}_kv_{kv_name}"
                smem[key] = dict(dynamic=dyn, static=sta, limit=lim)
                if rc != 0 or dyn != want or dyn + sta > lim \
                        or lim != SMEM_LIMIT:
                    fail(f"latent shared memory {key}: rc {rc}, dynamic "
                         f"{dyn} (kernel_smem {want}), static {sta}, limit "
                         f"{lim}")
    print(f"latent-form shared memory (bytes): {smem}", flush=True)
    return res_rows, pag_rows, smem


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
    counts the forwards of each params tree, records the CUDA stream each
    thread ran its forwards on (`cuda=False`: none, a CPU rehearsal) and
    counts calls of `torch.cuda.synchronize` (a device-wide wait that
    would serialize the two threads)."""

    def __init__(self, cuda: bool = True):
        import threading

        import torch
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.int8_gemv import ops as ig
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.ssd_scan import ops as sd
        from repro_torch.models import attention as attn
        from repro_torch.models import model as M
        from repro_torch.models import moe
        from repro_torch.models import quantize
        self.fa, self.pa, self.ig, self.attn, self.M = fa, pa, ig, attn, M
        self.sd = sd
        self.moe = moe
        self.quantize = quantize
        self.resident, self.paged = {}, {}
        # reads of int8 K/V (the kernels' int8 form), by form
        self.resident_int8, self.paged_int8 = {}, {}
        # reads of a latent K/V pair (Dk != Dv: MLA, the latent form)
        self.resident_latent, self.paged_latent = {}, {}
        # reads of heads of width 120 (h2o-danube3-4b), and of them the
        # int8 K/V ones and the segment passes
        self.resident_d120, self.paged_d120 = 0, 0
        self.d120_int8, self.d120_segment = 0, 0
        # unmasked reads of f32 / bf16 K/V heads at R >= R_MMA query rows
        # a (request, KV head): the many-row form's
        self.resident_many, self.paged_many = 0, 0
        # cross layers in the forwards' params (each reads its cross
        # cache once a forward, non-causal: form "cross")
        self.cross_layer_calls = 0
        # MoE layers: in the forwards' params, calls of apply_moe (and
        # the host seconds spent in them) and group-size reads
        self.moe_layer_calls = 0
        self.moe_calls = 0
        self.moe_host_s = 0.0
        self.group_size_reads = 0
        self.int8_products = 0
        self.int8_rows = {}
        self.int8_per_forward = {}
        self.forwards = 0
        # forwards by params tree (one a model)
        self.forwards_by_params = {}
        self._cuda = cuda
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
        orig_moe = self.moe.apply_moe
        orig_sizes = self.moe.group_sizes_host
        lock, cuda = self._lock, self._torch.cuda
        int8_dtype = self._torch.int8
        r_mma, mma_heads = self.fa.R_MMA, self.fa.MMA_HEADS

        def many(q, k, v, mask=None):
            """Whether an unmasked read has R_MMA rows a (request, KV
            head) or more over f32 / bf16 K/V of a head width the form
            takes."""
            return (mask is None and k.shape[-1] == v.shape[-1]
                    and k.element_size() in (2, 4)
                    and q.shape[-1] in mma_heads
                    and q.shape[1] * q.shape[3] >= r_mma)

        def attend(q, k, v, q_pos, k_pos, **kw):
            T = q.shape[1]
            form = ("cross" if not kw.get("causal", True)
                    else "segment" if kw.get("extra_mask") is not None
                    else "snapshot" if kw.get("slot_idx") is None
                    else "decode" if T == 1
                    else "prefill" if T > 64 else "commit/verify")
            with lock:
                self.resident[form] = self.resident.get(form, 0) + 1
                self.resident_d120 += q.shape[-1] == 120
                if q.shape[-1] == 120:
                    self.d120_int8 += k.dtype == int8_dtype
                    self.d120_segment += form == "segment"
                self.resident_many += many(q, k, v, kw.get("extra_mask"))
                if k.dtype == int8_dtype:
                    self.resident_int8[form] = \
                        self.resident_int8.get(form, 0) + 1
                if k.shape[-1] != v.shape[-1]:
                    self.resident_latent[form] = \
                        self.resident_latent.get(form, 0) + 1
            return orig_attend(q, k, v, q_pos, k_pos, **kw)

        def paged(q, k, v, *a, **kw):
            T = q.shape[1]
            form = ("decode" if T == 1 else "prefill" if T > 64
                    else "commit/verify")
            with lock:
                self.paged[form] = self.paged.get(form, 0) + 1
                self.paged_d120 += q.shape[-1] == 120
                if q.shape[-1] == 120:
                    self.d120_int8 += k.dtype == int8_dtype
                self.paged_many += many(q, k, v)
                if k.dtype == int8_dtype:
                    self.paged_int8[form] = self.paged_int8.get(form, 0) + 1
                if k.shape[-1] != v.shape[-1]:
                    self.paged_latent[form] = \
                        self.paged_latent.get(form, 0) + 1
            return orig_paged(q, k, v, *a, **kw)

        def apply(params, *a, **kw):
            n_int8 = self._n_int8(params)
            n_ssm = sum("A_log" in layer["mixer"] for layer in params["layers"])
            n_moe = sum("router" in layer.get("ffn", {})
                        for layer in params["layers"])
            n_cross = sum("cross" in layer for layer in params["layers"])
            where = (self._thread().name, cuda.current_stream().cuda_stream
                     if self._cuda else None)
            with lock:
                self.int8_products += n_int8
                self.forwards += 1
                self.forwards_by_params[id(params)] = \
                    self.forwards_by_params.get(id(params), 0) + 1
                self.ssm_layer_calls += n_ssm
                self.attn_layer_calls += len(params["layers"]) - n_ssm
                self.moe_layer_calls += n_moe
                self.cross_layer_calls += n_cross
                self.streams[where] = self.streams.get(where, 0) + 1
            return orig_apply(params, *a, **kw)

        def apply_moe(*a, **kw):
            t0 = time.perf_counter()
            out = orig_moe(*a, **kw)
            with lock:
                self.moe_calls += 1
                self.moe_host_s += time.perf_counter() - t0
            return out

        def group_sizes(*a, **kw):
            with lock:
                self.group_size_reads += 1
            return orig_sizes(*a, **kw)

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
        self._patch(self.moe, "apply_moe", apply_moe)
        self._patch(self.moe, "group_sizes_host", group_sizes)
        self._patch(cuda, "synchronize", sync)
        for mod, name in ((self.fa, "attend_partial_plain"),
                          (self.pa, "paged_attend_partial_plain"),
                          (self.ig, "int8_gemv_plain"),
                          (self.sd, "ssd_chunked"),
                          (self.sd, "ssd_slots_plain")):
            self._patch(mod, name, plain(getattr(mod, name)))
        self.fa.LAUNCHES = self.pa.LAUNCHES = self.ig.LAUNCHES = 0
        self.sd.LAUNCHES = 0
        self.fa.LAUNCHES_INT8_KV = self.pa.LAUNCHES_INT8_KV = 0
        self.fa.LAUNCHES_LATENT = self.pa.LAUNCHES_LATENT = 0
        self.fa.LAUNCHES_NONCAUSAL = 0
        self.fa.LAUNCHES_MANY_ROWS = self.pa.LAUNCHES_MANY_ROWS = 0
        self.fa.LAUNCHES_BY_PAIR.clear()
        self.pa.LAUNCHES_BY_PAIR.clear()
        return self

    def __exit__(self, *exc):
        self.launches = dict(
            flash_attention_partial=self.fa.LAUNCHES,
            paged_flash_decode=self.pa.LAUNCHES,
            int8_gemv_call=self.ig.LAUNCHES,
            ssd_scan_pallas=self.sd.LAUNCHES,
            flash_attention_partial_int8_kv=self.fa.LAUNCHES_INT8_KV,
            paged_flash_decode_int8_kv=self.pa.LAUNCHES_INT8_KV,
            flash_attention_partial_mla=self.fa.LAUNCHES_LATENT,
            paged_flash_decode_mla=self.pa.LAUNCHES_LATENT,
            flash_attention_partial_d120=self.fa.LAUNCHES_BY_PAIR.get(
                (120, 120), 0),
            paged_flash_decode_d120=self.pa.LAUNCHES_BY_PAIR.get(
                (120, 120), 0),
            flash_attention_partial_noncausal=self.fa.LAUNCHES_NONCAUSAL,
            flash_attention_partial_many_rows=self.fa.LAUNCHES_MANY_ROWS,
            paged_flash_decode_many_rows=self.pa.LAUNCHES_MANY_ROWS)
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)

    def check(self, label, paged_path: bool, int8_path: bool,
              attention: bool = True, ssm: bool = False,
              int8_kv: bool = False, moe: bool = False, mla: bool = False,
              d120: bool = False):
        """Launch counters against the model's calls; each kernel of the
        phase's path launched at least once, the others never. Every
        forward reads each attention layer's cache once (the resident or
        the paged kernel); verification adds a segment pass; each cross
        layer reads its cross cache once (kernel 1, non-causal, through
        slot_idx on either pool). With
        `int8_kv` every cache read (snapshots too) is the kernels' int8
        form and only segment passes read bf16/f32 K/V; with `moe` every
        MoE layer of every forward ran `apply_moe` with one group-size
        read; with `mla` every attention call (cache reads and segment
        passes) is the kernels' latent form, and without it none is; with
        `d120` some reads are of heads of width 120, each launched on the
        kernels' (120, 120) instantiation, and without it none is (with
        `int8_kv` too, every D 120 cache read, resident or pool, on the
        int8 form); every unmasked read of f32 / bf16 K/V at R >= R_MMA
        query rows a (request, KV head) is a many-row launch of its
        kernel, and no other read is."""
        res, pag = sum(self.resident.values()), sum(self.paged.values())
        L = self.launches
        cross = self.resident.get("cross", 0)
        if L["flash_attention_partial_noncausal"] != cross \
                or cross != self.cross_layer_calls:
            fail(f"{label}: {L['flash_attention_partial_noncausal']} "
                 f"non-causal launches and {cross} cross reads for "
                 f"{self.cross_layer_calls} cross layers of "
                 f"{self.forwards} forwards")
        if L["flash_attention_partial_d120"] != self.resident_d120 \
                or L["paged_flash_decode_d120"] != self.paged_d120 \
                or (self.resident_d120 > 0) != d120:
            fail(f"{label}: (120, 120) launches {L} for "
                 f"{self.resident_d120} resident and {self.paged_d120} pool "
                 "reads of heads of width 120")
        if d120 and int8_kv and self.d120_int8 != (
                self.resident_d120 - self.d120_segment + self.paged_d120):
            fail(f"{label}: {self.d120_int8} int8 K/V reads of heads of "
                 f"width 120 for {self.resident_d120} resident (of them "
                 f"{self.d120_segment} segment passes) and "
                 f"{self.paged_d120} pool reads")
        if L["flash_attention_partial_many_rows"] != self.resident_many \
                or L["paged_flash_decode_many_rows"] != self.paged_many:
            fail(f"{label}: many-row launches {L} for {self.resident_many}"
                 f" resident and {self.paged_many} pool reads at R >= "
                 "R_MMA")
        res_l, pag_l = (sum(self.resident_latent.values()),
                        sum(self.paged_latent.values()))
        if L["flash_attention_partial_mla"] != res_l \
                or L["paged_flash_decode_mla"] != pag_l:
            fail(f"{label}: latent-form launches {L} for {res_l} resident "
                 f"and {pag_l} pool reads of latent K/V")
        if (res_l, pag_l) != ((res, pag) if mla else (0, 0)):
            fail(f"{label}: latent reads resident {self.resident_latent}, "
                 f"pool {self.paged_latent} of {res} resident and {pag} "
                 "pool attention calls")
        res8, pag8 = (sum(self.resident_int8.values()),
                      sum(self.paged_int8.values()))
        if L["flash_attention_partial_int8_kv"] != res8 \
                or L["paged_flash_decode_int8_kv"] != pag8:
            fail(f"{label}: int8 K/V launches {L} for {res8} resident and "
                 f"{pag8} pool reads of int8 K/V")
        want8 = (res - self.resident.get("segment", 0), pag) if int8_kv \
            else (0, 0)
        if (res8, pag8) != want8:
            fail(f"{label}: int8 K/V reads resident {self.resident_int8}, "
                 f"pool {self.paged_int8}; expected {want8}")
        if self.moe_calls != self.moe_layer_calls \
                or self.group_size_reads != self.moe_calls \
                or (self.moe_calls > 0) != moe:
            fail(f"{label}: {self.moe_calls} MoE calls and "
                 f"{self.group_size_reads} group-size reads for "
                 f"{self.moe_layer_calls} MoE layers of {self.forwards} "
                 "forwards")
        if self.plain_calls:
            fail(f"{label}: {self.plain_calls} plain-version calls")
        if L["flash_attention_partial"] != res or (res > 0) != attention:
            fail(f"{label}: {L['flash_attention_partial']} flash-attention "
                 f"launches for {res} resident attention calls")
        if L["paged_flash_decode"] != pag or (pag > 0) != paged_path:
            fail(f"{label}: {L['paged_flash_decode']} paged launches for "
                 f"{pag} pool reads")
        cache_reads = res - self.resident.get("segment", 0) - cross + pag
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
        if paged_path and set(self.resident) - {"segment", "snapshot",
                                                "cross"}:
            fail(f"{label}: resident reads {self.resident} on the paged "
                 "path (only segment passes, snapshots and the slot-indexed "
                 "cross caches may use kernel 1)")
        if L["int8_gemv_call"] != self.int8_products \
                or (self.int8_products > 0) != int8_path:
            fail(f"{label}: {L['int8_gemv_call']} int8 GEMV launches for "
                 f"{self.int8_products} quantized products")
        if self.take_rows_calls != self.snapshots_layers:
            fail(f"{label}: {self.take_rows_calls} take_rows copies for "
                 f"{self.snapshots_layers} snapshot layer gathers (a pool "
                 "read went through a gathered copy)")


def first_layers(cfg, params, n: int):
    """`cfg` and `params` cut to their first `n` layers (an earlier
    phase's depth cut): the widths, the kept layers' weights and every
    other leaf as they were."""
    return (cfg.with_overrides(n_layers=n),
            dict(params, layers=params["layers"][:n]))


def moe_layers(cfg) -> int:
    """MoE layers of a config's plan."""
    return sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))


def greedy_reference(torch, M, cfg, params, prompt, n, device="cuda"):
    """Port's own greedy decode; returns tokens, top-1/top-2 gaps and the
    logit row each token was picked from (the prompt's prefill, then one
    decode step a token: the decode path of `path_noise`)."""
    cache = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device=device)
    lg, cache, _ = M.prefill(params, cfg, torch.tensor([prompt],
                                                       device=device), cache)
    last = lg[0, -1, : cfg.vocab]
    toks, gaps, rows = [], [], []
    for i in range(n):
        rows.append(last)
        top2 = torch.topk(last, 2).values
        gaps.append(float(top2[0] - top2[1]))
        t = int(torch.argmax(last))
        toks.append(t)
        if i + 1 < n:
            lg, cache, _ = M.decode_step(
                params, cfg, torch.tensor([[t]], device=device), cache)
            last = lg[0, 0, : cfg.vocab]
    return toks, gaps, rows


def path_noise(torch, M, cfg, params, prompt, toks, rows, device="cuda"):
    """Max |logit| difference between two exact-arithmetic-equal paths
    of the port: the greedy decode's logit rows (`rows`, as
    `greedy_reference` returns them for `toks`) and one prefill over the
    whole sequence (different batch shapes, cuBLAS algorithms and bf16
    residual roundings). Sets the scale of an allowed near-tie
    divergence."""
    seq = list(prompt) + list(toks)
    c = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device=device)
    lg_full, _, _ = M.prefill(params, cfg, torch.tensor([seq], device=device),
                              c)
    P = len(prompt)
    full = lg_full[0, P - 1: P - 1 + len(toks), : cfg.vocab]
    return float((torch.stack(rows) - full).abs().max())


def teacher_forced_gaps(torch, M, cfg, params, prompt, toks, device="cuda"):
    """For each committed token, how far its logit falls below the top
    logit of the target given the committed prefix (one prefill over
    prompt + toks); 0 where the token is the argmax."""
    c = M.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device=device)
    lg, _, _ = M.prefill(params, cfg,
                         torch.tensor([list(prompt) + list(toks)],
                                      device=device), c)
    rows = lg[0, len(prompt) - 1: len(prompt) - 1 + len(toks), : cfg.vocab]
    picked = rows.gather(1, torch.tensor(toks, device=device)[:, None])[:, 0]
    return (rows.max(dim=1).values - picked).tolist()


@contextlib.contextmanager
def route_records(records):
    """Append each MoE layer's sorted top-k expert sets (on the host) to
    `records` while the block runs."""
    from repro_torch.models import moe as moe_mod
    orig = moe_mod.route_topk

    def record(logits, k):
        out = orig(logits, k)
        records.append(out[1].sort(dim=-1).values.cpu())
        return out

    moe_mod.route_topk = record
    try:
        yield records
    finally:
        moe_mod.route_topk = orig


def router_flips(cfg, P, n, decode, full):
    """The (MoE layer, token) pairs whose top-k expert sets differ between
    the two paths of `path_noise` on the committed prefix: `decode` the
    records of `greedy_reference` (a prefill of the prompt's `P` tokens,
    then `n` - 1 one-token decodes), `full` those of the one prefill over
    the whole sequence. Returns (flips, pairs compared): the routing
    near-ties that bf16 rounding flips between batched and single-token
    forwards."""
    L = moe_layers(cfg)
    if len(full) != L or len(decode) != n * L:
        fail(f"router records: {len(decode)} + {len(full)} for {L} layers, "
             f"{n} tokens")
    pre, steps = decode[:L], decode[L:]
    flips = 0
    for layer in range(L):
        f = full[layer]
        flips += int((f[:P] != pre[layer]).any(-1).sum())
        flips += sum(int((f[P + i] != steps[i * L + layer][0]).any())
                     for i in range(n - 1))
    return flips, L * (P + n - 1)


def target_references(torch, M, cfg, params, prompts, device="cuda"):
    """Greedy reference, top-1/top-2 gaps and path noise of each prompt
    (shared by every phase: all serve the same target and prompts); on a
    MoE target also the router top-k sets that differ between the two
    paths of `path_noise` on the committed prefix."""
    out = []
    for p in prompts:
        decode, full = [], []    # stay empty without MoE layers
        with route_records(decode):
            ref, gaps, rows = greedy_reference(torch, M, cfg, params, p,
                                               NEW_TOKENS, device=device)
        with route_records(full):
            noise = path_noise(torch, M, cfg, params, p, ref, rows,
                               device=device)
        del rows
        if cfg.moe is None:
            out.append(dict(ref=ref, gaps=gaps, noise=noise))
            continue
        flips, pairs = router_flips(cfg, len(p), len(ref), decode, full)
        out.append(dict(ref=ref, gaps=gaps, noise=noise, router_flips=flips,
                        router_pairs=pairs))
        print(f"{cfg.name} prompt {len(p)}: router top-k sets differ "
              f"between the full prefill and the one-token decode path at "
              f"{flips} of {pairs} (MoE layer, token) pairs; path noise "
              f"{noise:.3g}", flush=True)
    return out


def make_engine(target, drafters, paged=False, backend=None,
                strategy="cosine", overrides=None, device="cuda"):
    """The serving phases' engine: `strategy` (`cosine` unless a phase
    serves a baseline), two drafters a request, tree width 2, with
    `overrides` of any other `CoSineConfig` field, on the card."""
    from repro_torch.config import CoSineConfig
    from repro_torch.serving.engine import SpeculativeEngine

    cos = CoSineConfig(**{**dict(
        n_drafters=len(drafters), drafters_per_request=2, tree_width=2,
        paged_pool=paged, page_size=PAGE_SIZE, pool_pages=POOL_PAGES),
        **(overrides or {})})
    return SpeculativeEngine(target, drafters, cos, strategy=strategy,
                             max_len=MAX_LEN, seed=0, backend=backend,
                             device=device)


def serve_phase(torch, label, target, drafters, prompts, kernel_err, refs,
                paged=False, int8=False, observe=None, attention=True,
                ssm=False, backend=None, overlap=True, int8_kv=False,
                moe=False, mla=False, d120=False, domains=None,
                strategy="cosine", overrides=None, device="cuda"):
    """Serve `prompts` through the engine and check the run; returns
    (summary, committed streams, launches by kernel). With
    `backend="async"` the run is also held to the wall-clock backend's
    contract (`check_async_run`) and its wall-clock quantities join the
    summary; `overlap=False` serves the serial twin (no draft-ahead).
    `domains` (one a prompt) are the requests' domain hints for the
    router; the summary then gives the acceptance of each domain.
    `strategy` and `overrides` (of `CoSineConfig` fields) select a
    baseline or an ablation (`make_engine`); the summary counts the
    forwards of each model, each drafter's decode steps and rows, and
    each runner's prefill writes. `device="cpu"` rehearses a phase
    without the card (no stream check, no device memory)."""
    from repro_torch.models import model as M

    on_cuda = device != "cpu"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    t0 = time.perf_counter()
    eng = make_engine(target, drafters, paged=paged, backend=backend,
                      strategy=strategy, overrides=overrides, device=device)
    if backend == "async":
        eng.executor.overlap = overlap
    sync()
    t_setup = time.perf_counter() - t0
    reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, domain=d)
            for p, d in zip(prompts, domains or [None] * len(prompts))]
    extra = observe(eng) if observe is not None else None
    decodes, decode_rows = [0] * len(drafters), [0] * len(drafters)
    draft_decode = eng.backend.draft_decode

    def counted_decode(di, rids, *a, **kw):
        # drafting runs on the engine thread alone
        decodes[di] += 1
        decode_rows[di] += len(rids)
        return draft_decode(di, rids, *a, **kw)

    eng.backend.draft_decode = counted_decode
    if on_cuda:
        torch.cuda.reset_peak_memory_stats()
    with PathCounters(cuda=on_cuda) as calls:
        t0 = time.perf_counter()
        try:
            stats = eng.run()
        finally:
            # the server is joined before anything else runs on the card
            eng.backend.shutdown()
        syncs_in_run = calls.device_syncs
        sync()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if on_cuda else None
    if on_cuda:
        # (on the CPU every wrapper takes its plain version: nothing to
        # hold the launch counters to)
        calls.check(label, paged, int8, attention=attention, ssm=ssm,
                    int8_kv=int8_kv, moe=moe, mla=mla, d120=d120)
    runners = {"target": eng.target, **{f"drafter {i}": d for i, d in
                                        enumerate(eng.drafters)}}
    # forwards of each model, where no two share a params tree
    ids = {id(r.params): name for name, r in runners.items()}
    by_model = None
    if len(ids) == len(runners):
        by_model = {name: calls.forwards_by_params.get(id(r.params), 0)
                    for name, r in runners.items()}
        if sum(by_model.values()) != calls.forwards:
            fail(f"{label}: forwards by model {by_model} for "
                 f"{calls.forwards} forwards")
    if backend == "async":
        wallclock = check_async_run(torch, label, eng, stats, calls,
                                    syncs_in_run, overlap, cuda=on_cuda)
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
        tf = teacher_forced_gaps(torch, M, tcfg, tparams, p, gen,
                                 device=device)
        n_argmax = sum(1 for g in tf if g == 0.0)
        if max(tf) >= tie_tol:
            fail(f"{label}: request {r.rid} committed token "
                 f"{tf.index(max(tf))} sits {max(tf):.4g} below the "
                 f"target's top logit (tolerance {tie_tol:.4g})")
        results.append(dict(rid=r.rid, prompt_len=len(p), matched=matched,
                            path_noise=noise, tie_tol=tie_tol, note=note,
                            teacher_forced_argmax=n_argmax,
                            teacher_forced_max_gap=max(tf),
                            iterations=r.n_iterations,
                            accepted=r.n_accepted_total,
                            drafted=r.n_drafted_total))
        print(f"{label} request {r.rid} (prompt {len(p)}): {matched}/"
              f"{NEW_TOKENS} tokens match the greedy reference; {note}; "
              f"teacher-forced: {n_argmax}/{NEW_TOKENS} are the target's "
              f"argmax, every token within {max(tf):.3g} of it; path "
              f"noise {noise:.3g}; {r.n_iterations} iterations, "
              f"{r.n_accepted_total} tokens committed of "
              f"{r.n_drafted_total} drafted", flush=True)

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
        int8_kv_reads=dict(resident=calls.resident_int8,
                           pool=calls.paged_int8),
        latent_reads=dict(resident=calls.resident_latent,
                          pool=calls.paged_latent),
        d120_reads=dict(resident=calls.resident_d120, pool=calls.paged_d120,
                        int8=calls.d120_int8),
        many_row_reads=dict(resident=calls.resident_many,
                            pool=calls.paged_many),
        cross_layer_calls=calls.cross_layer_calls,
        moe_layer_calls=calls.moe_calls,
        group_size_reads=calls.group_size_reads,
        moe_forwards=calls.moe_layer_calls // max(1, moe_layers(target[0])),
        moe_host_us_per_layer=(calls.moe_host_s / calls.moe_calls * 1e6
                               if calls.moe_calls else None),
        setup_s=t_setup, peak_mem_gb=peak_gb, requests_detail=results,
        strategy=strategy, overrides=overrides or {},
        forwards_by_model=by_model, draft_decodes_by_drafter=decodes,
        draft_decode_rows_by_drafter=decode_rows,
        prefill_writes={name: r.n_prefill_writes
                        for name, r in runners.items()},
        tree_nodes_per_request_iteration=sum(
            rec.big_gamma for rec in stats.records) / max(1, sum(
                rec.batch for rec in stats.records)),
        one_token_a_request_iterations=sum(
            rec.committed == rec.batch for rec in stats.records))
    if backend != "async" and hasattr(eng.executor, "n_survived"):
        # the simulated pipelined executor's draft-ahead outcomes
        summary.update(draft_ahead_survived=eng.executor.n_survived,
                       draft_ahead_invalidated=eng.executor.n_invalidated)
    if extra is not None:
        summary.update(extra())
    if backend == "async":
        summary.update(wallclock)
    if domains is not None:
        # committed tokens per iteration of a request: all requests, and
        # each domain's
        summary["request_acceptance"] = sum(
            r["accepted"] for r in results) / max(1, sum(
                r["iterations"] for r in results))
        summary["acceptance_by_domain"] = {
            d: sum(r["accepted"] for r, dd in zip(results, domains)
                   if dd == d)
            / max(1, sum(r["iterations"] for r, dd in zip(results, domains)
                         if dd == d))
            for d in dict.fromkeys(domains)}
    if moe:
        per_fwd = calls.group_size_reads / summary["moe_forwards"]
        summary["group_size_reads_per_forward"] = per_fwd
        print(f"{label}: {calls.moe_calls} MoE layer calls in "
              f"{summary['moe_forwards']} target forwards, "
              f"{calls.group_size_reads} host reads of group sizes "
              f"({per_fwd:.1f} a forward), "
              f"{summary['moe_host_us_per_layer']:.1f} us of host wall time "
              "per MoE layer (the device-to-host read waits for the "
              "layer's inputs)", flush=True)
    if int8_kv:
        print(f"{label}: int8 K/V reads resident {calls.resident_int8}, "
              f"pool {calls.paged_int8}", flush=True)
    print(f"{label}: wall clock {wall:.2f} s for {stats.total_committed} "
          f"tokens ({stats.total_committed / wall:.1f} tokens/s on the "
          f"card); simulated-clock throughput {stats.throughput_tps:.1f} "
          f"tokens/s (the engine's latency model, not a measurement); "
          f"mean acceptance {stats.mean_acceptance:.3f}; launches "
          f"{calls.launches} = resident attention calls {calls.resident}, "
          f"pool reads {calls.paged}, int8 products {calls.int8_products}, "
          f"SSM layers {calls.ssm_layer_calls} of {calls.forwards} forwards "
          f"(SSD launches by form {calls.ssd_forms})", flush=True)
    peak = "not measured (CPU)" if peak_gb is None else f"{peak_gb:.2f}"
    print(f"{label} ({strategy}{', ' + str(overrides) if overrides else ''}"
          f"): {calls.forwards} forwards (by model {by_model}), "
          f"{len(stats.records)} iterations, {stats.total_committed} "
          f"tokens committed, peak device GB {peak}, "
          f"{stats.total_committed / wall:.2f} wall tokens/s; drafter "
          f"decode steps {decodes} over {decode_rows} rows; prefill writes "
          f"{summary['prefill_writes']}", flush=True)
    return summary, streams, calls.launches


# phase T-ablate: the four ablation switches of DESIGN.md at once, one
# drafter a request (with two a request of two drafters, random routing
# and the full fan-out would give every drafter every request anyway)
ABLATION = dict(enable_routing=False, enable_fusion=False,
                subbatch_drafting=False, batched_prefill=True,
                drafters_per_request=1)


def burst_prefill_writes(lens, chunk: int) -> int:
    """Masked prefill writes of one burst (`ModelRunner.prefill_requests`)
    of contexts of `lens` tokens: one write for all that fit a chunk (if
    two or more do), and each longer one its own chunks."""
    short = sum(1 for n in lens if 0 < n <= chunk)
    return (1 if short > 1 else short) + sum(-(-n // chunk) for n in lens
                                             if n > chunk)


def first_differences(streams, other, refs):
    """(request, first token where `streams` and `other` differ, the
    reference's top-1/top-2 gap there) of each request whose streams
    differ."""
    out = []
    for i, (a, b) in enumerate(zip(streams, other)):
        if a != b:
            t = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            out.append((i, t, refs[i]["gaps"][t]))
    return out


def baseline_phases(torch, run, dense, full, mixed, twins,
                    overlap_gate=0.5):
    """The paper's baselines and the ablation switches, served with phase
    A's models, prompts and references (`dense`; `full`: its two
    drafters, `mixed`: phase D's, drafter 0 int8): T-ar (no drafter
    forward; the target's forwards are its iterations and prefill
    writes), T-vanilla (drafter 0 alone drafts chains), T-specinfer
    (both drafters every request, one merged tree), T-pipeinfer (the
    simulated pipelined executor), T-ablate (`ABLATION`: one masked
    prefill write for the burst, every drafter decoding every request),
    then on the wall-clock backend H-pipeinfer (`overlap_frac` >=
    `overlap_gate`), H-paged and H-int8. Every stream is held to the
    references under the tie rule by `run`; `twins` holds the committed
    streams of phases A, C, D and H. H-paged's must equal phase H's
    token for token (the same backend and burst prefill; the paged
    kernel is bitwise kernel 1), and H-int8's must equal phase H's
    where phase D's equal phase A's (the int8 drafter then moved no
    committed token on the simulated backend); each is also compared
    with its simulated twin (C, D), which prefills request by request:
    `first_differences`. Returns the summaries by phase."""
    from repro_torch.serving.runner import prefill_chunk_len

    out = {}
    n_d = len(full)

    def decoders(label, sm, want):
        """Fail unless exactly the drafters in `want` decoded."""
        dec = sm["draft_decodes_by_drafter"]
        if [i for i in range(n_d) if dec[i]] != want:
            fail(f"{label}: drafter decode steps {dec}, expected decodes "
                 f"by drafters {want} only")

    # T-ar: one token a request an iteration, the drafters never run
    sm, _ = run("phase T-ar", drafters=full, strategy="ar", **dense)
    fw, it = sm["forwards_by_model"], sm["iterations"]
    if fw is None or any(fw[f"drafter {i}"] for i in range(n_d)) \
            or any(sm["prefill_writes"][f"drafter {i}"] for i in range(n_d)):
        fail(f"phase T-ar: drafter forwards {fw}, prefill writes "
             f"{sm['prefill_writes']} (ar runs no drafter)")
    decoders("phase T-ar", sm, [])
    if fw["target"] != it + sm["prefill_writes"]["target"] \
            or sm["one_token_a_request_iterations"] != it:
        fail(f"phase T-ar: {fw['target']} target forwards for {it} "
             f"iterations and {sm['prefill_writes']['target']} prefill "
             f"writes ({sm['one_token_a_request_iterations']} iterations "
             "committed one token a request)")
    print(f"phase T-ar: {fw['target']} target forwards = {it} iterations "
          f"+ {sm['prefill_writes']['target']} prefill writes; no drafter "
          "forward", flush=True)
    out["phase T-ar"] = sm

    # T-vanilla and T-pipeinfer: drafter 0 alone drafts (chain trees);
    # drafter 1 is prefilled and takes the one-behind commits, as in the
    # reference, but never decodes
    for label, strategy in (("phase T-vanilla", "vanilla"),
                            ("phase T-pipeinfer", "pipeinfer")):
        sm, _ = run(label, drafters=full, strategy=strategy, **dense)
        decoders(label, sm, [0])
        print(f"{label}: mean acceptance {sm['mean_acceptance']:.3f}, "
              f"{sm['tree_nodes_per_request_iteration']:.2f} tree nodes a "
              f"request iteration; forwards by model "
              f"{sm['forwards_by_model']}"
              + (f"; draft-ahead survived {sm['draft_ahead_survived']}, "
                 f"invalidated {sm['draft_ahead_invalidated']}"
                 if "draft_ahead_survived" in sm else ""), flush=True)
        out[label] = sm

    # T-specinfer: every drafter drafts every request, one merged tree
    sm, _ = run("phase T-specinfer", drafters=full, strategy="specinfer",
                **dense)
    decoders("phase T-specinfer", sm, list(range(n_d)))
    rows = sm["draft_decode_rows_by_drafter"]
    if len(set(rows)) != 1:
        fail(f"phase T-specinfer: drafter decode rows {rows} (each drafter "
             "drafts every request)")
    print(f"phase T-specinfer: {sm['tree_nodes_per_request_iteration']:.2f}"
          f" tree nodes a request iteration (tree width {n_d - 1}); mean "
          f"acceptance {sm['mean_acceptance']:.3f}", flush=True)
    out["phase T-specinfer"] = sm

    # T-ablate: random routing, independent chains, the full fan-out and
    # the burst prefill
    sm, _ = run("phase T-ablate", drafters=full, overrides=ABLATION,
                **dense)
    tcfg = dense["target"][0]
    lens = [len(p) for p in dense["prompts"]]
    want = {"target": burst_prefill_writes(lens, prefill_chunk_len(tcfg))}
    for i, (dcfg, _, _) in enumerate(full):
        # the drafters hold one token less (one behind)
        want[f"drafter {i}"] = burst_prefill_writes(
            [n - 1 for n in lens], prefill_chunk_len(dcfg))
    if sm["prefill_writes"] != want:
        fail(f"phase T-ablate: prefill writes {sm['prefill_writes']}, "
             f"expected {want} (one masked write for the burst)")
    rows = sm["draft_decode_rows_by_drafter"]
    decoders("phase T-ablate", sm, list(range(n_d)))
    if len(set(rows)) != 1:
        fail(f"phase T-ablate: drafter decode rows {rows} (the full "
             "fan-out decodes every request on every drafter)")
    print(f"phase T-ablate: prefill writes {sm['prefill_writes']} for "
          f"prompts of {lens} tokens (one masked write for the burst); "
          f"drafter decode rows {rows} at one drafter a request",
          flush=True)
    out["phase T-ablate"] = sm

    # H-pipeinfer: the pipelined baseline on the wall-clock backend
    sm, _ = run("phase H-pipeinfer", drafters=full, strategy="pipeinfer",
                backend="async", **dense)
    decoders("phase H-pipeinfer", sm, [0])
    if sm["overlap_frac"] < overlap_gate:
        fail(f"phase H-pipeinfer: overlap_frac {sm['overlap_frac']:.3f} < "
             f"{overlap_gate} (drafting did not overlap verification)")
    out["phase H-pipeinfer"] = sm

    # H-paged and H-int8: phase H on the paged pool and with phase D's
    # drafters
    int8_moved_none = twins["D"] == twins["A"]
    print(f"phase D's committed streams equal phase A's: {int8_moved_none} "
          "(phase H-int8's must then equal phase H's)", flush=True)
    for label, kw, sim, must in (
            ("phase H-paged", dict(drafters=full, paged=True, observe=(
                lambda e: observe_pools(e, "phase H-paged"))), "C", True),
            ("phase H-int8", dict(drafters=mixed, int8=True), "D",
             int8_moved_none)):
        sm, streams = run(label, backend="async", **kw, **dense)
        same = {t: sum(a == b for a, b in zip(streams, twins[t]))
                for t in ("H", sim)}
        sm["streams_equal"] = same
        sm["first_differences"] = {t: first_differences(
            streams, twins[t], dense["refs"]) for t in ("H", sim)}
        print(f"{label}: committed streams equal token for token: "
              f"{same['H']}/{len(streams)} phase H's, {same[sim]}/"
              f"{len(streams)} phase {sim}'s (the simulated backend "
              f"prefills request by request); first differences "
              f"(request, token, reference top-1/top-2 gap) "
              f"{sm['first_differences']}", flush=True)
        if must and same["H"] != len(streams):
            fail(f"{label}: committed other tokens than phase H")
        out[label] = sm
    classes = {}
    for m, n in out["phase H-int8"]["int8_calls_by_rows"].items():
        classes[int8_row_class(m)] = classes.get(int8_row_class(m), 0) + n
    print(f"phase H-int8 int8 launches by rows "
          f"{out['phase H-int8']['int8_calls_by_rows']}: {classes}",
          flush=True)
    return out


def check_async_run(torch, label, eng, stats, calls, syncs_in_run, overlap,
                    cuda=True):
    """Hold a run of the wall-clock backend to its contract and gather
    the reference's wall-clock quantities (`benchmarks/wallclock.py`):
    the target's forwards ran on the server thread's stream and the
    drafters' on the engine thread's, two distinct streams, neither the
    legacy default one (`cuda=False`: on the two threads, which have no
    streams); no device-wide synchronize ran during the run.
    Returns overlap_frac (the share of cohorts whose drafting began
    before the previous verification finished), the verifier idle
    fraction, the draft-ahead outcomes and the server's spans summed by
    kind."""
    from repro_torch.serving.backend import AsyncTorchBackend

    b = eng.backend
    if not isinstance(b, AsyncTorchBackend):
        fail(f"{label}: the engine did not get the async backend")
    default = torch.cuda.default_stream().cuda_stream if cuda else None
    ts, ds = ((b.target_stream.cuda_stream, b.draft_stream.cuda_stream)
              if cuda else (None, None))
    server, engine = set(), set()
    n_server = n_engine = 0
    for (thread, stream), n in calls.streams.items():
        if thread.startswith("verify-server"):
            server.add(stream)
            n_server += n
        else:
            engine.add(stream)
            n_engine += n
    if server != {ts} or engine != {ds} or (cuda and (
            ts == ds or default in (ts, ds))):
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


class ProfEvent:
    """One profiler event with the fields of `prof.events()`'s
    `FunctionEvent` that the profiler windows read (and its place in the
    host operations' tree)."""
    __slots__ = ("name", "device_type", "thread", "time_range", "kernels",
                 "is_async", "parent", "children")

    def __init__(self, name, device_type, thread, time_range, is_async):
        self.name, self.device_type = name, device_type
        self.thread, self.time_range = thread, time_range
        self.is_async = is_async
        self.kernels, self.parent, self.children = [], None, []


class _Range(NamedTuple):
    start: float
    end: float


class _Kernel(NamedTuple):
    name: str
    duration: float


def profiler_events(torch, prof):
    """`_profiler_events` with the garbage collector off (it makes ~10^6
    objects, whose collections would double its time); prints how long
    the read took."""
    was = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        out = _profiler_events(torch, prof)
    finally:
        if was:
            gc.enable()
    print(f"profiler: {len(out)} events read in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _profiler_events(torch, prof):
    """`prof.events()` as the profiler windows read it, straight from the
    profiler's raw results, as `torch.autograd.profiler`'s
    `_parse_kineto_results` and `EventList._build_tree` give it: each
    event's name (demangled), device type, thread and time range (us from
    the trace's start); a host operation's device kernels, linked by
    correlation id; the runtime calls an operation made on its thread; a
    host operation that is the only child of one of its own name merged
    into it. torch's own parse also builds every event's Python object,
    stack and backward links, which over a window of ~10^6 events takes
    minutes of host time; this takes seconds. Sorted by (start, -end), as
    `prof.events()`."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    raw_events = res.events()
    kinds = type(raw_events[0]) if raw_events else None
    hidden = getattr(kinds, "is_hidden_event", None)
    legacy = (getattr(kinds, "cuda_elapsed_us", None)
              if getattr(prof.profiler, "use_device", None) == "cuda"
              else None)
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    names = {}
    out, frontend, linked = [], [], {}
    for k in raw_events:
        raw = k.name()
        if _filter_name(raw) or (hidden is not None and hidden(k)):
            continue
        name = names.get(raw)
        if name is None:
            name = torch._C._demangle(raw) if len(raw) > 1 else raw
            if name.startswith("ProfilerStep#"):
                name = "ProfilerStep*"
            names[raw] = name
        th = k.start_thread_id()
        e = ProfEvent(name, k.device_type(), th,
                      _Range((k.start_ns() - t0) / 1e3,
                             (k.end_ns() - t0) / 1e3),
                      k.is_async() or th != k.end_thread_id())
        if e.device_type == cpu and not e.is_async and legacy is not None:
            t = legacy(k)
            if t > 0:
                e.kernels.append(_Kernel(name, t))
        out.append(e)
        corr = k.linked_correlation_id()
        if corr > 0:
            linked.setdefault(corr, []).append(e)
        elif corr == 0:
            frontend.append((k.correlation_id(), e))
    for corr, e in frontend:
        if e.device_type != cpu or e.is_async:
            continue
        for d in linked.get(corr, ()):
            if d.device_type == cuda:
                e.kernels.append(_Kernel(d.name, d.time_range.end
                                         - d.time_range.start))
            elif d.device_type == cpu:
                d.thread = e.thread
    out.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    # the host operations' tree: on each thread, an operation's parent is
    # the innermost one whose time range holds its own
    by_thread = {}
    for e in out:
        if e.device_type == DeviceType.CPU and not e.is_async:
            by_thread.setdefault(e.thread, []).append(e)
    for events in by_thread.values():
        stack = []
        for e in events:
            while stack and (e.time_range.start >= stack[-1].time_range.end
                             or e.time_range.end > stack[-1].time_range.end):
                stack.pop()
            if stack:
                stack[-1].children.append(e)
                e.parent = stack[-1]
            stack.append(e)
    # an only child of its own name merges into its parent, which takes
    # its children and kernels
    while True:
        gone = set()
        for e in out:
            p = e.parent
            if p is not None and p.name == e.name and len(p.children) == 1:
                p.children, p.kernels = e.children, e.kernels
                for ch in e.children:
                    ch.parent = p
                gone.add(id(e))
        if not gone:
            return out
        out = [e for e in out if id(e) not in gone]


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
    events = profiler_events(torch, prof)
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


MOE_RANGE = "chip_smoke: moe layer"


def range_device_us(events, range_name):
    """Device time of the kernels launched inside the host ranges named
    `range_name`. The profiler links each device kernel by its
    correlation id to the one host operation that launched it (that
    operation's `kernels`); an operation counts when it starts inside
    such a range on the range's own thread. Returns (ranges, device us
    launched inside them, device us linked to any host operation)."""
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    ranges = [(e.thread, e.time_range.start, e.time_range.end)
              for e in host if e.name == range_name]
    inside = linked = 0.0
    for e in host:
        t = sum(k.duration for k in e.kernels)
        if not t:
            continue
        linked += t
        if any(th == e.thread and a <= e.time_range.start < b
               for th, a, b in ranges):
            inside += t
    return len(ranges), inside, linked


def profile_engine_window(torch, target, drafters, prompts, warm=3,
                          steps=5, wrap=()):
    """`torch.profiler` over `steps` iterations of a serving phase's
    engine (after `warm` unprofiled ones; simulated backend, resident
    pool). `wrap` names (module, function, range) triples: each call of
    the function runs inside a `record_function` range of that name.
    Returns (profiler events, the device's events outside those ranges,
    the window's wall ms, the device's busy ms in it: the union of its
    operations), or None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = make_engine(target, drafters)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    saved = []
    for mod, name, rng in wrap:
        orig = getattr(mod, name)

        def traced(*a, _orig=orig, _rng=rng, **kw):
            with record_function(_rng):
                return _orig(*a, **kw)

        saved.append((mod, name, orig))
        setattr(mod, name, traced)
    try:
        for _ in range(warm):
            eng.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)
    ranges = {rng for _, _, rng in wrap}
    events = profiler_events(torch, prof)
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in ranges]
    if not dev:
        return None
    busy = sum(b - a for a, b in _merge(
        [(e.time_range.start, e.time_range.end) for e in dev])) / 1e3
    return events, dev, window_ms, busy


def _kernel_share(dev, match, busy, window_ms):
    """Launches and device ms of the device events whose name `match`
    accepts, with their shares of the busy time and of the window."""
    mine = [e for e in dev if match(e.name)]
    ms = sum(e.time_range.end - e.time_range.start for e in mine) / 1e3
    return dict(launches=len(mine), device_ms=ms, share_of_busy=ms / busy,
                share_of_window=ms / window_ms)


def is_int8kv_kernel(name: str) -> bool:
    """A device event of kernels 1 and 2's int8 K/V form (`int8_kernel`)."""
    return "int8_kernel" in name


def profile_int8kv_window(torch, target, drafters, prompts, warm=3, steps=5,
                          match=is_int8kv_kernel):
    """`torch.profiler` over `steps` iterations of phase K's engine (int8
    KV caches for the target and the drafters): the device's busy time in
    the window and the int8 K/V forms' device time (`match`: the events of
    their kernel), as shares of the busy time and of the window. Returns a
    summary dict."""
    got = profile_engine_window(torch, target, drafters, prompts, warm,
                                steps)
    if got is None:
        print("phase K profiler: torch.profiler recorded no device "
              "activity; device shares not measured", flush=True)
        return dict(profiler="no device activity recorded")
    _, dev, window_ms, busy = got
    dev_ms = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    k8 = _kernel_share(dev, match, busy, window_ms)
    out = dict(steps=steps, window_ms=window_ms, device_busy_ms=busy,
               device_busy_share=busy / window_ms, device_op_ms=dev_ms,
               int8kv_launches=k8["launches"],
               int8kv_device_ms=k8["device_ms"],
               int8kv_share_of_busy=k8["share_of_busy"],
               int8kv_share_of_window=k8["share_of_window"])
    print(f"phase K profiler: {steps} iterations in {window_ms:.1f} ms, the "
          f"device busy {busy:.2f} ms ({busy / window_ms:.1%}); int8 K/V "
          f"forms {k8['launches']} launches, {k8['device_ms']:.3f} ms "
          f"({k8['share_of_busy']:.1%} of busy, "
          f"{k8['share_of_window']:.1%} of the window)", flush=True)
    return out


def profile_latent_window(torch, target, drafters, prompts, warm=3,
                          steps=5):
    """`torch.profiler` over `steps` iterations of phase L's engine
    (`profile_engine_window`): the device's busy time in the window, the
    device time of the latent kernels (kernels 1 and 2's
    `latent_kernel`), and that of the MoE layer (the kernels launched
    inside the `apply_moe` calls, each wrapped in a `record_function`
    range: `range_device_us`), each as a share of the busy time and of
    the window, with the share of the device time that the profiler
    linked to a host operation at all. Returns a summary dict."""
    from repro_torch.models import moe as moe_mod

    got = profile_engine_window(torch, target, drafters, prompts, warm,
                                steps,
                                wrap=[(moe_mod, "apply_moe", MOE_RANGE)])
    if got is None:
        print("phase L profiler: torch.profiler recorded no device "
              "activity; device shares not measured", flush=True)
        return dict(profiler="no device activity recorded")
    events, dev, window_ms, busy = got
    latent = _kernel_share(dev, lambda n: "latent_kernel" in n, busy,
                           window_ms)
    latent_ms = latent["device_ms"]
    dev_ms = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    moe_calls, moe_us, linked_us = range_device_us(events, MOE_RANGE)
    if not linked_us:
        print("phase L profiler: no device kernel was linked to a host "
              "operation; the MoE layer's share not measured", flush=True)
        return dict(profiler="no kernel linked to a host operation",
                    device_busy_ms=busy, latent_device_ms=latent_ms)
    moe_ms = moe_us / 1e3
    out = dict(steps=steps, window_ms=window_ms, device_busy_ms=busy,
               device_busy_share=busy / window_ms,
               latent_launches=latent["launches"], latent_device_ms=latent_ms,
               latent_share_of_busy=latent["share_of_busy"],
               latent_share_of_window=latent["share_of_window"],
               moe_layer_calls=moe_calls, moe_device_ms=moe_ms,
               moe_share_of_busy=moe_ms / busy,
               moe_share_of_window=moe_ms / window_ms,
               device_op_ms=dev_ms, linked_share=linked_us / 1e3 / dev_ms)
    print(f"phase L profiler: {steps} iterations in {window_ms:.1f} ms, the "
          f"device busy {busy:.2f} ms ({busy / window_ms:.1%}); latent "
          f"kernels {latent['launches']} launches, {latent_ms:.3f} ms "
          f"({latent['share_of_busy']:.1%} of busy, "
          f"{latent['share_of_window']:.1%} of "
          f"the window); MoE layer {moe_calls} calls, kernels launched "
          f"inside them {moe_ms:.3f} ms ({moe_ms / busy:.1%} of busy, "
          f"{moe_ms / window_ms:.1%} of the window); "
          f"{out['linked_share']:.1%} of the {dev_ms:.2f} ms of device "
          "operations linked to a host operation", flush=True)
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


def deepseek_phases(torch, M, attn, cfg, run, references, make_prompts, err,
                    paged_latent_exact, a_tps):
    """Phases L, L-paged and L-f32: `cfg` (deepseek-v3-671b) at full
    width, cut to its own first 4 of 61 layers (dense FFN in layers 0-2,
    the MoE of 256 routed experts top-8 and a shared expert in layer 3;
    MLA in every layer; the MTP subtree in the params), two drafters
    sharing its weights, phase A's requests; `run` and `references` are
    `main`'s. Fails unless the device memory of earlier phases is gone
    first. Returns the summaries of L and L-f32."""
    held_gb = torch.cuda.memory_allocated() / 1e9
    print(f"device memory held before phase L: {held_gb:.2f} GB", flush=True)
    if held_gb > 4.0:
        fail(f"phase L: {held_gb:.2f} GB still allocated after phase J")
    lcfg = cfg.with_overrides(n_layers=4)
    specs = M.layer_specs(lcfg)
    if [(s_.mixer, s_.ffn) for s_ in specs] != [("mla", "dense")] * 3 + [
            ("mla", "moe")]:
        fail(f"phase L: the cut plan is {specs}")
    lprompts = make_prompts(lcfg)
    t0 = time.perf_counter()
    lparams = M.init_params(lcfg, seed=40, device="cuda")
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"deepseek-v3-671b weights (4 layers + MTP, f32) "
          f"{time.perf_counter() - t0:.1f} s, {weights_gb:.2f} GB", flush=True)
    lrefs = references(lcfg, lparams, lprompts)
    mla_kw = dict(prompts=lprompts, err=err, moe=True, mla=True)
    sum_l, streams_l = run("phase L", target=(lcfg, lparams),
                           drafters=[(lcfg, lparams, f"l{i}")
                                     for i in range(2)],
                           refs=lrefs, **mla_kw)
    _, streams_lp = run("phase L-paged", target=(lcfg, lparams),
                        drafters=[(lcfg, lparams, f"l{i}") for i in range(2)],
                        refs=lrefs, paged=True,
                        observe=lambda e: observe_pools(e, "phase L-paged"),
                        **mla_kw)
    same = sum(a == b for a, b in zip(streams_l, streams_lp))
    print(f"phase L-paged: {same}/{len(lprompts)} committed streams equal "
          f"phase L's token for token (paged latent form bitwise kernel 1's "
          f"on the gathered view: {paged_latent_exact})", flush=True)
    if not paged_latent_exact or same != len(lprompts):
        fail("phase L-paged: the paged latent pool committed other tokens "
             "than the resident pool")
    # phase L-f32: phase L with f32 activations (the same weights): the
    # layer-3 router's bf16 near-ties loosen L's tie rule, as in phase J;
    # here the greedy stream must be committed exactly
    lcfg32 = lcfg.with_overrides(dtype="float32")
    sum_l32, _ = run("phase L-f32", target=(lcfg32, lparams),
                     drafters=[(lcfg32, lparams, f"l{i}") for i in range(2)],
                     refs=references(lcfg32, lparams, lprompts), **mla_kw)
    exact = [r["matched"] for r in sum_l32["requests_detail"]]
    if exact != [NEW_TOKENS] * len(lprompts):
        fail(f"phase L-f32: committed {exact} of {NEW_TOKENS} tokens of the "
             "greedy streams")
    for label, sm in (("phase L", sum_l), ("phase L-f32", sum_l32)):
        if sm["moe_layer_calls"] != sm["moe_forwards"]:
            fail(f"{label}: {sm['moe_layer_calls']} MoE layer calls for "
                 f"{sm['moe_forwards']} forwards of one MoE layer")
        reads = (sum(sm["resident_attention_calls"].values())
                 - sm["resident_attention_calls"].get("segment", 0))
        if reads != lcfg.n_layers * sm["forwards"]:
            fail(f"{label}: {reads} latent cache reads for "
                 f"{sm['forwards']} forwards of {lcfg.n_layers} MLA layers")
        if not sm["mean_acceptance"] > 1.0:
            fail(f"{label} mean acceptance {sm['mean_acceptance']:.3f} <= 1")
    print(f"phase L: kernel 1's latent form read each MLA layer's cache "
          f"once a forward: {lcfg.n_layers} layers x {sum_l['forwards']} "
          f"forwards = {lcfg.n_layers * sum_l['forwards']} cache reads (+ "
          f"{sum_l['resident_attention_calls'].get('segment', 0)} segment "
          f"passes) = {sum_l['kernel_launches']['flash_attention_partial_mla']}"
          f" latent launches; wall tokens/s L {sum_l['wall_tokens_per_s']:.2f}"
          f", L-f32 {sum_l32['wall_tokens_per_s']:.2f}, A "
          f"{a_tps:.2f} (same run); forwards L "
          f"{sum_l['forwards']}, L-f32 {sum_l32['forwards']}; peak device GB "
          f"L {sum_l['peak_mem_gb']:.2f}, L-f32 {sum_l32['peak_mem_gb']:.2f}; "
          f"router top-k sets differing between the two paths: "
          f"{sum(r['router_flips'] for r in lrefs)} of "
          f"{sum(r['router_pairs'] for r in lrefs)} pairs", flush=True)
    # host cost of one mla_attention call (layer 0, f32 latent cache in
    # the slot pool) at decode (4 rows), a tree verification (4 x 10) and
    # a prefill chunk (512 rows), enqueue time over 20 calls
    mla_host = {}
    lp = lparams["layers"][0]["mixer"]
    cache = attn.make_mla_cache(9, MAX_LEN, lcfg, torch.float32,
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    tree = _tree_mask(torch).expand(4, 10, 10).contiguous()
    for rows, B, T in ((4, 4, 1), (40, 4, 10), (512, 1, 512)):
        x = torch.randn((B, T, lcfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pos = (torch.tensor(PROMPT_LENS[:B], device="cuda")[:, None]
               + torch.arange(T, device="cuda")).to(torch.int32)
        if T == 512:
            pos = torch.arange(T, device="cuda", dtype=torch.int32)[None]
        sidx = torch.arange(1, B + 1, dtype=torch.int32, device="cuda")
        kw = dict(cache=cache, slot_idx=sidx, write=T != 10,
                  seg_mask=tree if T == 10 else None)
        mla_host[rows] = _host_us(torch, lambda: attn.mla_attention(
            lp, lcfg, x, pos, **kw), n=20)
    print(f"phase L: host us per mla_attention call by rows {mla_host}",
          flush=True)
    sum_l["mla_attention_host_us_by_rows"] = mla_host
    sum_l["router_flips"] = [dict(prompt_len=len(p), flips=r["router_flips"],
                                  pairs=r["router_pairs"])
                             for p, r in zip(lprompts, lrefs)]
    sum_l["weights_gb"] = weights_gb
    # where L's device time goes: the latent kernels and the MoE layer
    t0 = time.perf_counter()
    sum_l["profile"] = profile_latent_window(
        torch, (lcfg, lparams), [(lcfg, lparams, f"l{i}") for i in range(2)],
        lprompts, warm=2, steps=2)
    progress(f"phase L profiler window {time.perf_counter() - t0:.1f} s")
    del lparams, lp, cache
    gc.collect()
    torch.cuda.empty_cache()
    return sum_l, sum_l32


# greedy decodes of the image check (phases N and O)
IMAGE_STEPS = 16


def image_check(torch, M, fa, cfg, params, prompts, fe, label, tie_tol,
                device="cuda", max_len=MAX_LEN):
    """The cross layers at the model level with a frontend `fe` (B, S, d):
    each prompt prefilled into its slot with its frontend (`slot_extend`
    writes the cross rows in place; an encoder-decoder encodes first),
    then IMAGE_STEPS greedy `slot_decode_step`s of all slots at once that
    read those rows (kernel 1, non-causal, through slot_idx); every
    served logit row held against `apply(frontend=...)` over the whole
    sequence. A token may differ from the full forward's argmax only
    where that forward's top-1/top-2 gap is under `tie_tol`. On the card
    the non-causal launches of the prefills and the decodes are counted
    (`device="cpu"` rehearses the rest at tiny widths and a short
    `max_len`). Returns the
    check's summary."""
    B = len(prompts)
    n_cross = sum(s_.cross for s_ in M.layer_specs(cfg))
    cache = M.init_cache(cfg, B + 1, max_len, dtype=torch.float32,
                         device=device)
    fa.LAUNCHES_NONCAUSAL = 0
    rows = [[] for _ in prompts]
    t0 = time.perf_counter()
    for b, p in enumerate(prompts):
        idx = torch.tensor([b + 1], dtype=torch.int32, device=device)
        lg, _, _ = M.slot_extend(params, cfg, torch.tensor([p], device=device),
                                 cache, idx, frontend=fe[b: b + 1])
        rows[b].append(lg[0, -1, : cfg.vocab].clone())
    prefill_nc = fa.LAUNCHES_NONCAUSAL
    idx = torch.arange(1, B + 1, dtype=torch.int32, device=device)
    toks = [[] for _ in prompts]
    for _ in range(IMAGE_STEPS):
        nxt = torch.stack([r[-1] for r in rows]).argmax(-1)
        for b, t in enumerate(nxt.tolist()):
            toks[b].append(t)
        lg, _, _ = M.slot_decode_step(params, cfg, nxt[:, None].to(
            torch.int32), cache, idx)
        for b in range(B):
            rows[b].append(lg[b, 0, : cfg.vocab])
    decode_nc = fa.LAUNCHES_NONCAUSAL - prefill_nc
    if device == "cuda":
        torch.cuda.synchronize()
    served_s = time.perf_counter() - t0
    want_prefill = B * (n_cross + cfg.encoder_layers)
    if device == "cuda" and (prefill_nc, decode_nc) != (
            want_prefill, IMAGE_STEPS * n_cross):
        fail(f"{label} image check: {prefill_nc} / {decode_nc} non-causal "
             f"launches at prefill / decode, expected {want_prefill} / "
             f"{IMAGE_STEPS * n_cross}")
    gaps, ties = [], []
    for b, p in enumerate(prompts):
        full, _, _ = M.apply(params, cfg, torch.tensor(
            [p + toks[b][:-1]], device=device), frontend=fe[b: b + 1])
        ref = full[0, len(p) - 1:, : cfg.vocab]
        got = torch.stack(rows[b][:IMAGE_STEPS])
        gaps.append(float((got - ref).abs().max()))
        for i, t in enumerate(toks[b]):
            below = float(ref[i].max() - ref[i, t])
            if below > 0.0:
                if below >= tie_tol:
                    fail(f"{label} image check: prompt {len(p)} token {i} "
                         f"is {below:.4g} below the full forward's argmax "
                         f"(tolerance {tie_tol:.4g})")
                ties.append(dict(prompt_len=len(p), token=i, gap=below))
        del full
    out = dict(frontend_shape=list(fe.shape), steps=IMAGE_STEPS,
               max_logit_gap_vs_full=max(gaps),
               logit_gap_by_request=gaps, near_tie_tokens=ties,
               tie_tol=tie_tol, noncausal_launches_prefill=prefill_nc,
               noncausal_launches_decode=decode_nc, served_s=served_s)
    print(f"{label} image check: frontend {tuple(fe.shape)}; {B} prompts "
          f"prefilled with it, {IMAGE_STEPS} batched decodes reading the "
          f"cross rows; largest logit gap to apply(frontend) over the whole "
          f"sequence {max(gaps):.4g} (by request "
          f"{[round(g, 4) for g in gaps]}); {len(ties)} tokens at near-ties "
          f"of the full forward (tolerance {tie_tol:.4g}); non-causal "
          f"launches {prefill_nc} at prefill ({n_cross} cross + "
          f"{cfg.encoder_layers} encoder layers a prompt), {decode_nc} at "
          f"decode; {served_s:.2f} s", flush=True)
    del cache
    return out


def remaining_arch_phases(torch, M, fa, run, references, make_prompts,
                          kernel_err, paged_d120_exact, cfgs, drafter_cfg):
    """Phases M, M-paged, M-int8, N and O, after phase L's weights are
    released: h2o-danube3-4b with two llama-68m drafters (every cache read
    of the target on the (120, 120) instantiation), resident and paged,
    then resident with int8 KV caches for all three models; then
    llama-3.2-vision-11b and whisper-small, each with the image check
    (`image_check`) and a text-only serve with two drafters sharing its
    weights. Each model's weights are freed before the next. Returns the
    phases' summaries and the image checks."""
    danube, vision, whisper = cfgs
    danube = danube.with_overrides(n_layers=M_LAYERS)
    vision = vision.with_overrides(n_layers=N_LAYERS)
    held_gb = torch.cuda.memory_allocated() / 1e9
    print(f"device memory held before phase M: {held_gb:.2f} GB", flush=True)
    if held_gb > 4.0:
        fail(f"phase M: {held_gb:.2f} GB still allocated after phase L")
    out = {}

    def weights(cfg, seed, what):
        t0 = time.perf_counter()
        params = M.init_params(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        gb = torch.cuda.memory_allocated() / 1e9
        print(f"{cfg.name} weights ({what}, f32) {time.perf_counter() - t0:.1f}"
              f" s, {gb:.2f} GB held", flush=True)
        return params, gb

    # ---- phases M and M-paged: h2o-danube3-4b at full width, M_LAYERS deep
    mprompts = make_prompts(danube)
    mparams, gb = weights(danube, 50, f"{danube.n_layers} layers")
    mdraft = [M.init_params(drafter_cfg, seed=1 + i, device="cuda")
              for i in range(2)]
    mrefs = references(danube, mparams, mprompts)
    dense = dict(target=(danube, mparams), prompts=mprompts, refs=mrefs,
                 err=kernel_err, d120=True,
                 drafters=[(drafter_cfg, mdraft[i], f"d{i}")
                           for i in range(2)])
    sum_m, streams_m = run("phase M", **dense)
    _, streams_mp = run("phase M-paged", paged=True,
                        observe=lambda e: observe_pools(e, "phase M-paged"),
                        **dense)
    same = sum(a == b for a, b in zip(streams_m, streams_mp))
    print(f"phase M-paged: {same}/{len(mprompts)} committed streams equal "
          f"phase M's token for token (paged kernel bitwise kernel 1 at "
          f"(120, 120): {paged_d120_exact})", flush=True)
    if not paged_d120_exact or same != len(mprompts):
        fail("phase M-paged: the paged pool committed other tokens than the "
             "resident pool")
    # phase M-int8: the same weights with int8 KV caches for the target
    # and both drafters, resident: every D 120 cache read on the int8 form
    m8 = danube.with_overrides(kv_dtype="int8")
    d8 = drafter_cfg.with_overrides(kv_dtype="int8")
    sum_m8, _ = run("phase M-int8", target=(m8, mparams), prompts=mprompts,
                    refs=references(m8, mparams, mprompts), err=kernel_err,
                    d120=True, int8_kv=True,
                    drafters=[(d8, mdraft[i], f"d{i}") for i in range(2)])
    print(f"phase M-int8: {sum_m8['d120_reads']['int8']} int8 K/V reads of "
          f"heads of width 120 (every cache read of the target), "
          f"{sum_m8['kernel_launches']['flash_attention_partial_int8_kv']} "
          f"int8-form launches in all; peak device GB "
          f"{sum_m8['peak_mem_gb']:.2f} (phase M "
          f"{sum_m['peak_mem_gb']:.2f})", flush=True)
    out["phase M-int8"] = sum_m8
    sum_m["weights_gb"] = gb
    del mparams, mdraft, dense
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase N: llama-3.2-vision-11b; phase O: whisper-small
    for label, cfg, seed in (("phase N", vision, 60), ("phase O", whisper,
                                                       70)):
        prompts = make_prompts(cfg)
        params, gb = weights(cfg, seed, f"{cfg.n_layers} layers"
                             + (f" + {cfg.encoder_layers} encoder layers"
                                if cfg.is_encdec else ""))
        refs = references(cfg, params, prompts)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        fe = 0.1 * torch.randn((len(prompts), M.cross_len(cfg), cfg.d_model),
                               generator=gen, device="cuda")
        tie_tol = max(4.0 * max(r["noise"] for r in refs),
                      100.0 * kernel_err)
        check = image_check(torch, M, fa, cfg, params, prompts, fe, label,
                            tie_tol)
        del fe
        sm, _ = run(label, target=(cfg, params),
                    drafters=[(cfg, params, f"x{i}") for i in range(2)],
                    prompts=prompts, refs=refs, err=kernel_err)
        if not sm["mean_acceptance"] > 1.0:
            fail(f"{label} mean acceptance {sm['mean_acceptance']:.3f} <= 1")
        n_cross = sum(s_.cross for s_ in M.layer_specs(cfg))
        print(f"{label}: kernel 1 read each of the {n_cross} cross layers' "
              f"(empty) cross cache once a forward, non-causal: "
              f"{sm['kernel_launches']['flash_attention_partial_noncausal']}"
              f" launches over {sm['forwards']} forwards; peak device GB "
              f"{sm['peak_mem_gb']:.2f}", flush=True)
        sm["weights_gb"] = gb
        sm["image_check"] = check
        out[label] = sm
        del params, refs
        gc.collect()
        torch.cuda.empty_cache()
    out["phase M"] = sum_m
    return out


# =====================================================================
# training phases
# =====================================================================

@contextlib.contextmanager
def plain_oracle(attn, fa):
    """The test-only oracle of a training step: within it every
    self-contained attention read (the model's, the encoder's, MLA's)
    differentiates through autograd of the plain version
    (`attend_partial_plain`), which replaces
    `models.attention.blocked_attention`, and every full-sequence SSD
    scan through autograd of `ssd_chunked`, which replaces the SSD ops
    module's `ssd_slots`."""
    from repro_torch.kernels.ssd_scan import ops as sd

    def blocked(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                extra_mask=None, block=None):
        return fa.finalize(fa.attend_partial_plain(
            q, k, v, q_pos, k_pos, scale=scale, causal=causal,
            window=window, mask=extra_mask, block=block)).to(q.dtype)

    def slots(x, dt, A, B, C, chunk, state, slot_idx=None, write=True):
        if state is not None:
            raise RuntimeError("the plain oracle differentiates only a "
                               "full-sequence scan (state=None)")
        return sd.ssd_chunked(x, dt, A, B, C, chunk)[0]

    saved, saved_slots = attn.blocked_attention, sd.ssd_slots
    attn.blocked_attention, sd.ssd_slots = blocked, slots
    try:
        yield
    finally:
        attn.blocked_attention, sd.ssd_slots = saved, saved_slots


@contextlib.contextmanager
def ssd_paths(sd):
    """Counts the SSD scan's launches by path ("rec", "chunk") while it
    lasts: {path: launches}, through a wrapper of `sd.launch_plan` (the
    one function both wrappers launch through)."""
    counts = {"rec": 0, "chunk": 0}
    launch = sd.launch_plan

    def counted(*args):
        y = launch(*args)
        counts[args[-1].path] += 1
        return y

    sd.launch_plan = counted
    try:
        yield counts
    finally:
        sd.launch_plan = launch


def loss_and_grads(cfg, params, tokens, frontend=None):
    """(loss, gradient leaves) of `lm_loss` (remat off, as `train_model`
    steps) at `params`."""
    from repro_torch.launch.train import value_and_grad
    from repro_torch.optim.optimizers import tree_leaves
    loss, _, grads = value_and_grad(params, cfg, tokens, frontend,
                                    remat=False)
    return float(loss), tree_leaves(grads)


def grad_error(got, want) -> dict:
    """The largest over leaves of max |got - want| / max |want| ("max")
    and of ||got - want|| / ||want|| ("l2")."""
    def worst(norm):
        return max(float(norm((g - w).float()))
                   / max(float(norm(w.float())), 1e-30)
                   for g, w in zip(got, want))
    return {"max": worst(lambda t: t.abs().max()), "l2": worst(torch_norm)}


def torch_norm(t):
    """Frobenius norm of a tensor, whatever its rank."""
    return t.reshape(-1).norm()


def grad_check(torch, M, attn, fa, cfg, params, tokens, frontend=None):
    """One training step's loss and gradients with every attention
    forward on kernel 1 (`fa.attention`) and every SSD scan on the SSD
    kernel (`scan` of the SSD ops module) against the same step through
    the plain versions' autograd (`plain_oracle`). Returns (kernel loss,
    plain loss, `grad_error`'s dict, kernel-1 launches of the step, SSD
    kernel launches of the step)."""
    from repro_torch.kernels.ssd_scan import ops as sd

    fa.LAUNCHES = sd.LAUNCHES = 0
    loss_k, g_k = loss_and_grads(cfg, params, tokens, frontend)
    launches, ssd_launches = fa.LAUNCHES, sd.LAUNCHES
    with plain_oracle(attn, fa):
        loss_p, g_p = loss_and_grads(cfg, params, tokens, frontend)
    if fa.LAUNCHES != launches:
        fail(f"{cfg.name}: the plain oracle launched kernel 1")
    if sd.LAUNCHES != ssd_launches:
        fail(f"{cfg.name}: the plain oracle launched the SSD kernel")
    return loss_k, loss_p, grad_error(g_k, g_p), launches, ssd_launches


def layer_counts(cfg) -> dict:
    """Attention and SSM layers of `cfg`: the launches of kernel 1 and of
    the SSD kernel in one training forward."""
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    return {"attn": kinds.count("attn"), "ssm": kinds.count("ssm")}


def grad_checks(torch, M, attn, fa, cfg, params, tokens, label):
    """`grad_check` at f32 and at bf16 activations (`GRAD_TOL`), each
    step launching kernel 1 once an attention layer and the SSD kernel
    once an SSM layer (on a card; nothing on the CPU). Returns the
    checks by dtype."""
    cuda = tokens.device.type == "cuda"
    want = layer_counts(cfg)
    checks = {}
    for dtype, (metric, tol) in GRAD_TOL.items():
        c = cfg.with_overrides(dtype=dtype)
        loss_k, loss_p, err, n, n_ssd = grad_check(
            torch, M, attn, fa, c, params, tokens)
        checks[dtype] = dict(loss_kernel=loss_k, loss_plain=loss_p,
                             grad_rel_err=err, gated=metric, tol=tol,
                             launches=n, ssd_launches=n_ssd)
        print(f"{label} gradient check ({dtype} activations): loss "
              f"{loss_k:.6f} on the kernels, {loss_p:.6f} plain; gradient "
              f"leaves' largest errors {err['max']:.3g} of the leaf's "
              f"largest value, {err['l2']:.3g} of its norm (gated: "
              f"{metric} <= {tol:g}); {n} kernel-1 launches for "
              f"{want['attn']} attention layers, {n_ssd} SSD launches for "
              f"{want['ssm']} SSM layers", flush=True)
        if (n, n_ssd) != (want["attn"] * cuda, want["ssm"] * cuda):
            fail(f"{label}: {n} kernel-1 and {n_ssd} SSD launches in one "
                 f"{dtype} step of {want} layers")
        if not (err[metric] <= tol
                and abs(loss_k - loss_p) <= tol * abs(loss_p)):
            fail(f"{label}: the {dtype} step's gradients are {err} (loss "
                 f"{loss_k} vs {loss_p}) from the plain oracle's, "
                 f"tolerance {metric} {tol:g}")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return checks


def train_bound(n_params: int, tokens: int):
    """(FLOP a step, ms at the f32 CUDA-core rate) of a training step: 6
    x parameters x tokens (forward 2, backward 4); the products are f32
    (`qdot` promotes the bf16 activations to the f32 weights)."""
    flops = 6 * n_params * tokens
    return flops, flops / PEAK_FLOPS["float32"] * 1e3


def trees_equal(torch, a, b) -> bool:
    """Two parameter trees hold the same keys and bits, leaf by leaf."""
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    if len(tree_leaves(a)) != len(tree_leaves(b)):
        return False
    try:
        same = tree_leaves(tree_map(
            lambda x, y: x.dtype == y.dtype and x.shape == y.shape
            and bool(torch.equal(x, y)), a, b))
    except (KeyError, IndexError):
        return False
    return all(same)


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def training_phase(torch, M, attn, fa, cfg, device="cuda",
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
                   label="phase P", seed=40):
    """Phases P and R: `cfg` (qwen2-0.5b, mamba2-130m at full width)
    fine-tuned on one domain with `train_model` (AdamW, `batch` x `seq`),
    every attention forward on kernel 1 and every SSD scan on the SSD
    kernel, each with its tensor-op
    gradient. The first step's loss and gradients are held against the
    plain oracle's at f32 and at bf16 activations (`grad_checks`); the
    loss must fall; each forward must launch kernel 1 once an attention
    layer, on its many-row form, and the SSD kernel once an SSM layer, on
    its chunk path; the trained weights must read back from a checkpoint
    bit for bit. (On the CPU, for a rehearsal at tiny widths, nothing
    launches and no device memory or card is read.)"""
    import tempfile

    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    from repro_torch.data.synthetic import SyntheticCorpus, token_batches
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.launch.train import train_model
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    params = M.init_params(cfg, seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the first batch `train_model` draws from a corpus seeded alike
    first = next(token_batches(SyntheticCorpus(TRAIN_VOCAB, seed=0),
                               TRAIN_DOMAIN, batch, seq, 1))
    tokens = torch.as_tensor(first, device=dev)
    checks = grad_checks(torch, M, attn, fa, cfg, params, tokens, label)

    layers = layer_counts(cfg)
    fa.LAUNCHES = fa.LAUNCHES_MANY_ROWS = sd.LAUNCHES = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _sync(torch, dev)
    t0 = time.perf_counter()
    with ssd_paths(sd) as ssd_by_path:
        trained, losses = train_model(
            cfg, SyntheticCorpus(TRAIN_VOCAB, seed=0), TRAIN_DOMAIN, steps,
            batch=batch, seq=seq, lr=TRAIN_LR, params=params,
            verbose=False, device=dev)
        _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches, many = fa.LAUNCHES, fa.LAUNCHES_MANY_ROWS
    ssd_launches = sd.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    del params
    step_tokens = batch * (seq + 1)
    flops, bound_ms = train_bound(n_params, step_tokens)
    step_ms = wall / steps * 1e3
    if cuda and (launches < layers["attn"] * steps or many != launches):
        fail(f"{label}: {launches} kernel-1 launches ({many} many-row) in "
             f"{steps} steps of {layers['attn']} attention layers")
    if cuda and (ssd_launches < layers["ssm"] * steps
                 or ssd_by_path["chunk"] != ssd_launches):
        fail(f"{label}: {ssd_launches} SSD launches ({ssd_by_path}) in "
             f"{steps} steps of {layers['ssm']} SSM layers")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall: {losses}")
    first_loss = checks[cfg.dtype]["loss_kernel"]
    if abs(losses[0] - first_loss) > 1e-4 * losses[0]:
        fail(f"{label}: train_model's first loss {losses[0]} is not the "
             f"checked step's {first_loss}")

    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        path = str(Path(d) / f"{cfg.name}.msgpack")
        save_checkpoint(path, trained, cfg, meta={"steps": steps})
        ckpt_gb = Path(path).stat().st_size / 1e9
        back, meta = load_checkpoint(path, cfg, dev)
    same = trees_equal(torch, back, trained) and meta == {"steps": steps}
    ckpt_s = time.perf_counter() - t0
    del trained
    del back
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not same:
        fail(f"{label}: the checkpoint did not read back bit for bit")
    smi = nvidia_smi_line() if cuda else "cpu"
    print(f"{label} ({smi}): {cfg.name}, {n_params} parameters, {steps} "
          f"AdamW steps (lr {TRAIN_LR:g}) of {batch} x {seq + 1} tokens on "
          f"domain {TRAIN_DOMAIN!r}: {step_ms:.1f} ms a step "
          f"({step_tokens * steps / wall:.0f} tokens/s; bound "
          f"{bound_ms:.1f} ms, {flops / 1e12:.2f} TFLOP a step at the f32 "
          f"rate), peak {peak_gb} GB, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} ({', '.join(f'{v:.4f}' for v in losses)}); "
          f"kernel 1 launched {launches} times ({many} many-row, "
          f"{launches / steps:.0f} a step), the SSD kernel {ssd_launches} "
          f"times ({ssd_by_path}, {ssd_launches / steps:.0f} a step); "
          f"checkpoint of {ckpt_gb:.2f} GB written and read back bit for "
          f"bit in {ckpt_s:.1f} s", flush=True)
    summary = dict(
        phase=label, model=cfg.name, n_params=n_params,
        steps=steps, batch=batch, seq=seq, lr=TRAIN_LR,
        domain=TRAIN_DOMAIN, corpus_vocab=TRAIN_VOCAB, step_ms=step_ms,
        tokens_per_s=step_tokens * steps / wall, bound_ms=bound_ms,
        flops_per_step=flops, peak_mem_gb=peak_gb, losses=losses,
        grad_check=checks, kernel_launches=launches,
        many_row_launches=many, ssd_launches=ssd_launches,
        ssd_launches_by_path=ssd_by_path, checkpoint_gb=ckpt_gb,
        checkpoint_s=ckpt_s, device=smi,
        phase_s=time.perf_counter() - t_phase)
    return summary


def hybrid_grad_phase(torch, M, attn, fa, cfg, device="cuda",
                      batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=41):
    """Phase R-hybrid: one training step of `cfg` (an SSM layer and an
    attention layer) at f32 and bf16 activations, its SSD scan on the SSD
    kernel and its attention on kernel 1, each with its gradient, held
    against the plain oracle (`grad_checks`): the two gradients composed
    in one loss."""
    from repro_torch.data.synthetic import SyntheticCorpus, token_batches
    from repro_torch.optim.optimizers import tree_leaves

    t_phase = time.perf_counter()
    dev = torch.device(device)
    params = M.init_params(cfg, seed=seed, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    first = next(token_batches(SyntheticCorpus(TRAIN_VOCAB, seed=0),
                               TRAIN_DOMAIN, batch, seq, 1))
    checks = grad_checks(torch, M, attn, fa, cfg, params,
                         torch.as_tensor(first, device=dev),
                         "phase R-hybrid")
    del params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(phase="phase R-hybrid", model=cfg.name, n_params=n_params,
                layers=layer_counts(cfg), batch=batch, seq=seq,
                grad_check=checks, phase_s=time.perf_counter() - t_phase)


def sharding_phase(torch, M, cfg):
    """Phase S: the sharding rules on the card. A world-size-1 NCCL
    group from an in-memory store (no network), a (1, 1) ("data",
    "model") DeviceMesh on cuda, `cfg`'s parameters placed by the serve
    rules with `distribute`: each local tensor must equal its original bit
    for bit, and the local shards' bytes the dry-run's reckoning of the
    same specs. The group is torn down before the phase returns."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cuda", torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        params = M.init_params(cfg, seed=50, device="cuda")
        specs = sh.param_specs(cfg, mesh, mode="serve")
        placed = sh.distribute(params, specs, mesh)
        same = all(tree_leaves(tree_map(
            lambda p, d: d.to_local().dtype == p.dtype
            and torch.equal(d.to_local(), p), params, placed)))
        local = sum(d.to_local().numel() * d.to_local().element_size()
                    for d in tree_leaves(placed))
        held = dryrun.tree_bytes(sh.param_shapes(cfg), specs, mesh,
                                 lambda t: t.dtype)
        bf16 = dryrun.tree_bytes(sh.param_shapes(cfg), specs, mesh,
                                 lambda t: torch.bfloat16)
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)
        torch.cuda.synchronize()
        n_leaves = len(tree_leaves(placed))
        del params, placed
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase S: {cfg.name}'s {n_leaves} parameter leaves distributed "
          f"by the serve rules on a (1, 1) DeviceMesh over a world-size-1 "
          f"NCCL group: local shards equal the originals bit for bit: "
          f"{same}; {local} bytes a device held (f32), dry-run reckoning "
          f"{held} (f32 as held; {bf16} at bf16 as it lowers them); "
          f"all-reduce {float(one.item())}; {time.perf_counter() - t0:.1f}"
          f" s", flush=True)
    if not same or local != held or float(one.item()) != 1.0:
        fail(f"phase S: local shards equal {same}, {local} bytes held "
             f"against {held} reckoned")
    return dict(phase="phase S", model=cfg.name, leaves=n_leaves,
                bitwise=same, local_bytes=local, dryrun_bytes=held,
                dryrun_bf16_bytes=bf16,
                phase_s=time.perf_counter() - t0)


def trained_serving_phase(torch, M, run, references, kernel_err, steps):
    """Phase Q: the reference's serving recipe (`launch.serve`: the tiny
    target trained 2 x `steps` on the domain mixture, one tiny drafter a
    domain for `steps`) trained on the card, written to checkpoints and
    read back (bit for bit), drafter 0 loaded int8-quantized (its products
    on kernel 3); 8 requests served with `cosine` under the tie rule, and
    again at the same configs' untrained weights (the seeds
    `train_model` starts from). A request's committed tokens per
    iteration, over all requests, must exceed 1 and the untrained twin's,
    and so must the engine's mean acceptance (committed tokens per engine
    iteration of the whole cohort) exceed the twin's."""
    import tempfile

    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    from repro_torch.configs.drafters import int8_variant
    from repro_torch.data.synthetic import SyntheticCorpus
    from repro_torch.launch.serve import VOCAB, build_models
    from repro_torch.models.quantize import quantize_params

    t_phase = time.perf_counter()
    corpus = SyntheticCorpus(VOCAB, seed=0, sharpness=120.0, support=5)
    t0 = time.perf_counter()
    (tcfg, tparams), drafters = build_models(None, corpus, steps,
                                             device="cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        save_checkpoint(str(Path(d) / "target.msgpack"), tparams, tcfg)
        for dcfg, dp, dom in drafters:
            save_checkpoint(str(Path(d) / f"drafter_{dom}.msgpack"), dp,
                            dcfg)
        (_, tp2), drafters2 = build_models(d, corpus, steps, device="cuda")
        dcfg, _, dom0 = drafters2[0]
        q8, _ = load_checkpoint(str(Path(d) / f"drafter_{dom0}.msgpack"),
                                dcfg, "cuda", quantize="int8")
    same = trees_equal(torch, tp2, tparams) and all(
        trees_equal(torch, a[1], b[1]) for a, b in zip(drafters, drafters2))
    if not same:
        fail("phase Q: the checkpoints did not read back bit for bit")
    drafters2[0] = (int8_variant(dcfg), q8, dom0)
    pairs = corpus.prompts(8, 16, seed=13)
    prompts = [list(map(int, p)) for p, _ in pairs]
    domains = [d for _, d in pairs]
    sum_q, _ = run("phase Q", target=(tcfg, tp2), drafters=drafters2,
                   prompts=prompts, refs=references(tcfg, tp2, prompts),
                   err=kernel_err, int8=True, domains=domains)
    # the untrained twin: the weights `train_model` starts from (drafter
    # 0 quantized the same way)
    uparams = M.init_params(tcfg, seed=0, device="cuda")
    udrafters = [(c, M.init_params(c, seed=i + 1, device="cuda"), dom)
                 for i, (c, _, dom) in enumerate(drafters2)]
    udrafters[0] = (udrafters[0][0], quantize_params(udrafters[0][1]),
                    dom0)
    sum_u, _ = run("phase Q-untrained", target=(tcfg, uparams),
                   drafters=udrafters, prompts=prompts,
                   refs=references(tcfg, uparams, prompts), err=kernel_err,
                   int8=True, domains=domains)
    del tparams, tp2, drafters, drafters2, uparams, udrafters
    gc.collect()
    torch.cuda.empty_cache()
    acc, acc_u = sum_q["request_acceptance"], sum_u["request_acceptance"]
    eng, eng_u = sum_q["mean_acceptance"], sum_u["mean_acceptance"]
    print(f"phase Q: trained {steps} / {2 * steps} steps in {train_s:.1f} s"
          f"; tokens a request iteration {acc:.3f} trained, {acc_u:.3f} "
          f"untrained (by domain trained {sum_q['acceptance_by_domain']}, "
          f"untrained {sum_u['acceptance_by_domain']}); engine mean "
          f"acceptance {eng:.3f} trained, {eng_u:.3f} untrained; int8 GEMV "
          f"launches {sum_q['kernel_launches']['int8_gemv_call']} (drafter "
          f"{dom0!r}); phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if not (acc > 1.0 and acc > acc_u and eng > eng_u):
        fail(f"phase Q: acceptance {acc:.3f} a request iteration ({eng:.3f} "
             f"an engine iteration) of the trained drafters is not above 1 "
             f"and the untrained twin's {acc_u:.3f} ({eng_u:.3f})")
    return dict(train_s=train_s, steps=steps, request_acceptance=acc,
                untrained_request_acceptance=acc_u, mean_acceptance=eng,
                untrained_mean_acceptance=eng_u,
                acceptance_by_domain=sum_q["acceptance_by_domain"],
                untrained_acceptance_by_domain=sum_u[
                    "acceptance_by_domain"],
                phase_s=time.perf_counter() - t_phase)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import (DEEPSEEK_V3_671B, H2O_DANUBE3_4B,
                                         JAMBA_V0_1_52B, LLAMA_3_2_VISION_11B,
                                         MAMBA2_130M, QWEN1_5_4B, QWEN2_0_5B,
                                         QWEN2_MOE_A2_7B, WHISPER_SMALL)
        from repro_torch.configs.drafters import LLAMA_68M, int8_variant
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.int8_gemv import ops as ig
        from repro_torch.kernels.paged_attention import ops as pa
        from repro_torch.kernels.ssd_scan import ops as sd
        from repro_torch.models import attention as attn
        from repro_torch.models import model as M
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import quantize
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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
    progress(f"kernel build+load ({len(libraries)} nvcc in parallel) "
             f"{time.perf_counter() - t0:.1f} s")
    for lib in libraries:
        # ptxas report per instantiation: registers, shared memory, spills
        for line in (lib.build_log or "").splitlines():
            if "Used" in line or "spill" in line:
                print(f"{lib.name}: {line.strip()}", flush=True)
    int8kv_compiled = {}
    d120_compiled = {}
    many_compiled = {}
    for lib in libraries[:2]:
        if lib.build_log is None:   # built by an earlier run: no report
            print(f"{lib.name}: built before this run, registers not "
                  "reported", flush=True)
            continue
        for fn, st in ptxas_report(lib.build_log).items():
            if "int8_kernel" in fn:
                int8kv_compiled[f"{lib.name}:{fn}"] = st
                print(f"{lib.name}: int8 K/V form {fn}: {st['registers']} "
                      f"registers, spill stores {st['spill_stores']} B, "
                      f"spill loads {st['spill_loads']} B", flush=True)
        if not any(k.startswith(f"{lib.name}:") for k in int8kv_compiled):
            fail(f"{lib.name}: the build log names no int8_kernel "
                 "instantiation")
        for fn, st in ptxas_report(lib.build_log).items():
            if "rows_kernel" in fn:
                many_compiled[f"{lib.name}:{fn}"] = st
                print(f"{lib.name}: many-row form {fn}: {st['registers']} "
                      f"registers, spill stores {st['spill_stores']} B, "
                      f"spill loads {st['spill_loads']} B", flush=True)
        if not any(k.startswith(f"{lib.name}:") for k in many_compiled):
            fail(f"{lib.name}: the build log names no rows_kernel "
                 "instantiation")
        for fn, st in ptxas_report(lib.build_log).items():
            if "partial_kernelILi120ELi120E" in fn:
                d120_compiled[f"{lib.name}:{fn}"] = st
                print(f"{lib.name}: (120, 120) form {fn}: "
                      f"{st['registers']} registers, spill stores "
                      f"{st['spill_stores']} B, spill loads "
                      f"{st['spill_loads']} B", flush=True)

    fa_rows, fa_host = kernel_phase(torch, fa)
    pa_rows = paged_kernel_phase(torch, fa, pa)
    fa8_rows, pa8_rows, kv_write_host = int8kv_kernel_phase(torch, fa, pa,
                                                            attn)
    fam_rows, pam_rows, mla_smem = mla_kernel_phase(torch, fa, pa)
    fa120_rows, pa120_rows = d120_kernel_phase(torch, fa, pa)
    nc_rows = noncausal_kernel_phase(torch, fa)
    sd_rows, sd_in_place, sd_crossover, sd_host = ssd_kernel_phase(torch, sd)
    progress(f"kernel phases done {time.perf_counter() - t_start:.1f} s into "
             "the script")
    many_rows = [r for r in fa_rows + fa120_rows + nc_rows
                 if r["form"] == "many-row"]
    paged_many_rows = [r for r in pa_rows + pa120_rows
                       if r["form"] == "many-row"]
    print(f"many-row form: {len(many_rows)} kernel-1 and "
          f"{len(paged_many_rows)} paged shapes of the kernel phases "
          f"(R_MMA {fa.R_MMA})", flush=True)
    kernel_err = max(r["max_abs_err"]
                     for r in fa_rows + pa_rows + fa8_rows + pa8_rows)
    mla_kernel_err = max(r["max_abs_err"] for r in fam_rows + pam_rows)
    new_kernel_err = max(r["max_abs_err"]
                         for r in fa120_rows + pa120_rows + nc_rows)
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
        progress(f"{label} done {time.perf_counter() - t_start:.1f} s into "
                 "the script")
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
    # phase B: perfect drafters sharing the target's weights (the
    # target's first B_LAYERS layers, with their own references)
    bcfg, bparams = first_layers(QWEN1_5_4B, tparams, B_LAYERS)
    sum_b, _ = run("phase B", target=(bcfg, bparams),
                   drafters=[(bcfg, bparams, f"p{i}") for i in range(2)],
                   prompts=prompts, refs=references(bcfg, bparams, prompts),
                   err=kernel_err)
    del bparams
    if not sum_b["mean_acceptance"] > 1.0:
        fail(f"phase B mean acceptance {sum_b['mean_acceptance']:.3f} <= 1")
    # phase C: phase A on the paged KV pool
    sum_c, streams_c = run("phase C", drafters=full, paged=True,
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
    sum_d, streams_d = run("phase D", drafters=mixed, int8=True,
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
    sum_h, streams_h = run("phase H", drafters=full, backend="async",
                           **dense)
    sum_hs, _ = run("phase H-serial", drafters=full, backend="async",
                    overlap=False, **dense)
    wallclock = compare_wallclock(sum_h, sum_hs, sum_a)
    if sum_h["overlap_frac"] < 0.5:
        fail(f"phase H: overlap_frac {sum_h['overlap_frac']:.3f} < 0.5 "
             "(drafting did not overlap verification: serialized)")
    t0 = time.perf_counter()
    wallclock["profile"] = profile_async_window(torch, target, full, prompts,
                                                warm=2, steps=2)
    progress(f"phase H profiler window {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # phases T-ar .. H-int8: the paper's baselines, the ablation switches,
    # and the wall-clock backend with the pipelined baseline, the paged
    # pool and int8 drafters, all on phase A's weights and references
    baselines = baseline_phases(torch, run, dense, full, mixed, dict(
        A=streams_a, C=streams_c, D=streams_d, H=streams_h))
    wallclock["phase H-pipeinfer"] = compare_wallclock(
        baselines["phase H-pipeinfer"], None, baselines["phase T-pipeinfer"])
    for label, twin in (("phase H-paged", sum_c), ("phase H-int8", sum_d)):
        wallclock[label] = compare_wallclock(baselines[label], None, twin)
    # phases K and K-paged: phase A's models cut to K_LAYERS with int8 KV
    # caches for the target and both drafters, resident and paged: every
    # cache read on the kernels' int8 form
    kcfg, kparams = first_layers(QWEN1_5_4B, tparams, K_LAYERS[0])
    kcfg = kcfg.with_overrides(kv_dtype="int8")
    kdraft = [first_layers(QWEN2_0_5B, dparams[i], K_LAYERS[1])
              for i in range(2)]
    kv8 = dict(target=(kcfg, kparams), prompts=prompts,
               refs=references(kcfg, kparams, prompts), err=kernel_err,
               drafters=[(c.with_overrides(kv_dtype="int8"), p_, f"d{i}")
                         for i, (c, p_) in enumerate(kdraft)],
               int8_kv=True)
    sum_k, streams_k = run("phase K", **kv8)
    _, streams_kp = run("phase K-paged", paged=True,
                        observe=lambda e: observe_pools(e, "phase K-paged"),
                        **kv8)
    same = sum(a == b for a, b in zip(streams_k, streams_kp))
    paged8_exact = all(r["max_abs_diff_vs_kernel1"] == 0.0 for r in pa8_rows)
    print(f"phase K-paged: {same}/{len(prompts)} committed streams equal "
          f"phase K's token for token; peak device GB: A "
          f"{sum_a['peak_mem_gb']:.2f}, K {sum_k['peak_mem_gb']:.2f}",
          flush=True)
    if not paged8_exact or same != len(prompts):
        fail("phase K-paged: the paged int8 pool committed other tokens "
             "than the resident int8 pool")
    # where K's device time goes: the int8 K/V forms' share of it
    t0 = time.perf_counter()
    sum_k["profile"] = profile_int8kv_window(torch, kv8["target"],
                                             kv8["drafters"], prompts)
    progress(f"phase K profiler window {time.perf_counter() - t0:.1f} s")
    del kv8, kparams, kdraft
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
    progress(f"int8 kernel phase done {time.perf_counter() - t_start:.1f} s "
             "into the script")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase E: mamba2-130m target and drafters (SSD layers only), cut
    # to E_LAYERS
    mcfg = MAMBA2_130M.with_overrides(n_layers=E_LAYERS)
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

    # ---- phase J: qwen2-moe-a2.7b at full width (60 routed experts top-4
    # and a shared expert in every layer), with two qwen2-0.5b drafters,
    # both cut to J_LAYERS, resident pool
    jcfg = QWEN2_MOE_A2_7B.with_overrides(n_layers=J_LAYERS[0])
    jdcfg = QWEN2_0_5B.with_overrides(n_layers=J_LAYERS[1])
    jprompts = make_prompts(jcfg)
    t0 = time.perf_counter()
    jparams = M.init_params(jcfg, seed=30, device="cuda")
    jdraft = [M.init_params(jdcfg, seed=31 + i, device="cuda")
              for i in range(2)]
    torch.cuda.synchronize()
    print(f"qwen2-moe-a2.7b weights {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB with the drafters",
          flush=True)
    jrefs = references(jcfg, jparams, jprompts)
    sum_j, _ = run("phase J", target=(jcfg, jparams),
                   drafters=[(jdcfg, jdraft[i], f"d{i}")
                             for i in range(2)],
                   prompts=jprompts, refs=jrefs, err=kernel_err, moe=True)
    # phase J-f32: phase J with f32 activations (the same weights): at
    # bf16 the routing flips between batched and one-token forwards (see
    # the router counts above), which widens the tie rule's tolerance;
    # at f32 the paths agree far more closely and the rule is tight
    jcfg32 = jcfg.with_overrides(dtype="float32")
    sum_j32, _ = run("phase J-f32", target=(jcfg32, jparams),
                     drafters=[(jdcfg, jdraft[i], f"d{i}")
                               for i in range(2)],
                     prompts=jprompts,
                     refs=references(jcfg32, jparams, jprompts),
                     err=kernel_err, moe=True)
    n_moe = moe_layers(jcfg)
    for label, sm in (("phase J", sum_j), ("phase J-f32", sum_j32)):
        if sm["moe_layer_calls"] != n_moe * sm["moe_forwards"]:
            fail(f"{label}: {sm['moe_layer_calls']} MoE layer calls for "
                 f"{sm['moe_forwards']} target forwards of {n_moe}")
    attn_layers = sum_j["attention_layer_calls"]
    print(f"phase J: kernel 1 read each attention layer's cache once a "
          f"forward: {attn_layers} cache reads = attention layers x "
          f"forwards over {sum_j['forwards']} forwards (+ "
          f"{sum_j['resident_attention_calls'].get('segment', 0)} segment "
          f"passes) = {sum_j['kernel_launches']['flash_attention_partial']}"
          " launches; router top-k sets differing between the two paths: "
          f"{sum(r['router_flips'] for r in jrefs)} of "
          f"{sum(r['router_pairs'] for r in jrefs)} pairs", flush=True)
    # host cost of one MoE layer at decode, verification and prefill rows
    # (wall time: the group-size read waits for the router's result)
    moe_host = {}
    lp = jparams["layers"][0]["ffn"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    for rows in (4, 40, 512):
        x = torch.randn((rows, jcfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        moe_host[rows] = _host_us(torch, lambda: moe_mod.apply_moe(
            lp, x, jcfg, jcfg.moe), n=20)
    print(f"phase J: wall us per MoE layer call by rows {moe_host}",
          flush=True)
    sum_j["moe_layer_wall_us_by_rows"] = moe_host
    sum_j["router_flips"] = [dict(prompt_len=len(p), flips=r["router_flips"],
                                  pairs=r["router_pairs"])
                             for p, r in zip(jprompts, jrefs)]
    del jparams, jdraft, lp
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phases L, L-paged and L-f32: deepseek-v3-671b at full width
    # (cut to 4 layers), J's weights released first
    deepseek_phases(torch, M, attn, DEEPSEEK_V3_671B, run, references,
                    make_prompts, max(kernel_err, mla_kernel_err),
                    all(r["max_abs_diff_vs_kernel1"] == 0.0
                        for r in pam_rows), sum_a["wall_tokens_per_s"])

    # ---- phases M, M-paged, N and O: h2o-danube3-4b (head width 120),
    # llama-3.2-vision-11b and whisper-small, L's weights released first
    arch = remaining_arch_phases(
        torch, M, fa, run, references, make_prompts,
        max(kernel_err, new_kernel_err),
        all(r["max_abs_diff_vs_kernel1"] == 0.0 for r in pa120_rows),
        (H2O_DANUBE3_4B, LLAMA_3_2_VISION_11B, WHISPER_SMALL), LLAMA_68M)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase P: a qwen2-0.5b drafter fine-tuned at full width, every
    # attention forward on kernel 1 with a gradient through it; phase Q:
    # the reference's tiny deployment trained on the card, checkpointed
    # and served
    sum_p = training_phase(torch, M, attn, fa, QWEN2_0_5B)
    progress(f"phase P done {time.perf_counter() - t_start:.1f} s into the "
             f"script ({sum_p['phase_s']:.1f} s)")
    launches["flash_attention_partial"] += sum_p["kernel_launches"]
    launches["flash_attention_partial_many_rows"] += \
        sum_p["many_row_launches"]
    sum_q = trained_serving_phase(torch, M, run, references, kernel_err,
                                  SERVE_TRAIN_STEPS)
    # ---- phase R: mamba2-130m at full width and depth fine-tuned, every
    # SSD scan on the SSD kernel with its tensor-op gradient; phase
    # R-hybrid: jamba's widths cut to an SSM and an attention layer (dense
    # FFNs), the two gradients in one loss
    sum_r = training_phase(torch, M, attn, fa, MAMBA2_130M, label="phase R",
                           seed=42)
    progress(f"phase R done {time.perf_counter() - t_start:.1f} s into the "
             f"script ({sum_r['phase_s']:.1f} s)")
    launches["ssd_scan_pallas"] += sum_r["ssd_launches"]
    rcfg = JAMBA_V0_1_52B.with_overrides(n_layers=2, moe=None,
                                         hybrid_attn_offset=1)
    if layer_counts(rcfg) != {"attn": 1, "ssm": 1}:
        fail(f"phase R-hybrid: the cut plan is {layer_counts(rcfg)}")
    sum_rh = hybrid_grad_phase(torch, M, attn, fa, rcfg)
    progress(f"phase R-hybrid done {time.perf_counter() - t_start:.1f} s "
             f"into the script ({sum_rh['phase_s']:.1f} s)")
    # ---- phase S: the sharding rules on a DeviceMesh of the one card
    sum_s = sharding_phase(torch, M, QWEN2_0_5B)
    print(json.dumps({"training": dict(phase_P=sum_p, phase_Q=sum_q,
                                       phase_R=sum_r,
                                       phase_R_hybrid=sum_rh),
                      "sharding": dict(phase_S=sum_s)}), flush=True)

    print(json.dumps({"serving": summaries}), flush=True)
    print(json.dumps({"wallclock": wallclock}), flush=True)
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        fail(f"kernels never launched by the serving phases: {missing}")

    def by_phase(name):
        """The serving phases that launched kernel row `name`, and how
        often."""
        return {sm["phase"]: sm["kernel_launches"][name] for sm in summaries
                if sm["kernel_launches"][name]}

    kernels = []
    trained = {"phase P": sum_p["kernel_launches"],
               "phase R-hybrid (gradient checks)": sum(
                   c["launches"] for c in sum_rh["grad_check"].values())}
    extra = {"flash_attention_partial": dict(host=fa_host,
                                             training_launches=trained),
             "int8_gemv_call": dict(host=ig_host, crossover=crossover,
                                    launches_by_rows=int8_launch_classes),
             "ssd_scan_pallas": dict(host=sd_host, crossover=sd_crossover,
                                     training_launches={
                                         "phase R": sum_r["ssd_launches"],
                                         "phase R-hybrid (gradient checks)":
                                         sum(c["ssd_launches"] for c in
                                             sum_rh["grad_check"].values())},
                                     in_place=sd_in_place,
                                     rec_max_l={"N128": sd.rec_max_l(128),
                                                "N16": sd.rec_max_l(16)},
                                     launches_by_form=ssd_forms),
             "flash_attention_partial_int8_kv": dict(
                 yardstick_ms=sum(r["yardstick_ms"] for r in fa8_rows),
                 host_kv_write_us=kv_write_host,
                 compiled=int8kv_compiled, phase_k_profile=sum_k["profile"],
                 d120=_d120_int8_sums(fa8_rows)),
             "paged_flash_decode_int8_kv": dict(
                 yardstick_ms=sum(r["yardstick_ms"] for r in pa8_rows),
                 d120=_d120_int8_sums(pa8_rows)),
             "flash_attention_partial_mla": dict(
                 smem=mla_smem, sdpa_backends=sorted(
                     {r["sdpa_backend"] for r in fam_rows}),
                 **_latent_sums(fam_rows)),
             "paged_flash_decode_mla": dict(
                 sdpa_backends=sorted({r["sdpa_backend"] for r in pam_rows}),
                 **_latent_sums(pam_rows)),
             "flash_attention_partial_d120": dict(
                 launches_by_phase=by_phase("flash_attention_partial_d120"),
                 compiled=d120_compiled),
             "paged_flash_decode_d120": dict(
                 launches_by_phase=by_phase("paged_flash_decode_d120")),
             "flash_attention_partial_many_rows": dict(
                 launches_by_phase=by_phase(
                     "flash_attention_partial_many_rows"),
                 training_launches={"phase P": sum_p["many_row_launches"]},
                 r_mma=fa.R_MMA, heads=fa.MMA_HEADS,
                 compiled=many_compiled),
             "paged_flash_decode_many_rows": dict(
                 launches_by_phase=by_phase("paged_flash_decode_many_rows")),
             "flash_attention_partial_noncausal": dict(
                 launches_by_phase=by_phase(
                     "flash_attention_partial_noncausal"),
                 image_check_launches={
                     label: arch[label]["image_check"][
                         "noncausal_launches_prefill"]
                     + arch[label]["image_check"]["noncausal_launches_decode"]
                     for label in ("phase N", "phase O")})}
    # why a kernel has no library call (library_ms null)
    no_library = {
        "ssd_scan_pallas": "no PyTorch call computes the scan",
        "flash_attention_partial_int8_kv": INT8KV_NO_LIBRARY,
        "paged_flash_decode_int8_kv": INT8KV_NO_LIBRARY,
        "flash_attention_partial_mla": MLA_NO_LIBRARY,
        "paged_flash_decode_mla": MLA_NO_LIBRARY}
    for name, rows in (("flash_attention_partial", fa_rows),
                       ("paged_flash_decode", pa_rows),
                       ("int8_gemv_call", ig_rows),
                       ("ssd_scan_pallas", sd_rows),
                       ("flash_attention_partial_int8_kv", fa8_rows),
                       ("paged_flash_decode_int8_kv", pa8_rows),
                       ("flash_attention_partial_mla", fam_rows),
                       ("paged_flash_decode_mla", pam_rows),
                       ("flash_attention_partial_d120", fa120_rows),
                       ("paged_flash_decode_d120", pa120_rows),
                       ("flash_attention_partial_noncausal", nc_rows),
                       ("flash_attention_partial_many_rows", many_rows),
                       ("paged_flash_decode_many_rows", paged_many_rows)):
        source, replaces = KERNEL_SOURCES[name]
        tot = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms")}
        lib = [r["library_ms"] for r in rows]
        t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        # (the SSD and latent rows count their operations at the rate of
        # the unit they run on: `ops_ms`)
        t_ops = sum(r.get("ops_ms", r["flops"] / PEAK_FLOPS[r["dtype"]] * 1e3)
                    for r in rows)
        # (GQA rows: the bound at the tensor-core rate, beside the one at
        # the f32 CUDA-core rate)
        cc = ({} if not all("cuda_core_ops_ms" in r for r in rows) else
              dict(bound_cuda_core_ms=max(t_bytes, sum(
                  r["cuda_core_ops_ms"] for r in rows))))
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", **cc,
            library_ms=None if None in lib else sum(lib),
            **extra.get(name, {}),
            note="times are sums over one call of each shape below"
                 + (f"; {no_library[name]}" if None in lib else ""),
            shapes=rows))
    print(json.dumps({"kernels": kernels}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    progress(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
