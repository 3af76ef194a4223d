"""`chip_smoke.py`'s accounting on the CPU: the latent form's work and
bound, the profiler attribution of device time to a host range, the
image check of phases N and O and phase P's gradient check rehearsed at
tiny widths (the script itself needs the card)."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


def test_latent_work_and_bound():
    """V read out of K's tile moves Dk values a held key, not Dk + Dv; the
    operations are the same; the f32 latent bound counts them at the
    3xTF32 rate of the tensor cores, the bf16 one at the bf16 rate."""
    B, T, H, G, Dk, Dv, S = 1, 1, 1, 2, 6, 4, 3
    q = torch.zeros(B, T, H, G, Dk)
    k = torch.zeros(B, S, H, Dk)
    v = torch.zeros(B, S, H, Dv)
    q_pos = torch.tensor([[1]], dtype=torch.int32)
    k_pos = torch.tensor([[0, 1, -1]], dtype=torch.int32)
    nb, fl = smoke._work(torch, q, k, v, q_pos, k_pos, None, None, True)
    nb_a, fl_a = smoke._work(torch, q, k, k[..., :Dv], q_pos, k_pos, None,
                             None, True, v_in_k=True)
    assert fl == fl_a == 2 * (2 * H * G) * (Dk + Dv)   # 2 live keys
    assert nb - nb_a == 2 * H * Dv * 4
    assert smoke.LATENT_FLOPS["float32"] == smoke.TF32X3_FLOPS
    assert smoke.LATENT_FLOPS["bfloat16"] == smoke.PEAK_FLOPS["bfloat16"]
    flops = 1e12
    bound, by = smoke._bound(0, flops, "float32",
                             smoke.LATENT_FLOPS["float32"])
    assert by == "operations" and bound == flops / smoke.TF32X3_FLOPS * 1e3
    assert smoke._bound(0, flops, "float32")[0] == flops / 67e12 * 1e3


@pytest.mark.parametrize("arch", ["cross", "encdec"])
def test_image_check_rehearsed_on_the_cpu(arch):
    """Phases N and O's image check at tiny widths in f32: the decodes
    that read the cross rows the prefills wrote give the full forward's
    logits (gap far under 1e-4) and its greedy tokens."""
    from repro_torch.config import ModelConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import model as M
    base = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                       vocab=40, tie_embeddings=True, dtype="float32")
    cfg = (base.with_overrides(cross_attn_period=2, n_frontend_tokens=7)
           if arch == "cross" else
           base.with_overrides(n_kv_heads=2, norm_type="layer",
                               mlp_type="gelu", pos_embed="learned",
                               max_position=64, encoder_layers=2,
                               encoder_seq=9, n_frontend_tokens=9))
    params = M.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8]]
    fe = 0.1 * torch.randn((2, M.cross_len(cfg), 32), generator=gen)
    out = smoke.image_check(torch, M, fa, cfg, params, prompts, fe, "t",
                            tie_tol=1e-4, device="cpu", max_len=32)
    assert out["steps"] == smoke.IMAGE_STEPS
    assert out["max_logit_gap_vs_full"] < 1e-4 and not out["near_tie_tokens"]


@pytest.mark.parametrize("arch", ["dense", "mla", "encdec"])
def test_grad_check_rehearsed_on_the_cpu(arch, one_torch_thread):
    """Phase P's gradient check at tiny widths: the differentiable form of
    self-contained attention against autograd through the plain version
    (the oracle patched in and restored), one attention forward a layer
    (none from the oracle; the CPU has no launches to count), and the
    step's bound and the tree comparison it reports."""
    from repro_torch.config import MLAConfig, ModelConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    base = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                       vocab=40, tie_embeddings=True, dtype="float32")
    cfg = {"dense": base,
           "mla": base.with_overrides(
               attention="mla", n_kv_heads=4, mtp=True, mla=MLAConfig(
                   q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
                   qk_rope_head_dim=8, v_head_dim=8)),
           "encdec": base.with_overrides(
               n_kv_heads=4, norm_type="layer", mlp_type="gelu",
               pos_embed="learned", max_position=64, encoder_layers=1,
               encoder_seq=6, n_frontend_tokens=6)}[arch]
    params = M.init_params(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    fe = (0.1 * torch.randn((2, 6, 32), generator=gen)
          if arch == "encdec" else None)
    calls = []
    orig = fa.attention

    def counted(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    fa.attention = counted
    try:
        loss_k, loss_p, err, _, n_ssd = smoke.grad_check(
            torch, M, attn, fa, cfg, params, tokens, fe)
    finally:
        fa.attention = orig
    from repro_torch.optim.optimizers import tree_leaves
    assert attn.blocked_attention.__module__ == attn.__name__
    # self-attention a layer, a cross read a decoder layer of the
    # encoder-decoder, the MTP layer, the encoder's layers
    reads = cfg.n_layers * (1 + cfg.is_encdec) + cfg.mtp + \
        cfg.encoder_layers
    assert len(calls) == reads and n_ssd == 0
    assert loss_k == loss_p and err["max"] < 1e-5 and err["l2"] < 1e-5
    assert not any(t.requires_grad for t in tree_leaves(params))
    assert smoke.trees_equal(torch, params, params)
    flops, ms = smoke.train_bound(10 ** 9, 2048)
    assert flops == 6 * 10 ** 9 * 2048
    assert ms == flops / smoke.PEAK_FLOPS["float32"] * 1e3


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test: when the suite runs in several
    pytest-xdist workers at once, torch's OpenMP pool on every core makes
    small operations many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_training_phase_rehearsed_on_the_cpu(one_torch_thread):
    """Phase P end to end at tiny widths on the CPU: the gradient checks
    at both activation dtypes, `train_model`'s steps (its first loss the
    checked step's), the loss falling, the checkpoint read back bit for
    bit."""
    from repro_torch.config import ModelConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                      vocab=smoke.TRAIN_VOCAB, tie_embeddings=True,
                      qkv_bias=True)
    out = smoke.training_phase(torch, M, attn, fa, cfg, device="cpu",
                               batch=2, seq=16, steps=4)
    assert len(out["losses"]) == 4 and out["losses"][-1] < out["losses"][0]
    for dtype, check in out["grad_check"].items():
        metric, tol = smoke.GRAD_TOL[dtype]
        assert check["grad_rel_err"][metric] <= tol
    assert out["flops_per_step"] == 6 * out["n_params"] * 2 * 17


def test_ssm_training_phases_rehearsed_on_the_cpu(one_torch_thread,
                                                  monkeypatch):
    """Phases R and R-hybrid at tiny widths on the CPU: an SSM model
    fine-tuned (its scans through `SSDScanFunction`, whose backward is
    `ssd_grad`, against the plain oracle's autograd through
    `ssd_chunked`), and a hybrid model's gradient checks; the oracle
    restores the scan's entry when it ends."""
    from repro_torch.config import ModelConfig, SSMConfig
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd_scan import ops as sd
    from repro_torch.models import attention as attn
    from repro_torch.models import model as M
    grads = []
    ssd_grad = sd.ssd_grad
    monkeypatch.setattr(sd, "ssd_grad",
                        lambda *a: grads.append(1) or ssd_grad(*a))
    # (a vocabulary above the corpus's, as mamba2-130m's 50280 is on the
    # card: the first steps learn which ids occur)
    common = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=64, vocab=4 * smoke.TRAIN_VOCAB,
                  tie_embeddings=True,
                  ssm=SSMConfig(d_state=16, head_dim=16, chunk_size=8))
    ssm = ModelConfig(name="t-ssm", family="ssm", **common)
    out = smoke.training_phase(torch, M, attn, fa, ssm, device="cpu",
                               batch=2, seq=16, steps=4, label="phase R")
    assert sd.ssd_slots.__module__ == sd.__name__
    assert out["losses"][-1] < out["losses"][0]
    # two gradient checks and four steps, each one scan a layer
    assert len(grads) == 6 * ssm.n_layers
    hybrid = ModelConfig(name="t-hybrid", family="hybrid",
                         hybrid_attn_period=2, hybrid_attn_offset=1,
                         **common)
    assert smoke.layer_counts(hybrid) == {"attn": 1, "ssm": 1}
    out = smoke.hybrid_grad_phase(torch, M, attn, fa, hybrid,
                                  device="cpu", batch=2, seq=16)
    for dtype, check in out["grad_check"].items():
        metric, tol = smoke.GRAD_TOL[dtype]
        assert check["grad_rel_err"][metric] <= tol


def _ev(name, thread, start, end, kernels=(), dev=DeviceType.CPU):
    return SimpleNamespace(
        name=name, thread=thread, device_type=dev,
        time_range=SimpleNamespace(start=start, end=end),
        kernels=[SimpleNamespace(duration=d) for d in kernels])


def test_range_device_us_counts_kernels_launched_inside():
    """A kernel counts toward a range when the host operation that
    launched it starts inside the range on the range's thread: not one
    launched later, nor one from another thread; the device-side
    annotation of the range is no range."""
    R = smoke.MOE_RANGE
    events = [
        _ev(R, 1, 10, 50, kernels=[1]),      # a launch by the range itself
        _ev("aten::mm", 1, 12, 20, kernels=[5, 7]),
        _ev("aten::add", 1, 60, 61, kernels=[3]),
        _ev("aten::mm", 2, 20, 30, kernels=[4]),
        _ev("aten::view", 1, 30, 31),
        _ev(R, 0, 11, 49, dev=DeviceType.CUDA),
        _ev("sm90_gemm", 0, 13, 25, dev=DeviceType.CUDA),
    ]
    assert smoke.range_device_us(events, R) == (1, 13, 20)
    assert smoke.range_device_us(events, "no such range") == (0, 0, 20)


def _fields(events):
    """The fields the profiler windows read, one tuple an event."""
    return sorted((e.name, str(e.device_type), e.thread, e.time_range.start,
                   e.time_range.end, tuple(sorted(k.duration
                                                  for k in e.kernels)))
                  for e in events)


def test_profiler_events_are_prof_events():
    """`profiler_events` reads the raw results into the fields that
    `prof.events()` gives (names, device types, threads, time ranges,
    linked kernels), here on host operations of two threads inside a
    named range; the card's linked kernels: `tests/test_torch_gpu.py`."""
    import threading

    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(8)

    def work():
        with record_function(smoke.MOE_RANGE):
            for _ in range(50):
                (x * 2 + 1).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        work()
        t = threading.Thread(target=work)
        t.start()
        t.join()
    got = smoke.profiler_events(torch, prof)
    assert len(got) > 300
    assert _fields(got) == _fields(prof.events())
    assert [e.time_range.start for e in got] == sorted(
        e.time_range.start for e in got)


@pytest.mark.parametrize("T,G,D,dtype,form", [
    (1, 4, 120, torch.float32, "gqa"), (4, 4, 120, torch.bfloat16, "gqa"),
    (6, 4, 120, torch.float32, "many-row"),
    (1500, 1, 64, torch.float32, "many-row"),
    (512, 1, 32, torch.float32, "gqa"), (6, 4, 120, torch.int8, "int8"),
    (10, 4, 120, torch.bfloat16, "masked")])
def test_launch_form_names_the_form_the_wrappers_take(T, G, D, dtype, form):
    """`launch_form` (what the kernel phases print and the kernels line
    groups by) names the form `launch_plan` picks: the many-row form from
    R_MMA rows of unmasked f32 / bf16 K/V at D 64, 120, 128, never at
    D 32, for int8 K/V nor with a mask (a tree segment: the GQA form);
    its plan is the wrappers'."""
    from repro_torch.kernels.flash_attention import ops as fa
    q = torch.zeros(2, T, 3, G, D)
    k = torch.zeros(2, 64, 3, D, dtype=dtype)
    mask = torch.ones(2, T, 64, dtype=torch.bool) if form == "masked" \
        else None
    got, plan = smoke.launch_form(fa, q, k, k, 64, mask)
    assert got == ("gqa" if mask is not None else form)
    assert plan == fa.launch_plan(2, 3, T, G, 64, D, D, dtype,
                                  mask is not None)[:3]
    assert (plan[2] == fa.MMA_ROW_TILE) == (form == "many-row") or \
        form == "int8"


def test_gqa_bounds_at_both_rates():
    """A GQA row's bound counts its operations at the tensor-core rate of
    its K/V dtype (3xTF32 for f32, bf16 for bf16: the many-row form's
    units) and, beside it, at the f32 CUDA-core rate."""
    flops = 1e12
    f32 = smoke._gqa_bounds(0, flops, "float32")
    assert f32["bound_ms"] == flops / smoke.TF32X3_FLOPS * 1e3
    assert f32["bound_cuda_core_ms"] == flops / 67e12 * 1e3
    assert f32["bound_by"] == "operations"
    bf = smoke._gqa_bounds(0, flops, "bfloat16")
    assert bf["ops_ms"] == flops / 989e12 * 1e3
    assert bf["cuda_core_ops_ms"] == f32["cuda_core_ops_ms"]
    assert smoke._gqa_bounds(1e12, 1.0, "float32")["bound_by"] == "bytes"


def test_baseline_phases_rehearsed_on_the_cpu(one_torch_thread,
                                              monkeypatch):
    """Phases T-ar .. H-int8 at tiny widths on the CPU, through
    `make_engine` / `serve_phase`'s `strategy` and `overrides`: every
    stream greedy under the tie rule; ar
    runs no drafter and one target forward an iteration beside its
    prefill writes; vanilla and pipeinfer decode on drafter 0 alone,
    specinfer on both; the ablation's burst is one masked prefill write
    (a prompt longer than a chunk its own chunks) and its full fan-out
    decodes every request on both drafters; the wall-clock phases run
    the target on the server thread alone (the CPU has no streams, so
    their overlap is not gated here), H-paged's pools grow and H-int8's
    drafter 0 is int8."""
    import copy

    import numpy as np
    # short prompts and 8 new tokens a request in caches of 256, and a
    # pool of 2 pages a model, which they outgrow
    for name, value in (("NEW_TOKENS", 8), ("MAX_LEN", 256),
                        ("POOL_PAGES", 2)):
        monkeypatch.setattr(smoke, name, value)

    from repro_torch.config import ModelConfig
    from repro_torch.configs.drafters import int8_variant
    from repro_torch.models import model as M
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                      vocab=64, tie_embeddings=True, dtype="float32")
    dcfg = cfg.with_overrides(name="d", n_layers=1)
    tparams = M.init_params(cfg, 0, device="cpu")
    # drafter 0 holds the target's weights in a tree of its own (trees
    # are told apart by identity), drafter 1 random ones
    full = [(cfg, copy.deepcopy(tparams), "d0"),
            (dcfg, M.init_params(dcfg, 1, device="cpu"), "d1")]
    mixed = [(int8_variant(cfg), full[0][1], "d0"), full[1]]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist()
               for n in (16, 40, 72, 100)]
    refs = smoke.target_references(torch, M, cfg, tparams, prompts,
                                   device="cpu")
    dense = dict(target=(cfg, tparams), prompts=prompts, refs=refs, err=0.0)
    seen = {}

    def run(label, target, drafters, prompts, refs, err, **kw):
        sm, streams, _ = smoke.serve_phase(torch, label, target, drafters,
                                           prompts, err, refs,
                                           device="cpu", **kw)
        assert [s[:len(r["ref"])] for s, r in zip(streams, refs)] \
            == [r["ref"] for r in refs]
        seen[label] = (kw.get("strategy", "cosine"), kw.get("overrides"))
        return sm, streams

    greedy = [r["ref"] for r in refs]
    out = smoke.baseline_phases(torch, run, dense, full, mixed,
                                dict.fromkeys("ACDH", greedy),
                                overlap_gate=0.0)
    assert list(out) == list(seen) == [
        "phase T-ar", "phase T-vanilla", "phase T-pipeinfer",
        "phase T-specinfer", "phase T-ablate", "phase H-pipeinfer",
        "phase H-paged", "phase H-int8"]
    assert seen["phase T-ablate"] == ("cosine", smoke.ABLATION)
    assert out["phase T-ablate"]["prefill_writes"] == {
        "target": 1, "drafter 0": 1, "drafter 1": 1}
    # phase A's prompts on the card: the three short ones in one write,
    # the 600-token one in two chunks of at most 512
    assert smoke.burst_prefill_writes(smoke.PROMPT_LENS, 512) == 3
    assert smoke.burst_prefill_writes([63, 599], 512) == 3
    assert smoke.burst_prefill_writes([5], 512) == 1
    assert out["phase T-ar"]["forwards_by_model"]["drafter 1"] == 0
    assert out["phase T-vanilla"]["mean_acceptance"] > 1.0
    assert out["phase H-int8"]["int8_products"] > 0
    assert all(out[label]["streams_equal"] == {"H": 4, sim: 4}
               and out[label]["first_differences"] == {"H": [], sim: []}
               for label, sim in (("phase H-paged", "C"),
                                  ("phase H-int8", "D")))
    assert all(sm["backend"] == "async" and sm["server_forwards"] > 0
               for label, sm in out.items() if label.startswith("phase H"))
    assert all(p["pool_growths"] >= 1 for p in
               out["phase H-paged"]["pools"].values())
    eng = smoke.make_engine((cfg, tparams), full, strategy="specinfer",
                            overrides=dict(draft_len=3), device="cpu")
    assert (eng.strategy, eng.cfg.draft_len, eng.cfg.tree_width) == (
        "specinfer", 3, 2)


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_reference_noise_from_the_greedy_rows(arch, monkeypatch,
                                              one_torch_thread):
    """`target_references` takes the path noise (and a MoE target's router
    flips) from the greedy decode's own logit rows: the same numbers as
    running the decode path a second time beside the one prefill over the
    whole sequence, as the noise is defined."""
    import numpy as np

    from repro_torch.configs import QWEN2_0_5B, QWEN2_MOE_A2_7B
    from repro_torch.models import model as M
    monkeypatch.setattr(smoke, "NEW_TOKENS", 6)
    monkeypatch.setattr(smoke, "MAX_LEN", 64)
    cfg = (QWEN2_0_5B if arch == "dense" else QWEN2_MOE_A2_7B).reduced()
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (5, 12)]
    refs = smoke.target_references(torch, M, cfg, params, prompts,
                                   device="cpu")
    V, L = cfg.vocab, smoke.moe_layers(cfg)
    for p, r in zip(prompts, refs):
        assert len(r["ref"]) == len(r["gaps"]) == 6
        P, toks, records = len(p), r["ref"], []
        with smoke.route_records(records):
            c = M.init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
            full, _, _ = M.prefill(params, cfg, torch.tensor([p + toks]), c)
            c = M.init_cache(cfg, 1, 64, dtype=torch.float32, device="cpu")
            lg, c, _ = M.prefill(params, cfg, torch.tensor([p]), c)
            diffs = [(lg[0, -1, :V] - full[0, P - 1, :V]).abs().max()]
            assert int(torch.argmax(lg[0, -1, :V])) == toks[0]
            for i, t in enumerate(toks[:-1]):
                lg, c, _ = M.decode_step(params, cfg, torch.tensor([[t]]), c)
                diffs.append((lg[0, 0, :V] - full[0, P + i, :V]).abs().max())
                assert int(torch.argmax(lg[0, 0, :V])) == toks[i + 1]
        assert r["noise"] == float(max(diffs))
        if arch == "dense":
            assert "router_flips" not in r
            continue
        assert L > 0 and len(records) == (1 + 1 + len(toks) - 1) * L
        f, pre, steps = records[:L], records[L: 2 * L], records[2 * L:]
        flips = sum(int((f[j][:P] != pre[j]).any(-1).sum())
                    + sum(int((f[j][P + i] != steps[i * L + j][0]).any())
                          for i in range(len(toks) - 1))
                    for j in range(L))
        assert (r["router_flips"], r["router_pairs"]) == (
            flips, L * (P + len(toks) - 1))
