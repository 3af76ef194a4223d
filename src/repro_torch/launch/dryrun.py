"""Dry-run without a compiler (port of `repro.launch.dryrun`): for every
(architecture x input shape) on the production meshes, the per-device
memory that the sharding rules give and the analytic roofline, from the
port's meta-device trees. Nothing is allocated, compiled or run, and no
device or process group is needed: the meshes are structural.

The record is the reference's less what only a compiled XLA program has:
`t_lower_s`, `t_compile_s`, the HLO flops and bytes, the collective
bytes and counts and XLA's memory analysis are absent (not zero). In
their place each record holds the per-device bytes of the parameters
(bf16, as the reference lowers them), the optimizer state (train:
AdamW's f32 m and v below 10 B parameters, momentum-free SGD above, as
the reference chooses), the decode cache (serving steps, bf16) and the
tokens (and frontend) of one step. The roofline's compute and memory
terms are at the H100's peaks, in place of the reference's TPU v5e
constants; it has no collective term.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--step verify]
Writes experiments/dryrun_torch/<arch>__<shape>__<mesh>[__verify].json
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback

import torch

from repro_torch.analysis.analytic import estimate
from repro_torch.config import INPUT_SHAPES, ModelConfig
from repro_torch.configs import LONG_CONTEXT_POLICY, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.device import HBM_BYTES_PER_S, PEAK_FLOPS
from repro_torch.launch.mesh import PRODUCTION_SHAPES, mesh_axes
from repro_torch.models.model import effective_window
from repro_torch.optim.optimizers import tree_leaves

#: verification rows per request of the `verify` step (CoSine tree nodes)
GAMMA = 16
#: above this many parameters the reference trains with momentum-free
#: SGD (no optimizer state) instead of AdamW
BIG_MODEL = 10_000_000_000


class StructuralMesh:
    """A mesh of axis names and sizes only: what the rules read."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def production_mesh(multi_pod: bool = False) -> StructuralMesh:
    """The production mesh's shape and names (`launch.mesh`)."""
    return StructuralMesh(*PRODUCTION_SHAPES[multi_pod])


def resolve_config(arch: str, shape: str) -> ModelConfig:
    """`arch`'s config, with the sliding window at long_500k where its
    long-context policy says so."""
    cfg = get_config(arch)
    if shape == "long_500k" and LONG_CONTEXT_POLICY[arch] == "swa":
        cfg = cfg.with_overrides(long_context="swa")
    return cfg


def n_params_of(cfg: ModelConfig) -> int:
    return sum(t.numel() for t in tree_leaves(sh.param_shapes(cfg)))


def active_params_of(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: shared + top_k routed)."""
    total = n_params_of(cfg)
    if cfg.moe is None:
        return total
    moe = cfg.moe
    n_moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
    per_expert = 3 * cfg.d_model * moe.d_ff
    inactive = n_moe_layers * (moe.n_routed - moe.top_k) * per_expert
    return total - inactive


def local_numel(shape, spec, mesh) -> int:
    """Elements of one device's shard of a leaf of `shape` under
    `spec` (every sharded dim divides: the rules shard no other)."""
    axes = mesh_axes(mesh)
    n = 1
    for dim, entry in zip(shape, spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        ways = math.prod(axes[a] for a in names)
        if dim % ways:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {names}")
        n *= dim // ways
    return n


def tree_bytes(shapes, specs, mesh, dtype_of) -> int:
    """Per-device bytes of a tree under its specs; `dtype_of(leaf)` is
    the dtype each leaf is held in."""
    sizes = sh.map_with_path(
        lambda path, t: local_numel(t.shape, sh.spec_at(specs, path), mesh)
        * dtype_of(t).itemsize, shapes)
    return sum(tree_leaves(sizes))


def _bf16_floats(t) -> torch.dtype:
    """The reference lowers floating parameters as bf16."""
    return torch.bfloat16 if t.dtype.is_floating_point else t.dtype


def step_kind_for(shape_name: str) -> str:
    return {"train": "train", "prefill": "prefill",
            "decode": "decode"}[INPUT_SHAPES[shape_name].kind]


def cache_capacity(cfg: ModelConfig, shape_name: str) -> int:
    """A serving step's cache capacity, as the reference sizes it: the
    sequence + 128 (the window + 128 at long_500k with a window)."""
    S = INPUT_SHAPES[shape_name].seq_len
    if shape_name == "long_500k":
        win = effective_window(cfg)
        return (win + 128) if win else S + 128
    return S + 128


def memory(cfg: ModelConfig, shape_name: str, kind: str, mesh) -> dict:
    """Per-device bytes of one step's parameters, optimizer state, cache
    and inputs under the sharding rules."""
    ishape = INPUT_SHAPES[shape_name]
    B, S = ishape.global_batch, ishape.seq_len
    mode = "train" if kind == "train" else "serve"
    pshapes = sh.param_shapes(cfg)
    pspecs = sh.param_specs(cfg, mesh, mode=mode)
    out = {"param_bytes": tree_bytes(pshapes, pspecs, mesh, _bf16_floats)}
    bspec = sh.batch_spec(mesh, B)
    rows = {"train": S, "prefill": S, "decode": 1, "verify": GAMMA}[kind]
    tok_spec = (bspec, None)
    out["token_bytes"] = local_numel((B, rows), tok_spec, mesh) * 4
    if cfg.n_frontend_tokens:
        out["frontend_bytes"] = local_numel(
            (B, cfg.n_frontend_tokens, cfg.d_model), (bspec, None, None),
            mesh) * 2
    if kind == "train":
        big = n_params_of(cfg) > BIG_MODEL
        out["optimizer"] = "sgd(momentum=0)" if big else "adamw"
        # AdamW: f32 m and v sharded as the parameters, and its step count
        out["opt_state_bytes"] = 0 if big else 2 * tree_bytes(
            pshapes, pspecs, mesh, lambda t: torch.float32) + 4
    else:
        cap = cache_capacity(cfg, shape_name)
        cshapes, cspecs = sh.cache_specs(cfg, mesh, B, cap,
                                         dtype=torch.bfloat16)
        out["cache_capacity"] = cap
        out["cache_bytes"] = tree_bytes(cshapes, cspecs, mesh,
                                        lambda t: t.dtype)
    out["total_bytes"] = sum(n for k, n in out.items()
                             if k.endswith("_bytes"))
    return out


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            step_override: str | None = None,
            out_dir: str = "experiments/dryrun_torch") -> dict:
    mesh = production_mesh(multi_pod)
    cfg = resolve_config(arch, shape_name)
    kind = step_override or step_kind_for(shape_name)
    n_chips = mesh.size
    ishape = INPUT_SHAPES[shape_name]
    n_total = n_params_of(cfg)
    n_active = active_params_of(cfg)
    if kind == "train":
        tokens_processed = ishape.global_batch * ishape.seq_len
        model_flops = 6 * n_active * tokens_processed
    elif kind == "prefill":
        tokens_processed = ishape.global_batch * ishape.seq_len
        model_flops = 2 * n_active * tokens_processed
    else:
        tokens_processed = ishape.global_batch * (
            GAMMA if kind == "verify" else 1)
        model_flops = 2 * n_active * tokens_processed

    est = estimate(cfg, shape_name, kind, n_active, n_total)
    compute_s = est.flops / (n_chips * PEAK_FLOPS["bfloat16"])
    memory_s = est.hbm_bytes / (n_chips * HBM_BYTES_PER_S)
    result = {
        "arch": arch, "shape": shape_name, "step": kind,
        "mesh": "2x16x16" if multi_pod else "16x16", "n_chips": n_chips,
        "ok": True,
        "n_params": n_total, "n_active_params": n_active,
        "analytic": {"flops_global": est.flops,
                     "hbm_bytes_global": est.hbm_bytes},
        "per_device": memory(cfg, shape_name, kind, mesh),
        "roofline": {
            "device": "NVIDIA H100 SXM5 80GB (data-sheet peaks: bf16 "
                      f"{PEAK_FLOPS['bfloat16']:.3g} FLOP/s, HBM "
                      f"{HBM_BYTES_PER_S:.3g} B/s)",
            "compute_s": compute_s, "memory_s": memory_s,
            "dominant": "compute" if compute_s >= memory_s else "memory",
        },
        "model_flops_global": model_flops,
        "useful_flops_ratio": (model_flops / est.flops
                               if est.flops else None),
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if step_override is None else f"__{step_override}"
    name = f"{arch}__{shape_name}__{result['mesh']}{suffix}"
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    pd = result["per_device"]
    print(f"[dryrun] {name}: per device {pd['total_bytes'] / 2**30:.2f} GiB"
          f" (params {pd['param_bytes'] / 2**30:.2f} GiB) "
          f"dominant={result['roofline']['dominant']} "
          f"analytic flops={est.flops:.3e} hbm={est.hbm_bytes:.3e}")
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--step", type=str, default=None,
                    help="override step kind (e.g. verify)")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    args = ap.parse_args()

    if args.all:
        from repro_torch.configs import arch_shape_pairs
        failures = []
        for arch, shape in arch_shape_pairs():
            try:
                run_one(arch, shape, args.multi_pod, args.step, args.out)
            except Exception as e:
                failures.append((arch, shape, repr(e)))
                print(f"[dryrun] {arch}/{shape} FAILED: {e}")
                traceback.print_exc()
        if failures:
            print(f"{len(failures)} FAILURES:")
            for f in failures:
                print(" ", f)
            raise SystemExit(1)
        print("all combos recorded OK")
    else:
        run_one(args.arch, args.shape, args.multi_pod, args.step, args.out)


if __name__ == "__main__":
    main()
