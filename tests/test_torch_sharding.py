"""The port's sharding rules, mesh helpers and dry-run against the JAX
package (CPU; no device is touched).

* `param_specs` for every registered arch, in both modes, on the
  reference tests' two structural meshes (16 x 16 and 2 x 16 x 16), with
  `head_align` off and on and `moe_axis` "data" and "model": each leaf's
  spec equals the reference's spec for the same leaf and divides its
  dim. Leaves are matched through `models/convert.py::reference_tree`:
  the port's tree with a distinct id at each leaf is restacked into the
  reference's nesting, so each reference leaf names the port leaves it
  stacks (a stacked leaf's reference spec is the port's behind a leading
  None).
* `cache_specs` the same way at batch 32 and 128, `kv_shard` "auto" and
  "seq" (the layers' caches matched by the same restacking), and
  `batch_spec`'s fallbacks against the reference's.
* `distribute` on a real (2, 2) ("data", "model") DeviceMesh: four CPU
  processes on `gloo` (a `file://` store, no TCP rendezvous) place a
  tiny hybrid model's parameters in both modes, and each rank holds
  exactly its slice of every full tensor.
* `launch/mesh.py`'s helpers on a structural mesh, and `dryrun.run_one`
  for one arch and shape: the record's per-device bytes against a count
  by hand, and the fields only XLA has absent.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import ARCHS as JARCHS
from repro.distributed import sharding as jsh
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.models.convert import reference_tree
from repro_torch.optim.optimizers import tree_leaves

ARCH_IDS = sorted(ARCHS)
ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """The reference tests' structural mesh."""
    def __init__(self, shape_map):
        self.shape = dict(shape_map)
        self.axis_names = tuple(shape_map)


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


class _CachedShapes:
    """`jax` for the reference's sharding module with `eval_shape`
    computed once for each traced function and closure: the rules are
    evaluated on many meshes and variants of one arch, and tracing a
    full-size `init_params` costs up to half a second each time."""

    def __init__(self):
        self._seen = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def eval_shape(self, fn, *args):
        key = (fn.__code__, tuple(c.cell_contents
                                  for c in fn.__closure__ or ()))
        if key not in self._seen:
            self._seen[key] = jax.eval_shape(fn, *args)
        return self._seen[key]


_JAX = _CachedShapes()


@pytest.fixture
def cached_reference(monkeypatch):
    monkeypatch.setattr(jsh, "jax", _JAX)


def _reference_leaves(specs):
    """[(path, PartitionSpec)] of a reference spec tree, paths as the
    port's `map_with_path` writes them."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = []
    for path, spec in flat:
        out.append((tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path), spec))
    return out


def _ids(tree):
    """The tree with leaf i replaced by tensor([i]), and the paths."""
    paths = []

    def tag(path, leaf):
        paths.append(path)
        return torch.tensor([len(paths) - 1])

    return sh.map_with_path(tag, tree), paths


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _divides(spec, shape, mesh):
    assert len(spec) == len(shape), (spec, shape)
    for dim, axes in zip(shape, spec):
        if axes is not None:
            axes = (axes,) if isinstance(axes, str) else axes
            assert dim % math.prod(mesh.shape[a] for a in axes) == 0


def _match(port_specs, port_shapes, ref_specs, restacked, paths, mesh):
    """Each reference leaf's spec against the port specs of the leaves
    `restacked` says it stacks; every port leaf covered once."""
    seen = []
    for path, ref in _reference_leaves(ref_specs):
        ids = _at(restacked, path)
        ref = tuple(ref)
        if ids.dim() == 2:                 # stacked on a leading reps axis
            assert not ref or ref[0] is None, (path, ref)
            ref = ref[1:]
        for i in ids.reshape(-1).tolist():
            seen.append(i)
            shape = _at(port_shapes, paths[i]).shape
            want = ref + (None,) * (len(shape) - len(ref))
            got = _at(port_specs, paths[i])
            assert got == want, (paths[i], got, want)
            _divides(got, shape, mesh)
    assert sorted(seen) == list(range(len(paths)))


def _restack_params(cfg):
    ids, paths = _ids(sh.param_shapes(cfg))
    return reference_tree(ids, cfg), paths


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mode, cached_reference):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    restacked, paths = _restack_params(cfg)
    shapes = sh.param_shapes(cfg)
    for mesh in (SINGLE, MULTI):
        for head_align in (False, True):
            for moe_axis in ("data", "model"):
                kw = dict(mode=mode, moe_axis=moe_axis,
                          head_align=head_align)
                _match(sh.param_specs(cfg, mesh, **kw), shapes,
                       jsh.param_specs(jcfg, mesh, **kw), restacked, paths,
                       mesh)


@pytest.mark.parametrize("batch", [32, 128])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, batch, cached_reference):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    for mesh in (SINGLE, MULTI):
        for kv_shard in ("auto", "seq"):
            shapes, specs = sh.cache_specs(cfg, mesh, batch, 256,
                                           kv_shard=kv_shard)
            _, jspecs = jsh.cache_specs(jcfg, mesh, batch, 256,
                                        kv_shard=kv_shard)
            ids, paths = _ids(shapes)
            # the layers' caches restack as the layers' parameters do
            stages = reference_tree({"embed": ids["lengths"],
                                     "layers": ids["layers"]}, cfg)["stages"]
            restacked = {"stages": stages, "lengths": ids["lengths"]}
            _match(specs, shapes, jspecs, restacked, paths, mesh)


def test_batch_spec_fallbacks():
    assert sh.batch_spec(SINGLE, 256) == ("data",)
    assert sh.batch_spec(MULTI, 256) == ("pod", "data")
    assert sh.batch_spec(MULTI, 16) == ("data",)
    assert sh.batch_spec(MULTI, 1) is None
    for mesh in (SINGLE, MULTI):
        for b in (1, 2, 16, 32, 48, 128, 256, 512):
            assert sh.batch_spec(mesh, b) == jsh.batch_spec(mesh, b)


def test_mesh_helpers_and_placements():
    assert tmesh.batch_axes(MULTI) == ("pod", "data")
    assert tmesh.batch_axes(SINGLE) == ("data",)
    assert tmesh.axis_size(MULTI, "pod") == 2
    assert tmesh.axis_size(SINGLE, "pod") == 1
    assert tmesh.PRODUCTION_SHAPES[True][1] == ("pod", "data", "model")

    class Dm:   # a DeviceMesh's interface
        mesh_dim_names = ("pod", "data", "model")

        def size(self, i):
            return (2, 16, 16)[i]

    from torch.distributed.tensor import Replicate, Shard
    assert tmesh.mesh_axes(Dm()) == MULTI.shape
    assert tmesh.axis_size(Dm(), "data") == 16
    assert tmesh.batch_axes(Dm()) == ("pod", "data")
    assert sh.to_placements((("pod", "data"), None, "model"), Dm()) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements((None, "data"), Dm()) == [
        Replicate(), Shard(1), Replicate()]


def test_dryrun_record_matches_a_count_by_hand(tmp_path):
    """mamba2-130m, train_4k on 16 x 16: bf16 parameters under FSDP on
    "data" and TP on "model", AdamW's f32 m and v on the same shards,
    the step's (256, 4096) int32 tokens on "data"."""
    rec = dryrun.run_one("mamba2-130m", "train_4k", out_dir=str(tmp_path))
    on_disk = json.loads((tmp_path / "mamba2-130m__train_4k__16x16.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    cfg = ARCHS["mamba2-130m"]
    D, V, L = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    s = cfg.ssm
    din, H, N = s.d_inner(D), s.n_heads(D), s.d_state
    conv = din + 2 * N
    per_layer = (D // 16 * (2 * din + 2 * N + H)     # in_proj (data, -)
                 + din * (D // 16)                   # out_proj (-, data)
                 + s.d_conv * conv + conv            # conv w, b
                 + 3 * H + din + D)                  # A, D, dt; norms
    local = (V // 16 * (D // 16)                     # embed (model, data)
             + L * per_layer + D                     # final norm
             + D // 16 * (V // 16))                  # head (data, model)
    pd = rec["per_device"]
    assert pd["param_bytes"] == 2 * local
    assert pd["opt_state_bytes"] == 2 * 4 * local + 4
    assert pd["token_bytes"] == 256 // 16 * 4096 * 4
    assert pd["total_bytes"] == (pd["param_bytes"] + pd["opt_state_bytes"]
                                 + pd["token_bytes"])
    assert rec["n_params"] == sum(
        t.numel() for t in tree_leaves(TM.init_params(cfg, device="meta")))
    for absent in ("t_lower_s", "t_compile_s", "memory_analysis"):
        assert absent not in rec
    assert set(rec["per_device"]) == {"param_bytes", "token_bytes",
                                      "optimizer", "opt_state_bytes",
                                      "total_bytes"}
    assert "collective_s" not in rec["roofline"]
    assert "H100" in rec["roofline"]["device"]
    # a serving step counts its bf16 cache instead of optimizer state
    dec = dryrun.run_one("qwen2-0.5b", "decode_32k", multi_pod=True,
                         out_dir=str(tmp_path))["per_device"]
    q = ARCHS["qwen2-0.5b"]
    hd = q.resolved_head_dim
    cap = 32768 + 128
    # (128 requests on ("pod", "data"); 2 KV heads do not divide 16, the
    # head width 64 does)
    kv = q.n_layers * 2 * (128 // 32) * cap * q.n_kv_heads * (hd // 16) * 2
    pos = q.n_layers * (128 // 32) * cap * 4 + 128 // 32 * 4
    assert dec["cache_bytes"] == kv + pos


WORKER = textwrap.dedent("""
    import dataclasses, multiprocessing, os, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import ARCHS
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import model as M

    def rank_main(rank, store):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + store,
                                rank=rank, world_size=4)
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        sizes = mesh_axes(mesh)
        cfg = ARCHS["jamba-v0.1-52b"].reduced().with_overrides(
            n_layers=2, hybrid_attn_offset=1)
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                         layer_offset=0))
        params = M.init_params(cfg, seed=0, device="cpu")
        sharded = []
        for mode in ("train", "serve"):
            specs = sh.param_specs(cfg, mesh, mode=mode)
            placed = sh.distribute(params, specs, mesh)

            def check(path, full):
                local = sh.spec_at(placed, path).to_local()
                want = full
                for d, entry in enumerate(sh.spec_at(specs, path)):
                    if entry is None:
                        continue
                    names = (entry,) if isinstance(entry, str) else entry
                    idx, ways = 0, 1
                    for a in names:
                        idx, ways = idx * sizes[a] + coord[a], ways * sizes[a]
                    n = full.shape[d] // ways
                    want = want.narrow(d, idx * n, n)
                    sharded.append(path)
                assert torch.equal(local, want), (mode, path)

            sh.map_with_path(check, params)
        assert sharded
        dist.barrier()
        dist.destroy_process_group()
        # one write of under PIPE_BUF bytes: the ranks' lines never mix
        os.write(1, f"rank {rank} ok {len(sharded)}\\n".encode())

    # the ranks fork from this process, which has imported torch and the
    # port once (a fresh interpreter each takes seconds to)
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=rank_main, args=(r, sys.argv[1]))
             for r in range(4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    sys.exit(max(abs(p.exitcode or 0) for p in procs)
             or any(p.exitcode is None for p in procs))
""")


def test_distribute_on_four_gloo_processes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", WORKER,
                          str(tmp_path / "store")], env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    for r in range(4):
        assert f"rank {r} ok" in out.stdout
