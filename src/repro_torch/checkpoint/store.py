"""Msgpack tensor checkpoints in the reference's format (port of
`repro.checkpoint.store`).

One .msgpack file holds a map {flat_key: {"dtype", "shape", "data"}} plus
"__meta__" (a small json-able dict). Flat keys are '/'-joined paths of
the reference's parameter tree, lists and tuples tagged "__L<i>" and
"__T<i>", so a file either package writes loads in the other:
`save_checkpoint` restacks the port's per-layer parameters into the
reference's stages (`models.convert.reference_tree`) and
`load_checkpoint` splits them again (`params_from_numpy`). Leaves keep
their dtype ("float32", "bfloat16", "int8", ...) and bytes. The
encoding is the port's own (`checkpoint/codec.py`: the card's machine has
no msgpack package); "bfloat16" leaves are read with
`torch.frombuffer`, without numpy's extension types.

`load_checkpoint(..., quantize="int8")` is the reference's
calibrate-then-swap hook: the loaded weights go through
`models.quantize.quantize_params`. Sharded restore (the reference's
`shardings`) has no meaning on one card.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import codec
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.convert import params_from_numpy, reference_tree

#: checkpoint dtype names (numpy's, as the reference writes them)
DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
          "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "T" if isinstance(tree, tuple) else "L"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}__{tag}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith("__T") or k.startswith("__L")
                        for k in keys):
            seq = [rebuild(node[k]) for k in sorted(
                keys, key=lambda s: int(s[3:]))]
            return tuple(seq) if keys[0].startswith("__T") else seq
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _leaf(t: torch.Tensor) -> dict:
    """A tensor's entry: dtype name, shape and its bytes (a view)."""
    t = t.detach().cpu().contiguous()
    data = t.reshape(-1).view(torch.uint8).numpy()
    return {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
            "data": memoryview(data)}


def save_checkpoint(path: str, params, cfg: ModelConfig,
                    meta: Optional[dict] = None) -> None:
    """Write `params` (the port's tree, on any device) to `path` in the
    reference's layout."""
    payload = {"__meta__": meta or {}}
    for k, t in _flatten(reference_tree(params, cfg)).items():
        payload[k] = _leaf(t)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pieces: list = []
    codec.pack_into(payload, pieces)
    with open(path, "wb") as f:
        f.writelines(pieces)


def _tensor(spec) -> torch.Tensor:
    dtype = DTYPES[spec["dtype"]]
    shape = tuple(spec["shape"])
    data = spec["data"]
    if data.nbytes == 0:
        return torch.empty(shape, dtype=dtype)
    # a view into the file's buffer: `params_from_numpy` copies each leaf
    return torch.frombuffer(data, dtype=dtype).reshape(shape)


def load_checkpoint(path: str, cfg: ModelConfig, device=None,
                    quantize: Optional[str] = None):
    """Read a checkpoint either package wrote; returns (params, meta)
    with the port's per-layer parameters on `device` (CUDA unless "cpu"
    is asked for). quantize="int8" swaps the dense and embedding weights
    for int8 ones (`quantize_params`); an int8 checkpoint passes through
    unchanged."""
    dev = resolve_device(device)
    if quantize not in (None, "", "none", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    with open(path, "rb") as f:
        # writable, so `torch.frombuffer` takes views of it as they are
        buf = bytearray(f.read())
    payload = codec.unpackb(buf)
    meta = payload.pop("__meta__", {})
    flat = {k: _tensor(spec) for k, spec in payload.items()}
    params = params_from_numpy(_unflatten(flat), cfg, dev)
    if quantize == "int8":
        from repro_torch.models.quantize import quantize_params
        params = quantize_params(params, cfg)
    return params, meta
