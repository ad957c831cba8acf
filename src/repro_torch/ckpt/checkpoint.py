"""Step-atomic checkpoints: a manifest and one raw file a leaf
(counterpart of ``repro/ckpt/checkpoint.py``, in its on-disk format).

  * written to ``<dir>/tmp.<step>``, then renamed to ``<dir>/step_<N>``
    (N zero-padded to 10 digits): a crash during a save never corrupts
    the latest checkpoint, and ``latest_step`` reads committed ones only;
  * ``manifest.json`` lists each leaf's path (as ``jax.tree_util.keystr``
    writes it), file, shape and dtype, and the caller's metadata;
  * a leaf file holds the raw elements (the host's byte order, as the
    reference writes them); bf16 is written and read through a 16-bit
    view, so neither side needs ``ml_dtypes``.

A checkpoint the JAX package wrote reads back with ``load_numpy`` (no
target tree needed), and its parameters carry across through
``repro_torch/models/convert.py::params_from_numpy``.
"""
from __future__ import annotations

import ast
import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths


class BF16Bits(np.ndarray):
    """A uint16 array holding bf16 bit patterns (numpy has no bf16)."""


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bf16 bit for bit through a
    16-bit view: a ``BF16Bits`` array, or a JAX array's numpy form (dtype
    name ``bfloat16``, from ``ml_dtypes``, which this module does not
    import)."""
    a = np.asanyarray(a)
    bf16 = isinstance(a, BF16Bits) or a.dtype.name == "bfloat16"
    a = np.array(a, copy=True, order="C")  # writable and owned by torch
    if bf16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def _read(d: str, entry: dict) -> np.ndarray:
    with open(os.path.join(d, entry["file"]), "rb") as f:
        raw = f.read()
    shape = entry["shape"]
    if entry["dtype"] == "bfloat16":
        return np.frombuffer(raw, dtype=np.uint16).reshape(shape).view(BF16Bits)
    return np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(shape)


def save(directory: str, tree, *, step: int, metadata: dict | None = None) -> str:
    """Atomically write the checkpoint of ``step`` (a tree of tensors);
    returns its directory."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.bin"
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(arr.tobytes())
        entries.append({"path": path, "file": fname, "shape": list(arr.shape),
                        "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": entries, "metadata": metadata or {}}, f,
                  indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _manifest(directory: str, step: int | None):
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = _step_dir(directory, step)
    with open(os.path.join(d, "manifest.json")) as f:
        return d, json.load(f)


def restore(directory: str, target_tree, *, step: int | None = None):
    """Read the checkpoint (the latest unless ``step``) into the structure
    of ``target_tree``: each leaf a tensor on its target leaf's device, in
    the dtype the manifest records. Returns (tree, metadata)."""
    d, manifest = _manifest(directory, step)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    values = {}
    for path, ref in leaves_with_paths(target_tree):
        e = by_path.get(path)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {path}")
        values[path] = to_tensor(_read(d, e), ref.device)
    return _rebuild(target_tree, values), manifest["metadata"]


def _rebuild(tree, values, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, prefix + f"[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, prefix + f"[{i}]")
                          for i, v in enumerate(tree))
    return values[prefix]


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\d+)\]")


def load_numpy(directory: str, step: int | None = None):
    """The checkpoint (the latest unless ``step``) as the nested tree its
    manifest's paths describe: dicts for string keys, lists for integer
    indices, numpy leaves (bf16 as ``BF16Bits``). Returns (tree,
    metadata)."""
    d, manifest = _manifest(directory, step)
    root: dict = {}
    for e in manifest["leaves"]:
        keys = [ast.literal_eval(m) for m in _KEY.findall(e["path"])]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _read(d, e)
    return _lists(root), manifest["metadata"]


def _lists(node):
    """Dicts keyed 0..n-1 by integers become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def prune_old(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` checkpoints."""
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
