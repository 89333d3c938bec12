"""Checkpointing without external dependencies: port of
``repro.checkpoint.checkpointer``, in the reference's file format.

Format: one ``.npz`` per save holding every leaf under its flattened key
path (``a/b/#0``: dict keys sorted, sequence items ``#i``) and a JSON
manifest beside it (``<file>.json``) with each entry's shape and dtype, the
caller's metadata and the save time.  bfloat16 leaves are stored as their
uint16 bit pattern under a ``__bf16__`` prefix, as the reference stores
them, so a file written by either package loads in the other.  Tensors are
copied to the host to be written; ``restore_pytree`` puts each leaf back in
its template leaf's dtype and on its device.

Fault tolerance: ``Checkpointer.restore_dropped`` maps a checkpoint taken
with M servers onto the surviving (M-1)-server topology: the failed
server's row goes from every (M, ...) leaf and the survivors re-index
densely, which is the file-side twin of the dynamic engine's drop surgery
(``core.engine``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.topology import FLTopology
from repro_torch.tree import tree_map

_BF16 = "__bf16__"


def _flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """``{key path: leaf}``, dict keys sorted and sequence items ``#i``,
    as the reference names them."""
    flat: Dict[str, Any] = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                rec(f"{prefix}/#{i}", v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def _unflatten_from_paths(flat: Dict[str, Any], template: Any) -> Any:
    """Rebuild ``template``'s structure from ``{key path: value}``."""
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else str(k), node[k])
                    for k in node}
        if isinstance(node, tuple):
            vals = [rec(f"{prefix}/#{i}", v) for i, v in enumerate(node)]
            return (type(node)(*vals) if hasattr(node, "_fields")
                    else tuple(vals))
        if isinstance(node, list):
            return [rec(f"{prefix}/#{i}", v) for i, v in enumerate(node)]
        return flat[prefix]

    return rec("", template)


def _to_numpy(x: Any) -> Tuple[bool, np.ndarray]:
    """``(is_bf16, host array)``: a bfloat16 tensor as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return True, x.view(torch.int16).numpy().view(np.uint16)
        return False, x.numpy()
    return False, np.asarray(x)


def save_pytree(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Write ``tree`` to ``path`` (an ``.npz``, through a temporary file and
    ``os.replace``) and its manifest to ``path + ".json"``."""
    flat = {}
    for k, v in _flatten_with_paths(tree).items():
        bf16, arr = _to_numpy(v)
        flat[_BF16 + k if bf16 else k] = arr
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp[:-4], **flat)   # np.savez appends .npz
    os.replace(tmp, path)
    manifest = {
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "meta": meta or {},
        "time": time.time(),
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)


def _like(template: Any, value: np.ndarray) -> Any:
    """``value`` as ``template``'s kind of leaf: a tensor in its dtype on
    its device, an array in its dtype, or a Python scalar."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(value).to(device=template.device,
                                         dtype=template.dtype)
    if isinstance(template, np.ndarray):
        return np.asarray(value, template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(value)
    return value


def restore_pytree(path: str, template: Any) -> Any:
    """Read the tree saved at ``path`` into ``template``'s structure, each
    leaf in its template leaf's dtype and on its device."""
    flat: Dict[str, Any] = {}
    with np.load(path) as z:
        for k in z.files:
            if k.startswith(_BF16):
                bits = torch.from_numpy(z[k].view(np.int16).copy())
                flat[k[len(_BF16):]] = bits.view(torch.bfloat16)
            else:
                flat[k] = z[k]
    restored = _unflatten_from_paths(flat, template)
    return tree_map(_like, template, restored)


@dataclasses.dataclass
class Checkpointer:
    """Numbered checkpoints ``ckpt_<step:08d>.npz`` in ``directory``; the
    newest ``keep`` survive each save."""

    directory: str
    keep: int = 3

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None) -> str:
        path = self._path(step)
        save_pytree(path, tree, meta={"step": step, **(meta or {})})
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.directory):
            return None
        steps = [int(f[5:13]) for f in os.listdir(self.directory)
                 if f.startswith("ckpt_") and f.endswith(".npz")]
        return max(steps) if steps else None

    def restore(self, template: Any,
                step: Optional[int] = None) -> Tuple[Any, int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_pytree(self._path(step), template), step

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        files = sorted(f for f in os.listdir(self.directory)
                       if f.startswith("ckpt_") and f.endswith(".npz"))
        for f in files[: -self.keep]:
            os.remove(os.path.join(self.directory, f))
            j = os.path.join(self.directory, f + ".json")
            if os.path.exists(j):
                os.remove(j)

    # -- fault tolerance -----------------------------------------------------
    def restore_dropped(self, template: Any, dropped_server: int,
                        old_topo: FLTopology,
                        step: Optional[int] = None) -> Tuple[Any, FLTopology]:
        """Restore a checkpoint of an M-server run into the (M-1)-server
        topology without ``dropped_server``: its row goes from every leaf
        with a leading M axis.  ``template`` already has the (M-1)-sized
        leading axes; the new topology is ``old_topo.drop_server``'s."""
        m = old_topo.num_servers
        new_topo, keep = old_topo.drop_server(dropped_server)

        def widen(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
                    and leaf.shape[0] == m - 1:
                return torch.zeros((m,) + tuple(leaf.shape[1:]),
                                   dtype=leaf.dtype, device=leaf.device)
            return leaf

        restored, _ = self.restore(tree_map(widen, template), step)
        keep_idx = np.asarray(keep)

        def narrow(t, r):
            if isinstance(r, torch.Tensor) and r.dim() >= 1 \
                    and r.shape[0] == m and tuple(t.shape[:1]) == (m - 1,):
                return r.index_select(0, torch.as_tensor(keep_idx,
                                                         device=r.device))
            return r

        return tree_map(narrow, template, restored), new_topo
