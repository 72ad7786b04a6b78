"""Train-state checkpoints (``repro/checkpoint/store.py``): atomic, async,
auto-resume, single writer.

The format is the JAX package's, bit for bit, so a checkpoint written by
either package resumes in the other: one step directory
``step_XXXXXXXXX`` holds ``arrays.npz`` (uncompressed ``np.savez``, one
array a leaf, keyed by the leaf's JAX path string such as
``"['opt']/['mu']/['embed']"``) and ``manifest.json`` (``{"step",
"treedef", "keys", "meta"}``, ``treedef`` the string ``jax.tree_util``
writes for the same tree of dicts, lists and tuples). Leaves are listed
in JAX's order: a dict's by sorted key. A Python ``int`` leaf (the
port's step counter) is written as a 0-d ``int32``, as the JAX state
holds it, and read back as an ``int``. A bfloat16 leaf (every decoder's
published CONFIG holds bf16 params) is stored as the JAX package stores
it: its raw 2-byte values, nothing cast, under an npy header whose
``descr`` is ``'<V2'`` (ml_dtypes' bfloat16 as numpy writes it), so its
npz entry equals the JAX one byte for byte. ``np.load`` returns such an
entry as a ``|V2`` void array; ``load_checkpoint`` views it as bf16 where
the template's leaf is a bf16 tensor (the same bits, no copy) and raises
against any other template. (The JAX package's own ``load_checkpoint``
hands the void array back as it is.)

Writes go to ``step_XXXXXXXXX.tmp`` and are published by ``os.replace``
(atomic on POSIX), so a killed writer never leaves a checkpoint that
resume would trust: a ``.tmp`` directory, or one without a manifest, is
never listed. Only process 0 writes (``torch.distributed``'s rank when a
process group is initialised). ``AsyncCheckpointer`` copies the state to
the host inside ``save()`` and writes it on a daemon thread, behind a
bounded queue that applies back-pressure.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_BF16_HOST = np.dtype("V2")   # a bf16 leaf's raw 2-byte values on the host
_BF16_DESCR = "<V2"           # its npy header's descr, as the JAX package's


def _items(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(JAX path string, leaf)`` of every leaf in JAX's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _items(tree[k], f"{path}/[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _items(x, f"{path}/[{i}]")]
    if tree is None:
        return []
    return [(path[1:], tree)]


def _treedef(tree: Tree) -> str:
    """The tree's shape as ``str(jax.tree_util.tree_structure(tree))``
    without the ``PyTreeDef(...)`` around it."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(x) for x in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(x) for x in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "None" if tree is None else "*"


def _rebuild(template: Tree, leaves: Dict[str, Any], path: str = "") -> Tree:
    """``template``'s tree with each leaf taken from ``leaves`` by path."""
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{path}/[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(x, leaves, f"{path}/[{i}]")
                              for i, x in enumerate(template))
    if template is None:
        return None
    return leaves[path[1:]]


def _to_host(key: str, leaf: Any) -> np.ndarray:
    """A leaf as the numpy array the npz holds (a bf16 tensor as its raw
    2-byte values, ``_BF16_HOST``)."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_HOST)
        try:   # a copy, also of a CPU tensor: a caller may mutate it later
            return host.numpy()
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {key}: {leaf.dtype} has no numpy dtype; "
                f"cast it before saving") from e
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def host_state(state: Tree) -> Tree:
    """``state`` with every leaf copied to a numpy array on the host."""
    return _rebuild(state, {key: _to_host(key, leaf)
                            for key, leaf in _items(state)})


def _leaf_shape(leaf: Any) -> Tuple[int, ...]:
    if isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
        return tuple(leaf.shape)
    return tuple(np.shape(leaf))


def _restore(key: str, arr: np.ndarray, leaf: Any) -> Any:
    """``arr`` as a leaf like ``leaf``: a tensor on its device, an int, or
    the array itself. A bf16 leaf's raw values (``|V2``) become a bf16
    tensor with the same bits where ``leaf`` is one, and raise
    elsewhere."""
    if arr.dtype == _BF16_HOST:
        if not (isinstance(leaf, torch.Tensor)
                and leaf.dtype == torch.bfloat16):
            raise TypeError(
                f"checkpoint leaf {key} holds bfloat16 values (|V2) but "
                f"the template's leaf is "
                f"{getattr(leaf, 'dtype', type(leaf).__name__)}")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(leaf.device)
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(leaf.device)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return int(arr)
    return arr


def _savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``, entry for entry (a stored zip64 entry
    ``<key>.npy`` each), but a bf16 leaf's header says ``_BF16_DESCR``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if arr.dtype != _BF16_HOST:
                    np.lib.format.write_array(f, arr)
                    continue
                arr = np.ascontiguousarray(arr)
                header = np.lib.format.header_data_from_array_1_0(arr)
                header["descr"] = _BF16_DESCR
                np.lib.format.write_array_header_1_0(f, header)
                f.write(arr.tobytes())


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: Tree,
    *,
    process_index: Optional[int] = None,
    keep: int = 3,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Atomic checkpoint write. Returns the final path (or None if this
    process is not the writer). Keeps the newest ``keep`` steps."""
    pi = _process_index() if process_index is None else process_index
    if pi != 0:
        return None

    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {key: _to_host(key, leaf) for key, leaf in _items(state)}
    _savez(os.path.join(tmp, _ARRAYS), arrays)
    manifest = {
        "step": step,
        "treedef": f"PyTreeDef({_treedef(state)})",
        "keys": sorted(arrays.keys()),
        "meta": extra_meta or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _gc_old(ckpt_dir, keep)
    return final


def _gc_old(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            path = os.path.join(ckpt_dir, name)
            if os.path.exists(os.path.join(path, _MANIFEST)):
                try:
                    out.append(int(name[len("step_"):]))
                except ValueError:
                    pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def load_checkpoint(
    ckpt_dir: str,
    template: Tree,
    *,
    step: Optional[int] = None,
) -> Tuple[Tree, int]:
    """Restore into the shape of ``template``: each leaf's shape is
    checked (``ValueError``), a leaf the checkpoint lacks raises
    ``KeyError``, and each tensor lands on its template leaf's device in
    the dtype it was saved in (a bf16 leaf as bf16, against a bf16
    template only: ``TypeError`` otherwise). Returns ``(state, step)``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    restored = {}
    with np.load(os.path.join(path, _ARRAYS)) as arrays:
        for key, leaf in _items(template):
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            if tuple(arr.shape) != _leaf_shape(leaf):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs "
                    f"template {_leaf_shape(leaf)}")
            restored[key] = _restore(key, arr, leaf)
    return _rebuild(template, restored), manifest["step"]


class AsyncCheckpointer:
    """Non-blocking checkpoint writer with a bounded queue."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, max_pending: int = 1):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="AsyncCheckpointer")
        self._thread.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host, meta = item
            try:
                save_checkpoint(self.ckpt_dir, step, host, keep=self.keep,
                                extra_meta=meta)
            except BaseException as e:  # surfaced on next save()/close()
                self._err = e

    def save(self, step: int, state: Tree,
             meta: Optional[Dict[str, Any]] = None) -> None:
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
        # device->host copy happens here (sync); disk write is async
        self._q.put((step, host_state(state), meta))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._err is not None:
            raise RuntimeError("async checkpoint failed") from self._err
