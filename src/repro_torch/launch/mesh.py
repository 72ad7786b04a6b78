"""Device meshes over a ``torch.distributed`` world
(``repro/launch/mesh.py``, with ``repro/compat.py``'s ``axis_size`` and
``jax.lax.axis_index``).

A ``Mesh`` lays the ranks of the world the caller initialised on a grid
of named axes, row-major as ``jax.make_mesh`` lays devices: on a
``(data, model)`` mesh rank ``data_idx * n_model + model_idx``. Every
rank builds a process group for each axis and each tuple of axes, in
one order, so that a collective over any axes (``collectives``) finds
its group. The backend is the caller's: ``nccl`` where each rank has a
card of its own, ``gloo`` where ranks share one card or run on the CPU;
nothing here picks or changes it.

Production meshes: ``(16, 16)`` = 256 ranks, axes ``(data, model)``;
``(2, 16, 16)`` = 512 ranks, axes ``(pod, data, model)``. ``pod`` and
``data`` carry data parallelism, ``model`` the vocabulary sharding of
the Sparton head. A mesh of the wrong size for the world raises.
``AbstractMesh`` is a mesh's shape without a world, for the spec
functions of ``launch.sharding``.

To start a world: ``python -m torch.distributed.run --nproc-per-node N
script.py`` (each process then calls ``init_process_group(backend)``),
or ``spawn_world(fn, N, backend=..., root=...)`` from one process.
"""

from __future__ import annotations

import itertools
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

Axes = Union[str, Sequence[str]]


def as_axes(axes: Axes) -> Tuple[str, ...]:
    """A name or a sequence of names, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """``shape`` over ``axis_names`` on the initialised world, this rank's
    coordinates, its process groups and its device (``cuda`` unless
    ``device`` says otherwise: rank ``r`` takes card ``r % device_count``,
    so ranks that share one card all use ``cuda:0``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: DeviceLike = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "Mesh: torch.distributed is not initialised; call "
                "init_process_group(backend, ...) in every rank first")
        shape, names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"Mesh: shape {shape} and axes {names} do not "
                             "match one to one")
        size = 1
        for n in shape:
            size *= n
        world = dist.get_world_size()
        if size != world:
            raise ValueError(f"Mesh: shape {shape} holds {size} ranks, the "
                             f"world has {world}")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = size
        self.rank = dist.get_rank()
        self.coords: Dict[str, int] = {}
        rest = self.rank
        for name, n in reversed(list(zip(names, shape))):
            rest, self.coords[name] = divmod(rest, n)
        self.coords = {name: self.coords[name] for name in names}
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", self.rank % torch.cuda.device_count())
        self.device = dev
        self._groups: Dict[Tuple[str, ...], Any] = {}
        for k in range(1, len(names) + 1):
            for subset in itertools.combinations(names, k):
                self._make_groups(subset)

    def rank_of(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (every axis named)."""
        r = 0
        for name in self.axis_names:
            r = r * self.shape[name] + coords[name]
        return r

    def _make_groups(self, subset: Tuple[str, ...]) -> None:
        """Every group over ``subset`` (one per coordinate of the other
        axes), created on every rank in the same order; keeps this
        rank's."""
        if len(subset) == len(self.axis_names):
            self._groups[subset] = dist.group.WORLD
            return
        others = [a for a in self.axis_names if a not in subset]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in others)):
            base = dict(zip(others, fixed))
            ranks = sorted(self.rank_of({**base, **dict(zip(subset, c))})
                           for c in itertools.product(
                               *(range(self.shape[a]) for a in subset)))
            group = dist.new_group(ranks)
            if all(self.coords[a] == base[a] for a in others):
                self._groups[subset] = group

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        axes = as_axes(axes)
        missing = [a for a in axes if a not in self.shape]
        if missing or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} are not distinct axes of the "
                             f"mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Axes):
        """This rank's process group over ``axes``."""
        return self._groups[self._key(axes)]

    def ranks(self, axes: Axes) -> Tuple[int, ...]:
        """The global ranks of this rank's group over ``axes``, in the
        row-major order of ``axes`` as given (JAX's gather order)."""
        axes = as_axes(axes)
        self._key(axes)
        return tuple(
            self.rank_of({**self.coords, **dict(zip(axes, c))})
            for c in itertools.product(*(range(self.shape[a])
                                         for a in axes)))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device})")


class AbstractMesh:
    """A mesh's shape alone (``jax.sharding.AbstractMesh``): ``shape`` over
    ``axis_names``, no world, no rank. What the spec functions of
    ``launch.sharding`` read; the production ``(16, 16)`` and ``(2, 16,
    16)`` meshes can be described on any host."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        shape, names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"AbstractMesh: shape {shape} and axes {names} "
                             "do not match one to one")
        self.axis_names = names
        self.shape: Dict[str, int] = dict(zip(names, shape))
        self.size = 1
        for n in shape:
            self.size *= n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_size(mesh: Mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (their product for a tuple)."""
    n = 1
    for a in as_axes(axes):
        n *= mesh.shape[a]
    return n


def axis_index(mesh: Mesh, axes: Axes) -> int:
    """This rank's index along ``axes``, row-major over a tuple (the JAX
    package's ``offset * axis_size(ax) + axis_index(ax)`` loop)."""
    i = 0
    for a in as_axes(axes):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """``(16, 16)`` over ``(data, model)``, or ``(2, 16, 16)`` over ``(pod,
    data, model)`` with ``multi_pod``: a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 512 if multi_pod else 256
    if world != need:
        raise ValueError(f"make_production_mesh: the mesh {shape} over "
                         f"{axes} needs a world of {need} ranks, this one "
                         f"has {world}")
    return Mesh(shape, axes, device=device)


def make_mesh_for(shape: Sequence[int],
                  axes: Optional[Sequence[str]] = None, *,
                  device: DeviceLike = None) -> Mesh:
    """Any mesh of the world's size (the elastic re-mesh path and tests);
    ``axes`` default to the last ``len(shape)`` of ``(pod, data,
    model)``."""
    if axes is None:
        axes = ("pod", "data", "model")[-len(shape):]
    return Mesh(shape, axes, device=device)


def batch_axes(mesh: Any) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (every axis but ``model``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def n_batch_shards(mesh: Any) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _rank_main(fn, rank, world_size, backend, root, args, threads):
    """One rank of ``spawn_world``: its result, or its traceback, pickled
    into ``root``."""
    out = Path(root)
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{out}/store",
                                rank=rank, world_size=world_size)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.tmp").write_bytes(pickle.dumps(result))
        os.replace(out / f"rank{rank}.tmp", out / f"rank{rank}.pkl")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_world(fn: Callable[..., Any], world_size: int, *, backend: str,
                root: Union[str, Path], args: Tuple = (),
                timeout: float = 600.0, threads: int = 0) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, each in
    a world of the caller's ``backend`` joined through a ``FileStore`` in
    the empty directory ``root``. Returns each rank's result (picklable:
    move tensors to the host first). A rank that raises, exits without a
    result or outlives ``timeout`` seconds (the others are then killed)
    raises ``RuntimeError`` with its traceback. ``threads`` sets each
    rank's ``torch.set_num_threads`` (0 leaves it)."""
    import multiprocessing

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, backend, str(root), args, threads), daemon=True)
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if not p.is_alive() and p.exitcode != 0]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    errors = []
    for r, p in enumerate(procs):
        err = root / f"rank{r}.err"
        if err.exists():
            errors.append(f"rank {r} raised:\n{err.read_text()}")
        elif not (root / f"rank{r}.pkl").exists():
            why = ("hung past the timeout" if r in hung and
                   time.monotonic() > deadline else
                   f"exited with code {p.exitcode} and no result")
            errors.append(f"rank {r} {why}")
    if errors:
        raise RuntimeError("spawn_world: " + "\n".join(errors))
    return [pickle.loads((root / f"rank{r}.pkl").read_bytes())
            for r in range(world_size)]
