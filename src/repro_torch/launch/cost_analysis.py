"""Cost and roofline count of one step on the H100: the port's
counterpart of ``repro/launch/hlo_analysis.py``.

The JAX package reads XLA's cost and memory analysis of a compiled step.
Eager PyTorch compiles nothing, so the port counts a step while it runs,
usually on ``meta`` tensors (``launch/dryrun.py``): nothing is allocated
and no kernel is launched. ``StepCounter``, a ``TorchDispatchMode``,
sees every ATen op below autograd (the backward's and a checkpointed
layer's recomputation included) and records:

* the products' FLOPs by dtype, with ``torch.utils.flop_counter``'s
  formulas (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions,
  attention); an f32 product is ``"tf32"`` only while
  ``torch.backends.cuda.matmul.allow_tf32`` is set;
* the bytes of every op that is not a view and moves data: each input
  and each output once (XLA's "bytes accessed");
* the peak of live storage bytes, each storage rounded up to 512 bytes
  as the CUDA caching allocator rounds a block, from the op that makes
  it (the step's arguments from the start, ``track``) until it dies (a
  weakref finalizer).

On meta tensors an op's outputs follow from its inputs' shapes, strides
and dtypes and its other arguments, and most meta kernels are Python
reference code: the counter keeps each op's output layout by those keys
and makes a repeated call's outputs with ``torch.empty_strided`` (a
model's layers repeat their ops). Views, in-place ops and any op whose
outputs share an input's storage or do not start their own storage run
every time.

A hand-written kernel stands in the count as its cost function gives it
(``count_kernel``), not as the ops of its plain version: its ``meta``
branch reports the cost, and on the CPU the plain version runs inside
``plain_version``, which reports the same cost and hides the plain
ops' FLOPs and bytes (their allocations still count).

``roofline_terms`` turns the counts into seconds at the H100's data-sheet
peaks (the SXM part, dense, at its 700 W limit); ``memory_analysis``
gives XLA's memory keys. One card has no collectives: ``collective_s``
is 0. The collective parser (``parse_collectives``) and the meshes come
with multi-GPU (ROADMAP item 10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "f32": 67e12,
              "f64": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_CAPACITY = 80e9            # "80 GB"
ALLOC_ROUND = 512              # the caching allocator's block rounding

# ops that allocate without moving data, or move none
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "resize_", "set_"}

_ACTIVE: List["StepCounter"] = []
_UNCACHED = object()       # the layout cache's mark for "run it each time"
_LAYOUTS: Dict[Any, Any] = {}      # meta ops' output layouts, by key
# by op: (its layout may be cached, it moves bytes, its FLOP formula)
_OPS: Dict[Any, Tuple[bool, bool, Any]] = {}
_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device,
             torch.layout, torch.memory_format)


def _tensors(xs) -> Iterator[torch.Tensor]:
    """The tensors among an op's arguments or results (one level of lists,
    as ATen's signatures nest them)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    yield y


def _key(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    if isinstance(x, _HASHABLE):
        return x
    raise TypeError


def _op_info(func) -> Tuple[bool, bool, Any]:
    mutates = any(a.alias_info is not None and a.alias_info.is_write
                  for a in func._schema.arguments)
    packet = func._overloadpacket
    info = (not (func.is_view or mutates),
            not (func.is_view or packet.__name__ in _NO_TRAFFIC),
            flop_registry.get(packet))
    _OPS[func] = info
    return info


def product_kind(dtype: torch.dtype) -> str:
    """The peak a product of ``dtype`` runs at: ``"bf16"``, ``"fp16"``,
    ``"tf32"`` (f32 with TF32 matmuls allowed), ``"f32"``, ``"f64"``, or
    the dtype's name."""
    if dtype == torch.float32:
        return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "f32"
    return {torch.bfloat16: "bf16", torch.float16: "fp16",
            torch.float64: "f64"}.get(dtype, str(dtype).replace("torch.", ""))


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


class PeakAbove(RuntimeError):
    """Raised by a ``StepCounter`` whose live bytes pass ``stop_above``."""


class StepCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module's docstring).
    ``device_type`` picks the storages whose bytes count as live (the
    step's device; a CPU scalar in a meta step is not device memory).
    With ``stop_above`` the step stops (``PeakAbove``) as soon as the
    live bytes pass it: whether a step fits needs no more."""

    def __init__(self, device_type: str = "meta",
                 stop_above: Optional[float] = None):
        super().__init__()
        self.device_type = device_type
        self.stop_above = stop_above
        self.flops_by_dtype: Dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self._live = set()      # ids of the live storages counted
        self._plain = 0         # depth of plain_version regions

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    def track(self, tree: Any) -> int:
        """Counts the storages of ``tree``'s tensors as live; returns the
        bytes newly counted."""
        return sum(self._track(t) for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))

    def _track(self, t: torch.Tensor) -> int:
        if t.device.type != self.device_type:
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return 0
        n = _rounded(st.nbytes())
        self._live.add(key)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key, n)
        if self.stop_above is not None and self.live_bytes > self.stop_above:
            raise PeakAbove(f"{self.live_bytes} live bytes, past "
                            f"{self.stop_above:.0f}")
        return n

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def add_kernel(self, name: str, flops: int, nbytes: int,
                   kind: str) -> None:
        """One call of a hand-written kernel, at its cost function's
        count."""
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                             "bytes": 0})
        row["calls"] += 1
        row["flops"] += flops
        row["bytes"] += nbytes
        self.flops_by_dtype[kind] += flops
        self.bytes += nbytes

    def _run(self, func, args, kwargs, cacheable):
        """``func(*args, **kwargs)``, on meta tensors from the layout
        cache where it can be (see the module's docstring)."""
        if not cacheable or self.device_type != "meta":
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs)
        layout = _LAYOUTS.get(key)
        if layout is _UNCACHED:
            return func(*args, **kwargs)
        if layout is not None:
            many, specs = layout
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in specs]
            return type(many)(outs) if many is not None else outs[0]
        out = func(*args, **kwargs)
        _LAYOUTS[key] = self._layout(out, args, kwargs)
        return out

    @staticmethod
    def _layout(out, args, kwargs):
        """How to remake ``out`` from nothing, or ``_UNCACHED``."""
        many = out if isinstance(out, (list, tuple)) else None
        outs = list(out) if many is not None else [out]
        if not outs or not all(isinstance(t, torch.Tensor) for t in outs):
            return _UNCACHED
        ins = {id(t.untyped_storage()) for t in _tensors(args)}
        ins |= {id(t.untyped_storage()) for t in _tensors(kwargs.values())}
        specs = []
        for t in outs:
            st = t.untyped_storage()
            if (id(st) in ins or t.storage_offset() != 0
                    or st.nbytes() != torch.empty_strided(
                        t.shape, t.stride(), dtype=t.dtype,
                        device="meta").untyped_storage().nbytes()):
                return _UNCACHED
            specs.append((tuple(t.shape), t.stride(), t.dtype))
        if len({id(t.untyped_storage()) for t in outs}) != len(outs):
            return _UNCACHED
        return (type(many)() if many is not None else None, specs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        cacheable, traffic, formula = _OPS.get(func) or _op_info(func)
        out = self._run(func, args, kwargs, cacheable)
        outs = {id(t): t for t in _tensors(
            out if isinstance(out, (list, tuple)) else (out,))}
        for t in outs.values():
            self._track(t)
        if self._plain or not traffic:
            return out
        ins = {id(t): t for t in _tensors(args)}
        if kwargs:
            ins.update((id(t), t) for t in _tensors(kwargs.values()))
        if formula is not None:
            kind = product_kind(next(_tensors(args)).dtype)
            self.flops_by_dtype[kind] += int(formula(*args, **kwargs,
                                                     out_val=out))
        self.bytes += sum(t.nbytes for t in ins.values())
        self.bytes += sum(t.nbytes for t in outs.values())
        return out


def storage_bytes(tree: Any, exclude: Set[int] = frozenset()
                  ) -> Tuple[int, Set[int]]:
    """The rounded bytes of the distinct storages behind ``tree``'s
    tensors whose ids are not in ``exclude``, and those ids."""
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in exclude:
                seen[id(st)] = _rounded(st.nbytes())
    return sum(seen.values()), set(seen)


def active() -> Optional[StepCounter]:
    """The innermost ``StepCounter`` running, if any."""
    return _ACTIVE[-1] if _ACTIVE else None


def count_kernel(name: str, flops: int, nbytes: int, kind: str) -> None:
    """A kernel's ``meta`` branch reports its cost to the active counter
    (nothing happens without one)."""
    counter = active()
    if counter is not None:
        counter.add_kernel(name, flops, nbytes, kind)


@contextlib.contextmanager
def plain_version(name: str, flops: int, nbytes: int,
                  kind: str) -> Iterator[None]:
    """Around a kernel's plain version on the CPU: the active counter
    takes the kernel's cost and not the plain ops' FLOPs and bytes."""
    counter = active()
    if counter is None:
        yield
        return
    counter.add_kernel(name, flops, nbytes, kind)
    counter._plain += 1
    try:
        yield
    finally:
        counter._plain -= 1


@dataclasses.dataclass
class Roofline:
    flops: float                 # every product's FLOPs, per device
    hbm_bytes: float             # per device
    collective_operand_bytes: float
    collective_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0     # useful model FLOPs per device
    useful_ratio: float = 0.0

    def table_row(self) -> str:
        return (f"{self.compute_s:.3e},{self.memory_s:.3e},"
                f"{self.collective_s:.3e},{self.bottleneck},"
                f"{self.useful_ratio:.3f}")


def roofline_terms(flops_by_dtype: Dict[str, float], hbm_bytes: float, *,
                   model_flops: float = 0.0) -> Roofline:
    """The step's least times on one H100: ``compute_s`` sums each dtype's
    FLOPs over that dtype's peak (a kind without one, an integer product,
    at the f32 peak), ``memory_s`` the bytes over HBM's rate;
    ``collective_s`` is 0 on one card."""
    flops = float(sum(flops_by_dtype.values()))
    compute_s = sum(f / PEAK_FLOPS.get(kind, PEAK_FLOPS["f32"])
                    for kind, f in flops_by_dtype.items())
    memory_s = hbm_bytes / HBM_BYTES_PER_S
    terms = {"compute": compute_s, "memory": memory_s, "collective": 0.0}
    r = Roofline(flops=flops, hbm_bytes=hbm_bytes,
                 collective_operand_bytes=0.0, collective_wire_bytes=0.0,
                 compute_s=compute_s, memory_s=memory_s, collective_s=0.0,
                 bottleneck=max(terms, key=terms.get))
    if model_flops:
        r.model_flops = model_flops
        r.useful_ratio = model_flops / max(flops, 1.0)
    return r


def memory_analysis(counter: StepCounter, argument_bytes: int,
                    output_bytes: int) -> Dict[str, float]:
    """XLA's memory keys from a counted step: the arguments (state or
    params, and the batch) and the outputs' new storages, both rounded
    as the allocator rounds them; ``temp`` the rest of the peak; no
    aliasing (the port's step keeps the state it is given)."""
    peak = counter.peak_bytes
    return {"argument_size_in_bytes": float(argument_bytes),
            "output_size_in_bytes": float(output_bytes),
            "temp_size_in_bytes": float(max(peak - argument_bytes
                                            - output_bytes, 0)),
            "alias_size_in_bytes": 0.0,
            "peak_estimate_bytes": float(peak)}
