"""Roofline terms of a role program: the pricing half of
``repro.launch.hlo_analysis``.

The JAX module reads a compiled program's FLOPs and bytes from XLA's
``cost_analysis()`` and parses its collectives out of the HLO text. The
port compiles nothing: it runs one rank's program eagerly inside
``count_cost()``, a dispatch mode that

  * adds each aten op's FLOPs by ``torch.utils.flop_counter``'s formulas
    (matmul-like ops; XLA's count also holds elementwise work);
  * adds each aten op's operand and result bytes, views not counted; a
    gather (indexing) op counts the rows it reads, not its whole source,
    and an op that writes into one of its operands counts the bytes of its
    other operands, read and written (a cache read or write moves the rows
    it touches, not the cache);
  * records each collective the program notes (``note_collective``): its
    kind, its result bytes and its group's size (``collective_stats``);
    the buffers around it are built ``uncounted()``, since a collective is
    priced on the link;

and inside the three kernel ops (``kernels.ops``, whose work observer it
is) the counter is suspended and the kernel's own work on these inputs is
added instead (routed rows and visited experts, live keys), whichever
version ran. On fake tensors, whose values do not exist, the work of the
grouped GEMM and of split-KV is their bound on these shapes (every row
routed, min(experts, rows) experts visited; every key live), and the
counter names each kernel it bounded (``bounded``).

A program on DTensors (the multi-pod dry-run) is counted on each rank's
local ops: the counter lets DTensor unwrap its arguments and counts the
local ops it runs (DTensor's global-shape sharding propagation is not
counted), and records as collectives the functional collectives DTensor
emits (``_c10d_functional`` all-gather, reduce-scatter, all-reduce,
all-to-all) and the ``c10d`` collectives of the port's own
``parallel.collectives``, each with its group's size.
``PeakTracker`` follows the storages the program allocates to their
release and keeps the peak of their live bytes: the dry-run's memory
figure, which needs no allocation on fake tensors.

From a collective's result bytes R and group size S, as in JAX:

    operand bytes                           link bytes (ring model, egress
                                            per device — used for t_coll)
    all-reduce          R                    2·R·(S−1)/S
    all-gather          R/S                  R·(S−1)/S
    reduce-scatter      R·S                  R·(S−1)
    all-to-all          R                    R·(S−1)/S
    collective-permute  R                    R

Roofline terms per chip (the counts are already per device), priced on a
``Pricing`` entry:

    compute    = flops_dev / peak FLOP/s
    memory     = bytes_dev / HBM bytes/s
    collective = link_bytes_dev / link bytes/s

``TPUv5e`` is JAX's pricing (197e12, 819e9, 50e9 per ICI link), under
which ``roofline`` returns JAX's terms for the same inputs. ``H100`` is the
card: 989e12 bf16 dense FLOP/s (the data sheet's, not ``core.hardware``'s
Table 5 FP8 peak), 3.35e12 HBM bytes/s and 50e9 bytes/s of scale-out per
GPU (``HARDWARE["H100"]``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hardware import (HARDWARE, TPU_V5E_HBM_BW,
                                       TPU_V5E_ICI_BW, TPU_V5E_PEAK_FLOPS)
from repro_torch.kernels import ops as kops

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.int16: 2, torch.float16: 2,
    torch.bfloat16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

# ops that read only the rows their indices select
_GATHERS = (torch.ops.aten.index, torch.ops.aten.index_select,
            torch.ops.aten.gather, torch.ops.aten.embedding)
# allocations: no bytes move
_FACTORIES = ("empty", "empty_strided", "empty_like", "new_empty",
              "new_empty_strided")
# fills shaped like a template tensor: write their output, read nothing
_TEMPLATED = ("zeros_like", "ones_like", "full_like", "new_zeros",
              "new_ones", "new_full")

# collectives by op name: (functional form, result is the op's output;
# c10d in-place form, result is its first argument)
_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all"}
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_allgather_base_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all", "alltoall_": "all-to-all"}


# the wait of a functional collective returns its result again
_WAIT = torch.ops._c10d_functional.wait_tensor.default


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def _collective(func, args, out) -> Optional[Tuple[str, int, int]]:
    """(kind, result bytes, group size) of a collective op, else None."""
    ns, name = func.namespace, func._overloadpacket.__name__
    if ns == "_c10d_functional" and name in _FUNCTIONAL:
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = _resolve_process_group(args[-1])
        return _FUNCTIONAL[name], _nbytes(out), group.size()
    if ns == "c10d" and name in _C10D:
        import torch.distributed as dist
        i = [a.name for a in func._schema.arguments].index("process_group")
        group = args[i]
        if not isinstance(group, dist.ProcessGroup):
            group = dist.ProcessGroup.unbox(group)
        return _C10D[name], _nbytes(args[0]), group.size()
    return None


@contextlib.contextmanager
def _unseen_propagation(mode):
    """DTensor's sharding propagation runs each op once more on fake
    tensors of the global shapes, to learn its output's shape: neither
    the rank's work nor its memory, so ``mode`` (a counter or a tracker)
    is suspended there."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    # the uncached form where this torch has one (the cached one calls it)
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    original = getattr(ShardingPropagator, name)

    def propagate(self, op_schema):
        with mode.suspended():
            return original(self, op_schema)

    setattr(ShardingPropagator, name, propagate)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)

@dataclasses.dataclass(frozen=True)
class Pricing:
    """The hardware a program is priced on: per-chip peak FLOP/s, HBM
    bytes/s and link bytes/s."""
    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# bf16 dense peak of one H100 SXM (NVIDIA data sheet, 700 W)
H100_BF16_PEAK_FLOPS = 989e12

PRICING: Dict[str, Pricing] = {
    "TPUv5e": Pricing("TPUv5e", TPU_V5E_PEAK_FLOPS, TPU_V5E_HBM_BW,
                      TPU_V5E_ICI_BW),
    "H100": Pricing("H100", H100_BF16_PEAK_FLOPS, HARDWARE["H100"].hbm_bw,
                    HARDWARE["H100"].scale_out_bw),
}


def get_pricing(name: str) -> Pricing:
    try:
        return PRICING[name]
    except KeyError:
        raise KeyError(f"unknown pricing {name!r}; known: "
                       f"{sorted(PRICING)}") from None


def shape_bytes(dtype: torch.dtype, shape: Iterable[int]) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: Dict[str, int]
    link_bytes: Dict[str, int]
    counts: Dict[str, int]

    @property
    def total_operand(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_link(self) -> int:
        return sum(self.link_bytes.values())


def collective_stats(recorded: Iterable[Tuple[str, int, int]]
                     ) -> CollectiveStats:
    """Per-kind operand and ring-model link bytes (per device) of the
    collectives ``recorded``, each (kind, result bytes R, group size S)."""
    operand = {k: 0 for k in COLLECTIVE_OPS}
    link = {k: 0 for k in COLLECTIVE_OPS}
    counts = {k: 0 for k in COLLECTIVE_OPS}
    for op, r, s in recorded:
        s = max(int(s), 1)
        if op == "all-reduce":
            operand[op] += r
            link[op] += int(2 * r * (s - 1) / s)
        elif op == "all-gather":
            operand[op] += r // s
            link[op] += int(r * (s - 1) / s)
        elif op == "reduce-scatter":
            operand[op] += r * s
            link[op] += int(r * (s - 1))
        elif op == "all-to-all":
            operand[op] += r
            link[op] += int(r * (s - 1) / s)
        else:                       # collective-permute
            operand[op] += r
            link[op] += r
        counts[op] += 1
    return CollectiveStats(operand, link, counts)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(x) -> int:
    return sum(shape_bytes(t.dtype, t.shape) for t in _tensors(x))


class CostCounter(TorchDispatchMode):
    """FLOPs, bytes and collectives of the ops run under it (see the
    module's docstring). ``cost`` is the dict ``roofline`` reads."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = []          # (kind, result bytes, group size)
        self.bounded = set()           # kernels priced by their bound
        self._paused = 0
        self._dtensor = _dtensor_type()

    @property
    def cost(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes)}

    def add(self, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes

    @contextlib.contextmanager
    def suspended(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    @contextlib.contextmanager
    def kernel(self, work, *inputs):
        """A kernel op (``kernels.ops``' work observer): its own work on
        ``inputs``, ``work(*inputs)``, in place of what its version does;
        on fake tensors, its bound (``kops.bound_work``)."""
        from torch._subclasses.fake_tensor import is_fake
        with self.suspended():
            yield
            if any(is_fake(t) for t in _tensors(list(inputs))):
                bound = kops.bound_work(work)
                if bound is not work:
                    self.bounded.add(work.__name__[:-len("_work")])
                work = bound
            self.add(*work(*inputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented           # counted on the local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        coll = _collective(func, args, out)
        if coll is not None:
            self.collectives.append(coll)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        self.bytes += self._op_bytes(func, args, kwargs, out)
        return out

    @staticmethod
    def _op_bytes(func, args, kwargs, out) -> int:
        schema = func._schema
        aliases = [r.alias_info for r in schema.returns]
        if (aliases and all(a is not None and not a.is_write
                            for a in aliases)) or \
                func._overloadpacket is torch.ops.aten._unsafe_view or \
                func.namespace in ("prim", "_c10d_functional") or \
                func._overloadpacket.__name__ in _FACTORIES:
            return 0            # a view, an allocation, metadata, a wait
        if func._overloadpacket.__name__ in _TEMPLATED:
            return _nbytes(out)             # reads only the template's shape
        if func._overloadpacket in _GATHERS:
            index = [t for t in _tensors(args) if not t.is_floating_point()]
            return 2 * _nbytes(out) + _nbytes(index)
        written = [i for i, a in enumerate(schema.arguments)
                   if a.alias_info is not None and a.alias_info.is_write]
        if written:
            others = [a for i, a in enumerate(args) if i not in written]
            others += [v for k, v in kwargs.items()
                       if k not in {schema.arguments[i].name
                                    for i in written}]
            return 2 * _nbytes(others)
        return _nbytes(args) + _nbytes(list(kwargs.values())) + _nbytes(out)


# The counter ``count_cost`` has open, if any.
_OPEN = None


@contextlib.contextmanager
def uncounted():
    """Suspend the open cost counter, if any: a collective's buffers are
    priced on the link (its link bytes), not as HBM traffic."""
    if _OPEN is None:
        yield
    else:
        with _OPEN.suspended():
            yield


def note_collective(kind: str, result: torch.Tensor,
                    group_size: int) -> None:
    """Record in the open cost counter, if any, a collective of ``kind``
    with ``result`` over a group of ``group_size`` ranks."""
    if _OPEN is not None and not _OPEN._paused:
        _OPEN.collectives.append((kind, _nbytes(result), group_size))


@contextlib.contextmanager
def count_cost():
    """Count the FLOPs, bytes and collectives of the program run inside:
    yields the ``CostCounter``. The kernel ops add their own work."""
    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("count_cost does not nest")
    _OPEN = counter = CostCounter()
    previous = kops.set_work_observer(counter)
    try:
        with _unseen_propagation(counter), counter:
            yield counter
    finally:
        kops.set_work_observer(previous)
        _OPEN = None


class PeakTracker(TorchDispatchMode):
    """Peak live bytes of the storages the ops run under it allocate.

    Each op's output storage is counted once, from the op that makes it
    until Python releases it (a finalizer on the storage); views and
    in-place results (outputs that alias an input) add nothing. Storages
    made before the tracker opened (the program's arguments) are not
    counted. Works on fake tensors, which have storages but no memory; on
    DTensors it counts the local tensors."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._paused = 0
        self._sizes: Dict[int, int] = {}
        self._dtensor = _dtensor_type()

    def _release(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    @contextlib.contextmanager
    def suspended(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def __enter__(self):
        self._unseen = _unseen_propagation(self)
        self._unseen.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unseen.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self._paused or func is _WAIT or any(
                r.alias_info is not None for r in func._schema.returns):
            return out      # a view, an in-place result, a collective's wait
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._sizes or st.nbytes() == 0:
                continue
            self._sizes[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key)
        return out


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops_dev: float
    bytes_dev: float
    coll_operand_dev: float
    coll_link_dev: float
    coll_breakdown: Dict[str, int]
    coll_counts: Dict[str, int]
    chips: int
    # seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    priced_on: str = "TPUv5e"

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def total_lower_bound(self) -> float:
        """Perfect-overlap execution-time lower bound: max of the terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def compute_fraction(self) -> float:
        """Fraction of the bound spent in useful compute (roofline score)."""
        lb = self.total_lower_bound
        return self.t_compute / lb if lb > 0 else 0.0


def roofline(cost: Dict[str, float], coll: CollectiveStats, chips: int,
             hardware: str = "TPUv5e") -> RooflineTerms:
    hw = get_pricing(hardware)
    flops = float(cost.get("flops", 0.0))
    mem = float(cost.get("bytes accessed", 0.0))
    return RooflineTerms(
        flops_dev=flops, bytes_dev=mem,
        coll_operand_dev=float(coll.total_operand),
        coll_link_dev=float(coll.total_link),
        coll_breakdown=dict(coll.link_bytes),
        coll_counts=dict(coll.counts),
        chips=chips,
        t_compute=flops / hw.peak_flops,
        t_memory=mem / hw.hbm_bw,
        t_collective=float(coll.total_link) / hw.link_bw,
        priced_on=hw.name,
    )


def model_flops(n_params_active: float, n_tokens: int, train: bool) -> float:
    """6·N·D for training (fwd 2ND + bwd 4ND); 2·N·D for a forward pass."""
    return (6.0 if train else 2.0) * n_params_active * n_tokens


def improvement_hint(terms: RooflineTerms) -> str:
    d = terms.dominant
    if d == "collective":
        big = max(terms.coll_breakdown, key=terms.coll_breakdown.get)
        return (f"collective-bound ({big} dominates): reshard to remove the "
                f"{big} (split-KV / weight-stationary layout) or overlap it "
                "with compute")
    if d == "memory":
        return ("HBM-bound: raise arithmetic intensity — larger per-chip "
                "batch, fused kernels, or weight quantisation to cut bytes")
    return ("compute-bound: already at the roofline apex; gains come from "
            "cutting redundant FLOPs (remat policy, capacity factor)")
