"""The 3BO decode rotation of ``parallel.afd`` replayed from one CUDA graph.

At serving shapes a rotation (embeddings, every layer's mixers and M2N
cycles for every micro-batch, the head and ``pos + 1``) is some ten
thousand small launches, each enqueued by a Python call; the host, not the
card, sets its pace. Its shapes are static in the serve and it waits on the
host nowhere, so ``AFDRuntime.decode_step_3bo`` captures it once into a
``torch.cuda.CUDAGraph`` and replays it:

* ``applies`` says whether a runtime's rotations can be captured: the A
  role and every F device are one CUDA device, and the kernels are the
  CUDA ones.
* ``rotation_key`` names what a captured rotation is bound to: ``n_bo``,
  the tokens' and positions' shape, stride, dtype and device (they are
  copied into the graph's own buffers, so their addresses do not matter),
  and every cache tensor's address as well (the graph reads and writes the
  caches where they lie).
* ``capture`` records a rotation into a graph; ``CapturedRotation.replay``
  copies a call's tokens and positions into the graph's buffers on the
  stream, replays it and returns copies of its logits and ``pos + 1``, so a
  caller keeps what it was given as from the rotation run call by call.

A replay runs no Python of the rotation, so what that Python does besides
the device work is recorded at capture (``SideEffects``) and done again
once per replay: the runtime's M2N records (``AFDStats.record``, which the
serving engine checks against Eq. 9/17) and the calls the kernel front
door's work observer (``ops.set_work_observer``) would have seen. The
kernels' launch counters (``kernels.ops.launch_counts``) count the
launches issued into the capture once and nothing of a replay; the runtime
counts its replays (``AFDRuntime.replays``). The work of a call depends on
values computed inside the rotation (the grouped GEMM's group sizes,
split-KV's lengths): the captured rotation keeps those tensors, which lie
in the graph's pool and are rewritten by every replay, and a replay under
an observer hands it clones of them, taken after the replay on the
stream. The observer's other inputs are meta tensors of the captured
shapes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import trace
from repro_torch.kernels import ops
from repro_torch.kernels import splitkv_attention as _skv


_UNOBSERVED = contextlib.nullcontext()


def applies(a_device: torch.device, f_devices: Sequence[torch.device],
            impl: Optional[str]) -> bool:
    """Whether the rotation of a runtime on these devices and kernels can
    be captured: one CUDA device for both roles, and the CUDA kernels."""
    if impl == "plain" or a_device.type != "cuda":
        return False

    def index(d: torch.device) -> int:
        return torch.cuda.current_device() if d.index is None else d.index
    return all(d.type == "cuda" and index(d) == index(a_device)
               for d in f_devices)


def _layout(t: torch.Tensor) -> tuple:
    return t.dtype, t.device, tuple(t.shape), t.stride()


def rotation_key(micro_batches, n_bo: int) -> tuple:
    """What a captured rotation is bound to, for ``decode_step_3bo``'s
    ``micro_batches`` (tokens, caches, pos) and ``n_bo``."""
    return (n_bo,) + tuple(
        (_layout(tokens), _layout(pos),
         tuple((name, t.data_ptr()) + _layout(t)
               for cache in caches for name, t in cache.items()))
        for tokens, caches, pos in micro_batches)


class _Records(list):
    """Stands in for ``AFDRuntime.stats`` while side effects are recorded:
    the arguments of each ``record`` call."""

    def record(self, *args) -> None:
        self.append(args)


class _Calls(list):
    """The work observer while side effects are recorded: each kernel
    call's work function and inputs, a meta tensor for each tensor input
    but those whose values the work reads (``ops.VALUE_INPUTS``), which
    are kept as they are."""

    def kernel(self, work, *inputs):
        keep = ops.VALUE_INPUTS.get(work, ())
        self.append((work, tuple(
            torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                device="meta")
            if isinstance(x, torch.Tensor) and i not in keep else x
            for i, x in enumerate(inputs))))
        return _UNOBSERVED


class SideEffects:
    """What a rotation does besides its device work: its M2N records and
    the calls the work observer saw, with the tensors of the values those
    calls read."""

    def __init__(self, records, calls):
        self.records: List[tuple] = records
        self.calls: List[tuple] = calls

    @classmethod
    def during(cls, rt, body):
        """``body()``'s result and side effects, which it leaves undone:
        ``rt.stats`` and the caller's observer see nothing of it."""
        calls, records = _Calls(), _Records()
        stats, rt.stats = rt.stats, records
        observer = ops.set_work_observer(calls)
        try:
            out = body()
        finally:
            rt.stats = stats
            ops.set_work_observer(observer)
        return out, cls(list(records), list(calls))

    def replay(self, stats, observer) -> None:
        """Do them again: each M2N record into ``stats`` and each call
        reported to ``observer`` (if any) inside the range it returns,
        with one clone of each value tensor as it is now."""
        for args in self.records:
            stats.record(*args)
        if observer is None:
            return
        clones: Dict[int, torch.Tensor] = {}

        def now(x):
            if not isinstance(x, torch.Tensor) or x.is_meta:
                return x
            if id(x) not in clones:
                clones[id(x)] = x.clone()
            return clones[id(x)]
        for work, inputs in self.calls:
            with observer.kernel(work, *map(now, inputs)):
                pass


class CapturedRotation:
    """One rotation in a CUDA graph, with its own token and position
    buffers per micro-batch, its outputs and its side effects (whose value
    tensors it holds, so they keep their place in the graph's pool). It
    holds no reference to a caller's caches, only their addresses in
    ``key``; it holds the split-KV workspace the graph was captured
    with."""

    def __init__(self, key, graph, tokens, pos, outs, effects, workspace):
        self.key = key
        self.graph = graph
        self.tokens: List[torch.Tensor] = tokens
        self.pos: List[torch.Tensor] = pos
        self.outs: List[Tuple[torch.Tensor, torch.Tensor]] = outs
        self.effects: SideEffects = effects
        self._workspace = workspace

    def replay(self, rt, micro_batches):
        """The rotation of ``micro_batches``, whose key is this one's: the
        list of (logits, caches, pos + 1) the eager rotation returns."""
        for (tokens, _, pos), t_in, p_in in zip(micro_batches, self.tokens,
                                                self.pos):
            t_in.copy_(tokens)
            p_in.copy_(pos)
        self.graph.replay()
        out = [(logits.clone(), list(caches), pos.clone())
               for (logits, pos), (_, caches, _) in zip(self.outs,
                                                        micro_batches)]
        self.effects.replay(rt.stats, ops.work_observer())
        return out


def capture(rt, micro_batches, key) -> CapturedRotation:
    """Capture ``rt``'s rotation of ``micro_batches`` (eager once already
    with this key, so every workspace it uses exists) into a CUDA graph.
    Nothing runs: the caller replays it."""
    tokens = [t.clone() for t, _, _ in micro_batches]
    pos = [p.clone() for _, _, p in micro_batches]
    mbs = [(t, caches, p)
           for t, (_, caches, _), p in zip(tokens, micro_batches, pos)]
    graph = torch.cuda.CUDAGraph()
    trace.count("sync.graph_capture")     # the capture waits for the device
    with torch.cuda.graph(graph):
        outs, effects = SideEffects.during(rt, lambda: rt._rotation(mbs))
    return CapturedRotation(key, graph, tokens, pos,
                            [(lg, p) for lg, _, p in outs], effects,
                            _skv.workspace_tensors())
