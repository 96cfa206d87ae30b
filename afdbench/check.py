"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the finished requests that emitted a token inside the window, drawn from
the seed and holding the longest of them, is run through the plain float32 reference
(``afdbench.reference``): each prompt (made again by the engine's rule)
followed by the tokens the engine served. At every served token the gap
is the reference's best logit minus the reference's logit of the served
token; greedy decoding in exact arithmetic serves gap 0. The mean gap
over the sample's served tokens (or, where the cell's check file names
it, their 99th percentile) is compared with the cell's limit
(``afdbench/checks/<cell>.json``), and the tokens compared with the least
the sample has to hold (``judge``); the widest gap is reported beside
them.
The widest gap of some hundreds of tokens is set by the few near-ties in
them and swings from seed to seed as much as between the program and
the control; the mean separates them, and where the control's mean swings
too, the 99th percentile (``PERF.md``).

The control puts the reference computed as a float8 (e4m3) model (both
operands of every weight product rounded) in the program's place: at the
same positions it reads the gap of the token the float8 model ranks
first. It runs in the readings script
(``afdbench/readings.py``) and the tests, never in a benchmark run, and is
judged by the same ``judge``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from afdbench.reference.model import Reference, fp8_round, prompt_tokens
from afdbench.traffic import sub_seed


def sample(served, prompt_lens: Dict[int, int], seed: int,
           target_tokens: int) -> List[Tuple[int, int, List[int]]]:
    """(rid, prompt length, served tokens) of the longest finished request
    and then of others in an order drawn from ``seed``, until the sample
    holds ``target_tokens`` served tokens."""
    pool = [(r.rid, prompt_lens[r.rid], list(r.output)) for r in served
            if len(r.output)]
    if not pool:
        return []
    pool.sort(key=lambda x: (-(x[1] + len(x[2])), x[0]))
    out, rest = [pool[0]], pool[1:]
    rng = np.random.RandomState(sub_seed(seed, 2))
    for i in rng.permutation(len(rest)):
        if sum(len(o) for _, _, o in out) >= target_tokens:
            break
        out.append(rest[i])
    return out


# the gap statistics a cell's check file may hold to a limit
GAPS = (("mean_gap", "mean_logit_gap"), ("p99_gap", "p99_logit_gap"))


def judge(reading: dict, limits: dict) -> Tuple[bool, List[tuple]]:
    """``correct`` and the (name, value, limit) compared: each gap
    statistic the cell's check file names against its limit, the served
    tokens compared against the least the sample has to hold."""
    gaps = [(name, reading[key], float(limits[key]["limit"]))
            for key, name in GAPS if key in limits]
    if not gaps:
        raise ValueError("the check file names no gap statistic")
    tokens = ("served_tokens_compared", reading["tokens"],
              int(limits["min_tokens"]))
    ok = all(v <= lim for _, v, lim in gaps) and tokens[1] >= tokens[2]
    return bool(ok), gaps + [tokens]


def _sequences(smp, vocab: int, device) -> Tuple[list, list]:
    seqs, first = [], []
    for rid, plen, out in smp:
        toks = np.concatenate([prompt_tokens(rid, plen, vocab),
                               np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        first.append(plen - 1)
    return seqs, first


def _gaps(logits: Sequence[torch.Tensor], picks: Sequence[torch.Tensor]
          ) -> np.ndarray:
    """Best logit minus the logit of the picked token, at every row."""
    out = []
    for lg, pk in zip(logits, picks):
        best = lg.max(dim=-1).values
        got = lg.gather(1, pk.to(lg.device).long()[:, None])[:, 0]
        out.append((best - got).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def _summary(g: np.ndarray, seconds: float) -> dict:
    if g.size == 0:
        return {"max_gap": float("inf"), "p99_gap": float("inf"),
                "mean_gap": float("inf"), "mismatch": 1.0, "tokens": 0,
                "seconds": seconds}
    return {"max_gap": float(g.max()), "p99_gap": float(np.percentile(g, 99)),
            "mean_gap": float(g.mean()), "mismatch": float((g > 0).mean()),
            "tokens": int(g.size), "seconds": seconds}


def program_gap(arch: dict, params, smp, vocab: int, device) -> dict:
    """The gaps of the program's served tokens; an empty sample reads as
    no token compared (not correct)."""
    if not smp:
        return _summary(np.zeros(0), 0.0)
    t0 = time.perf_counter()
    seqs, first = _sequences(smp, vocab, device)
    logits = Reference(arch, params).logits(seqs, first)
    picks = [torch.as_tensor(out, device=device) for _, _, out in smp]
    return _summary(_gaps(logits, picks), time.perf_counter() - t0)


def control_gap(arch: dict, params, smp, vocab: int, device) -> dict:
    """The gaps of the tokens the float8 reference ranks first, at the
    positions of the same sequences; also the program's."""
    if not smp:
        out = _summary(np.zeros(0), 0.0)
        out["program"] = dict(out)
        return out
    t0 = time.perf_counter()
    seqs, first = _sequences(smp, vocab, device)
    ref = Reference(arch, params).logits(seqs, first)
    ctl = Reference(arch, params, quant=fp8_round).logits(seqs, first)
    picks = [c.argmax(dim=-1) for c in ctl]
    del ctl
    served = [torch.as_tensor(out, device=device) for _, _, out in smp]
    out = _summary(_gaps(ref, picks), time.perf_counter() - t0)
    out["program"] = _summary(_gaps(ref, served), 0.0)
    return out
