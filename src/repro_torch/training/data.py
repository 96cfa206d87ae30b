"""Synthetic token pipeline. Counterpart of ``repro.training.data``.

Two generators:

  * ``kind="random"`` — i.i.d. uniform tokens (shape/throughput testing).
  * ``kind="markov"`` — a learnable synthetic language: tokens follow a
    fixed sparse Markov chain with injected noise, so cross-entropy has a
    known floor below log(V) and training loss measurably decreases.

Both are deterministic in (seed, step): a restart resumes the stream at
the exact batch index. Every draw is made on the same
``np.random.RandomState`` in the same order as JAX's (tokens; then the
branch choices, noise mask and noise tokens; then ``patch_embeds``; then
``frames``), so each batch is bit-identical to the JAX package's; only
then do the arrays become tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.common import ArchConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    kind: str = "markov"            # "markov" | "random"
    branching: int = 4              # successors per token in the chain
    noise: float = 0.05             # fraction of uniform-random tokens


def _transition_table(dc: DataConfig) -> np.ndarray:
    rng = np.random.RandomState(dc.seed + 1)
    return rng.randint(0, dc.vocab_size,
                       size=(dc.vocab_size, dc.branching)).astype(np.int32)


def make_batch(dc: DataConfig, step: int, cfg: Optional[ArchConfig] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Batch for global step ``step`` (a pure function of (dc, step)):
    ``tokens`` (B, S) int32, and ``patch_embeds`` / ``frames`` float32
    where ``cfg`` has a vision prefix / an encoder. ``device`` None means
    the CUDA device, as for ``Model``."""
    rng = np.random.RandomState((dc.seed * 1_000_003 + step) % (2 ** 31))
    b, s, v = dc.batch_size, dc.seq_len, dc.vocab_size
    if dc.kind == "random":
        tokens = rng.randint(0, v, size=(b, s)).astype(np.int32)
    else:
        table = _transition_table(dc)
        tokens = np.empty((b, s), np.int32)
        tokens[:, 0] = rng.randint(0, v, size=b)
        branch = rng.randint(0, dc.branching, size=(b, s))
        noise_mask = rng.rand(b, s) < dc.noise
        noise_tok = rng.randint(0, v, size=(b, s))
        for t in range(1, s):
            nxt = table[tokens[:, t - 1], branch[:, t]]
            tokens[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
    arrays = {"tokens": tokens}
    if cfg is not None and cfg.vision_seq:
        arrays["patch_embeds"] = (rng.randn(b, cfg.vision_seq, cfg.d_model)
                                  .astype(np.float32) * 0.02)
    if cfg is not None and cfg.is_encdec:
        arrays["frames"] = (rng.randn(b, cfg.encoder_seq, cfg.d_model)
                            .astype(np.float32) * 0.02)
    device = resolve_device(device)
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def batches(dc: DataConfig, cfg: Optional[ArchConfig] = None,
            start_step: int = 0,
            device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield make_batch(dc, step, cfg, device)
        step += 1


def entropy_floor(dc: DataConfig) -> float:
    """Approximate CE floor of the markov stream (nats): a uniform choice
    among ``branching`` successors plus the noise mixture."""
    p_clean = 1.0 - dc.noise
    h = -(p_clean * math.log(p_clean / dc.branching + dc.noise / dc.vocab_size))
    h += -(dc.noise * math.log(dc.noise / dc.vocab_size + 1e-30))
    return h
