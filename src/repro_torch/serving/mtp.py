"""Multi-Token-Prediction / speculative-decoding acceptance harness.
Counterpart of ``repro.serving.mtp``.

The budget model (Eq. 1) relaxes the run-batch latency to SLO × L_accept.
This module *measures* L_accept for a (target, draft) pair with greedy
speculative decoding: the draft proposes ``k`` tokens autoregressively,
the target verifies them in one forward pass, and the accepted prefix
length (+1 for the target's own next token) is recorded.

Greedy acceptance (argmax match; ties go to the lowest token id, as
``jnp.argmax`` breaks them) is exact for greedy serving and gives the
statistical average acceptance length the paper's L_accept = 1.7
assumption stands in for.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class MTPStats:
    rounds: int = 0
    proposed: int = 0
    accepted: int = 0
    emitted: int = 0

    @property
    def l_accept(self) -> float:
        """Average tokens emitted per target forward (≥ 1)."""
        return self.emitted / self.rounds if self.rounds else 1.0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def _logits(model: Model, params, tokens: List[int]) -> torch.Tensor:
    t = torch.tensor([tokens], dtype=torch.int32, device=model.device)
    return model.forward(params, {"tokens": t})[0][0]


@torch.no_grad()
def speculative_generate(target: Model, target_params,
                         draft: Model, draft_params,
                         prompt, n_tokens: int,
                         k_draft: int = 4) -> Tuple[List[int], MTPStats]:
    """Greedy speculative decoding for a single sequence.

    prompt: (S,) token ids (a sequence or a 1-D tensor). Returns
    (generated tokens, stats). Verification runs full forwards (cache-free:
    the harness measures acceptance, not wall-clock).
    """
    stats = MTPStats()
    tokens = [int(t) for t in prompt]
    n_prompt = len(tokens)

    while stats.emitted < n_tokens:
        base = len(tokens)
        # draft proposes k tokens greedily
        d_tokens: List[int] = []
        for _ in range(k_draft):
            dl = _logits(draft, draft_params, tokens + d_tokens)
            d_tokens.append(int(torch.argmax(dl[-1])))
        # target verifies the whole block in one forward
        tl = _logits(target, target_params, tokens + d_tokens)
        accepted = 0
        for i, dt in enumerate(d_tokens):
            if int(torch.argmax(tl[base - 1 + i])) != dt:
                break
            accepted += 1
        # emit the accepted prefix + the target's own correction token
        emit = d_tokens[:accepted]
        emit.append(int(torch.argmax(tl[base - 1 + accepted])))
        tokens.extend(emit)
        stats.rounds += 1
        stats.proposed += k_draft
        stats.accepted += accepted
        stats.emitted += len(emit)
    return tokens[n_prompt:], stats


def effective_budget_relaxation(stats: MTPStats, slo_tpot: float) -> float:
    """T = SLO × L_accept (Eq. 1): the run-batch latency the measured
    acceptance length buys."""
    return slo_tpot * stats.l_accept
