"""The benchmark's plain reference against the program's plain path (the
AFD runtime on CPU tensors) at the configurations' smoke sizes, on the
benchmark's own weights. The test imports both; the reference imports
nothing of the program."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from afdbench import weights
from afdbench.reference.model import Reference, fp8_round, prompt_tokens


def _smoke(name: str, **changes):
    from repro_torch.configs import granite_moe_1b_a400m, jamba_v0_1_52b
    mod = {"granite": granite_moe_1b_a400m, "jamba": jamba_v0_1_52b}[name]
    return dataclasses.replace(mod.smoke_config(), **changes)


CASES = {"granite": ("granite", {}),
         # the benchmark serves Jamba without positional encoding
         "jamba": ("jamba", {"use_rope": False}),
         "jamba_rope": ("jamba", {})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_plain_path(case):
    from repro_torch.parallel.afd import AFDRuntime
    name, changes = CASES[case]
    cfg = _smoke(name, **changes)
    arch = dataclasses.asdict(cfg)
    params = weights.make_params(arch, 2**31 + 3, torch.float32,
                                 torch.device("cpu"))
    rt = AFDRuntime(cfg, params, device="cpu")
    toks = torch.as_tensor(prompt_tokens(7, 21, cfg.vocab_size))
    caches, pos = rt.init_cache(1, 32)
    got, _, _ = rt.prefill(toks[None].to(torch.int32), caches, pos, chunk=8)
    want = Reference(arch, params).logits([toks], [0])[0]
    scale = float(want.abs().max())
    assert float((got[0] - want).abs().max()) <= 1e-4 * scale
    # the float8 control departs from both
    ctl = Reference(arch, params, quant=fp8_round).logits([toks], [0])[0]
    assert float((ctl - want).abs().max()) > 1e-2 * scale


def test_prompts_are_the_engines():
    from repro_torch.serving.afd_engine import AFDServeEngine
    from afdbench.traffic import ArrivalEvent

    class Stub:
        class cfg:
            vocab_size = 49155

    for rid, n in ((0, 5), (12345, 300), (2**20, 1)):
        ev = ArrivalEvent(rid=rid, t=0.0, prompt_len=n, max_new_tokens=1)
        want = AFDServeEngine._make_prompt(Stub, ev)
        assert np.array_equal(prompt_tokens(rid, n, 49155), want)


def test_weights_repeat_from_the_seed():
    arch = dataclasses.asdict(_smoke("jamba"))
    a = weights.make_params(arch, 2**33 + 1, torch.float32,
                            torch.device("cpu"))
    b = weights.make_params(arch, 2**33 + 1, torch.float32,
                            torch.device("cpu"))
    c = weights.make_params(arch, 2**33 + 2, torch.float32,
                            torch.device("cpu"))
    wa, wb, wc = (p["layers"][1]["moe"]["wi"] for p in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert weights.param_bytes(a) > 0
