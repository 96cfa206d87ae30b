"""The model the benchmark knows: the configurations draw the tensors they
drew before shared experts were laid out, and a configuration with shared
experts is added to a copy of the benchmark as new files only: its cell
is correct, and not correct against a reference that leaves the shared
expert out."""

from __future__ import annotations

import hashlib

import pytest
import torch

from afdbench import check as chk
from afdbench import harness, weights, work
from afdbench.reference import model
from afdbench.tests import tiny

ROOT = tiny.ROOT

# make_params(port, 2**31 + 5, float32, cpu) of each tiny configuration:
# sha256 over every leaf's shape and bytes, dict keys sorted (recorded
# before shared experts were laid out)
PARENT_HASHES = {
    "tiny-moe":
        "df27a994070aecad925e506be7f7c68351778ed61808dbeb0ba1fd1ed0d6d2fe",
    "tiny-hybrid":
        "fe2a72a094163a3bb59c267e491d9bc9670cb791dbcdf88ad46075e8ed529a3f"}
SEED = 2**31 + 51


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        h.update(str(tuple(leaf.shape)).encode())
        h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in (root / "afdbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


class _NoShared(model.Reference):
    """The reference with the shared expert's term left out."""

    def _moe(self, lp, h):
        return super()._moe({k: v for k, v in lp.items() if k != "shared"},
                            h)


@pytest.mark.parametrize("config", sorted(PARENT_HASHES))
def test_make_params_draws_the_tensors_it_drew_before(config):
    arch = tiny.CONFIGS[config]["port"]
    params = weights.make_params(arch, 2**31 + 5, torch.float32,
                                 torch.device("cpu"))
    assert _digest(params) == PARENT_HASHES[config]


def test_shared_experts_are_one_gated_mlp_in_the_moe_layer():
    arch = tiny.SHARED["port"]
    params = weights.make_params(arch, SEED, torch.float32,
                                 torch.device("cpu"))
    for lp in params["layers"]:
        assert lp["moe"]["shared"]["wi"].shape == (64, 2 * 48)
        assert lp["moe"]["shared"]["wo"].shape == (48, 64)
    assert "shared" not in weights.make_params(
        tiny.CONFIGS["tiny-moe"]["port"], SEED, torch.float32,
        torch.device("cpu"))["layers"][0]["moe"]


def test_token_flops_counts_the_shared_expert():
    arch = tiny.SHARED["port"]
    extra = work.token_flops(arch, 7) - work.token_flops(
        tiny.CONFIGS["tiny-moe"]["port"], 7)
    assert extra == 2 * 3 * 64 * 48 * arch["n_layers"]


def test_a_shared_expert_cell_is_added_as_files_and_is_correct(tmp_path):
    root = tiny.make_root(tmp_path)
    before = _files(root)
    tiny.add_shared(root)
    after = _files(root)
    # nothing of the copied benchmark changed; two files are new
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == [
        "afdbench/checks/tiny-shared-cell.json",
        "afdbench/configs/tiny-shared.json"]
    out = harness.run_cell(root, tiny.SHARED_CELL, seed=SEED, seconds=1.0,
                           trace=False, device="cpu")
    rec = out.record
    assert rec["correct"], out.notes
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert rec["checks"]["mean_logit_gap"]["limit"] == tiny.LIMIT


def test_a_reference_without_the_shared_expert_is_not_correct(
        tmp_path, monkeypatch):
    root = tiny.add_shared(tiny.make_root(tmp_path))
    monkeypatch.setattr(chk, "Reference", _NoShared)
    out = harness.run_cell(root, tiny.SHARED_CELL, seed=SEED, seconds=1.0,
                           trace=False, device="cpu")
    assert out.record["correct"] is False
    assert out.record["checks"]["mean_logit_gap"]["value"] > tiny.LIMIT


def test_an_empty_sample_is_not_correct():
    arch = tiny.CONFIGS["tiny-moe"]["port"]
    params = weights.make_params(arch, 3, torch.float32, torch.device("cpu"))
    reading = chk.program_gap(arch, params, [], arch["vocab_size"],
                              torch.device("cpu"))
    ok, checks = chk.judge(reading, {"mean_gap": {"limit": tiny.LIMIT},
                                     "min_tokens": 12})
    assert ok is False and reading["tokens"] == 0
    ctl = chk.control_gap(arch, params, [], arch["vocab_size"],
                          torch.device("cpu"))
    assert chk.judge(ctl, {"mean_gap": {"limit": tiny.LIMIT},
                           "min_tokens": 0})[0] is False
