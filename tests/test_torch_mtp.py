"""The port's MTP / speculative-decoding harness against the JAX
package's on JAX's qwen1.5-0.5b smoke weights (float32, the CPU): the
self-draft (every proposal accepted), JAX's own noisy draft (its
``tests/test_serving.py`` tree, 0.05 × N(0, 1) added to every float32
leaf: nothing accepted) and a draft with a tenth of that noise (partial
acceptance). The generated tokens and every ``MTPStats`` field must equal
JAX's exactly.

JAX's ``Model.init`` keys each parameter by Python's ``hash`` of its
name, which is salted per process; the weights here are drawn with the
name's CRC-32 instead, so every run sees the same ones.
"""

import contextlib
import dataclasses
import zlib
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import make_model as jmake_model  # noqa: E402
from repro.serving import mtp as jmtp  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.serving import mtp  # noqa: E402

ARCH = "qwen1.5-0.5b"


@contextlib.contextmanager
def stable_jax_keys():
    """JAX's per-name init keys from the name's CRC-32 (not ``hash``)."""
    def key_for(root, name):
        return jax.random.fold_in(root, zlib.crc32(name.encode()) % (1 << 31))
    with mock.patch.object(jcommon, "_key_for", key_for):
        yield


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jconfigs.get_smoke_config(ARCH), \
        tconfigs.get_smoke_config(ARCH)
    jm = jmake_model(jcfg)
    with stable_jax_keys():
        jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, make_model(tcfg, device="cpu"), tcfg


@pytest.mark.parametrize("noise,n_tokens,k_draft", [
    (0.0, 10, 3), (0.05, 12, 4), (0.005, 12, 4)],
    ids=["self", "noisy", "slightly-noisy"])
def test_speculative_generate_matches_jax(models, noise, n_tokens, k_draft):
    jm, jp, tm, tcfg = models
    jd = jax.tree_util.tree_map(
        lambda x: x + noise * jax.random.normal(jax.random.PRNGKey(7),
                                                x.shape, x.dtype)
        if x.dtype == jnp.float32 else x, jp) if noise else jp
    prompt = [1, 2, 3]
    want, jstats = jmtp.speculative_generate(
        jm, jp, jm, jd, jnp.asarray(prompt, jnp.int32), n_tokens=n_tokens,
        k_draft=k_draft)
    got, stats = mtp.speculative_generate(
        tm, params_from_jax(tcfg, _numpy_tree(jp), "cpu"), tm,
        params_from_jax(tcfg, _numpy_tree(jd), "cpu"),
        torch.tensor(prompt, dtype=torch.int32), n_tokens=n_tokens,
        k_draft=k_draft)
    assert got == [int(t) for t in want]
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    assert stats.l_accept == jstats.l_accept
    assert stats.acceptance_rate == jstats.acceptance_rate
    assert len(got) >= n_tokens
    if noise == 0.0:
        assert stats.acceptance_rate == 1.0 and stats.l_accept >= 3.0
    elif noise == 0.005:
        assert 0.0 < stats.acceptance_rate < 1.0
    assert mtp.effective_budget_relaxation(stats, 0.05) == \
        jmtp.effective_budget_relaxation(jstats, 0.05)


def test_mtp_stats_properties():
    s = mtp.MTPStats()
    assert s.l_accept == 1.0 and s.acceptance_rate == 0.0
    s = mtp.MTPStats(rounds=4, proposed=16, accepted=6, emitted=10)
    assert s.l_accept == 2.5 and s.acceptance_rate == 0.375
    assert mtp.effective_budget_relaxation(s, 0.04) == pytest.approx(0.1)
