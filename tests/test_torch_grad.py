"""The port's training gradients and train step against the JAX package's,
float32 on the CPU, on JAX's weights (through ``bridge.params_from_jax``,
which maps JAX's gradient and AdamW-state trees the same way) and JAX's
batches:

  * for each of the 10 smoke archs, the port's autograd gradients of
    ``Model.loss`` against ``jax.grad`` of JAX's: every leaf present and
    finite, relative error ‖g_t − g_j‖ / max(‖g_j‖, 1e-12) ≤ 1e-4 per
    leaf. Over eight weight draws the worst leaf was ≤ 2.3e-6 in every
    arch but the Mamba decay leaves (``A_log``, ``dt_bias``): up to
    1.6e-5 (mamba2) and 9.8e-5 (Jamba), where the port's own SSD with
    another chunk size moves the same gradient by up to 5.5e-5 (its sum
    cancels);
  * three AdamW steps of ``build_step_fn`` (one batch, and two
    microbatches), each from JAX's params and state before it: metrics
    and the new ``mu``/``nu`` ≤ 1e-5 relative per leaf (measured ≤
    2.4e-6), the new params ≤ 1e-4 (measured 4e-6–5.5e-5). AdamW divides
    each gradient element by its root mean square plus eps, which turns
    float32 noise in near-zero gradient elements into O(lr) steps, so the
    params cannot meet the state's bound; compounded over steps, or on an
    arch whose gradients have many such elements (qwen's QKV biases under
    RoPE), the gap grows to 1e-3;
  * ``python -m repro_torch train`` in a subprocess on the CPU: 12 steps
    with a checkpoint every 6, then a rerun to 18 that resumes at 12.

JAX's ``Model.init`` keys each parameter by Python's ``hash`` of its
name, which is salted per process; the weights here are drawn with the
name's CRC-32 instead, so every run sees the same ones.
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import zlib
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import make_model as jmake_model  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.training.train import build_step_fn as jbuild  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models.model import make_model  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.checkpoint import _named  # noqa: E402
from repro_torch.training.train import TrainConfig, build_step_fn  # noqa: E402
from repro_torch.training.train import loss_and_grads  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
GRAD_RTOL = 1e-4
STATE_RTOL = 1e-5
PARAM_RTOL = 1e-4


@contextlib.contextmanager
def stable_jax_keys():
    """JAX's per-name init keys from the name's CRC-32 (not ``hash``)."""
    def key_for(root, name):
        return jax.random.fold_in(root, zlib.crc32(name.encode()) % (1 << 31))
    with mock.patch.object(jcommon, "_key_for", key_for):
        yield


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def _rel(t: torch.Tensor, j: torch.Tensor) -> float:
    t, j = t.double(), j.double()
    return float((t - j).norm() / j.norm().clamp(min=1e-12))


def _setup(arch, batch_size=2, seq_len=16):
    jcfg, tcfg = jconfigs.get_smoke_config(arch), \
        tconfigs.get_smoke_config(arch)
    jm, tm = jmake_model(jcfg), make_model(tcfg, device="cpu")
    with stable_jax_keys():
        jp = jm.init(jax.random.PRNGKey(0))
    kw = dict(batch_size=batch_size, seq_len=seq_len,
              vocab_size=tcfg.vocab_size)
    return (jcfg, tcfg, jm, tm, jp,
            params_from_jax(tcfg, _numpy_tree(jp), "cpu"),
            jdata.DataConfig(**kw), tdata.DataConfig(**kw))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_gradients_match_jax(arch):
    jcfg, tcfg, jm, tm, jp, tp, jdc, tdc = _setup(arch)
    jb, tb = jdata.make_batch(jdc, 0, jcfg), tdata.make_batch(tdc, 0, tcfg,
                                                              "cpu")
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b)[0]))(
        jp, jb)
    tl, _, tg = loss_and_grads(tm, tp, tb)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got, want = dict(_named(tg)), dict(_named(
        params_from_jax(tcfg, _numpy_tree(jg), "cpu")))
    assert sorted(got) == sorted(want) == sorted(dict(_named(tp)))
    for name, g in got.items():
        assert g.shape == want[name].shape and g.dtype == torch.float32
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, want[name]) <= GRAD_RTOL, (name, _rel(g, want[name]))


def _state_from_jax(tcfg, js):
    return {k: params_from_jax(tcfg, _numpy_tree(js[k]), "cpu", torch.float32)
            for k in ("mu", "nu")} | {
        "step": torch.tensor(int(js["step"]), dtype=torch.int32)}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_adamw_steps_match_jax(grad_accum):
    """granite-moe smoke (capacity MoE, aux loss, clip at 1.0): three
    ``build_step_fn`` AdamW steps on batches 0-2 of the markov stream, the
    port's each from JAX's params and state of the step before."""
    jcfg, tcfg, jm, tm, jp, tp, jdc, tdc = _setup("granite-moe-1b-a400m",
                                                  batch_size=4)
    jo, to = jopt.adamw(lr=1e-2), topt.adamw(lr=1e-2)
    jstep = jax.jit(jbuild(jm, jo, JTrainConfig(grad_accum=grad_accum)))
    tstep = build_step_fn(tm, to, TrainConfig(grad_accum=grad_accum))
    js = jo.init(jp)
    for i in range(3):
        tp = params_from_jax(tcfg, _numpy_tree(jp), "cpu")
        ts = _state_from_jax(tcfg, js)
        jp, js, jmet = jstep(jp, js, jdata.make_batch(jdc, i, jcfg))
        tp, ts, tmet = tstep(tp, ts, tdata.make_batch(tdc, i, tcfg, "cpu"))
        assert sorted(tmet) == sorted(jmet)
        for k in jmet:
            assert abs(float(tmet[k]) - float(jmet[k])) <= \
                STATE_RTOL * abs(float(jmet[k])), (i, k)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for tree, want, rtol in (
                (tp, params_from_jax(tcfg, _numpy_tree(jp), "cpu"),
                 PARAM_RTOL),
                ({k: ts[k] for k in ("mu", "nu")},
                 {k: v for k, v in _state_from_jax(tcfg, js).items()
                  if k != "step"}, STATE_RTOL)):
            got, want = dict(_named(tree)), dict(_named(want))
            assert sorted(got) == sorted(want)
            for name, t in got.items():
                err = _rel(t, want[name])
                assert err <= rtol, (i, name, err)


def _train(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch", "train"]
                         + args + ["--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return out.stdout


def test_train_driver_runs_and_resumes():
    with tempfile.TemporaryDirectory() as ckpt:
        common = ["--arch", "qwen1.5-0.5b", "--preset", "smoke", "--batch",
                  "4", "--seq", "32", "--ckpt-dir", ckpt, "--log-every", "6"]
        out1 = _train(common + ["--steps", "12", "--ckpt-every", "6"])
        assert "done: 12 steps" in out1 and "resumed" not in out1
        assert sorted(os.listdir(ckpt)) == ["step_000000006",
                                            "step_000000012"]
        out2 = _train(common + ["--steps", "18"])
        assert "resumed from step 12" in out2
        assert "done: 6 steps" in out2
        assert "entropy floor" in out2


def test_train_defaults_to_cuda():
    """``--device`` defaults to cuda: without a card the driver raises
    rather than training on the CPU; ``make_batch`` defaults to the card
    too."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch", "train",
                          "--arch", "qwen1.5-0.5b", "--preset", "smoke",
                          "--steps", "1"], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert "done:" not in res.stdout
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.make_batch(tdata.DataConfig(1, 4, 16), 0)
