"""The multi-pod dry-run's cells and placements against the JAX package:
``launch.shapes`` (the 40 cells, their skips, batch and cache stand-ins
at full width) and ``training.train.opt_state_shardings`` (AdamW and
Adafactor state specs on every arch)."""

import collections

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import shapes as jshp  # noqa: E402
from repro.models.model import make_model as jmake_model  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train import opt_state_shardings as jopt_shardings  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import shapes as tshp  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.models.transformer import encoder_config  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.train import opt_state_shardings  # noqa: E402

CELLS = [(a, s) for a in tconfigs.ARCH_IDS for s in tshp.SHAPES]


def test_forty_cells_thirty_three_run_jax_s_seven_skip():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(CELLS) == 40
    assert list(tshp.SHAPES) == list(jshp.SHAPES)
    for name, spec in tshp.SHAPES.items():
        j = jshp.SHAPES[name]
        assert (spec.name, spec.kind, spec.seq_len, spec.global_batch) == (
            j.name, j.kind, j.seq_len, j.global_batch)
    skipped = []
    for arch, shape in CELLS:
        got = tshp.cell_supported(tconfigs.get_config(arch), shape)
        assert got == jshp.cell_supported(jconfigs.get_config(arch), shape)
        assert tshp.tokens_processed(tconfigs.get_config(arch),
                                     tshp.SHAPES[shape]) == \
            jshp.tokens_processed(jconfigs.get_config(arch),
                                  jshp.SHAPES[shape])
        if not got[0]:
            skipped.append((arch, shape))
    assert len(skipped) == 7
    assert all(s == "long_500k" for _, s in skipped)


def _sd(shape, dtype) -> tuple:
    return tuple(int(d) for d in shape), str(dtype).split(".")[-1]


def _jax_leaves(tree, stacked: int = 0):
    """(shape, dtype) of every leaf, a scanned leaf counted once per
    period without its stack axis (the port's per-layer layout)."""
    out = collections.Counter()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if "stack" in keys and stacked:
            out[_sd(leaf.shape[1:], leaf.dtype)] += leaf.shape[0]
        else:
            out[_sd(leaf.shape, leaf.dtype)] += 1
    return out


def _port_leaves(tree):
    out = collections.Counter()

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif t is not None:
            out[_sd(t.shape, t.dtype)] += 1
    walk(tree)
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_match_jax(arch, shape):
    """Full width, all 40 cells: the batch stand-ins equal JAX's by name,
    shape and dtype; the decode cache's leaves equal JAX's (the stacked
    periods as one leaf per layer), enc-dec cross K/V included."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jspec, tspec = jshp.SHAPES[shape], tshp.SHAPES[shape]
    jb, tb = jshp.batch_specs(jcfg, jspec), tshp.batch_specs(tcfg, tspec)
    assert set(jb) == set(tb)
    for k in jb:
        assert tb[k].device.type == "meta"
        assert _sd(tb[k].shape, tb[k].dtype) == _sd(jb[k].shape, jb[k].dtype)
    if jspec.kind != "decode":
        return
    jc = jshp.cache_specs(jmake_model(jcfg), jspec)
    tc = tshp.cache_specs(Model(tcfg, device="cpu"), tspec)
    assert _port_leaves(tc) == _jax_leaves(jc, stacked=1)
    assert all(t.device.type == "meta" for t in
               shd.map_with_path(lambda _, x: x, tc["layers"][0]).values())


# ---------------------------------------------------------------------------
# optimizer-state shardings
# ---------------------------------------------------------------------------

def _norm(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _port_path(tcfg, parts, spec, tail, stacked_axis=True):
    """JAX's param path (with a stack axis for scanned leaves) as the
    port's per-layer paths and specs; ``stacked_axis=False`` for a spec
    that has already lost the stack entry."""
    def layers(prefix, rest, plan, idx, scanned):
        if not scanned:
            return {f"{prefix}/{idx}/{rest}": _norm(spec)}
        s = _norm(spec)
        if stacked_axis:
            assert not s or s[0] is None, s
            s = s[1:]
        n0, per = len(plan.prefix), len(plan.period)
        return {f"{prefix}/{n0 + p * per + idx}/{rest}": _norm(s)
                for p in range(plan.n_periods)}
    rest = lambda k: "/".join(parts[k:] + tail)  # noqa: E731
    if parts[0] == "decoder" and parts[1] in ("prefix", "stack"):
        return layers("layers", rest(3), tcfg.layer_plan(), int(parts[2]),
                      parts[1] == "stack")
    if parts[0] == "decoder":
        return {rest(1): _norm(spec)}
    if parts[:2] == ["encoder", "stack"] and parts[2] in ("prefix", "stack"):
        return layers("encoder/layers", rest(4),
                      encoder_config(tcfg).layer_plan(), int(parts[3]),
                      parts[2] == "stack")
    if parts[:2] == ["encoder", "stack"]:
        return {"encoder/" + rest(2): _norm(spec)}
    return {rest(0): _norm(spec)}


def _jax_opt_specs_as_port(tcfg, shardings) -> dict:
    """JAX's optimizer-state specs on the port's paths. A scanned 1-D
    parameter (a bias, a norm scale) is 2-D in JAX's stack, so JAX's
    Adafactor factors it: its vc (the parameter's spec, the stack dim
    dropped) is the port's unfactored v, and its vr (the stack dim alone)
    has no counterpart."""
    out = {}
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: hasattr(x, "spec"))
    for p, sh in leaves:
        parts = jshd._path_str(p).split("/")
        head, parts = parts[0], parts[1:]
        if head == "step":
            out["step"] = _norm(sh.spec)
            continue
        tail = [parts.pop()] if parts[-1] in ("vr", "vc", "v") else []
        scanned = "stack" in parts[:3]
        if scanned and tail and tail != ["v"] and _stacked_ndim(
                tcfg, parts) == 1:
            if tail == ["vc"]:
                for path, spec in _port_path(tcfg, parts, sh.spec, ["v"],
                                             stacked_axis=False).items():
                    out[f"{head}/{path}"] = spec
            continue
        for path, spec in _port_path(tcfg, parts, sh.spec, tail).items():
            out[f"{head}/{path}"] = spec
    return out


def _stacked_ndim(tcfg, parts) -> int:
    """The per-layer ndim of the scanned parameter at JAX path ``parts``."""
    params = _stacked_ndim.cache.get(tcfg.name)
    if params is None:
        params = _stacked_ndim.cache[tcfg.name] = jax.eval_shape(
            jmake_model(jconfigs.get_smoke_config(tcfg.name)).init,
            jax.random.PRNGKey(0))
    node = params
    for k in parts:
        node = node[int(k) if isinstance(node, list) else k]
    return len(node.shape) - 1


_stacked_ndim.cache = {}


def _port_opt_specs(state, specs) -> dict:
    out = {}

    def at(path, _):
        node = specs
        for key in path.split("/"):
            node = node[int(key) if isinstance(node, list) else key]
        out[path] = _norm(node)
    shd.map_with_path(at, state)
    return out


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_opt_state_shardings_match_jax(arch, optimizer):
    """AdamW's mu/nu mirror the parameter specs, its step is replicated;
    Adafactor's vr drops the last dim and vc the second-to-last, on the
    (2, 4) and (2, 2, 2) meshes under the training rules."""
    jcfg, tcfg = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    pshapes = jax.eval_shape(jmake_model(jcfg).init, jax.random.PRNGKey(0))
    jo, to = getattr(jopt, optimizer)(), getattr(topt, optimizer)()
    oshapes = jax.eval_shape(jo.init, pshapes)
    tparams = init_params(tcfg, seed=0, device="cpu")
    tstate = to.init(tparams)
    for sizes, names in (((2, 4), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        jmesh, tmesh = AbstractMesh(sizes, names), shd.MeshShape(names, sizes)
        for rname in ("TRAIN_RULES", "TRAIN_RULES_SP"):
            jr, tr = getattr(jshd, rname), getattr(shd, rname)
            want = _jax_opt_specs_as_port(tcfg, jopt_shardings(
                oshapes, jshd.params_shardings(pshapes, jmesh, jr), jmesh))
            got = _port_opt_specs(tstate, opt_state_shardings(
                tstate, shd.params_shardings(tparams, tmesh, tr), tmesh))
            assert got == want, (arch, optimizer, sizes, rname)
            assert np.all([isinstance(v, tuple) for v in got.values()])
