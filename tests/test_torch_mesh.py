"""The port's mesh tooling held against the JAX package on the CPU: the
int8 error-feedback all-reduce (``runtime.compress``) over gloo groups of
one and two ranks; the sharding rules (``runtime.sharding``) on JAX's
``AbstractMesh`` (16, 16) and (2, 16, 16) for every arch's published
config; the dry-run's meta-tensor specs (``launch.specs``) against JAX's
``eval_shape`` leaves; ``steps.make_serve_step`` and
``layers.moe_forward_a2a`` against JAX's at fp32 on bridged parameters.
Torch runs on one thread in every case (``one_torch_thread``)."""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from lm_parity import close, one_torch_thread  # noqa: F401
from lm_parity import models as _models
from repro.configs import all_cells as jax_all_cells
from repro.configs import get_arch as jax_arch
from repro.launch import specs as jspecs
from repro.launch.dryrun import default_step_cfg as jax_default_step_cfg
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.runtime import compress as jcompress
from repro.runtime import sharding as jsharding
from repro.runtime import steps as jsteps
from repro_torch.configs import ARCH_SPECS, all_cells, get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs
from repro_torch.launch.dryrun import default_step_cfg
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.runtime import compress, sharding, steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
# one JAX init and bridge an arch for the whole module
models = functools.lru_cache(maxsize=None)(_models)
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def gloo_group(tmp_path_factory):
    """A one-rank gloo group through a ``file://`` store, this worker's
    default group while the module runs."""
    if dist.is_initialized():
        yield dist.group.WORLD
        return
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# compress (JAX's tests/test_fault_tolerance.py:188-226 and
# tests/test_properties.py:184)
# --------------------------------------------------------------------------
def test_error_feedback_telescopes():
    """Sum of dequantized values + final residual == sum of true values,
    and every step's (q, scale, error) equals JAX's bit for bit."""
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=16).astype(np.float32) for _ in range(50)]
    e, je = torch.zeros(16), jnp.zeros(16)
    total_sent = torch.zeros(16)
    for x in xs:
        q, scale, e = compress.compress_residual(torch.tensor(x) + e)
        jq, jscale, je = jcompress.compress_residual(jnp.asarray(x) + je)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
        total_sent = total_sent + compress.dequantize_int8(q, scale)
    np.testing.assert_allclose((total_sent + e).numpy(), sum(xs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_quantize_error_bounded_by_half_step(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-100, 100, size=int(rng.integers(1, 65))) \
        .astype(np.float32)
    q, scale, err = compress.compress_residual(torch.tensor(x))
    assert float(err.abs().max()) <= float(scale) * 0.5 + 1e-6
    np.testing.assert_array_equal(
        err.numpy(), np.asarray(jcompress.compress_residual(
            jnp.asarray(x))[2]))


def test_compressed_psum_one_rank_matches_jax(gloo_group):
    """Over a one-rank gloo group: the mean of one (within a quantization
    step), output + error == input within 1e-6, both equal to JAX's
    ``shard_map`` over a one-device mesh."""
    g = {"w": np.asarray([0.5, -1.5, 2.0], np.float32),
         "b": np.asarray([[1e-3, -7.0], [3.0, 0.25]], np.float32)}
    mesh = jax.make_mesh((1,), ("pod",))
    from jax.sharding import PartitionSpec as P
    jg = jax.tree.map(jnp.asarray, g)
    spec = jax.tree.map(lambda _: P(), jg)
    jout, jerr = jcommon.shard_map(
        lambda a, b: jcompress.compressed_psum(a, "pod", b), mesh=mesh,
        in_specs=(spec, spec), out_specs=(spec, spec), check=False)(
        jg, jcompress.init_error_state(jg))
    tg = {k: torch.tensor(v) for k, v in g.items()}
    allreduce = compress.make_compressed_dp_allreduce(gloo_group)
    out, err = allreduce(tg, compress.init_error_state(tg))
    for k in g:
        np.testing.assert_allclose(out[k].numpy(), g[k], atol=0.03)
        np.testing.assert_allclose((out[k] + err[k]).numpy(), g[k],
                                   atol=1e-6)
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))


RANK_SCRIPT = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.runtime import compress
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=2)
rng = np.random.default_rng(10 + rank)
g = {"a": torch.tensor(rng.normal(size=(4, 5)).astype(np.float32)),
     "b": torch.tensor(rng.normal(size=7).astype(np.float32) * 3)}
e = {k: torch.tensor(rng.normal(size=v.shape).astype(np.float32) * 0.01)
     for k, v in g.items()}
red, err = compress.compressed_psum(g, dist.group.WORLD, e)
np.savez(out, **{f"g_{k}": v.numpy() for k, v in g.items()},
         **{f"e_{k}": v.numpy() for k, v in e.items()},
         **{f"r_{k}": v.numpy() for k, v in red.items()},
         **{f"n_{k}": v.numpy() for k, v in err.items()})
dist.destroy_process_group()
"""


def _jax_formula(g, e):
    """numpy of JAX's ``compressed_psum`` over the ranks' (g, e): int8 of
    g + e, SUM of the int32 values, MAX of the scales, / n."""
    qs, scales, errs = [], [], []
    for gi, ei in zip(g, e):
        x = (gi + ei).astype(np.float32)
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))
                           / np.float32(127.0))
        q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
        qs.append(q.astype(np.int32))
        scales.append(scale)
        errs.append(x - q.astype(np.float32) * scale)
    red = (sum(qs).astype(np.float32) * max(scales)) / np.float32(len(g))
    return red, errs


def test_compressed_psum_two_ranks(tmp_path):
    """Two gloo ranks spawned on the CPU: each rank's mean and error equal
    numpy of JAX's formula."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(r),
                               str(store), str(tmp_path / f"r{r}.npz")],
                              env=env)
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    res = [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(2)]
    for k in ("a", "b"):
        red, errs = _jax_formula([r[f"g_{k}"] for r in res],
                                 [r[f"e_{k}"] for r in res])
        for r in range(2):
            np.testing.assert_allclose(res[r][f"r_{k}"], red, rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(res[r][f"n_{k}"], errs[r],
                                       rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# sharding rules on the production meshes
# --------------------------------------------------------------------------
def _norm_spec(spec) -> tuple:
    """A spec as a tuple, one-name tuples as the name (JAX normalises
    ``P(("data",))`` to ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jspec_leaves(tree):
    """(path, normalised spec) of a tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {jax.tree_util.keystr(p): _norm_spec(tuple(s.spec))
            for p, s in flat}


def _tspec_leaves(tree):
    """(path, normalised spec) of the port's tree of spec tuples, keyed as
    JAX's ``keystr``."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + f"['{k}']")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + f"[{i}]")
        else:
            out[path] = _norm_spec(t)

    walk(tree, "")
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_SPECS))
def test_build_rules_match_jax(arch, mesh_name):
    """The table, batch axes and MoE strategy; every parameter leaf's
    spec; the decode caches' and every batch's specs — equal to JAX's on
    the same abstract mesh, gather and a2a."""
    sizes, names = MESHES[mesh_name]
    jmesh = AbstractMesh(sizes, names)
    tmesh_ = tmesh.make_production_mesh(multi_pod=mesh_name == "multi")
    assert tmesh_.shape == dict(jmesh.shape)
    cfg, jcfg = get_arch(arch).config, jax_arch(arch).config
    _, jaxes = jspecs.abstract_params(jcfg)
    _, taxes = specs.abstract_params(cfg)
    for strategy in ("gather", "a2a"):
        jr = jsharding.build_rules(jcfg, jmesh, moe_strategy=strategy)
        tr = sharding.build_rules(cfg, tmesh_, moe_strategy=strategy)
        assert tr.table == jr.table
        assert tr.batch_axes == jr.batch_axes
        assert tr.moe_strategy == jr.moe_strategy
        assert _tspec_leaves(tr.param_sharding(taxes)) == \
            _jspec_leaves(jr.param_sharding(jaxes))
    for shape in get_arch(arch).shapes():
        if shape.kind == "decode":
            jc = jspecs.abstract_cache(jcfg, shape.global_batch,
                                       shape.seq_len)
            tc = specs.abstract_cache(cfg, shape.global_batch,
                                      shape.seq_len)
            assert _tspec_leaves(sharding.cache_sharding(tr, tc, cfg)) == \
                _jspec_leaves(jsharding.cache_sharding(jr, jc, jcfg))
        for jb, tb in ((jspecs.train_batch_specs(jcfg, shape),
                        specs.train_batch_specs(cfg, shape)),
                       (jspecs.prefill_batch_specs(jcfg, shape),
                        specs.prefill_batch_specs(cfg, shape)),
                       ({"t": jspecs.decode_token_specs(jcfg, shape)},
                        {"t": specs.decode_token_specs(cfg, shape)})):
            assert _tspec_leaves(sharding.batch_sharding(tr, tb)) == \
                _jspec_leaves(jsharding.batch_sharding(jr, jb))


@pytest.mark.parametrize("seq_shard", [False, True])
def test_act_spec_and_constrain(seq_shard):
    """Activation specs equal JAX's on the production mesh; ``constrain``
    raises where a spec would shard and returns its input on a mesh of
    size-1 axes."""
    cfg = get_arch("gemma2-27b").config
    jr = jsharding.build_rules(jax_arch("gemma2-27b").config,
                               AbstractMesh((16, 16), ("data", "model")),
                               sequence_shard=seq_shard)
    tr = sharding.build_rules(cfg, tmesh.make_production_mesh(),
                              sequence_shard=seq_shard)
    for shape, logical in (((32, 64, 4608), ("batch", None, "embed_act")),
                           ((1, 64, 4608), ("batch", None, "embed_act")),
                           ((32, 16, 256000), ("batch", None, "vocab")),
                           ((32, 16, 32, 128),
                            ("batch", None, "q_heads", None)),
                           ((8, 16, 36864), ("batch", None, "mlp_act"))):
        x = jax.ShapeDtypeStruct(shape, jnp.float32)
        assert _norm_spec(tr.act_spec(x, logical)) == \
            _norm_spec(tuple(jr.act_spec(x, logical)))
    with pytest.raises(NotImplementedError, match="sharded"):
        tr.constrain(torch.empty((32, 64, 4608), device="meta"),
                     ("batch", None, "embed_act"))
    ones = sharding.build_rules(cfg, tmesh.AbstractMesh((1, 1),
                                                        ("data", "model")))
    x = torch.zeros(2, 3, 4608)
    assert ones.constrain(x, ("batch", None, "embed_act")) is x


def test_placements_on_a_host_mesh(gloo_group):
    from torch.distributed.tensor import Replicate, Shard
    host = tmesh.make_host_mesh("cpu", axes=("data", "model"))
    assert host.shape == {"data": 1, "model": 1}
    assert sharding.placements((("data",), None, "model"), host) == \
        [Shard(0), Shard(2)]
    assert sharding.placements((None,), host) == [Replicate(), Replicate()]
    rules = sharding.build_rules(get_arch("smollm-135m").config, host)
    x = torch.zeros(4, 2, 576)
    assert rules.constrain(x, ("batch", None, "embed_act")) is x


# --------------------------------------------------------------------------
# the dry-run's specs
# --------------------------------------------------------------------------
def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.dtype(leaf.dtype).name


def _arrays(ins) -> dict:
    return {k: v for k, v in ins.items()
            if k not in ("kind", "axes", "max_len")}


def _shape_leaves(ins, port: bool) -> dict:
    """{path: (shape, dtype)} of an ``input_specs`` dict's arrays, the
    paths in JAX's ``keystr`` form."""
    if port:
        flat = _tleaves(_arrays(ins))
    else:
        flat = ((jax.tree_util.keystr(p), v) for p, v in
                jax.tree_util.tree_flatten_with_path(_arrays(ins))[0])
    return {p: (tuple(v.shape), _dtype_name(v)) for p, v in flat}


def _tleaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tleaves(v, path + f"['{k}']")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tleaves(v, path + f"[{i}]")
    else:
        yield path, tree


def test_specs_match_jax_eval_shape():
    """Every cell's ``input_specs``: the same leaves, shapes and dtypes as
    JAX's ``eval_shape`` stand-ins (train state, params, batches, caches,
    decode tokens); the axes trees equal; nothing is allocated."""
    jcells = {(s.arch_id, sh.name): (s, sh) for s, sh in jax_all_cells()}
    cells = list(all_cells())
    assert [(s.arch_id, sh.name) for s, sh in cells] == list(jcells)
    for spec, shape in cells:
        jspec, jshape = jcells[spec.arch_id, shape.name]
        ins = specs.input_specs(spec, shape, default_step_cfg(spec, shape))
        jins = jspecs.input_specs(jspec, jshape,
                                  jax_default_step_cfg(jspec, jshape))
        assert ins["kind"] == jins["kind"]
        assert ins.get("max_len") == jins.get("max_len")
        assert _shape_leaves(ins, True) == _shape_leaves(jins, False), \
            (spec.arch_id, shape.name)
        assert ins["axes"] == jins["axes"], spec.arch_id
        assert all(t.device.type == "meta"
                   for _, t in _tleaves(_arrays(ins)))


# --------------------------------------------------------------------------
# make_serve_step and moe_forward_a2a at fp32
# --------------------------------------------------------------------------
def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-236b",
                                  "mamba2-370m"])
def test_make_serve_step_matches_jax(arch):
    """One serve step against the ring cache of a 12-token prefill: the
    greedy tokens equal JAX's, the logits (``greedy=False``) and the
    updated cache within 1e-5."""
    jcfg, params, tcfg, tparams = models(arch)
    cb = (tcfg.n_codebooks,) if tcfg.n_codebooks else ()
    toks = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (2, 12) + cb).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg, max_len=20))(
        params, jnp.asarray(toks))
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    sc = jsteps.StepConfig(remat="none")
    tsc = steps.StepConfig(remat="none")
    jn, jc1 = jax.jit(jsteps.make_serve_step(jcfg, sc))(params, jc,
                                                        jnp.asarray(tok))
    jlog, _ = jax.jit(jsteps.make_serve_step(jcfg, sc, greedy=False))(
        params, jc, jnp.asarray(tok))
    with torch.no_grad():
        tn, tc1 = steps.make_serve_step(tcfg, tsc)(
            tparams, _to_torch(jc), torch.tensor(tok))
        tlog, _ = steps.make_serve_step(tcfg, tsc, greedy=False)(
            tparams, _to_torch(jc), torch.tensor(tok))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.dtype == torch.int32
    close(tlog, jlog)
    jflat = dict(_tleaves(jax.tree.map(np.asarray, jc1)))
    for path, leaf in _tleaves(tc1):
        close(leaf, jflat[path])


def _moe_inputs(arch, B, S):
    jcfg, params, tcfg, tparams = models(arch)
    jffn = jax.tree.map(lambda a: a[0], params["layers"]["sub0"]["ffn"])
    tffn = {k: (v[0] if isinstance(v, torch.Tensor)
                else {kk: vv[0] for kk, vv in v.items()})
            for k, v in tparams["layers"]["sub0"]["ffn"].items()}
    x = np.random.default_rng(7).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    return jcfg, jffn, tcfg, tffn, x


@pytest.mark.parametrize("arch,B,S", [("deepseek-v2-236b", 2, 8),
                                      ("phi3.5-moe-42b-a6.6b", 2, 8),
                                      ("phi3.5-moe-42b-a6.6b", 2, 160)])
def test_moe_forward_a2a_matches_jax(gloo_group, arch, B, S):
    """The all-to-all dispatch on a (1, 1) mesh against JAX's own
    ``moe_forward_a2a`` on a (1, 1) mesh, at T <= 256 (lossless) and past
    it (capacity drops): the output within 1e-5 of its scale (outputs
    reach about 40: the two frameworks sum the experts' products in other
    orders), the aux loss within 1e-5."""
    jcfg, jffn, tcfg, tffn, x = _moe_inputs(arch, B, S)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jctx = jlayers.ParallelCtx(mesh=jmesh, batch_axes=("data",),
                               moe_strategy="a2a")
    jout, jaux = jax.jit(lambda p, v: jlayers.moe_forward(p, v, jcfg,
                                                          jctx))(
        jffn, jnp.asarray(x))
    host = tmesh.make_host_mesh("cpu", axes=("data", "model"))
    ctx = layers.ParallelCtx(mesh=host, batch_axes=("data",),
                             moe_strategy="a2a")
    with torch.no_grad():
        tout, taux = layers.moe_forward(tffn, torch.tensor(x), tcfg, ctx)
    close(tout, jout, 1e-5 * float(np.abs(np.asarray(jout)).max()))
    close(taux, jaux)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_moe_a2a_equals_local_without_drops(gloo_group, arch):
    """At one expert shard and T <= 256 (no token dropped by either) the
    all-to-all dispatch equals the local ``moe_forward`` within 1e-5 of
    the output's scale; the aux losses are equal."""
    _, _, tcfg, tffn, x = _moe_inputs(arch, 4, 16)
    host = tmesh.make_host_mesh("cpu")
    ctx = layers.ParallelCtx(mesh=host, batch_axes=("data",),
                             moe_strategy="a2a")
    with torch.no_grad():
        a2a, aux_a = layers.moe_forward(tffn, torch.tensor(x), tcfg, ctx)
        loc, aux_l = layers.moe_forward(tffn, torch.tensor(x), tcfg)
    close(a2a, loc.numpy(), 1e-5 * float(loc.abs().max()))
    assert float(aux_a) == float(aux_l)


def test_supports_paged_cache_and_all_cells():
    for arch in ARCH_SPECS:
        assert tfm.supports_paged_cache(get_arch(arch).config) == \
            jtfm.supports_paged_cache(jax_arch(arch).config)
    padded = dataclasses.replace(get_arch("smollm-135m").config,
                                 pad_q_heads_to=12)
    assert not tfm.supports_paged_cache(padded)
    assert len(list(all_cells())) == len(list(jax_all_cells())) == 33
