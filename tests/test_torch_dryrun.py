"""The port's step costs and dry-run held against the JAX package on the
CPU: ``launch.stepcost``'s prefill and decode FLOPs equal the HLO
``dot_flops`` of JAX's compiled ``make_prefill_step`` / ``make_serve_step``
(``hloparse.analyze``) for one arch of each family at smoke shapes; the
dry-run over every cell on both production meshes writes only ``ok``
records, whose per-device argument bytes equal the sum computed from
JAX's own ``PartitionSpec``s and ``eval_shape`` shapes.  Torch runs on
one thread in every case (``one_torch_thread``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.launch import hloparse
from repro.launch import specs as jspecs
from repro.launch.dryrun import default_step_cfg as jax_default_step_cfg
from repro.models import transformer as jtfm
from repro.optim.adamw import opt_state_sharding as jopt_state_sharding
from repro.runtime import sharding as jsharding
from repro.runtime import steps as jsteps
from repro_torch.configs import ARCH_SPECS, SHAPES, all_cells, get_arch
from repro_torch.launch import dryrun, stepcost

# one arch of each family: dense GQA, MoE, MLA, SSM, hybrid, codebooks,
# VLM; (B, S, max_len): S 12 runs mamba2's sequential scan, S 128 its
# chunked scan (JAX's ``ops.ssd`` under ``auto``)
FAMILIES = [("smollm-135m", 2, 12, 20), ("phi3.5-moe-42b-a6.6b", 2, 12, 20),
            ("deepseek-v2-236b", 2, 12, 20), ("mamba2-370m", 2, 12, 20),
            ("mamba2-370m", 1, 128, 132), ("zamba2-1.2b", 2, 12, 20),
            ("musicgen-medium", 2, 12, 20), ("llava-next-34b", 2, 12, 20)]


def _jax_costs(arch, B, S, L):
    """HLO dot_flops of JAX's compiled prefill (B x S positions, an image
    prefix included) and serve step (a ring of L)."""
    cfg = jax_arch(arch).smoke
    sc = jsteps.StepConfig(remat="none")
    params = jax.eval_shape(lambda k: jtfm.init_lm(k, cfg)[0],
                            jax.random.PRNGKey(0))
    cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    batch = {"inputs": jax.ShapeDtypeStruct(
        (B, S - cfg.vision_tokens) + cb, jnp.int32)}
    if cfg.vision_tokens:
        batch["image_embeds"] = jax.ShapeDtypeStruct(
            (B, cfg.vision_tokens, cfg.d_model), jnp.dtype(cfg.dtype))
    prefill = jax.jit(jsteps.make_prefill_step(cfg, sc, max_len=L)).lower(
        params, batch).compile()
    cache = jax.eval_shape(lambda: jtfm.init_cache(cfg, B, L,
                                                   dtype=cfg.dtype))
    tok = jax.ShapeDtypeStruct((B, 1) + cb, jnp.int32)
    serve = jax.jit(jsteps.make_serve_step(cfg, sc)).lower(
        params, cache, tok).compile()
    return (hloparse.analyze(prefill.as_text())["dot_flops"],
            hloparse.analyze(serve.as_text())["dot_flops"])


@pytest.mark.parametrize("arch,B,S,L", FAMILIES,
                         ids=[f"{a}-S{s}" for a, _, s, _ in FAMILIES])
def test_step_costs_match_hlo(arch, B, S, L):
    """prefill_step_cost and serve_step_cost FLOPs equal JAX's HLO
    dot_flops exactly; ``analyze`` carries hloparse's keys, with no
    collective on one card."""
    jp, jd = _jax_costs(arch, B, S, L)
    cfg = get_arch(arch).smoke
    assert stepcost.prefill_step_cost(cfg, B, S)[0] == jp
    assert stepcost.serve_step_cost(cfg, B, L)[0] == jd
    rec = stepcost.analyze(cfg, "decode", batch=B, seq=1, max_len=L)
    assert rec["dot_flops"] == jd and rec["hbm_bytes"] > 0
    assert (rec["collective_bytes"], rec["collectives"]) == (0.0, {})


def _per_device_bytes(tree, shardings, mesh):
    """Each leaf's bytes over the product of the sizes of the mesh axes
    its JAX ``PartitionSpec`` names."""
    total = 0
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    assert len(leaves) == len(shs)
    for leaf, sh in zip(leaves, shs):
        n = 1
        for entry in sh.spec:
            for axis in ((entry,) if isinstance(entry, str)
                         else (entry or ())):
                n *= mesh.shape[axis]
        total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize \
            // n
    return total


def _jax_argument_bytes(spec, shape, mesh):
    cfg = spec.config
    scfg = jax_default_step_cfg(spec, shape)
    rules = jsharding.build_rules(cfg, mesh)
    ins = jspecs.input_specs(spec, shape, scfg)
    psh = rules.param_sharding(ins["axes"])
    if ins["kind"] == "train":
        rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
        state_sh = {"params": psh,
                    "opt": jopt_state_sharding(psh, ins["state"]["opt"],
                                               mesh),
                    "step": rep}
        pairs = [(ins["state"], state_sh),
                 (ins["batch"], jsharding.batch_sharding(rules,
                                                         ins["batch"]))]
    elif ins["kind"] == "prefill":
        pairs = [(ins["params"], psh),
                 (ins["batch"], jsharding.batch_sharding(rules,
                                                         ins["batch"]))]
    else:
        pairs = [(ins["params"], psh),
                 (ins["cache"], jsharding.cache_sharding(rules, ins["cache"],
                                                         cfg)),
                 (ins["tokens"], jsharding.batch_sharding(rules,
                                                          ins["tokens"]))]
    return sum(_per_device_bytes(t, s, mesh) for t, s in pairs)


def test_dryrun_all_cells_on_both_meshes(tmp_path, capsys):
    """Every cell on ``single`` and ``multi``: an ``ok`` record on disk
    with JAX's field names, the XLA-only ones null, per-device argument
    bytes equal to JAX's specs' sum; ``main`` exits 0 and names the
    count."""
    from repro.configs import ARCH_SPECS as JAX_SPECS
    recs = dryrun.run_cells(list(ARCH_SPECS), list(SHAPES),
                            ["single", "multi"], tmp_path)
    n_cells = len(list(all_cells()))
    assert len(recs) == 2 * n_cells
    meshes = {"single": AbstractMesh((16, 16), ("data", "model")),
              "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}
    for rec in recs:
        assert rec["status"] == "ok", rec.get("error")
        mesh_name = "multi" if "pod" in rec["mesh"] else "single"
        on_disk = json.loads((tmp_path / mesh_name / (
            f"{rec['arch']}__{rec['shape']}.json")).read_text())
        assert on_disk == json.loads(json.dumps(rec))
        assert rec["n_devices"] == (512 if mesh_name == "multi" else 256)
        for key in ("seconds_compile", "xla_flops_raw", "xla_bytes_raw",
                    "collective_bytes_per_device"):
            assert rec[key] is None
        assert rec["memory"]["temp_bytes"] is None
        assert rec["flops_per_device"] > 0
        jspec = JAX_SPECS[rec["arch"]]
        want = _jax_argument_bytes(jspec, SHAPES[rec["shape"]],
                                   meshes[mesh_name])
        assert rec["memory"]["argument_bytes"] == want, \
            (rec["arch"], rec["shape"], mesh_name)
    assert dryrun.main(["--arch", "smollm-135m", "--mesh", "single",
                        "--out", str(tmp_path / "cli")]) == 0
    assert f"{3}/{3} cells planned OK" in capsys.readouterr().out
