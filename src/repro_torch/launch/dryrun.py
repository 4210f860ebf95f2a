"""Dry-run of the port: every (architecture x input shape) cell planned on
a mesh, the counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host \
        [--device cpu]

Meshes: ``single`` (16 x 16) and ``multi`` (2 x 16 x 16) are the JAX
package's production meshes, abstract (``launch.mesh.AbstractMesh``);
``host`` is this host's cards (``make_host_mesh``: one on an H100).

Where the JAX dry-run lowers and compiles each cell's step with XLA, the
port builds the cell's inputs as meta tensors (``launch.specs``: nothing
is allocated), resolves their specs with the sharding rules and counts
the step with ``launch.stepcost``.  Each record keeps the JAX record's
field names:

  * ``flops_per_device`` / ``hbm_bytes_per_device`` — the step's
    ``stepcost`` figures over the device count (an even split: the port
    runs no SPMD partitioner; on one card, the step's own);
  * ``collective_bytes_per_device`` — 0 on ``host`` (one card), null on
    the abstract meshes, whose collectives only a compile would place;
  * ``memory.argument_bytes`` — exact: each argument leaf's bytes over
    the product of the sizes of the mesh axes its spec names;
    ``output_bytes`` and ``alias_bytes`` the same of the outputs and of
    the donated arguments (train state, decode cache);
  * ``fits`` — arguments plus outputs less aliases within the device's
    memory (16 GiB a chip on the production meshes, the card's
    ``total_memory`` on ``host``); activations are not counted;
  * null: ``seconds_compile``, ``xla_flops_raw``, ``xla_bytes_raw``,
    ``memory.temp_bytes``, ``memory.code_bytes`` (only an XLA compile has
    them).

One JSON a cell lands in ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>
<tag>.json``; a cell that fails is recorded with ``"status": "fail"`` and
the run exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import time
import traceback

import torch

from repro_torch.configs import ARCH_SPECS, SHAPES, get_arch
from repro_torch.configs.base import ArchSpec
from repro_torch.configs.shapes import Shape
from repro_torch.launch import specs as S
from repro_torch.launch import stepcost
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import opt_state_sharding
from repro_torch.runtime.sharding import (batch_sharding, build_rules,
                                          cache_sharding, per_device_bytes)
from repro_torch.runtime.steps import StepConfig

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")
CHIP_BYTES = 16 * 2 ** 30          # the production target's memory a chip


def device_memory(mesh_name: str, device) -> int:
    """Bytes one device of the mesh holds: 16 GiB a production chip, the
    card's total memory (or the host's RAM on the CPU) on ``host``."""
    if mesh_name != "host":
        return CHIP_BYTES
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def plan_cell(spec: ArchSpec, shape: Shape, mesh, step_cfg: StepConfig,
              memory: int, host: bool) -> dict:
    """Specs, per-device bytes and the step's cost of one cell: the
    record, JAX's fields."""
    cfg = spec.config
    t0 = time.time()
    rules = build_rules(cfg, mesh, sequence_shard=step_cfg.sequence_shard,
                        moe_strategy=step_cfg.moe_strategy)
    ins = S.input_specs(spec, shape, step_cfg)
    psh = rules.param_sharding(ins["axes"])
    gb, seq = shape.global_batch, shape.seq_len
    if ins["kind"] == "train":
        state_sh = {"params": psh,
                    "opt": opt_state_sharding(psh, ins["state"]["opt"]),
                    "step": ()}
        args = (ins["state"], ins["batch"])
        arg_sh = (state_sh, batch_sharding(rules, ins["batch"]))
        outs, out_sh = (ins["state"],), (state_sh,)
        alias = per_device_bytes(ins["state"], state_sh, mesh)
        cost = stepcost.analyze(cfg, "train", batch=gb, seq=seq,
                                n_micro=step_cfg.n_micro,
                                moment_dtype=step_cfg.optimizer.moment_dtype)
    elif ins["kind"] == "prefill":
        cache = S.abstract_cache(cfg, gb, ins["max_len"])
        cache_sh = cache_sharding(rules, cache, cfg)
        args = (ins["params"], ins["batch"])
        arg_sh = (psh, batch_sharding(rules, ins["batch"]))
        cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        logits = S.sds((gb,) + cb + (tfm.padded_vocab(cfg),), cfg.dtype)
        outs, out_sh = (logits, cache), (batch_sharding(rules, logits),
                                         cache_sh)
        alias = 0
        cost = stepcost.analyze(cfg, "prefill", batch=gb, seq=seq)
    else:                                          # decode
        cache_sh = cache_sharding(rules, ins["cache"], cfg)
        tok_sh = batch_sharding(rules, ins["tokens"])
        args = (ins["params"], ins["cache"], ins["tokens"])
        arg_sh = (psh, cache_sh, tok_sh)
        cb = (cfg.n_codebooks,) if cfg.n_codebooks else ()
        nxt = S.sds((gb,) + cb, torch.int32)
        outs, out_sh = (nxt, ins["cache"]), (batch_sharding(rules, nxt),
                                             cache_sh)
        alias = per_device_bytes(ins["cache"], cache_sh, mesh)
        cost = stepcost.analyze(cfg, "decode", batch=gb, seq=1,
                                max_len=seq)
    arg_bytes = sum(per_device_bytes(a, s, mesh) for a, s in zip(args,
                                                                  arg_sh))
    out_bytes = sum(per_device_bytes(o, s, mesh) for o, s in zip(outs,
                                                                 out_sh))
    n_dev = mesh.size
    return {
        "arch": spec.arch_id,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh.shape,
        "n_devices": int(n_dev),
        "seconds_lower": round(time.time() - t0, 3),
        "seconds_compile": None,
        "flops_per_device": cost["dot_flops"] / n_dev,
        "hbm_bytes_per_device": cost["hbm_bytes"] / n_dev,
        "collective_bytes_per_device": (cost["collective_bytes"] if host
                                        else None),
        "xla_flops_raw": None,
        "xla_bytes_raw": None,
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(out_bytes), "temp_bytes": None,
                   "alias_bytes": int(alias), "code_bytes": None},
        "device_memory_bytes": int(memory),
        "fits": bool(arg_bytes + out_bytes - alias <= memory),
        "collectives": cost["collectives"] if host else None,
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "step_cfg": {"n_micro": step_cfg.n_micro, "remat": step_cfg.remat,
                     "sequence_shard": step_cfg.sequence_shard,
                     "moe_strategy": step_cfg.moe_strategy},
    }


def default_step_cfg(spec: ArchSpec, shape: Shape) -> StepConfig:
    """Per-cell microbatching, JAX's: 8 micro-batches for a global batch
    of 64 or more, full remat."""
    if shape.kind != "train":
        return StepConfig(n_micro=1, remat="none")
    n_micro = 8 if shape.global_batch >= 64 else 1
    return StepConfig(n_micro=n_micro, remat="full")


def _padded(spec: ArchSpec, tp: int = 16) -> ArchSpec:
    """q / kv heads padded to the model axis' multiple (TP), as JAX's
    ``--pad-heads`` (a config the padding cannot serve raises, and its
    cell is recorded as failed; the port serves no padded heads, so its
    decode cells fail at the cache)."""
    cfg = spec.config
    hq = -(-cfg.n_heads // tp) * tp
    hkv = hq if cfg.n_kv_heads == cfg.n_heads else cfg.n_kv_heads
    if (hq, hkv) == (cfg.n_heads, cfg.n_kv_heads):
        return spec
    g = hq // hkv
    if (cfg.n_heads - 1) // g >= cfg.n_kv_heads:
        return spec
    return dataclasses.replace(spec, config=dataclasses.replace(
        cfg, pad_q_heads_to=hq, pad_kv_heads_to=hkv))


def run_cells(arch_ids, shape_names, meshes, out_dir: pathlib.Path,
              step_cfg: StepConfig | None = None, tag: str = "",
              pad_heads: bool = False, device=None) -> list[dict]:
    """Plan every cell of ``arch_ids`` x ``shape_names`` on each of
    ``meshes`` (single | multi | host); write one JSON a cell under
    ``out_dir/<mesh>/``; return the records."""
    results = []
    for mesh_name in meshes:
        if mesh_name == "host":
            mesh = make_host_mesh(device)
            dev = torch.device(mesh.device_type)
        else:
            mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
            dev = torch.device("meta")
        memory = device_memory(mesh_name, dev)
        mdir = out_dir / mesh_name
        mdir.mkdir(parents=True, exist_ok=True)
        for aid in arch_ids:
            spec = get_arch(aid)
            for sname in shape_names:
                shape = SHAPES[sname]
                if shape not in spec.shapes():
                    print(f"SKIP  {aid} x {sname} (long-context not "
                          f"applicable)")
                    continue
                scfg = step_cfg or default_step_cfg(spec, shape)
                label = f"{aid} x {sname} @ {mesh_name}"
                fname = mdir / f"{aid}__{sname}{tag}.json"
                try:
                    run_spec = (_padded(spec) if pad_heads
                                and spec.config.n_heads else spec)
                    rec = plan_cell(run_spec, shape, mesh, scfg, memory,
                                    host=mesh_name == "host")
                    rec["status"] = "ok"
                    fname.write_text(json.dumps(rec, indent=1))
                    mem = rec["memory"]
                    need = (mem["argument_bytes"] + mem["output_bytes"]
                            - mem["alias_bytes"])
                    print(f"OK    {label}: flops/dev="
                          f"{rec['flops_per_device']:.3e} args+outs/dev="
                          f"{need / 2 ** 30:.2f} GiB fits={rec['fits']}")
                except Exception as e:
                    rec = {"arch": aid, "shape": sname, "mesh": mesh_name,
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    fname.write_text(json.dumps(rec, indent=1))
                    print(f"FAIL  {label}: {type(e).__name__}: "
                          f"{str(e)[:200]}")
                results.append(rec)
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "host"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--n-micro", type=int, default=0,
                    help="override microbatches")
    ap.add_argument("--remat", default="", choices=["", "none", "dots", "full"])
    ap.add_argument("--sequence-shard", action="store_true")
    ap.add_argument("--moe-strategy", default="", choices=["", "gather", "a2a"])
    ap.add_argument("--pad-heads", action="store_true",
                    help="pad q/kv heads to the model-axis multiple (TP)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    ap.add_argument("--device", default=None,
                    help="the host mesh's devices: cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    arch_ids = [args.arch] if args.arch else list(ARCH_SPECS)
    shape_names = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    step_cfg = None
    if args.n_micro or args.remat or args.sequence_shard or args.moe_strategy:
        step_cfg = StepConfig(n_micro=args.n_micro or 1,
                              remat=args.remat or "full",
                              sequence_shard=args.sequence_shard,
                              moe_strategy=args.moe_strategy or "gather")
    results = run_cells(arch_ids, shape_names, meshes, pathlib.Path(args.out),
                        step_cfg, tag=args.tag, pad_heads=args.pad_heads,
                        device=args.device)
    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} cells planned OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
