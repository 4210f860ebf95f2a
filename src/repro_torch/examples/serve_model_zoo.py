"""Serving example: the whole model zoo on ONE paged engine.

Every family of ``repro_torch/configs/`` — dense/MoE GQA, compressed-latent
MLA (deepseek), sliding-window, local/global, pure and hybrid SSM,
multi-codebook — serves through the same ``ServeEngine`` continuous-batching
loop; ``init_paged_cache`` picks the per-family page-pool layout (latent
pools, private windowed rings, O(1) state slots) behind one block-table
seam.  The optional seams (prefix cache, speculative, int8 pages) are
feature-gated per family and report the blocking config field by name.

    # at smoke size on the CPU
    PYTHONPATH=src python -m repro_torch.examples.serve_model_zoo \
        --device cpu --requests 3 --gen 8
    # at published widths on the card (K4, K8, K9, the sweeps)
    PYTHONPATH=src python -m repro_torch.examples.serve_model_zoo --full \
        --arches smollm-135m,h2o-danube-3-4b,mamba2-370m,zamba2-1.2b,musicgen-medium

``--full`` serves the published configs (the card's: the kernels take
head dims of 64, 120 and 128, not the smoke configs' 32).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import device as _device
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.serving import EngineConfig, ServeEngine, poisson_trace

ZOO = ["smollm-135m", "deepseek-v2-236b", "h2o-danube-3-4b",
       "gemma2-27b", "mamba2-370m", "zamba2-1.2b", "musicgen-medium"]
ENGINE = dict(n_slots=2, page_size=4, max_len=48, decode_chunk=4)


def kv_bytes_per_token(cfg, itemsize=2):
    """Decode-cache bytes one new token writes (the HBM the J/token
    metric charges per step; SSM state is O(1) so a token writes none)."""
    if cfg.use_mla:
        return (cfg.kv_lora_rank + cfg.rope_head_dim) * itemsize
    if cfg.uses_ssm and not cfg.hybrid_attn_every:
        return 0
    hd = cfg.head_dim or cfg.d_model // cfg.n_heads
    return 2 * cfg.padded_kv_heads * hd * itemsize


def gate_column(cfg) -> str:
    """The optional seams' gates: each one's first blocker, or ok."""
    return " ".join(f"{name}:{blk[0] if blk else 'ok'}" for name, blk in [
        ("int8", tfm.int8_paged_blockers(cfg)),
        ("spec", tfm.speculative_blockers(cfg)
         or tfm.chunked_prefill_blockers(cfg)),
        ("prefix", tfm.chunked_prefill_blockers(cfg))])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arches", default=",".join(ZOO))
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="the published configs (the card's); default the "
                         "smoke configs")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    """Serve each arch; returns {arch: EngineReport}."""
    args = build_parser().parse_args(argv)
    dev = _device.resolve(args.device)
    ecfg = EngineConfig(**ENGINE)
    reports = {}
    for arch in args.arches.split(","):
        spec = get_arch(arch)
        cfg = spec.config if args.full else spec.smoke
        params = bridge.init_lm(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        reqs = poisson_trace(args.requests, rate_per_step=0.3, seed=7,
                             vocab_size=cfg.vocab_size, prompt_len=(3, 13),
                             max_new_tokens=(args.gen // 2, args.gen),
                             n_codebooks=cfg.n_codebooks)
        t0 = time.perf_counter()
        rep = ServeEngine(cfg, ecfg, params, device=dev).run(reqs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        print(f"[{arch}] {rep.tokens_kept} tokens / {len(rep.results)} reqs "
              f"in {wall:.1f}s, {kv_bytes_per_token(cfg)} KV B/token, "
              f"{gate_column(cfg)}")
        first = np.asarray(rep.results[0].tokens).ravel()[:8].tolist()
        print(f"[{arch}] first stream: {first}")
        reports[arch] = rep
        del params
    return reports


if __name__ == "__main__":
    main()
