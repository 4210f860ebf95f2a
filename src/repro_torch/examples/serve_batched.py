"""Serving example: batched prefill + continuous decode with a FROST cap
chosen from the DECODE roofline (memory-bound => deep caps near-free).

    # at smoke size on the CPU
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --device cpu --requests 8 --gen 24
    # stablelm-1.6b at its published width on the card (K4, K9 and the
    # ring decode sweep)
    PYTHONPATH=src python -m repro_torch.examples.serve_batched --full

The decode step's roofline terms come from ``launch.stepcost`` (the JAX
example parses its compiled step's HLO); its FLOPs equal the HLO's.
``--full`` serves the published config: the kernels take head dims of
64, 120 and 128, not the smoke configs' 32, so the card runs ``--full``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import device as _device
from repro_torch.configs import get_arch
from repro_torch.core import (BALANCED, H100_SXM, CapProfiler,
                              PowerCappedDevice, WorkloadProfile)
from repro_torch.data import DataConfig, TokenBatches
from repro_torch.launch import stepcost
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import (StepConfig, make_prefill_step,
                                       make_serve_step)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--full", action="store_true",
                    help="the published config (the card's); default the "
                         "smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None, device_spec=H100_SXM) -> dict:
    """Run the example; returns the decode step's ``flops`` and
    ``hbm_bytes``, the cap ``decision``, ``tok_per_s`` and the generated
    ``tokens`` (requests, gen[, n_cb])."""
    args = build_parser().parse_args(argv)
    dev = _device.resolve(args.device)
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke
    step_cfg = StepConfig(remat="none")
    params = tfm.prepare_params(bridge.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(0), dev), cfg)
    max_len = args.prompt_len + args.gen
    prefill = make_prefill_step(cfg, step_cfg, max_len=max_len)
    serve = make_serve_step(cfg, step_cfg)

    data = TokenBatches(DataConfig(seed=1, vocab_size=cfg.vocab_size,
                                   seq_len=args.prompt_len,
                                   global_batch=args.requests,
                                   n_codebooks=cfg.n_codebooks))
    prompts = torch.as_tensor(data.batch(0)["inputs"]).to(dev)

    def shape_tok(nxt):
        return nxt.reshape(args.requests, 1, -1) if cfg.n_codebooks \
            else nxt.reshape(args.requests, 1)

    with torch.no_grad():
        logits, cache = prefill(params, {"inputs": prompts})
        nxt = torch.argmax(logits, -1).to(torch.int32)
        tok0 = shape_tok(nxt)

        # FROST on the decode graph: ONE serve step's roofline
        flops, nbytes = stepcost.serve_step_cost(cfg, args.requests,
                                                 max_len)
        wl = WorkloadProfile(name=f"{cfg.name}-decode",
                             flops_per_step=flops, hbm_bytes_per_step=nbytes,
                             samples_per_step=args.requests)
        model = PowerCappedDevice(device_spec)

        class Probe:
            def probe(self, cap, duration_s):
                return model.probe(wl, cap, duration_s)

        d = CapProfiler(Probe(), policy=BALANCED).run()
        cfrac = wl.compute_fraction(device_spec)
        print(f"[frost] decode step: {flops/1e6:.1f} MFLOP / "
              f"{nbytes/1e6:.1f} MB (estimate) -> compute fraction "
              f"{cfrac:.2f} -> cap {d.cap:.0%} "
              f"(energy {d.predicted_energy_saving:+.1%}, "
              f"delay {d.predicted_delay_increase:+.1%})")

        # decode loop (greedy continuous batch)
        outs = [nxt]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tok = tok0
        for _ in range(args.gen - 1):
            nxt, cache = serve(params, cache, tok)
            tok = shape_tok(nxt)
            outs.append(nxt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    total = args.gen * args.requests
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "host CPU")
    print(f"[serve] {total} tokens in {dt*1e3:.0f} ms "
          f"({total/max(dt,1e-9):.0f} tok/s on {where})")
    tokens = torch.stack(outs, 1).cpu().numpy()
    print(f"[serve] first sequence: {tokens[0].ravel()[:20].tolist()}")
    return {"flops": flops, "hbm_bytes": nbytes, "decision": d,
            "tok_per_s": total / max(dt, 1e-9), "seconds": dt,
            "tokens": np.asarray(tokens)}


if __name__ == "__main__":
    main()
