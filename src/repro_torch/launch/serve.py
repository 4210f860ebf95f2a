"""Serving launcher of the PyTorch port — the CLI of ``repro.launch.serve``
plus ``--device``, over the port's continuous-batching engine.

    # continuous batching under a Poisson arrival trace, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --traffic poisson --shared-prefix-len 32 --prompt-pools 2

    # the same at smoke size on the CPU (plain torch paths, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --smoke --traffic poisson --device cpu

``--traffic poisson`` runs ``repro_torch.serving.ServeEngine``: requests
join fixed decode slots mid-stream (prefill-on-join into the paged KV
cache, suffix-only prefill on prefix-cache hits) and free on EOS / token
budget.  FROST (unless ``--no-frost``): every chunk emits one ``StepDone``
+ ``PowerSampled`` with the measured wall time and useful tokens; the
``OnlineCapProfiler`` amortises probes over the live stream against the
analytic H100 SXM device model, and J/token charges occupied slots only.

Not ported yet, each exits non-zero naming its ROADMAP.md item:
``--traffic batch`` (ring decode, kernel K5), ``--spec-k`` (speculative
decoding), ``--kv-dtype int8`` and ``--host-tier`` (KV tiers), ``--chaos``
and ``--snapshot-dir`` (chaos and snapshots).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.control import CapApplied, EventBus, StepDone
from repro_torch.control.online import OnlineCapProfiler
from repro_torch.core import (BALANCED, H100_SXM, PowerCappedDevice,
                              QoSPolicy, WorkloadProfile)
from repro_torch.core.profiler import RecordingBackend
from repro_torch.device import resolve
from repro_torch.runtime.fault import ServingSupervisor
from repro_torch.runtime.steps import StepConfig, with_decode_policy
from repro_torch.serving import (EnergyAwareAdmission, EngineConfig,
                                 ServeEngine, poisson_trace)
from repro_torch.telemetry.meters import (AnalyticDeviceMeter,
                                          CpuProcessMeter, DramMeter)
from repro_torch.telemetry.sampler import PowerSampler


class NotPorted(SystemExit):
    """A CLI feature of the JAX launcher this port does not serve yet."""

    def __init__(self, feature: str, item: str):
        super().__init__(f"[serve] {feature} is not yet ported to "
                         f"repro_torch (ROADMAP.md, {item})")


def _parse_kv_splits(value: str | int) -> str | int:
    """CLI form of ``KernelPolicy.kv_splits``: 'auto' or a positive int."""
    if value == "auto":
        return "auto"
    n = int(value)
    if n < 1:
        raise ValueError(f"--kv-splits must be 'auto' or >= 1, got {value!r}")
    return n


def decode_workload(cfg, requests: int,
                    tokens_per_step: float = 1.0) -> WorkloadProfile:
    """Decode-step roofline from first principles: every step streams the
    parameters from HBM once, with 2 FLOPs per parameter per live sequence
    on top (the JAX launcher's model)."""
    p = float(cfg.param_count())
    tps = max(tokens_per_step, 1.0)
    return WorkloadProfile(
        name=f"{cfg.name}-decode",
        flops_per_step=2.0 * p * max(requests, 1) * tps,
        hbm_bytes_per_step=2.0 * p,          # bf16 weights once per sweep
        samples_per_step=max(requests, 1) * tps,
    )


class FrostPlane:
    """The control-plane wiring for a serving run: bus, simulated capped
    H100, analytic meter + sampler, online profiler, cap ledger."""

    def __init__(self, cfg, n_slots: int, edp_exponent: float):
        self.bus = EventBus()
        self.backend = RecordingBackend()
        self.device = PowerCappedDevice(H100_SXM)
        self.cfg = cfg
        self.n_slots = n_slots
        self.meter = AnalyticDeviceMeter(self.device,
                                         decode_workload(cfg, n_slots))
        self.sampler = PowerSampler(
            {"gpu": self.meter, "cpu": CpuProcessMeter(),
             "dram": DramMeter(4, 16)},
            rate_hz=0.1, bus=self.bus, node_id="serve-0")
        self.cap_log = self.bus.tap(CapApplied)
        policy = QoSPolicy(policy_id=f"serve-ed{edp_exponent:g}p",
                           edp_exponent=edp_exponent) \
            if edp_exponent != BALANCED.edp_exponent else BALANCED
        self.profiler = OnlineCapProfiler(
            self.bus, self.backend, policy=policy, node_id="serve-0",
            model_id=cfg.name, steps_per_probe=1, hold_steps=8)
        self._step = 0

    def emit_chunk(self, n_useful: int, n_active: int, n_steps: int,
                   wall_s: float, tokens_scored: float = 1.0) -> float:
        """One chunk's telemetry: measured wall time + useful tokens feed
        the profiler; the cap in force shapes the modelled energy.
        Returns the chunk's J."""
        cap = self.backend.current_cap()
        wl = decode_workload(self.cfg, n_active,
                             tokens_per_step=tokens_scored)
        self.meter.set_cap(cap)
        self.meter.set_workload(wl, busy=True)
        est = self.device.estimate(wl, cap)
        energy_j = est.energy_j * max(n_steps, 1)
        self.sampler.sample_once()
        self.bus.publish(StepDone(node_id="serve-0", step=self._step,
                                  duration_s=wall_s, samples=n_useful,
                                  energy_j=energy_j, model_id=self.cfg.name))
        self._step += 1
        return energy_j

    def summary(self):
        caps = self.cap_log
        probes = sum(1 for c in caps if c.reason == "probe")
        decisions = [c for c in caps if c.reason == "decision"]
        timeline = " -> ".join(f"{c.cap:.0%}({c.reason[0]})" for c in caps[:12])
        print(f"[frost-ctrl] {len(caps)} cap commands mid-run "
              f"({probes} amortised probes, {len(decisions)} decisions): "
              f"{timeline}{' ...' if len(caps) > 12 else ''}")
        if self.profiler.decision is not None:
            d = self.profiler.decision
            print(f"[frost-ctrl] serving cap {d.cap:.0%} of TDP "
                  f"(pred. energy saving {d.predicted_energy_saving:+.1%}, "
                  f"delay {d.predicted_delay_increase:+.1%}, "
                  f"fit {'accepted' if d.fit_accepted else 'fallback'})")
        self.profiler.close()


def run_engine(args, cfg, step_cfg, params, frost: FrostPlane | None,
               device):
    """Continuous batching: Poisson arrivals into the paged-KV engine.
    Prints the JAX launcher's ``[serve]`` lines; returns the report."""
    greedy = args.temperature <= 0.0
    max_len = args.shared_prefix_len + args.prompt_len + args.gen
    ecfg = EngineConfig(n_slots=args.n_slots, page_size=args.page_size,
                        max_len=max_len, decode_chunk=max(1, args.decode_chunk),
                        n_pages=args.n_pages, greedy=greedy,
                        temperature=max(args.temperature, 1e-6),
                        sample_seed=args.sample_seed,
                        prefix_cache=not args.no_prefix_cache,
                        prefill_chunk=max(1, args.prefill_chunk),
                        preempt=not args.no_preempt,
                        max_skip=max(0, args.max_skip),
                        kv_splits=_parse_kv_splits(args.kv_splits),
                        decode_k_chunk=max(1, args.decode_k_chunk))

    def on_chunk(s):
        if frost is None:
            return None
        return frost.emit_chunk(s.tokens_kept, s.n_active,
                                ecfg.decode_chunk, s.wall_s,
                                tokens_scored=ecfg.spec_k + 1)

    pref = {"avoided_j": 0.0}

    def on_prefill(n_computed, n_saved):
        if frost is None:
            return None
        cap = frost.backend.current_cap()
        e_tok = frost.device.estimate(decode_workload(cfg, 1), cap).energy_j
        pref["avoided_j"] += e_tok * n_saved
        return e_tok * n_computed

    admission = None
    if args.power_budget > 0:
        dev_model = frost.device if frost is not None \
            else PowerCappedDevice(H100_SXM)
        admission = EnergyAwareAdmission(
            dev_model, lambda n: decode_workload(cfg, n), args.power_budget,
            backend=frost.backend if frost is not None else None)

    p_lo = min(max(4, args.prompt_len // 2), args.prompt_len)
    g_lo = min(max(2, args.gen // 2), args.gen)
    trace = poisson_trace(
        args.requests, rate_per_step=args.arrival_rate, seed=args.seed,
        vocab_size=cfg.vocab_size,
        prompt_len=(p_lo, args.prompt_len),
        max_new_tokens=(g_lo, args.gen),
        n_codebooks=cfg.n_codebooks, eos_id=args.eos_id,
        shared_prefix_len=args.shared_prefix_len,
        prompt_pools=args.prompt_pools)
    supervisor = ServingSupervisor(bus=frost.bus if frost is not None
                                   else None, node_id="serve-0")
    engine = ServeEngine(cfg, ecfg, params, step_cfg=step_cfg, device=device,
                         on_chunk=on_chunk, on_prefill=on_prefill,
                         admission=admission,
                         on_heartbeat=supervisor.on_heartbeat)
    rep = engine.run(trace)

    lat = rep.latency_percentiles((50, 95))
    waits = [r.wait_steps for r in rep.results if r.admit_step >= 0]
    print(f"[serve] engine: {len(rep.results)} requests over {rep.n_chunks} "
          f"chunks of {ecfg.decode_chunk} ({args.n_slots} slots, "
          f"page_size {args.page_size}, kv_splits {ecfg.kv_splits}, "
          f"decode_k_chunk {ecfg.decode_k_chunk}, "
          f"occupancy {rep.occupancy:.0%})")
    j_line = (f", {rep.j_per_token:.3g} J/token (occupied slots only)"
              if frost is not None else "")
    print(f"[serve] decode {rep.tokens_kept} useful / {rep.tokens_computed} "
          f"computed tokens in {rep.decode_wall_s*1e3:.0f} ms "
          f"({rep.tok_per_s:.0f} tok/s measured{j_line})")
    if ecfg.prefix_cache:
        j_avoid = ""
        if frost is not None and pref["avoided_j"] > 0:
            j_avoid = (f", ~{pref['avoided_j']:.3g} J prefill avoided "
                       "(modelled, in the J/token ledger)")
        print(f"[serve] prefix cache: {rep.prefix_hit_rate:.0%} of "
              f"{rep.prompt_tokens} prompt tokens restored "
              f"({rep.prefill_tokens_saved} saved), "
              f"{rep.n_preemptions} preemptions{j_avoid}")
    print(f"[serve] latency p50 {lat[50]:.0f} / p95 {lat[95]:.0f} steps; "
          f"queue wait mean {np.mean(waits):.1f} steps"
          if waits else "[serve] nothing admitted")
    derate = supervisor.workers[supervisor.node_id].derate
    if supervisor.n_derates_published:
        print(f"[supervisor] derate estimate {derate:.0%} "
              f"({supervisor.n_derates_published} NodeDerated published)")
    for r in rep.results[:4]:
        print(f"[serve]   rid={r.rid} L={r.prompt_len} "
              f"gen={r.n_tokens}/{r.max_new_tokens} wait={r.wait_steps} "
              f"lat={r.latency_steps} fin={r.finish_reason}"
              + (f" J/tok={r.j_per_token:.3g}" if frost is not None else ""))
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu; the card is required "
                         "unless cpu is named")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per decode chunk")
    ap.add_argument("--kv-splits", type=str, default="auto",
                    help="two-stage split-KV decode sweep: 'auto' picks by "
                         "the ops.choose_kv_splits occupancy model, an int "
                         "forces that split count (1 = single-stage sweep)")
    ap.add_argument("--decode-k-chunk", type=int, default=256,
                    help="split-K block (keys per grid step) for the ring "
                         "decode/verify kernels")
    ap.add_argument("--traffic", choices=("batch", "poisson"), default="batch",
                    help="batch: static fixed-batch baseline (not ported "
                         "yet); poisson: continuous-batching engine under "
                         "Poisson arrivals")
    ap.add_argument("--arrival-rate", type=float, default=0.25,
                    help="poisson arrivals per decode step")
    ap.add_argument("--n-slots", type=int, default=4,
                    help="decode slots (engine batch dimension)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV-cache page size (tokens per block)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="KV page pool size (default: fully provisioned; "
                         "smaller pools exercise preemption/requeue)")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"),
                    default="bfloat16",
                    help="KV page storage (int8: not ported yet)")
    ap.add_argument("--host-tier", action="store_true",
                    help="host-memory KV tier (not ported yet)")
    ap.add_argument("--host-pages", type=int, default=None)
    ap.add_argument("--transfer-j-per-byte", type=float, default=1e-9)
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help=">0: every prompt = pooled shared head of this "
                         "length + unique suffix")
    ap.add_argument("--prompt-pools", type=int, default=1,
                    help="number of distinct shared prefixes to draw from")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable prompt-prefix page sharing in the engine")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="suffix tokens per chunked-prefill verify sweep")
    ap.add_argument("--no-preempt", action="store_true",
                    help="reserve the whole context at admission instead "
                         "of lazy pages + preemption/requeue")
    ap.add_argument("--max-skip", type=int, default=2,
                    help="head-of-line skip-ahead window when the queue "
                         "head cannot get pages (0 = strict FIFO)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (not ported yet)")
    ap.add_argument("--drafter", choices=("ngram", "repeat"), default="ngram")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples with this temperature")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="free a slot early when this token is sampled")
    ap.add_argument("--power-budget", type=float, default=0.0,
                    help="W; >0 gates admission on predicted board draw")
    ap.add_argument("--chaos", type=str, default="",
                    help="fault schedule (not ported yet)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--snapshot-dir", type=str, default=None,
                    help="engine snapshots (not ported yet)")
    ap.add_argument("--snapshot-every", type=int, default=4)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--no-frost", action="store_true",
                    help="disable the FROST control plane (no sampler, "
                         "meters, or bus are even built)")
    ap.add_argument("--edp-exponent", type=float, default=2.0)
    return ap


def _refuse_unported(args) -> None:
    if args.traffic == "batch":
        raise NotPorted("--traffic batch (ring decode, kernel K5)",
                        "queue 2, item 1; pass --traffic poisson")
    if args.spec_k > 0:
        raise NotPorted("--spec-k (speculative decoding, kernel K6)",
                        "queue 2, item 3")
    if args.kv_dtype == "int8" or args.host_tier:
        raise NotPorted("--kv-dtype int8 / --host-tier (KV tiers)",
                        "queue 2, item 4")
    if args.chaos or args.snapshot_dir:
        raise NotPorted("--chaos / --snapshot-dir (chaos and snapshots)",
                        "queue 2, item 5")


def run(argv=None):
    """Parse ``argv``, serve, print the ``[serve]`` / ``[frost-ctrl]``
    lines; returns the engine's report."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = resolve(args.device)
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    step_cfg = with_decode_policy(StepConfig(),
                                  kv_splits=_parse_kv_splits(args.kv_splits),
                                  decode_k_chunk=max(1, args.decode_k_chunk))
    params = bridge.init_lm(cfg, torch.Generator().manual_seed(args.seed),
                            device)
    frost = None if args.no_frost else FrostPlane(cfg, args.n_slots,
                                                  args.edp_exponent)
    rep = run_engine(args, cfg, step_cfg, params, frost, device)
    if frost is not None:
        frost.summary()
    return rep


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
