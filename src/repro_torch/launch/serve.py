"""Serving launcher of the PyTorch port — the CLI of ``repro.launch.serve``
plus ``--device``.

    # static batch (the default traffic), on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 8 --prompt-len 512 --gen 33

    # continuous batching under a Poisson arrival trace, speculative
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --traffic poisson --shared-prefix-len 32 --prompt-pools 2 --spec-k 3

    # gemma2-27b at full width (54.5 GB of bf16 weights) on one H100
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --requests 4 --prompt-len 512 --gen 33

    # mamba2-370m at full width and depth (SSM state slots, no KV cache)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --traffic poisson --requests 8 --n-slots 4

    # musicgen-medium (tokens of 4 codebooks) or zamba2-1.2b (Mamba2 layers
    # and one shared attention block) at full width and depth
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --traffic poisson --requests 8 --n-slots 4

    # int8 KV pages with the host-memory tier under a tight page pool
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --traffic poisson --shared-prefix-len 32 --prompt-pools 2 \
        --kv-dtype int8 --host-tier --n-pages 10

    # at smoke size on the CPU (plain torch paths, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --smoke --device cpu

    # the static batch over 4 ranks (torchrun; NCCL with a card a rank,
    # gloo where ranks share one): each rank decodes its rows
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch smollm-135m --requests 8 --prompt-len 512 --gen 33

Two traffic modes:

  * ``batch`` — the fixed-batch run-to-completion baseline: one prefill,
    then decode chunks over the ring-buffer cache.  The last chunk runs
    whole and its overrun is discarded.
  * ``poisson`` — ``repro_torch.serving.ServeEngine``: requests join fixed
    decode slots mid-stream (prefill-on-join into the paged KV cache,
    suffix-only prefill on prefix-cache hits) and free on EOS / token
    budget.

``--spec-k K`` makes either mode speculative: each cache sweep verifies K
self-drafted tokens plus one bonus (``--drafter ngram`` or ``repeat``);
greedy output is identical to the plain loop's.  As in the JAX launcher,
the model's blockers decide: gemma2's windowed layers allow it on the
batch path and refuse it in the engine (``local_global``); mamba2's
and zamba2's recurrent state refuses it in both (``uses_ssm``), and so do
musicgen's codebooks (``n_codebooks``).  A codebook model's tokens are
(B, S, n_cb): the batch path feeds (B, 1, n_cb) a step and samples each
codebook over its own logits.

``--kv-dtype int8`` stores the engine's KV pages as int8 rows with per-row
fp32 scales (a family blocked by ``int8_paged_blockers`` warns once and
keeps its cache dtype, as in JAX); ``--host-tier`` pages cold prefix pages
out to host memory (``--host-pages`` of them) and back on a hit, each
direction charged at ``--transfer-j-per-byte``.  With the FROST plane on,
a page is paged out only when its round trip costs less than recomputing
its rows, priced from the plane's device model.

FROST (unless ``--no-frost``): every chunk emits one ``StepDone`` +
``PowerSampled`` with the measured wall time and useful tokens; the
``OnlineCapProfiler`` amortises probes over the live stream against the
analytic H100 SXM device model, and J/token charges useful tokens only.

Chaos drills (poisson mode): ``--chaos "kind@step[:duration[:arg]],..."``
schedules faults on the engine clock (``--chaos-seed`` seeds the
corruption sites).  An armed ``engine_crash`` snapshots every
``--snapshot-every`` chunks into ``--snapshot-dir`` (a temporary directory
when none is given) and restores from the last snapshot, up to
``--max-restarts`` times; ``bus_drop`` / ``bus_delay`` disturb the FROST
plane's bus through a ``ChaosBus``.  Two ``[chaos]`` lines sum it up:

    # crash-restore under an emergency cap, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --smoke --device cpu --traffic poisson \
        --chaos engine_crash@6,emergency_cap@2:4:0.5

A config whose weights alone exceed the card's free memory exits non-zero,
naming it (``refuse_oversized``), before any weight is drawn.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.control import CapApplied, EventBus, StepDone
from repro_torch.control.online import OnlineCapProfiler
from repro_torch.core import (BALANCED, H100_SXM, PowerCappedDevice,
                              QoSPolicy, WorkloadProfile)
from repro_torch.core.profiler import RecordingBackend
from repro_torch.data import DataConfig, TokenBatches
from repro_torch.device import resolve
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.runtime import speculate
from repro_torch.runtime.chaos import ChaosBus, FaultInjector
from repro_torch.runtime.fault import ServingSupervisor
from repro_torch.runtime.steps import (StepConfig, make_decode_loop,
                                       make_prefill_step,
                                       make_speculative_decode_loop, sample,
                                       with_decode_policy)
from repro_torch.serving import (EnergyAwareAdmission, EngineConfig,
                                 EngineCrash, ServeEngine, batch_trace,
                                 poisson_trace)
from repro_torch.telemetry.meters import (AnalyticDeviceMeter,
                                          CpuProcessMeter, DramMeter)
from repro_torch.telemetry.sampler import PowerSampler


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
    on top (the JAX launcher's model).  ``tokens_per_step`` is the
    speculative multiplier: compute and samples scale with it, the HBM
    term does not."""
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


def run_batch(args, cfg, step_cfg, params, frost: FrostPlane | None,
              device, rules=None) -> dict:
    """Static batch: one prefill, then decode chunks over the ring cache
    (speculative with ``--spec-k``).  Prints the JAX launcher's
    ``[serve]`` lines; returns the generated tokens, the timings and the
    speculation counts.  With sharding ``rules`` (several ranks) each
    rank decodes its rows of the batch on its shards of ``params`` (all
    of them where the requests do not divide over the ranks); the tokens
    are returned whole."""
    greedy = args.temperature <= 0.0
    temperature = max(args.temperature, 1e-6)
    plen = args.shared_prefix_len + args.prompt_len
    max_len = plen + args.gen
    chunk = max(1, args.decode_chunk)
    spec = args.spec_k > 0
    if args.shared_prefix_len > 0:
        # pooled shared heads + unique suffixes, uniform length
        trace = batch_trace(args.requests, seed=args.seed,
                            vocab_size=cfg.vocab_size,
                            prompt_len=args.prompt_len,
                            max_new_tokens=args.gen,
                            n_codebooks=cfg.n_codebooks,
                            shared_prefix_len=args.shared_prefix_len,
                            prompt_pools=args.prompt_pools)
        prompts = np.stack([r.prompt for r in trace])
    else:
        data = TokenBatches(DataConfig(seed=args.seed,
                                       vocab_size=cfg.vocab_size,
                                       seq_len=args.prompt_len,
                                       global_batch=args.requests,
                                       n_codebooks=cfg.n_codebooks))
        prompts = data.batch(0)["inputs"]
    params = tfm.prepare_params(params, cfg)
    if rules is not None:
        from repro_torch.runtime import sharding
        params = sharding.shard_params(
            params, rules.param_sharding(bridge.param_axes(cfg)), rules.mesh)
    prefill = make_prefill_step(cfg, step_cfg, max_len=max_len, rules=rules)
    gen = None
    if not greedy:
        gen = torch.Generator(device=device)
        gen.manual_seed(args.sample_seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    last_logits, cache = prefill(
        params, {"inputs": torch.as_tensor(prompts, device=device)})
    nxt = sample(last_logits, greedy=greedy, temperature=temperature,
                 generator=gen)
    sync()
    t_prefill = time.perf_counter() - t0

    if spec:
        drafter = speculate.get_drafter(args.drafter, args.spec_k)
        loop = make_speculative_decode_loop(cfg, step_cfg, chunk,
                                            drafter=drafter, greedy=greedy,
                                            temperature=temperature)
        ds = drafter.init_state(args.requests)
        drafter.seed_batch(ds, prompts, nxt.cpu().numpy())
        dstate = speculate.state_to(ds, device)
    else:
        loop = make_decode_loop(cfg, step_cfg, chunk, greedy=greedy,
                                temperature=temperature, rules=rules)

    generated = [nxt.cpu().numpy()[:, None]]   # token sampled from prefill
    tok = nxt[:, None]                         # (B, 1), on the device
    remaining = args.gen - 1
    decode_energy_j = 0.0
    n_spec_steps = n_spec_accepted = 0
    t_decode = 0.0
    while remaining > 0:
        t_c = time.perf_counter()
        if spec:
            toks, counts, cache, dstate = loop(params, cache, tok, dstate,
                                               gen)
            sync()
            wall = time.perf_counter() - t_c
            toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
            # counts are uniform across the batch (ring lockstep)
            flat = np.concatenate([toks[:, s, :counts[0, s]]
                                   for s in range(counts.shape[1])], axis=1)
            n_spec_steps += counts.shape[1]
            n_spec_accepted += int(counts[0].sum()) - counts.shape[1]
            tok = torch.as_tensor(flat[:, -1:], device=device)
        else:
            toks, cache = loop(params, cache, tok, gen)
            sync()
            wall = time.perf_counter() - t_c
            flat = toks.cpu().numpy()
            tok = toks[:, -1:]
        t_decode += wall
        keep = min(flat.shape[1], remaining)
        if frost is not None:
            # a chunk is `chunk` cache sweeps; speculation scores K+1
            # tokens per sweep (charged) and harvests 1..K+1
            decode_energy_j += frost.emit_chunk(
                keep * args.requests, args.requests, chunk, wall,
                tokens_scored=args.spec_k + 1 if spec else 1.0)
        generated.append(flat[:, :keep])
        remaining -= keep
    toks_out = np.concatenate(generated, axis=1)
    if len(toks_out) != args.requests:     # this rank's rows of the batch
        from repro_torch.runtime import collectives as col
        toks_out = col._all_gather(torch.as_tensor(toks_out), 0,
                                   rules.mesh.group("data")).numpy()

    # the first token came from prefill: tok/s and J/token charge only the
    # (gen - 1) * requests tokens the decode loop produced
    n_decoded = (args.gen - 1) * args.requests
    tok_per_s = n_decoded / max(t_decode, 1e-9)
    j_per_token = decode_energy_j / max(n_decoded, 1)
    j_line = f"; {j_per_token:.3g} J/token analytic" \
        if frost is not None else ""
    spec_line = ""
    acceptance = 0.0
    if spec and n_spec_steps:
        acceptance = n_spec_accepted / (n_spec_steps * args.spec_k)
        spec_line = (f", spec K={args.spec_k} acceptance {acceptance:.0%} "
                     f"({1 + n_spec_accepted / n_spec_steps:.2f} tok/sweep)")
    pol = step_cfg.kernel_policy
    print(f"[serve] prefill {args.requests}x{plen} in "
          f"{t_prefill*1e3:.0f} ms; decode {n_decoded} tokens in "
          f"{t_decode*1e3:.0f} ms ({tok_per_s:.0f} tok/s measured, "
          f"chunks of {chunk}, kv_splits {pol.kv_splits}, "
          f"decode_k_chunk {pol.decode_k_chunk}{spec_line}{j_line})")
    print(f"[serve] sample continuation: {toks_out[0].ravel()[:16].tolist()}")
    return {"tokens": toks_out, "prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": tok_per_s, "j_per_token": j_per_token,
            "spec_steps": n_spec_steps, "acceptance": acceptance}


def run_engine(args, cfg, step_cfg, params, frost: FrostPlane | None,
               device):
    """Continuous batching: Poisson arrivals into the paged-KV engine.
    Prints the JAX launcher's ``[serve]`` lines; returns the report."""
    greedy = args.temperature <= 0.0
    max_len = args.shared_prefix_len + args.prompt_len + args.gen
    recompute_j = None
    if args.host_tier and frost is not None:
        # a page's recompute priced at the analytic one-sequence sweep
        # cost per token at full power: the demote-or-drop rule compares
        # the page's D2H + H2D round trip against re-prefilling its rows
        recompute_j = frost.device.estimate(
            decode_workload(cfg, 1), 1.0).energy_j
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
                        decode_k_chunk=max(1, args.decode_k_chunk),
                        spec_k=max(0, args.spec_k), drafter=args.drafter,
                        kv_dtype=args.kv_dtype, host_tier=args.host_tier,
                        host_pages=args.host_pages,
                        transfer_j_per_byte=args.transfer_j_per_byte,
                        recompute_j_per_token=recompute_j)
    # effective tokens per slot-step: 1.0 plain; under speculation a
    # running estimate (accepted + bonus per sweep), so that admission
    # prices occupancy at the throughput actually delivered
    eff = {"tps": 1.0}

    def on_chunk(s):
        if s.n_active and ecfg.spec_k:
            tps = s.tokens_kept / max(s.n_active * ecfg.decode_chunk, 1)
            eff["tps"] = 0.5 * eff["tps"] + 0.5 * max(tps, 1.0)
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
            dev_model,
            lambda n: decode_workload(cfg, n, tokens_per_step=eff["tps"]),
            args.power_budget,
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
    # -- chaos / fault tolerance ---------------------------------------------
    injector = None
    if args.chaos:
        injector = FaultInjector.from_spec(args.chaos, seed=args.chaos_seed)
    snapshot_dir = args.snapshot_dir
    if snapshot_dir is None and injector is not None and \
            any(ev.kind == "engine_crash" for ev in injector.events):
        # a crash without a snapshot directory would lose the run: take a
        # throwaway one, so that the drill recovers instead of dying
        snapshot_dir = tempfile.mkdtemp(prefix="serve_snap_")
        print(f"[chaos] engine_crash armed; snapshots -> {snapshot_dir}")
    snapshot_every = args.snapshot_every if snapshot_dir is not None else 0

    supervisor = ServingSupervisor(bus=frost.bus if frost is not None
                                   else None, node_id="serve-0")
    cbus = ChaosBus(frost.bus) if frost is not None else None
    if cbus is not None:
        frost.bus = cbus       # emit_chunk publishes through the chaos shim

    def on_fault(ev):
        # bus_drop / bus_delay disturb the telemetry transport, not the
        # engine: swallow or hold the next N publishes on the control bus
        if cbus is None:
            return
        if ev.kind == "bus_drop":
            cbus.drop_next(max(1, ev.duration))
        elif ev.kind == "bus_delay":
            cbus.delay_next(max(1, ev.duration))

    eng_kwargs = dict(step_cfg=step_cfg, device=device, on_chunk=on_chunk,
                      on_prefill=on_prefill, admission=admission,
                      injector=injector,
                      on_heartbeat=supervisor.on_heartbeat, on_fault=on_fault,
                      snapshot_every=snapshot_every)
    engine = ServeEngine(cfg, ecfg, params, snapshot_dir=snapshot_dir,
                         **eng_kwargs)
    restarts = 0
    while True:
        try:
            rep = engine.resume() if restarts else engine.run(trace)
            break
        except EngineCrash as crash:
            restarts += 1
            if snapshot_dir is None or restarts > args.max_restarts:
                raise
            print(f"[chaos] engine crashed at step {crash.step}; "
                  f"restoring from {snapshot_dir} "
                  f"(restart {restarts}/{args.max_restarts})")
            engine = ServeEngine.restore(cfg, ecfg, params, snapshot_dir,
                                         **eng_kwargs)
    if cbus is not None:
        cbus.flush()           # deliver anything a bus_delay still holds

    lat = rep.latency_percentiles((50, 95))
    waits = [r.wait_steps for r in rep.results if r.admit_step >= 0]
    print(f"[serve] engine: {len(rep.results)} requests over {rep.n_chunks} "
          f"chunks of {ecfg.decode_chunk} ({args.n_slots} slots, "
          f"page_size {args.page_size}, kv_splits {ecfg.kv_splits}, "
          f"decode_k_chunk {ecfg.decode_k_chunk}, "
          f"occupancy {rep.occupancy:.0%})")
    j_name = "J/accepted-token" if ecfg.spec_k else \
        "J/token (occupied slots only)"
    j_line = f", {rep.j_per_token:.3g} {j_name}" if frost is not None else ""
    print(f"[serve] decode {rep.tokens_kept} useful / {rep.tokens_computed} "
          f"computed tokens in {rep.decode_wall_s*1e3:.0f} ms "
          f"({rep.tok_per_s:.0f} tok/s measured{j_line})")
    if ecfg.spec_k:
        print(f"[serve] speculative K={ecfg.spec_k} ({ecfg.drafter}): "
              f"acceptance {rep.acceptance_rate:.0%}, "
              f"{rep.tokens_per_step:.2f} tokens/slot-sweep "
              f"(admission sees {eff['tps']:.2f}x effective tok/s)")
    if ecfg.prefix_cache:
        j_avoid = ""
        if frost is not None and pref["avoided_j"] > 0:
            j_avoid = (f", ~{pref['avoided_j']:.3g} J prefill avoided "
                       "(modelled, in the J/token ledger)")
        print(f"[serve] prefix cache: {rep.prefix_hit_rate:.0%} of "
              f"{rep.prompt_tokens} prompt tokens restored "
              f"({rep.prefill_tokens_saved} saved), "
              f"{rep.n_preemptions} preemptions{j_avoid}")
    if ecfg.host_tier:
        print(f"[serve] kv tier: {engine.kv_dtype} pages, "
              f"{rep.n_demotions} paged out / {rep.n_promotions} paged in, "
              f"transfer {rep.transfer_j:.3g} J (in the J/token ledger)")
    print(f"[serve] latency p50 {lat[50]:.0f} / p95 {lat[95]:.0f} steps; "
          f"queue wait mean {np.mean(waits):.1f} steps"
          if waits else "[serve] nothing admitted")
    if injector is not None:
        kinds = ", ".join(f"{ev.kind}@{ev.step}" for ev in injector.log)
        print(f"[chaos] {rep.n_faults_injected} faults injected ({kinds}); "
              f"{rep.n_restores} restores, {rep.requeued_requests} requests "
              f"requeued, {rep.degraded_steps} degraded steps, "
              f"{rep.n_pages_quarantined} pages quarantined")
        if cbus is not None and (cbus.n_dropped or cbus.n_delayed):
            print(f"[chaos] telemetry: {cbus.n_dropped} publishes dropped, "
                  f"{cbus.n_delayed} delayed (flushed at exit)")
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
    ap.add_argument("--arch", default="smollm-135m",
                    help="a ported arch (default: smollm-135m, the main "
                         "path's model)")
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
                    help="batch: static fixed-batch baseline; poisson: "
                         "continuous-batching engine under Poisson arrivals")
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
                    help="KV page storage (int8: per-row fp32 scales, "
                         "dequantized inside the attention sweeps)")
    ap.add_argument("--host-tier", action="store_true",
                    help="page cold prefix pages out to host memory and "
                         "back on a prefix hit")
    ap.add_argument("--host-pages", type=int, default=None,
                    help="host-tier capacity in pages (default: unbounded)")
    ap.add_argument("--transfer-j-per-byte", type=float, default=1e-9,
                    help="modelled J per byte of each page-out / page-in")
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
                    help=">0: speculative decoding — verify K drafts + 1 "
                         "bonus token per cache sweep (both traffic modes)")
    ap.add_argument("--drafter", choices=("ngram", "repeat"), default="ngram",
                    help="self-drafter for --spec-k (ngram = prompt-lookup)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples with this temperature")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="free a slot early when this token is sampled")
    ap.add_argument("--power-budget", type=float, default=0.0,
                    help="W; >0 gates admission on predicted board draw")
    ap.add_argument("--chaos", type=str, default="",
                    help="fault schedule 'kind@step[:duration[:arg]],...' "
                         "on the engine clock (poisson mode), e.g. "
                         "'slot_crash@20,engine_crash@40,"
                         "emergency_cap@60:16:0.5'")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the fault injector's RNG (corruption "
                         "site choice)")
    ap.add_argument("--snapshot-dir", type=str, default=None,
                    help="engine snapshot directory (crash recovery); "
                         "auto tempdir when --chaos arms an engine_crash")
    ap.add_argument("--snapshot-every", type=int, default=4,
                    help="snapshot every N decode chunks (needs "
                         "--snapshot-dir or an armed engine_crash)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="crash-restore attempts before giving up")
    ap.add_argument("--no-frost", action="store_true",
                    help="disable the FROST control plane (no sampler, "
                         "meters, or bus are even built)")
    ap.add_argument("--edp-exponent", type=float, default=2.0)
    return ap


def refuse_oversized(cfg, free_bytes: int) -> None:
    """Exit, naming the cause, when ``cfg``'s weights alone (in
    ``cfg.dtype``, from ``param_count``) exceed ``free_bytes``, the memory
    free on the serving card, before any of them is drawn."""
    need = cfg.param_count() * common.dt(cfg.dtype).itemsize
    if need > free_bytes:
        raise SystemExit(
            f"[serve] {cfg.name}: {need / 2 ** 30:.1f} GiB of {cfg.dtype} "
            f"weights exceed the {free_bytes / 2 ** 30:.1f} GiB free on the "
            f"card; serve it with --smoke, or hand serve() a config cut in "
            f"depth")


def run(argv=None):
    """Parse ``argv``, choose the config (``--arch``, ``--smoke``) and
    :func:`serve` it."""
    args = build_parser().parse_args(argv)
    spec = get_arch(args.arch)
    return serve(args, spec.smoke if args.smoke else spec.config)


def serve(args, cfg):
    """Serve ``cfg`` as the parsed ``args`` ask, print the ``[serve]`` /
    ``[frost-ctrl]`` lines; returns the engine's report (poisson) or
    ``run_batch``'s result (batch).  A caller may hand a config the
    registry does not hold, such as a published one cut in depth to fit
    one card."""
    rules = None
    if tmesh.world_size() > 1:
        if args.traffic == "poisson":
            raise SystemExit("[serve] --traffic poisson: the paged engine "
                             "under a mesh of ranks is not ported; run it "
                             "on one rank")
        if args.spec_k > 0:
            raise SystemExit("[serve] --spec-k: speculative decoding under "
                             "a mesh of ranks is not ported; run it on one "
                             "rank")
        import torch.distributed as dist

        from repro_torch.runtime import sharding
        host = tmesh.make_host_mesh(args.device)
        device = tmesh.local_device(args.device)
        # the weights stay whole over "data" (no gather every token)
        rules = sharding.build_rules(cfg, host, fsdp=False)
        print(f"[serve] mesh {host.shape} over {dist.get_world_size()} "
              f"ranks ({dist.get_backend()}): each decodes its rows")
    else:
        device = resolve(args.device)
    if device.type == "cuda":
        refuse_oversized(cfg, torch.cuda.mem_get_info(device)[0])
    step_cfg = with_decode_policy(StepConfig(),
                                  kv_splits=_parse_kv_splits(args.kv_splits),
                                  decode_k_chunk=max(1, args.decode_k_chunk))
    # drawn on the serving device: a full-width model never passes
    # through the host
    params = bridge.init_lm(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    n_par = args.n_slots if args.traffic == "poisson" else args.requests
    frost = None if args.no_frost else FrostPlane(cfg, n_par,
                                                  args.edp_exponent)
    if args.traffic == "poisson":
        out = run_engine(args, cfg, step_cfg, params, frost, device)
    else:
        with torch.no_grad():
            out = run_batch(args, cfg, step_cfg, params, frost, device,
                            rules)
    if frost is not None:
        frost.summary()
    return out


def main(argv=None) -> int:
    if tmesh.world_size() > 1:
        tmesh.quiet_unless_rank0()
    run(argv)
    if tmesh.world_size() > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
