"""Training launcher of the PyTorch port — the CLI of ``repro.launch.train``
plus ``--device``.

    # smollm-135m at its published width and depth on the card, FROST on
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 24 --frost

    # at smoke size on the CPU (plain torch paths, no kernels)
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --device cpu --steps 4 --frost

Wires together: config registry -> data pipeline -> train step (fp32
master weights, activations in ``cfg.dtype``, AdamW in place; on the card
every norm runs K9 and every attention layer K4, forward and backward)
-> FROST control plane (a batch profile on the analytic H100 SXM model
warm-starts an online profiler that keeps retuning the cap from streamed
step telemetry) -> supervisor (heartbeats, checkpoint/restart through
``repro_torch.checkpoint``) -> telemetry.

Every train step publishes ``StepDone`` on the control-plane bus and reads
the enforcement backend before the next step, so cap commands issued by the
online profiler take effect mid-run.

The batch profile needs the step's roofline terms.  The JAX launcher reads
them from the compiled step's HLO; here :func:`train_step_cost` computes
them from the config: its FLOPs equal the JAX step's HLO ``dot_flops``
(the tests hold them equal on the smoke configs), its HBM bytes are a
stated estimate.

``--fail-at STEP`` makes the node go silent at that step: the supervisor
notices, restores the last checkpoint (``--ckpt-every``) and carries on.

Under ``torchrun --nproc-per-node N`` with N > 1 the step runs sharded,
as JAX's launcher does on a host of several devices: the sharding rules
on the host mesh (JAX's 1-D "data" mesh over every rank: FSDP), each rank
holding its shards of the state and taking its rows of each batch; NCCL
where every rank has a card of its own, gloo where ranks share one.
Each rank checkpoints its own shards (``rank<r>`` under the checkpoint
directory), and only rank 0 prints.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch smollm-135m --steps 24
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from repro_torch import device as _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.launch import mesh as tmesh
from repro_torch.control import CapApplied, EventBus, StepDone
from repro_torch.control.online import OnlineCapProfiler
from repro_torch.core import (H100_SXM, CapProfiler, PowerCappedDevice,
                              QoSPolicy, WorkloadProfile)
from repro_torch.core.profiler import RecordingBackend
from repro_torch.data import DataConfig, TokenBatches
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _capacity
from repro_torch.optim import OptimizerConfig
from repro_torch.runtime.fault import Supervisor, SupervisorConfig
from repro_torch.runtime.steps import (StepConfig, init_train_state,
                                       make_train_step, shard_train_state)
from repro_torch.telemetry.meters import (AnalyticDeviceMeter,
                                          CpuProcessMeter, DramMeter)
from repro_torch.telemetry.sampler import PowerSampler


def _step_cost(cfg: ModelConfig, B: int, S: int) -> tuple[float, float]:
    """(dot FLOPs of a train step, matmul output elements of its forward)
    over B x S tokens.  Matmuls as the code computes them: every
    projection, the attention's two products over the whole S x S matrix
    (the JAX reference path masks it, it does not skip it), the MoE's
    experts over their capacity buffers, the SSD scan as JAX runs it at
    this S (``ops.ssd`` under ``auto``: the sequential scan's per-step
    readout up to 64 steps or for a ragged S, else the chunked scan's
    products), the hybrid shared block's input projection (2d -> d),
    attention and MLP once for each of its applications (a unit each),
    the head (a codebook model's one product a codebook).  Each counts
    three times (forward, and the backward's two products: the input's
    gradient and the weight's, or dq / dk and dp / dv), the sequential
    scan's readout y = C h twice (the backward's dh = C dy is an outer
    product, no dot)."""
    T = B * S
    d = cfg.d_model
    flops = outs = 0.0

    def mm(rows, k, n, times=3):
        nonlocal flops, outs
        flops += times * 2.0 * rows * k * n
        outs += float(rows) * n

    def attention():
        if cfg.use_mla:
            H, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                             cfg.v_head_dim)
            r_kv, r_q = cfg.kv_lora_rank, cfg.q_lora_rank
            if r_q:
                mm(T, d, r_q)
                mm(T, r_q, H * (dn + dr))
            else:
                mm(T, d, H * (dn + dr))
            mm(T, d, r_kv + dr)
            mm(T, r_kv, H * dn)
            mm(T, r_kv, H * dv)
            mm(B * H * S, dn + dr, S)                  # q . k
            mm(B * H * S, S, dv)                       # p . v
            mm(T, H * dv, d)
            return
        hd, hq, hkv = (cfg.resolved_head_dim, cfg.padded_q_heads,
                       cfg.padded_kv_heads)
        mm(T, d, hq * hd)
        mm(T, d, hkv * hd)
        mm(T, d, hkv * hd)
        mm(B * hq * S, hd, S)
        mm(B * hq * S, S, hd)
        mm(T, hq * hd, d)

    def ffn(moe: bool, d_ff: int):
        n_in = 2 if cfg.gated_mlp else 1
        if not moe:
            for _ in range(n_in):
                mm(T, d, d_ff)
            mm(T, d_ff, d)
            return
        E, k, ff = cfg.n_experts, cfg.experts_per_token, cfg.resolved_moe_d_ff
        C = _capacity(cfg, k, T, E)
        mm(T, d, E)                                    # router
        mm(E * C, d, ff)
        mm(E * C, d, ff)
        mm(E * C, ff, d)
        if cfg.n_shared_experts:
            sff = cfg.resolved_shared_d_ff * cfg.n_shared_experts
            mm(T, d, sff)
            mm(T, d, sff)
            mm(T, sff, d)

    def mamba():
        nonlocal flops, outs
        di, H = cfg.d_inner, cfg.resolved_ssm_heads
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        GN = cfg.ssm_groups * N
        for n in (di, di, GN, GN, H):                  # z, x, B, C, dt
            mm(T, d, n)
        Q = ops.DEFAULT_POLICY.ssd_chunk
        if S <= 64 or S % Q:
            # the sequential scan (JAX's ``ssd_ref``): its readout y = C h
            mm(B * S * H * P, N, 1, times=2)
        else:
            # the chunked scan (``ssd_chunked_jnp``), per chunk and head
            # over B x Q rows: the scores C B^T and the band's M x, three
            # times each; the carried-in readout C h^T and the state update
            # x^T (w B), three times each, but twice each when the chunk
            # is the only one (its incoming state is the constant zero and
            # its outgoing state is never read); and the carried-in term's
            # decay gradient, a contraction over min(P, N)
            nc = S // Q
            per_chunk = 3 * Q * N + 3 * Q * P + min(P, N) + (
                4 if nc == 1 else 6) * P * N
            flops += 2.0 * B * H * Q * per_chunk * nc
            outs += float(B * S * H * P)               # y, as the readout's
        mm(T, di, d)

    for _ in range(cfg.first_dense_layers):
        attention()
        ffn(False, cfg.dense_d_ff or cfg.d_ff)
    for _ in range(cfg.n_layers - cfg.first_dense_layers):
        if cfg.uses_ssm:
            mamba()
        else:
            attention()
            ffn(cfg.uses_moe, cfg.d_ff)
    if tfm.is_hybrid(cfg):
        for _ in range(tfm.n_units(cfg)):             # the shared block
            mm(T, 2 * d, d)
            attention()
            ffn(False, cfg.d_ff)
    for _ in range(max(cfg.n_codebooks, 1)):           # the head
        mm(T, d, tfm.padded_vocab(cfg))
    return flops, outs


def train_step_cost(cfg: ModelConfig, batch: int, seq: int, *,
                    n_micro: int = 1,
                    moment_dtype: str = "float32") -> tuple[float, float]:
    """(FLOPs, HBM bytes) of one train step over ``batch`` x ``seq``
    tokens (``seq`` counts an image prefix too).

    FLOPs: the dot FLOPs of :func:`_step_cost` for each of the
    ``n_micro`` micro-batches.  For a dense model that is 6 N T plus 3
    times the attention's 4 B S^2 Hq D summed over the layers, N the
    matmul weights (a tied head counted once), T the tokens; the MoE
    counts its experts over their capacity buffers, the SSM its
    projections and the scan's products, the hybrid family its shared
    block once for each application.

    HBM bytes, an estimate: the fp32 weights, their gradients and both
    moments each read and written once (the optimizer), and each matmul's
    output written once in the forward and read once in the backward in
    ``cfg.dtype``."""
    flops, outs = _step_cost(cfg, batch // n_micro, seq)
    es = common.dt(cfg.dtype).itemsize
    ms = common.dt(moment_dtype).itemsize
    n_params = cfg.param_count()
    nbytes = n_params * (2 * 4 + 2 * 4 + 2 * 2 * ms) + n_micro * 2 * es * outs
    return flops * n_micro, float(nbytes)


def profile_cap_for_step(cfg: ModelConfig, flops: float, bytes_hbm: float,
                         coll: float, policy: QoSPolicy, *,
                         bus=None, backend=None):
    """FROST batch pass: given the step's roofline terms, pick the cap on
    the analytic H100 SXM model.  Returns (decision, workload, device) so
    the online profiler can warm-start from the same artefacts."""
    wl = WorkloadProfile(name=cfg.name, flops_per_step=flops,
                         hbm_bytes_per_step=bytes_hbm,
                         collective_bytes_per_step=coll,
                         samples_per_step=1)
    dev = PowerCappedDevice(H100_SXM)

    class _W:                                   # Workload protocol adapter
        def probe(self, cap, duration_s):
            return dev.probe(wl, cap, duration_s)

    prof = CapProfiler(_W(), policy=policy, probe_seconds=30.0,
                       bus=bus, backend=backend, node_id="node-0")
    return prof.run(), wl, dev


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new directory "
                         "under the system's temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="the node goes silent at this step; the "
                         "supervisor restores the last checkpoint")
    ap.add_argument("--frost", action="store_true",
                    help="run the FROST control plane (batch profile warm-"
                         "starts an online retuner over the step stream)")
    ap.add_argument("--edp-exponent", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return ap


def train(args) -> dict:
    """One launcher run.  Returns the report: ``losses``, ``steps``,
    ``seconds``, ``steps_per_s``, ``tokens_per_s``, ``peak_gib`` (None on
    the CPU), ``restarts``, ``cap_commands``.  Without ``--ckpt-dir`` the
    checkpoints go to a temporary directory, removed at the end."""
    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    rules = None
    if tmesh.world_size() > 1:
        import torch.distributed as dist

        from repro_torch.runtime import sharding
        host = tmesh.make_host_mesh(args.device)
        dev = tmesh.local_device(args.device)
        rules = sharding.build_rules(cfg, host)
        print(f"[train] mesh {host.shape} over {dist.get_world_size()} "
              f"ranks ({dist.get_backend()})")
    else:
        dev = _device.resolve(args.device)
    print(f"[train] arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family} device={dev}")

    step_cfg = StepConfig(
        n_micro=args.n_micro, remat="none",
        optimizer=OptimizerConfig(learning_rate=args.lr,
                                  warmup_steps=max(2, args.steps // 10),
                                  total_steps=args.steps))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, step_cfg, gen, dev)
    if rules is not None:
        state = shard_train_state(state, rules, cfg)
    train_step = make_train_step(cfg, step_cfg, rules)

    data = TokenBatches(DataConfig(
        seed=args.seed, vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, n_codebooks=cfg.n_codebooks))

    # -- FROST control plane (paper Sec III-C + Fig 1 loop) --------------------
    bus = EventBus()
    backend = RecordingBackend()
    cap_log = bus.tap(CapApplied)        # lossless cap-command accounting
    frost_wl = frost_dev = online = gpu_meter = None
    if args.frost:
        policy = QoSPolicy(policy_id=f"train-ed{args.edp_exponent:g}p",
                           edp_exponent=args.edp_exponent)
        flops, nbytes = train_step_cost(
            cfg, args.batch, args.seq, n_micro=args.n_micro,
            moment_dtype=step_cfg.optimizer.moment_dtype)
        decision, frost_wl, frost_dev = profile_cap_for_step(
            cfg, flops, nbytes, 0.0, policy, bus=bus, backend=backend)
        print(f"[frost] selected cap = {decision.cap:.0%} "
              f"(pred. energy saving {decision.predicted_energy_saving:+.1%}, "
              f"delay {decision.predicted_delay_increase:+.1%}, "
              f"fit rmse {decision.fit.rel_rmse:.3%}; step {flops:.4g} "
              f"FLOP, {nbytes:.4g} B on the analytic H100 SXM model)")
        gpu_meter = AnalyticDeviceMeter(frost_dev, frost_wl, cap=decision.cap)
        gpu_meter.set_workload(frost_wl, busy=True)
        online = OnlineCapProfiler(bus, backend, policy=policy,
                                   node_id="node-0", model_id=cfg.name,
                                   steps_per_probe=2, hold_steps=16,
                                   warm_start=decision)

    meters = {"cpu": CpuProcessMeter(), "dram": DramMeter(4, 16)}
    if gpu_meter is not None:
        meters["gpu"] = gpu_meter
    sampler = PowerSampler(meters, rate_hz=0.1, bus=bus, node_id="node-0")

    # -- supervised run ----------------------------------------------------------
    own_dir = (None if args.ckpt_dir
               else tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    ckpt_dir = args.ckpt_dir or own_dir
    if rules is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{os.environ['RANK']}")
    ckpt = CheckpointManager(ckpt_dir, keep=2, save_async=True)
    ckpt.save(state, 0)                    # recovery floor before step 1

    def restore():
        restored = ckpt.restore(state)
        for p in common.tree_leaves(restored["params"]):
            p.requires_grad_(True)
        return restored, ckpt.latest_step() or 0

    sup = Supervisor(SupervisorConfig(checkpoint_every=args.ckpt_every),
                     save_fn=lambda s, i: ckpt.save(s, i),
                     restore_fn=restore)
    sup.register("node-0")

    step_no = {"i": 0}

    def instrumented_step(state, batch):
        """The step loop as a control-plane producer: run the step, honour
        whatever cap is currently enforced, publish StepDone."""
        state, metrics = train_step(state, batch)
        cap = backend.current_cap()            # cap commands land mid-run
        if frost_dev is not None:
            gpu_meter.set_cap(cap)
            est = frost_dev.estimate(frost_wl, cap)
            duration_s, energy_j = est.step_time_s, est.energy_j
        else:
            duration_s, energy_j = 0.0, 0.0
        i = step_no["i"] = step_no["i"] + 1
        if duration_s > 0:
            # samples must match the profile workload's samples_per_step (1)
            bus.publish(StepDone(node_id="node-0", step=i,
                                 duration_s=duration_s,
                                 samples=frost_wl.samples_per_step,
                                 energy_j=energy_j, model_id=cfg.name))
        return state, metrics

    batches = (data.batch(i) for i in range(args.steps))
    inject = None if args.fail_at is None else {args.fail_at: "node-0"}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with sampler:
        state, report = sup.run(instrumented_step, state, batches,
                                inject_failure_at=inject)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    losses = [h["loss"] for h in report["history"]]
    n_steps = len(losses)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    print(f"[train] {report['final_step']} steps in {dt:.1f}s "
          f"({dt/max(n_steps,1):.3f}s/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    peak_s = "n/a (cpu)" if peak is None else f"{peak:.2f} GiB"
    print(f"[train] {n_steps / dt:.2f} steps/s, "
          f"{n_steps * args.batch * args.seq / dt:.0f} tokens/s, "
          f"peak memory {peak_s}, {report['restarts']} restarts")
    out = dict(losses=losses, steps=n_steps, seconds=dt,
               steps_per_s=n_steps / dt,
               tokens_per_s=n_steps * args.batch * args.seq / dt,
               peak_gib=peak, restarts=report["restarts"],
               cap_commands=len(cap_log), final_step=report["final_step"])
    if online is not None:
        print(f"[frost-ctrl] {len(cap_log)} cap commands over the run; "
              f"online refits={online.n_refits} "
              f"cap now {backend.current_cap():.0%}")
        online.close()
    ckpt.wait()
    if own_dir is not None:
        shutil.rmtree(own_dir)
    return out


def main(argv=None) -> int:
    if tmesh.world_size() > 1:
        tmesh.quiet_unless_rank0()
    train(build_parser().parse_args(argv))
    if tmesh.world_size() > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
