"""Continuous-batching serving engine over the paged KV cache — the port of
``repro.serving.engine`` for the slice it serves:

    poll ──> prefill-on-join ──> grow/preempt ──> decode chunk ──> harvest
     ^   (cached prefix shared,   (lazy pages;     (paged loop,     │
     │    only the suffix runs)    requeue on       pools updated   │
     │                             pressure)        in place)       │
     └──────────────────── free slots / pages on finish ────────────┘

Joins with a prefix-cache hit map shared read-only pages and prefill only
the uncached suffix (chunked, through the paged verify sweep); cold
prompts run the bucketed prefill + page inject.  Windowed layers (gemma2's
local layers) keep a private ring of pages per slot: the inject writes the
last ``window`` prompt rows into it, and models with such layers keep the
cold path (no prefix cache, no speculation), as in the JAX package.  SSM
layers (mamba2) keep one recurrent state slot per engine slot: a cold
join prefills the prompt at its exact length (a pad token would enter the
state) and overwrites the slot's state; they too keep the cold path.  MLA
layers (deepseek-v2) keep one latent row per token on the main block
tables, and its first dense layers a stacked pool group on the same page
ids: both ride the prefix cache and the copy-on-write page copy like the
k/v pools.  The hybrid family (zamba2) adds its shared attention block's
per-slot linear buffer: the inject writes the prompt's rows ``[0, L)``
of the slot's span; it is no page group (no host tier, no page copy) and
keeps the cold path.  A codebook model (musicgen) feeds (n_slots, 1,
n_cb) tokens and harvests one token of ``n_cb`` codes a step; it too
keeps the cold path (no prefix cache, no speculation), as in JAX.  The
host bookkeeping (``PagedKVCache``, ``Scheduler``) is the JAX package's,
copied; the device steps are the port's torch functions on the engine's
device.

Speculative mode (``EngineConfig.spec_k > 0``): each chunk iteration
becomes a K+1-token verify step (draft -> verify -> accept -> commit, per
slot, through the paged verify sweep), the harvest consumes a variable
number of tokens per slot per step, and the report adds the drafts
proposed and accepted.  The per-slot drafter state is one more host
mirror, seeded at prefill-on-join.

int8 KV pages (``EngineConfig.kv_dtype="int8"``): the k/v pools hold int8
rows with per-row fp32 scales, quantized once when they are written (the
decode scatter, the commit, the prefill inject here) and dequantized
inside the attention sweeps.  A family whose cache cannot hold them
(``int8_paged_blockers``) warns once and serves its cache dtype, as the
JAX engine does.  The host tier (``host_tier``): cold prefix pages are
paged out to host memory and back on a prefix hit (``PagedKVCache``'s
demote / promote), each direction charged at ``transfer_j_per_byte`` into
the J/token ledger.

Chaos and crash recovery (``injector``, ``snapshot_dir``): a seeded
``FaultInjector`` is polled on the decode-step clock at the top of every
cycle.  Slot crashes requeue their request with zero token loss, page
corruptions are caught and quarantined by ``verify_invariants``, ``derate``
and ``emergency_cap`` windows degrade service (admission paused; under a
cap the chunk halves and speculation stops) instead of breaking the site's
power cap, and an ``engine_crash`` raises :class:`EngineCrash`.  Every
``snapshot_every`` chunks the engine writes a snapshot (the device pools
plus a JSON blob of the queue, slots, results, counters and the paged-KV
host metadata with its host-tier pages) through ``repro_torch.checkpoint``;
``ServeEngine.restore`` + ``resume`` fold each in-flight slot's tokens into
its prompt, requeue it through the prefix cache, and give the fault-free
run's greedy streams.

``EngineConfig``, ``ChunkStats``, ``EngineReport`` and
``EnergyAwareAdmission`` are unchanged.

``ChunkStats.wall_s`` is taken after ``torch.cuda.synchronize()``: it
measures the chunk's execution on the card, not its enqueue.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch import quant
from repro_torch.checkpoint.store import CheckpointManager, restore_pytree
from repro_torch.kernels import ops
from repro_torch.models import transformer as tfm
from repro_torch.runtime import speculate
from repro_torch.runtime.chaos import FaultInjector, corrupt_paged_kv
from repro_torch.runtime.steps import (StepConfig, make_paged_decode_loop,
                                       make_paged_speculative_decode_loop,
                                       make_prefill_suffix_step,
                                       make_run_ctx, sample,
                                       with_decode_policy)
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import RequestQueue, Scheduler


class EngineCrash(RuntimeError):
    """Injected engine-process death (chaos drills).  Carries the decode
    step at which the engine died; callers recover through
    ``ServeEngine.restore`` + ``resume``."""

    def __init__(self, step: int):
        super().__init__(f"engine crashed at step {step}")
        self.step = int(step)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine knobs orthogonal to the model config (the JAX package's)."""
    n_slots: int = 4
    page_size: int = 16
    max_len: int = 256            # per-request prompt + generation ceiling
    decode_chunk: int = 8
    n_pages: int | None = None    # None: fully provisioned (no page waits)
    greedy: bool = True
    temperature: float = 1.0
    sample_seed: int = 0
    cache_dtype: str = "bfloat16"
    min_prefill_bucket: int = 8   # prompts pad up to pow2 buckets >= this
    spec_k: int = 0
    drafter: str = "ngram"
    drafter_hist: int = 128
    prefix_cache: bool = True
    prefill_chunk: int = 16       # suffix tokens per chunked-prefill sweep
    preempt: bool = True
    max_skip: int = 2
    kv_splits: str | int = "auto"
    decode_k_chunk: int = 256
    kv_dtype: str = "bfloat16"
    host_tier: bool = False
    host_pages: int | None = None
    transfer_j_per_byte: float = 1e-9
    recompute_j_per_token: float | None = None


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """One decode chunk's telemetry, handed to the ``on_chunk`` hook."""
    step: int                     # chunk index
    wall_s: float                 # measured execution time on the device
    n_slots: int
    n_active: int                 # slots holding a live request
    tokens_kept: int              # useful tokens harvested this chunk
    tokens_computed: int          # n_active * chunk * (K+1) (incl. overrun)
    drafts_proposed: int = 0      # speculative mode only
    drafts_accepted: int = 0
    clock_step: int = 0           # engine decode-step clock at chunk end
    degrade_level: int = 0        # 0 healthy, 1 derate, 2 emergency cap


@dataclasses.dataclass
class EngineReport:
    """Run summary + per-request results (ratios guarded against empty
    runs: 0.0, never NaN/inf)."""
    results: list[RequestResult]
    n_chunks: int = 0
    decode_wall_s: float = 0.0
    prefill_wall_s: float = 0.0
    tokens_kept: int = 0
    tokens_computed: int = 0
    energy_j: float = 0.0
    occupancy: float = 0.0        # mean active/slots over chunks
    spec_k: int = 0               # 0 = plain decode
    drafts_proposed: int = 0
    drafts_accepted: int = 0
    prompt_tokens: int = 0        # prompt tokens across every join (requeues too)
    prefill_tokens_saved: int = 0  # restored from the prefix cache, not computed
    n_preemptions: int = 0        # slots evicted + re-queued on page pressure
    n_faults_injected: int = 0
    n_restores: int = 0
    degraded_steps: int = 0
    requeued_requests: int = 0
    n_pages_quarantined: int = 0
    transfer_j: float = 0.0
    n_demotions: int = 0
    n_promotions: int = 0

    @property
    def tok_per_s(self) -> float:
        if self.tokens_kept <= 0 or self.decode_wall_s <= 0.0:
            return 0.0
        return self.tokens_kept / self.decode_wall_s

    @property
    def j_per_token(self) -> float:
        if self.tokens_kept <= 0:
            return 0.0
        return self.energy_j / self.tokens_kept

    @property
    def acceptance_rate(self) -> float:
        if self.drafts_proposed <= 0:
            return 0.0
        return self.drafts_accepted / self.drafts_proposed

    @property
    def j_per_accepted_token(self) -> float:
        return self.j_per_token

    @property
    def tokens_per_step(self) -> float:
        if self.n_chunks <= 0 or self.tokens_computed <= 0:
            return 0.0
        steps = self.tokens_computed / max(self.spec_k + 1, 1)
        return self.tokens_kept / max(steps, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        if self.prompt_tokens <= 0:
            return 0.0
        return self.prefill_tokens_saved / self.prompt_tokens

    def latency_percentiles(self, qs=(50, 95)) -> dict[int, float]:
        lats = [r.latency_steps for r in self.results if r.finish_step >= 0]
        if not lats:
            return {q: 0.0 for q in qs}
        return {q: float(np.percentile(lats, q)) for q in qs}


class EnergyAwareAdmission:
    """Admission hook: admit while the predicted board draw at the
    resulting occupancy, under the cap in force, stays within a budget."""

    def __init__(self, device, workload_fn: Callable[[int], object],
                 budget_w: float, backend=None):
        self.device = device
        self.workload_fn = workload_fn        # n_active -> WorkloadProfile
        self.budget_w = float(budget_w)
        self.backend = backend                # CapBackend (current_cap())

    def __call__(self, request: Request, n_active_after: int) -> bool:
        cap = self.backend.current_cap() if self.backend is not None else 1.0
        est = self.device.estimate(self.workload_fn(n_active_after), cap)
        return est.power_w <= self.budget_w


class ServeEngine:
    """Drives the paged decode loop over live slots on one device."""

    def __init__(self, cfg, engine_cfg: EngineConfig, params, *,
                 step_cfg: StepConfig | None = None, device=None,
                 on_chunk: Callable[[ChunkStats], float | None] | None = None,
                 on_prefill: Callable[[int, int], float | None] | None = None,
                 admission=None,
                 injector: FaultInjector | None = None,
                 on_heartbeat: Callable[[int, float], None] | None = None,
                 on_fault: Callable[[object], None] | None = None,
                 snapshot_dir: str | None = None, snapshot_every: int = 0):
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = _device.resolve(device)
        self.params = tfm.prepare_params(
            {k: _to(v, self.device) for k, v in params.items()}, cfg)
        # int8 pages pair per-row scales with full-length k/v pools: a
        # family whose pools are latent rows, private rings or state slots
        # warns once, naming the feature, and keeps its cache dtype
        kv_dtype = engine_cfg.cache_dtype
        if engine_cfg.kv_dtype == "int8":
            i8_block = tfm.int8_paged_blockers(cfg)
            if not i8_block:
                kv_dtype = "int8"
            else:
                ops.warn_kv_dtype_fallback(
                    cfg.name, f"int8 paged cache blocked by {i8_block[0]}")
        self.kv_dtype = kv_dtype
        self.step_cfg = with_decode_policy(
            step_cfg or StepConfig(),
            kv_splits=engine_cfg.kv_splits,
            decode_k_chunk=engine_cfg.decode_k_chunk,
            kv_dtype=self.kv_dtype)
        self.on_chunk = on_chunk
        self.on_prefill = on_prefill
        # chaos: faults polled on the decode-step clock each cycle; the
        # kinds the engine cannot act on itself (bus_drop / bus_delay) go
        # to on_fault, so that the launcher disturbs its own telemetry
        self.injector = injector
        # on_heartbeat(clock_step, chunk_wall_s): liveness for a serving
        # supervisor, suppressed while a "stall" fault lasts
        self.on_heartbeat = on_heartbeat
        self.on_fault = on_fault
        self.snapshot_every = int(snapshot_every)
        self._ckpt = CheckpointManager(snapshot_dir, keep=2) \
            if snapshot_dir else None
        self.kv = PagedKVCache(cfg, n_slots=engine_cfg.n_slots,
                               page_size=engine_cfg.page_size,
                               max_len=engine_cfg.max_len,
                               n_pages=engine_cfg.n_pages,
                               dtype=self.kv_dtype,
                               host_tier=engine_cfg.host_tier,
                               host_pages=engine_cfg.host_pages,
                               transfer_j_per_byte=engine_cfg.transfer_j_per_byte,
                               recompute_j_per_token=engine_cfg.recompute_j_per_token)
        self._use_prefix = (engine_cfg.prefix_cache
                            and not tfm.chunked_prefill_blockers(cfg))
        self.scheduler = Scheduler(engine_cfg.n_slots, self.kv,
                                   admission=admission,
                                   max_skip=engine_cfg.max_skip,
                                   lazy=engine_cfg.preempt,
                                   prefix=self._use_prefix)
        self.cache = self.kv.make_cache(self.device)
        # unit subs whose page axis rides the main block tables: the only
        # pools a page copy may touch (a windowed sub's axis 1 holds the
        # slots' private rings, an SSM sub's their state slots); MLA subs
        # always do, and so does the first dense layers' group
        self._table_subs = frozenset(
            f"sub{i}" for i in range(tfm.unit_size(cfg))
            if not cfg.uses_ssm
            and (cfg.use_mla or cfg.window_for_layer(i) == 0))
        self._transfer_seen = 0.0            # kv.transfer_j folded so far
        if engine_cfg.host_tier:
            if self.kv.tables_active:
                self.kv.attach_tier(self._fetch_page, self._restore_page,
                                    self._cache_page_bytes())
            else:
                warnings.warn(
                    f"config {cfg.name!r}: host KV tier disabled: no page "
                    "pool rides the block tables (state-slot layout)",
                    RuntimeWarning, stacklevel=2)
        self._ctx = make_run_ctx(cfg, self.step_cfg)
        self._loops: dict[tuple[int, bool], Callable] = {}
        self._suffix = make_prefill_suffix_step(cfg, self.step_cfg) \
            if self._use_prefix else None
        self._pos = np.zeros((engine_cfg.n_slots,), np.int32)
        self._gen = None
        if not engine_cfg.greedy:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(engine_cfg.sample_seed)
        self._eff_chunk = engine_cfg.decode_chunk
        self._drafter = None
        self._dstate = None
        if engine_cfg.spec_k > 0:
            spec_block = (tfm.speculative_blockers(cfg)
                          or tfm.chunked_prefill_blockers(cfg))
            if spec_block:
                raise ValueError(f"{cfg.name}: speculative serving blocked "
                                 f"by {spec_block[0]}")
            self._drafter = speculate.get_drafter(
                engine_cfg.drafter, engine_cfg.spec_k,
                hist_len=engine_cfg.drafter_hist)
            # host mirror of the per-slot drafter state, like pos and the
            # block tables: seeded at join, carried through the chunk loop,
            # read back at harvest
            self._dstate = self._drafter.init_state(engine_cfg.n_slots)
        # graceful degradation: level 0 healthy, 1 derate (admission
        # paused), 2 emergency cap (also a halved chunk, no speculation)
        self._degrade_level = 0
        self._degrade_until = -1           # engine-clock step the window ends
        self._cap_frac = 1.0               # cap fraction in force (reporting)
        self._stall_until = -1             # heartbeat suppression window end

    # -- device steps ----------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _chunk_loop(self, chunk: int, spec: bool):
        key = (chunk, spec)
        if key not in self._loops:
            if spec:
                self._loops[key] = make_paged_speculative_decode_loop(
                    self.cfg, self.step_cfg, chunk, drafter=self._drafter,
                    greedy=self.ecfg.greedy,
                    temperature=self.ecfg.temperature)
            else:
                self._loops[key] = make_paged_decode_loop(
                    self.cfg, self.step_cfg, chunk, greedy=self.ecfg.greedy,
                    temperature=self.ecfg.temperature)
        return self._loops[key]

    def _inject_rows(self, slot: int, bucket: int, L: int) -> dict:
        """Per-sub flat destination rows for :meth:`_inject`: length-
        ``bucket`` arrays mapping prefill index ``p`` to a pool row, out of
        bounds (dropped) where ``p`` is padding or outside the sub's
        retention.  Table subs take ``PagedKVCache.inject_rows``; a
        window-``w`` sub keeps only ``[max(0, L - w), L)``, at ring offset
        ``p % Cw`` of the slot's private pages (older rows can never be
        attended again).  SSM subs have state slots, not rows: none.  MLA
        subs and the first dense layers' group (``__dense__``) take the
        main rows; the hybrid shared buffer (``__shared__``) the slot's
        linear span, ``slot * cs + p`` for ``p < L``."""
        ps = self.kv.page_size
        main = np.asarray(self.kv.inject_rows(slot, bucket, L))
        rows = {}
        if self.cfg.first_dense_layers:
            rows["__dense__"] = main
        for i in range(tfm.unit_size(self.cfg)):
            if self.cfg.uses_ssm:
                continue
            w = 0 if self.cfg.use_mla else self.cfg.window_for_layer(i)
            if w <= 0:
                rows[f"sub{i}"] = main
                continue
            cw = -(-min(self.kv.max_blocks * ps, w) // ps) * ps
            p = np.arange(bucket)
            valid = (p >= max(0, L - w)) & (p < L)
            rows[f"sub{i}"] = np.where(valid, slot * cw + p % cw,
                                       self.ecfg.n_slots * cw)
        if tfm.is_hybrid(self.cfg):
            cs = self.kv.max_blocks * ps
            p = np.arange(bucket)
            rows["__shared__"] = np.where(p < L, slot * cs + p,
                                          self.ecfg.n_slots * cs)
        return rows

    def _inject(self, pcache, rows: dict, slot: int) -> None:
        """Scatter a (padded, linear) prefill cache into the slot's pages
        and private rings, in place; out-of-bounds rows are dropped.  An
        SSM sub's state slot is overwritten with the prompt's state.  The
        prefill keeps the first dense layers' caches as a list; they are
        stacked into the paged group's layout.  The hybrid shared buffer
        takes its rows like a pool.  int8 pools quantize the rows per row
        and write their scales beside them."""
        groups = [(c, pcache["units"][name], rows.get(name))
                  for name, c in self.cache["units"].items()]
        if "shared" in self.cache:
            groups.append((self.cache["shared"], pcache["shared"],
                           rows["__shared__"]))
        if "dense" in self.cache:
            src = {key: torch.stack([c[key] for c in pcache["dense"]])
                   for key in self.cache["dense"]}
            groups.append((self.cache["dense"], src, rows["__dense__"]))
        def scatter(pool, vals):
            pool.view(pool.shape[0], -1, *pool.shape[3:]).index_copy_(
                1, idx, vals.to(pool.dtype))

        for c, src, r in groups:
            if "conv" in c:
                for key in ("conv", "ssm"):
                    c[key][:, slot] = src[key][:, 0].to(c[key].dtype)
                continue
            first = next(iter(c.values()))
            keep = r < first.shape[1] * first.shape[2]
            idx = self._tensor(r[keep], torch.int64)
            sel = self._tensor(np.nonzero(keep)[0], torch.int64)
            for key in ("k", "v", "lat"):
                if key not in c:
                    continue
                vals = src[key][:, 0].index_select(1, sel)   # (nu, n, ...)
                if key + "_scale" in c:
                    # int8 pools: the prefill rows quantize on the way in,
                    # as the decode scatter and the commit do
                    vals, scales = quant.quantize_int8_rows(vals)
                    scatter(c[key + "_scale"], scales)
                scatter(c[key], vals)

    def _page_copy(self, src: int, dst: int, n_rows: int) -> None:
        """Copy-on-write: rows 0..n_rows-1 of ``src`` page into ``dst``
        across every pool on the block tables (scale pools in int8 mode),
        the first dense layers' group included, in place."""
        for c in self._table_groups().values():
            for pool in c.values():
                pool[:, dst, :n_rows] = pool[:, src, :n_rows]

    # -- host tier (two-tier KV hierarchy) -------------------------------------
    def _table_groups(self) -> dict:
        """Pool groups whose axis 1 is the main page-id space: the unit
        subs on the block tables plus the stacked first dense layers.
        Slot-indexed groups (windowed rings, SSM state, the hybrid shared
        buffer) are not pages."""
        groups = {name: c for name, c in self.cache["units"].items()
                  if name in self._table_subs}
        if "dense" in self.cache:
            groups["dense"] = self.cache["dense"]
        return groups

    def _cache_page_bytes(self) -> int:
        """Device bytes of ONE page across every table pool, scale pools
        included in int8 mode: what each page-out and page-in is charged
        for."""
        return sum(pool.numel() // pool.shape[1] * pool.element_size()
                   for c in self._table_groups().values()
                   for pool in c.values())

    def _fetch_page(self, page: int) -> dict:
        """D2H: one device page's rows of every table pool as host numpy
        blobs (keys ``group/pool``).  numpy has no bfloat16, so a bf16
        pool goes out as its uint16 bit pattern.  The copy waits for the
        device, as JAX's ``np.asarray`` does: one wait per demotion
        (``PagedKVCache.n_demotions`` counts them)."""
        blobs = {}
        for name, c in self._table_groups().items():
            for key, pool in c.items():
                # a host tensor of its own: on a CPU engine ``.cpu()`` would
                # alias the pool, whose page is about to be reused
                rows = torch.empty(pool.shape[:1] + pool.shape[2:],
                                   dtype=pool.dtype)
                rows.copy_(pool[:, page])
                if rows.dtype == torch.bfloat16:
                    rows = rows.view(torch.int16).numpy().view(np.uint16)
                else:
                    rows = rows.numpy()
                blobs[f"{name}/{key}"] = rows
        return blobs

    def _restore_page(self, page: int, blob: dict) -> None:
        """H2D: write a fetched blob back into device page ``page`` of
        every table pool, bit for bit (a bf16 pool takes its uint16 bits
        back)."""
        for name, c in self._table_groups().items():
            for key, pool in c.items():
                rows = np.asarray(blob[f"{name}/{key}"])
                if pool.dtype == torch.bfloat16:
                    t = torch.from_numpy(rows.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(rows)
                pool[:, page] = t.to(self.device)

    def _sync_transfer(self) -> None:
        """Fold the tier-transfer energy the page manager charged since the
        last sync into the run's ledger: modelled (bytes x J/byte), not
        measured; ``energy_j`` includes it and ``transfer_j`` breaks it
        out, so J/token includes the cost of paging."""
        delta = self.kv.transfer_j - self._transfer_seen
        if delta > 0.0:
            self._transfer_seen = self.kv.transfer_j
            self._report.energy_j += delta
            self._report.transfer_j += delta

    def _bucket(self, L: int) -> int:
        b = self.ecfg.min_prefill_bucket
        while b < L:
            b *= 2
        return b

    def _prefill_suffix(self, slot: int, req: Request, m: int):
        """Chunked paged prefill of the uncached suffix ``prompt[m:]``;
        returns the logits row scoring the token after the prompt."""
        ecfg = self.ecfg
        L = req.prompt_len
        suffix = np.asarray(req.prompt[m:])
        qc = ecfg.prefill_chunk
        logits, r = None, 0
        for c0 in range(0, L - m, qc):
            r = min(qc, L - m - c0)
            tok = np.zeros((ecfg.n_slots, qc), np.int32)
            tok[slot, :r] = suffix[c0:c0 + r]
            ncommit = np.zeros((ecfg.n_slots,), np.int32)
            ncommit[slot] = r
            pos = self._pos.copy()
            pos[slot] = m + c0
            self.cache = {**self.cache, "pos": self._tensor(pos),
                          "block_tables": self._tensor(self.kv.tables)}
            logits, self.cache = self._suffix(self.params, self.cache,
                                              self._tensor(tok),
                                              self._tensor(ncommit))
        return logits[slot, r - 1]

    # -- join ----------------------------------------------------------------
    def _sample_first(self, logits_row, rid: int):
        """The prefill's token from its last prompt row: (Vp,) -> a 0-d
        array, or a codebook model's (n_cb, Vp) -> (n_cb,)."""
        del rid
        nxt = sample(logits_row[None], greedy=self.ecfg.greedy,
                     temperature=self.ecfg.temperature, generator=self._gen)
        return np.asarray(nxt.cpu()[0], np.int32)

    def _join(self, slot: int, req: Request, m: int, copy, t0: float) -> None:
        L = req.prompt_len
        if L + req.max_new_tokens > self.ecfg.max_len:
            raise ValueError(f"request {req.rid}: prompt {L} + "
                             f"{req.max_new_tokens} new > max_len "
                             f"{self.ecfg.max_len}")
        if copy is not None:
            self._page_copy(copy.src_page, copy.dst_page, copy.n_rows)
            self.kv.copy_done(copy.src_page)
        if m > 0:
            logits_row = self._prefill_suffix(slot, req, m)
        else:
            # SSM prompts prefill at their exact length: the recurrent
            # state is a reduction over every fed token, pad included
            bucket = L if self.cfg.uses_ssm else self._bucket(L)
            inputs = np.zeros((1, bucket) + req.prompt.shape[1:], np.int32)
            inputs[0, :L] = req.prompt
            # full_cache: windowed subs stay linear, so that the bucket's
            # pad rows cannot wrap over the real window tail
            logits, pcache = tfm.prefill(self.params, self._tensor(inputs),
                                         self.cfg, self._ctx, max_len=bucket,
                                         full_cache=True)
            logits_row = logits[0, L - 1]
            self._inject(pcache, self._inject_rows(slot, bucket, L), slot)
        first = self._sample_first(logits_row, req.rid)
        self._pos[slot] = L
        if self._use_prefix:
            self.kv.register_prefix(slot, np.asarray(req.prompt))
        if self._drafter is not None:
            self._drafter.seed_request(self._dstate, slot, req.prompt, first)
        state = self.scheduler.slots[slot]
        state.next_token = first
        state.tok_start = len(self._results[req.rid].tokens)
        res = self._results[req.rid]
        res.slot = slot
        if res.admit_step < 0:        # requeued joins keep first-admit stats
            res.admit_step = self._now
            res.admit_t = time.perf_counter() - t0
        res.prefill_tokens_saved += m
        self._report.prompt_tokens += L
        self._report.prefill_tokens_saved += m
        if self.on_prefill is not None:
            energy = self.on_prefill(L - m, m)
            if energy:
                self._report.energy_j += energy
                res.energy_j += energy
        res.tokens.append(first.tolist() if first.ndim else int(first))
        if req.eos_id is not None and first.ndim == 0 \
                and int(first) == req.eos_id:
            state.remaining = 0
            res.finish_reason = "eos"
        if state.remaining <= 0:                  # max_new 1, or instant EOS
            res.finish_reason = res.finish_reason or "max_new_tokens"
            res.finish_step = self._now
            res.finish_t = time.perf_counter() - t0
            self.scheduler.finish(slot)
            self._pos[slot] = 0

    # -- preemption ----------------------------------------------------------
    def _preempt(self, slot: int, t0: float) -> None:
        """Evict ``slot`` on page pressure: re-queue its request with the
        tokens generated so far folded into the prompt, index its pages in
        the prefix cache, then free the slot."""
        state = self.scheduler.slots[slot]
        req = state.request
        res = self._results[req.rid]
        gen = np.asarray(res.tokens[state.tok_start:], np.int32)
        prompt = np.asarray(req.prompt, np.int32)
        if gen.size:
            prompt = np.concatenate([prompt, gen.reshape((-1,) +
                                                         prompt.shape[1:])])
        written = int(self._pos[slot])
        if self._use_prefix:
            self.kv.register_prefix(slot, prompt[:written])
        new_req = dataclasses.replace(req, prompt=prompt,
                                      max_new_tokens=state.remaining,
                                      arrival_step=self._now)
        self.scheduler.finish(slot)
        self._pos[slot] = 0
        self._queue.push(new_req)
        res.n_preemptions += 1
        self._report.n_preemptions += 1

    def _grow_pages(self, t0: float, need: int | None = None) -> None:
        """Lazy allocation: grow every active slot's pages to cover the
        chunk's writes, preempting the lowest-priority slot when the pool
        runs dry."""
        ecfg = self.ecfg
        if need is None:
            need = ecfg.decode_chunk * (ecfg.spec_k + 1)
        slots = self.scheduler.slots
        order = sorted(self.scheduler.active_slots(),
                       key=lambda s: (-slots[s].request.priority,
                                      slots[s].seq))
        for slot in order:
            if slots[slot] is None:
                continue                   # preempted earlier this pass
            req = slots[slot].request
            ctx = req.prompt_len + req.max_new_tokens - 1
            target = min(int(self._pos[slot]) + need, ctx, self.kv.max_len)
            while not self.kv.ensure(slot, target):
                victim = self.scheduler.victim()
                if victim == slot:
                    if self.scheduler.n_active <= 1:
                        raise RuntimeError(
                            f"request {slots[slot].request.rid}: page pool "
                            f"({self.kv.n_pages} pages) too small even at "
                            "zero concurrency; raise n_pages")
                    self._preempt(slot, t0)
                    break
                self._preempt(victim, t0)

    # -- harvest -------------------------------------------------------------
    def _harvest(self, toks: np.ndarray, counts: np.ndarray,
                 t0: float) -> dict[int, int]:
        """Append each active slot's kept tokens, finish on EOS / budget.

        toks (n_slots, steps, K+1[, n_cb]): step s of slot b yields
        ``counts[b, s]`` tokens (1 on the plain path; accepted drafts + the
        bonus token, 1..K+1, when speculating), consumed in order; a
        codebook model's token is its ``n_cb`` codes, kept as a list, and
        never ends a request on EOS (as in JAX).  Returns kept tokens per
        request id."""
        kept_by_rid: dict[int, int] = {}
        for slot in self.scheduler.active_slots():
            state = self.scheduler.slots[slot]
            req = state.request
            res = self._results[req.rid]
            kept = 0
            budget = state.remaining
            for s in range(toks.shape[1]):
                if res.finish_reason == "eos" or kept >= budget:
                    break
                for i in range(int(counts[slot, s])):
                    t = toks[slot, s, i]
                    res.tokens.append(t.tolist() if t.ndim else int(t))
                    kept += 1
                    if req.eos_id is not None and t.ndim == 0 \
                            and int(t) == req.eos_id:
                        res.finish_reason = "eos"
                        break
                    if kept >= budget:
                        break
            kept_by_rid[req.rid] = kept
            state.remaining = 0 if res.finish_reason == "eos" \
                else state.remaining - kept
            # the loop's carried token: last emitted token of the last step
            state.next_token = toks[slot, -1,
                                    max(int(counts[slot, -1]) - 1, 0)]
            if state.remaining == 0:
                res.finish_reason = res.finish_reason or "max_new_tokens"
                res.finish_step = self._now + self._eff_chunk
                res.finish_t = time.perf_counter() - t0
                self.scheduler.finish(slot)
                self._pos[slot] = 0
        return kept_by_rid

    # -- chaos + degradation -------------------------------------------------
    def degrade(self, level: int, *, steps: int, cap: float = 1.0) -> None:
        """Enter (or extend / deepen) a degradation window of ``steps``
        engine-clock steps.  Level 1 (derate) pauses admission; level 2
        (emergency cap) also halves the decode chunk and drops speculation.
        The window clears itself once the clock passes its end."""
        self._degrade_level = max(self._degrade_level, int(level))
        self._degrade_until = max(self._degrade_until,
                                  self._now + max(int(steps), 1))
        if cap:
            self._cap_frac = min(self._cap_frac, float(cap))

    @property
    def degrade_level(self) -> int:
        return self._degrade_level

    def _apply_faults(self, t0: float) -> None:
        """Poll the injector on the decode-step clock and apply what came
        due.  ``engine_crash`` raises :class:`EngineCrash` (the caller
        restores from the last snapshot); the rest is absorbed in place."""
        if self.injector is None:
            return
        for ev in self.injector.poll(self._now):
            self._report.n_faults_injected += 1
            if ev.kind == "engine_crash":
                raise EngineCrash(self._now)
            if ev.kind == "slot_crash":
                slot = int(ev.arg) % self.ecfg.n_slots
                if self.scheduler.slots[slot] is not None:
                    self._preempt(slot, t0)
                    self._report.requeued_requests += 1
            elif ev.kind == "page_corrupt":
                if corrupt_paged_kv(self.kv, self.injector.rng) is not None:
                    # audit and repair at once: nothing may allocate on
                    # corrupted metadata
                    self.kv.verify_invariants(repair=True)
                    self._report.n_pages_quarantined = \
                        len(self.kv.quarantined)
            elif ev.kind == "stall":
                self._stall_until = self._now + \
                    max(ev.duration, self.ecfg.decode_chunk)
            elif ev.kind == "derate":
                self.degrade(1, steps=max(ev.duration, 1), cap=ev.arg)
            elif ev.kind == "emergency_cap":
                self.degrade(2, steps=max(ev.duration, 1), cap=ev.arg)
            elif self.on_fault is not None:
                self.on_fault(ev)     # bus_drop / bus_delay: the launcher's

    # -- snapshot / restore --------------------------------------------------
    @staticmethod
    def _ser_req(req: Request) -> dict:
        p = np.asarray(req.prompt)
        return {"rid": req.rid, "prompt": p.tolist(), "dtype": str(p.dtype),
                "max_new_tokens": req.max_new_tokens,
                "arrival_step": req.arrival_step, "eos_id": req.eos_id,
                "priority": req.priority}

    @staticmethod
    def _de_req(rec: dict) -> Request:
        return Request(rid=int(rec["rid"]),
                       prompt=np.asarray(rec["prompt"], dtype=rec["dtype"]),
                       max_new_tokens=int(rec["max_new_tokens"]),
                       arrival_step=int(rec["arrival_step"]),
                       eos_id=rec["eos_id"], priority=int(rec["priority"]))

    def snapshot(self) -> dict:
        """The engine's recoverable state as a checkpointable tree: the
        device pools (``cache``) and a JSON blob (``meta``, a uint8 array)
        of the queue, each slot's progress, the results so far, the report
        counters, the degradation windows and the paged-KV host metadata
        (block tables, trie, host-tier pages).  Taken at chunk boundaries
        only, so every slot's KV is written through its ``pos`` and the
        fold into the prompt replays exactly."""
        slots = []
        for slot in self.scheduler.active_slots():
            state = self.scheduler.slots[slot]
            slots.append({"slot": slot,
                          "request": self._ser_req(state.request),
                          "remaining": int(state.remaining),
                          "tok_start": int(state.tok_start),
                          "written": int(self._pos[slot])})
        rep = {f.name: getattr(self._report, f.name)
               for f in dataclasses.fields(self._report)
               if f.name != "results"}
        meta = {"now": self._now, "chunk_idx": self._chunk_idx,
                "occ_sum": self._occ_sum,
                # a cap or derate window outlives the process that crashed
                # under it: the restored engine stays degraded until the
                # window ends
                "degrade": {"level": self._degrade_level,
                            "until": self._degrade_until,
                            "cap": self._cap_frac,
                            "stall": self._stall_until},
                "req_order": self._req_order,
                "queue": [self._ser_req(r) for r in self._queue.pending()],
                "slots": slots,
                "results": {str(rid): dataclasses.asdict(res)
                            for rid, res in self._results.items()},
                "report": rep,
                "kv": self.kv.state_dict()}
        blob = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
        return {"cache": self.cache, "meta": blob}

    def save_snapshot(self) -> None:
        """Write :meth:`snapshot` as step ``now``; the pools' copy to the
        host waits for the device."""
        if self._ckpt is None:
            raise ValueError("engine was built without snapshot_dir")
        self._ckpt.save(self.snapshot(), self._now)

    @classmethod
    def restore(cls, cfg, engine_cfg: EngineConfig, params, snapshot_dir,
                *, step: int | None = None, **kwargs) -> "ServeEngine":
        """Rebuild an engine from the latest committed snapshot (or
        ``step``).

        The pools come back onto the engine's device bit for bit, and the
        paged-KV metadata (prefix trie and host-tier pages included)
        verbatim.  Then every in-flight slot becomes a requeued request
        with its generated tokens folded into the prompt, its written pages
        registered in the trie before the slot is released, so that
        ``resume()`` re-admits it through the prefix cache: the re-prefill
        is short and the greedy streams equal an uninterrupted run's.
        ``verify_invariants(repair=True)`` audits the restored pool."""
        eng = cls(cfg, engine_cfg, params, snapshot_dir=snapshot_dir,
                  **kwargs)
        like = {"cache": eng.cache, "meta": np.zeros((0,), np.uint8)}
        tree = restore_pytree(like, snapshot_dir, step)
        meta = json.loads(bytes(tree["meta"]))
        eng.cache = tree["cache"]
        eng.kv.load_state(meta["kv"])
        eng.kv.verify_invariants(repair=True)
        # transfer energy accrued before the crash is inside the restored
        # report: charge only what happens from here on
        eng._transfer_seen = eng.kv.transfer_j
        eng._results = {int(rid): RequestResult(**rec)
                        for rid, rec in meta["results"].items()}
        eng._req_order = [int(r) for r in meta["req_order"]]
        eng._now = int(meta["now"])
        eng._chunk_idx = int(meta["chunk_idx"])
        eng._occ_sum = float(meta["occ_sum"])
        deg = meta["degrade"]
        eng._degrade_level = int(deg["level"])
        eng._degrade_until = int(deg["until"])
        eng._cap_frac = float(deg["cap"])
        eng._stall_until = int(deg["stall"])
        eng._report = EngineReport(results=[], **meta["report"])
        eng._report.n_restores += 1
        if eng.injector is not None:
            # the crash's own injection died with the process (snapshots
            # predate it): the injector's log is authoritative
            eng._report.n_faults_injected = max(
                eng._report.n_faults_injected, eng.injector.n_injected)
            # derate / cap windows are external conditions: one that fired
            # after the last snapshot will not fire again, but its window
            # may still be open, so the remainder is imposed again
            for ev in eng.injector.log:
                lvl = {"derate": 1, "emergency_cap": 2}.get(ev.kind)
                if lvl and ev.step + ev.duration > eng._now:
                    eng.degrade(lvl, steps=ev.step + ev.duration - eng._now,
                                cap=ev.arg)
        eng._report.n_pages_quarantined = len(eng.kv.quarantined)
        reqs = [eng._de_req(rec) for rec in meta["queue"]]
        for srec in meta["slots"]:
            req = eng._de_req(srec["request"])
            res = eng._results[req.rid]
            gen = np.asarray(res.tokens[int(srec["tok_start"]):], np.int32)
            prompt = np.asarray(req.prompt, np.int32)
            if gen.size:
                prompt = np.concatenate(
                    [prompt, gen.reshape((-1,) + prompt.shape[1:])])
            slot = int(srec["slot"])
            if eng._use_prefix and slot in eng.kv.allocated:
                # index the dead slot's written pages before releasing
                # them: the requeue restores from the trie, not compute
                eng.kv.register_prefix(slot, prompt[:int(srec["written"])])
            reqs.append(dataclasses.replace(
                req, prompt=prompt, max_new_tokens=int(srec["remaining"]),
                arrival_step=eng._now))
            eng._report.requeued_requests += 1
        for slot in list(eng.kv.allocated):   # slots died with the process
            eng.kv.release(slot)
        eng._pos[:] = 0
        eng._queue = RequestQueue(reqs)
        return eng

    def resume(self) -> EngineReport:
        """Continue a restored engine to completion."""
        with torch.no_grad():
            return self._drive()

    # -- main loop -----------------------------------------------------------
    def _begin(self, requests: list[Request]) -> None:
        self._queue = RequestQueue(requests)
        self._results = {r.rid: RequestResult(
            rid=r.rid, prompt_len=r.prompt_len, arrival_step=r.arrival_step,
            max_new_tokens=r.max_new_tokens) for r in requests}
        self._req_order = [r.rid for r in requests]
        self._now = 0
        self._chunk_idx = 0
        self._occ_sum = 0.0
        self._report = EngineReport(results=[], spec_k=self.ecfg.spec_k)
        self._transfer_seen = self.kv.transfer_j
        self._degrade_level = 0
        self._degrade_until = -1
        self._cap_frac = 1.0
        self._stall_until = -1
        self._eff_chunk = self.ecfg.decode_chunk

    def run(self, requests: list[Request]) -> EngineReport:
        self._begin(requests)
        with torch.no_grad():
            if self._ckpt is not None and self.snapshot_every > 0:
                # step-0 snapshot: a crash before the first periodic save
                # still restores (to the full queue)
                self.save_snapshot()
            return self._drive()

    def _drive(self) -> EngineReport:
        ecfg = self.ecfg
        queue = self._queue
        report = self._report
        t0 = time.perf_counter()
        n_cb = self.cfg.n_codebooks
        tok_in = np.zeros((ecfg.n_slots, 1) + ((n_cb,) if n_cb else ()),
                          np.int32)

        while len(queue) or self.scheduler.n_active:
            self._apply_faults(t0)           # may raise EngineCrash
            if self._degrade_level and self._now >= self._degrade_until:
                self._degrade_level = 0      # window cleared: full service
                self._cap_frac = 1.0
            degraded = self._degrade_level
            t_p = time.perf_counter()
            if not degraded:                 # degraded: admission paused
                for slot, req, m, copy in self.scheduler.poll(queue,
                                                              self._now):
                    self._join(slot, req, m, copy, t0)
            # emergency cap: halve the chunk and drop speculation, so that
            # the chunk's compute shrinks instead of breaking the cap
            eff_chunk = ecfg.decode_chunk if degraded < 2 \
                else max(ecfg.decode_chunk // 2, 1)
            spec = self._drafter is not None and degraded < 2
            eff_k = ecfg.spec_k if spec else 0
            self._eff_chunk = eff_chunk
            if ecfg.preempt:
                self._grow_pages(t0, eff_chunk * (eff_k + 1))
            # joins may have paged prefixes in, growth cold pages out:
            # their modelled energy enters the ledger before the chunk's
            self._sync_transfer()
            self._sync()
            report.prefill_wall_s += time.perf_counter() - t_p

            if self.scheduler.n_active == 0:
                if degraded:
                    # admission paused and nothing running: jump the clock
                    # to the window's end instead of spinning
                    self._now = max(self._degrade_until, self._now + 1)
                    report.degraded_steps += eff_chunk
                    continue
                nxt = queue.next_arrival()
                if nxt is None:
                    break
                if nxt <= self._now:
                    raise RuntimeError(
                        f"request {queue.peek_ready(self._now).rid} not "
                        f"admissible at zero load (pool {self.kv.n_pages} "
                        "pages / admission hook); raise n_pages or the "
                        "power budget")
                self._now = nxt                   # idle: jump to next arrival
                continue

            active = np.zeros((ecfg.n_slots,), np.int32)
            for slot in self.scheduler.active_slots():
                active[slot] = 1
                tok_in[slot, 0] = self.scheduler.slots[slot].next_token
            self.cache = {**self.cache, "pos": self._tensor(self._pos),
                          "block_tables": self._tensor(self.kv.tables)}
            loop = self._chunk_loop(eff_chunk, spec)
            args = [self.params, self.cache, self._tensor(tok_in),
                    self._tensor(active)]
            if spec:
                args.append(speculate.state_to(self._dstate, self.device))
            t_c = time.perf_counter()
            if spec:
                toks, counts, self.cache, dstate = loop(*args, self._gen)
                self._sync()
                wall = time.perf_counter() - t_c
                toks = toks.cpu().numpy()
                counts = counts.cpu().numpy()
                self._dstate = speculate.state_to_host(dstate)
            else:
                toks, self.cache = loop(*args, self._gen)
                self._sync()
                wall = time.perf_counter() - t_c
                toks = toks.cpu().numpy()[:, :, None]
                counts = np.ones(toks.shape[:2], np.int32)

            n_active = int(active.sum())
            # the device pos advanced by each slot's emitted counts
            self._pos += counts.sum(axis=1).astype(np.int32) * active
            kept_by_rid = self._harvest(toks, counts, t0)
            kept = sum(kept_by_rid.values())
            proposed = n_active * eff_chunk * eff_k
            accepted = int(counts.sum()) - n_active * eff_chunk \
                if spec else 0
            self._now += eff_chunk
            self._chunk_idx += 1
            if degraded:
                report.degraded_steps += eff_chunk

            stats = ChunkStats(step=self._chunk_idx, wall_s=wall,
                               n_slots=ecfg.n_slots, n_active=n_active,
                               tokens_kept=kept,
                               tokens_computed=n_active * eff_chunk
                               * (eff_k + 1),
                               drafts_proposed=proposed,
                               drafts_accepted=accepted,
                               clock_step=self._now,
                               degrade_level=degraded)
            energy = self.on_chunk(stats) if self.on_chunk is not None else None
            report.n_chunks += 1
            report.decode_wall_s += wall
            report.tokens_kept += kept
            report.tokens_computed += stats.tokens_computed
            report.drafts_proposed += proposed
            report.drafts_accepted += accepted
            self._occ_sum += n_active / ecfg.n_slots
            if energy:
                report.energy_j += energy
                for rid, n in kept_by_rid.items():
                    if n > 0:
                        self._results[rid].energy_j += energy * n / max(kept, 1)
            if self.on_heartbeat is not None and self._now > self._stall_until:
                self.on_heartbeat(self._now, wall)
            if self._ckpt is not None and self.snapshot_every > 0 \
                    and self._chunk_idx % self.snapshot_every == 0:
                self.save_snapshot()

        # final poll: a fault due between the last chunk and the run's end
        # still fires (an engine_crash here restores and replays the tail,
        # so results count only once this returns)
        self._apply_faults(t0)
        self._sync_transfer()
        report.n_demotions = self.kv.n_demotions
        report.n_promotions = self.kv.n_promotions
        report.occupancy = self._occ_sum / max(report.n_chunks, 1)
        report.results = [self._results[rid] for rid in self._req_order]
        return report


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)
