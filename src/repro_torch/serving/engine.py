"""Continuous-batching serving engine over the paged KV cache — the port of
``repro.serving.engine`` for the slice it serves:

    poll ──> prefill-on-join ──> grow/preempt ──> decode chunk ──> harvest
     ^   (cached prefix shared,   (lazy pages;     (paged loop,     │
     │    only the suffix runs)    requeue on       pools updated   │
     │                             pressure)        in place)       │
     └──────────────────── free slots / pages on finish ────────────┘

Joins with a prefix-cache hit map shared read-only pages and prefill only
the uncached suffix (chunked, through the paged verify sweep); cold
prompts run the bucketed prefill + page inject.  The host bookkeeping
(``PagedKVCache``, ``Scheduler``) is the JAX package's, copied; the device
steps are the port's torch functions on the engine's device.

``EngineConfig``, ``ChunkStats``, ``EngineReport`` and
``EnergyAwareAdmission`` are unchanged.  Configurations this slice does
not serve raise ``NotImplementedError`` naming the feature: speculative
decoding (``spec_k > 0``), int8 KV pages, the host tier, fault injection
and snapshots.

``ChunkStats.wall_s`` is taken after ``torch.cuda.synchronize()``: it
measures the chunk's execution on the card, not its enqueue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.models import transformer as tfm
from repro_torch.runtime.steps import (StepConfig, make_paged_decode_loop,
                                       make_prefill_suffix_step,
                                       make_run_ctx, sample,
                                       with_decode_policy)
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import RequestQueue, Scheduler


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


def _unported(ecfg: EngineConfig, injector, snapshot_dir) -> str | None:
    if ecfg.spec_k > 0:
        return "speculative decoding (spec_k > 0)"
    if ecfg.kv_dtype == "int8":
        return "int8 KV pages (kv_dtype='int8')"
    if ecfg.host_tier:
        return "host-memory KV tier (host_tier)"
    if injector is not None:
        return "fault injection (injector)"
    if snapshot_dir is not None:
        return "engine snapshots (snapshot_dir)"
    return None


class ServeEngine:
    """Drives the paged decode loop over live slots on one device."""

    def __init__(self, cfg, engine_cfg: EngineConfig, params, *,
                 step_cfg: StepConfig | None = None, device=None,
                 on_chunk: Callable[[ChunkStats], float | None] | None = None,
                 on_prefill: Callable[[int, int], float | None] | None = None,
                 admission=None, injector=None,
                 on_heartbeat: Callable[[int, float], None] | None = None,
                 snapshot_dir: str | None = None):
        missing = _unported(engine_cfg, injector, snapshot_dir)
        if missing:
            raise NotImplementedError(f"{missing} is not ported to "
                                      "repro_torch yet")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = _device.resolve(device)
        self.params = tfm.prepare_params(
            {k: _to(v, self.device) for k, v in params.items()}, cfg)
        self.kv_dtype = engine_cfg.cache_dtype
        self.step_cfg = with_decode_policy(
            step_cfg or StepConfig(),
            kv_splits=engine_cfg.kv_splits,
            decode_k_chunk=engine_cfg.decode_k_chunk,
            kv_dtype=self.kv_dtype)
        self.on_chunk = on_chunk
        self.on_prefill = on_prefill
        self.on_heartbeat = on_heartbeat
        self.kv = PagedKVCache(cfg, n_slots=engine_cfg.n_slots,
                               page_size=engine_cfg.page_size,
                               max_len=engine_cfg.max_len,
                               n_pages=engine_cfg.n_pages,
                               dtype=self.kv_dtype)
        self._use_prefix = (engine_cfg.prefix_cache
                            and not tfm.chunked_prefill_blockers(cfg))
        self.scheduler = Scheduler(engine_cfg.n_slots, self.kv,
                                   admission=admission,
                                   max_skip=engine_cfg.max_skip,
                                   lazy=engine_cfg.preempt,
                                   prefix=self._use_prefix)
        self.cache = self.kv.make_cache(self.device)
        self._ctx = make_run_ctx(cfg, self.step_cfg)
        self._loops: dict[int, Callable] = {}
        self._suffix = make_prefill_suffix_step(cfg, self.step_cfg) \
            if self._use_prefix else None
        self._pos = np.zeros((engine_cfg.n_slots,), np.int32)
        self._gen = None
        if not engine_cfg.greedy:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(engine_cfg.sample_seed)
        self._eff_chunk = engine_cfg.decode_chunk

    # -- device steps ----------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _chunk_loop(self, chunk: int):
        if chunk not in self._loops:
            self._loops[chunk] = make_paged_decode_loop(
                self.cfg, self.step_cfg, chunk, greedy=self.ecfg.greedy,
                temperature=self.ecfg.temperature)
        return self._loops[chunk]

    def _inject(self, pcache, rows: np.ndarray) -> None:
        """Scatter a (padded) prefill cache into the slot's pages, in
        place; rows past the prompt (out of bounds) are dropped."""
        keep = rows < self.kv.n_pages * self.kv.page_size
        idx = self._tensor(rows[keep], torch.int64)
        sel = self._tensor(np.nonzero(keep)[0], torch.int64)
        for name, c in self.cache["units"].items():
            src = pcache["units"][name]
            for key in ("k", "v"):
                pool = c[key]
                nu = pool.shape[0]
                vals = src[key][:, 0].index_select(1, sel)   # (nu, n, Hkv, hd)
                pool.view(nu, -1, *pool.shape[3:]).index_copy_(
                    1, idx, vals.to(pool.dtype))

    def _page_copy(self, src: int, dst: int, n_rows: int) -> None:
        """Copy-on-write: rows 0..n_rows-1 of ``src`` page into ``dst``
        across every pool, in place."""
        for c in self.cache["units"].values():
            for pool in c.values():
                pool[:, dst, :n_rows] = pool[:, src, :n_rows]

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
            bucket = self._bucket(L)
            inputs = np.zeros((1, bucket), np.int32)
            inputs[0, :L] = req.prompt
            logits, pcache = tfm.prefill(self.params, self._tensor(inputs),
                                         self.cfg, self._ctx, max_len=bucket)
            logits_row = logits[0, L - 1]
            self._inject(pcache, self.kv.inject_rows(slot, bucket, L))
        first = self._sample_first(logits_row, req.rid)
        self._pos[slot] = L
        if self._use_prefix:
            self.kv.register_prefix(slot, np.asarray(req.prompt))
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
        res.tokens.append(int(first))
        if req.eos_id is not None and int(first) == req.eos_id:
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
            need = ecfg.decode_chunk
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
    def _harvest(self, toks: np.ndarray, t0: float) -> dict[int, int]:
        """Append each active slot's kept tokens, finish on EOS / budget.
        toks (n_slots, chunk).  Returns kept tokens per request id."""
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
                t = int(toks[slot, s])
                res.tokens.append(t)
                kept += 1
                if req.eos_id is not None and t == req.eos_id:
                    res.finish_reason = "eos"
            kept_by_rid[req.rid] = kept
            state.remaining = 0 if res.finish_reason == "eos" \
                else state.remaining - kept
            state.next_token = toks[slot, -1]
            if state.remaining == 0:
                res.finish_reason = res.finish_reason or "max_new_tokens"
                res.finish_step = self._now + self._eff_chunk
                res.finish_t = time.perf_counter() - t0
                self.scheduler.finish(slot)
                self._pos[slot] = 0
        return kept_by_rid

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
        self._eff_chunk = self.ecfg.decode_chunk

    def run(self, requests: list[Request]) -> EngineReport:
        self._begin(requests)
        with torch.no_grad():
            return self._drive()

    def _drive(self) -> EngineReport:
        ecfg = self.ecfg
        queue = self._queue
        report = self._report
        t0 = time.perf_counter()
        tok_in = np.zeros((ecfg.n_slots, 1), np.int32)
        eff_chunk = ecfg.decode_chunk

        while len(queue) or self.scheduler.n_active:
            t_p = time.perf_counter()
            for slot, req, m, copy in self.scheduler.poll(queue, self._now):
                self._join(slot, req, m, copy, t0)
            if ecfg.preempt:
                self._grow_pages(t0, eff_chunk)
            self._sync()
            report.prefill_wall_s += time.perf_counter() - t_p

            if self.scheduler.n_active == 0:
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
            loop = self._chunk_loop(eff_chunk)
            t_c = time.perf_counter()
            toks, self.cache = loop(self.params, self.cache,
                                    self._tensor(tok_in),
                                    self._tensor(active), self._gen)
            self._sync()
            wall = time.perf_counter() - t_c
            toks = toks.cpu().numpy()

            n_active = int(active.sum())
            self._pos[active.astype(bool)] += eff_chunk
            kept_by_rid = self._harvest(toks, t0)
            kept = sum(kept_by_rid.values())
            self._now += eff_chunk
            self._chunk_idx += 1

            stats = ChunkStats(step=self._chunk_idx, wall_s=wall,
                               n_slots=ecfg.n_slots, n_active=n_active,
                               tokens_kept=kept,
                               tokens_computed=n_active * eff_chunk,
                               clock_step=self._now)
            energy = self.on_chunk(stats) if self.on_chunk is not None else None
            report.n_chunks += 1
            report.decode_wall_s += wall
            report.tokens_kept += kept
            report.tokens_computed += stats.tokens_computed
            self._occ_sum += n_active / ecfg.n_slots
            if energy:
                report.energy_j += energy
                for rid, n in kept_by_rid.items():
                    if n > 0:
                        self._results[rid].energy_j += energy * n / max(kept, 1)
            if self.on_heartbeat is not None:
                self.on_heartbeat(self._now, wall)

        report.occupancy = self._occ_sum / max(report.n_chunks, 1)
        report.results = [self._results[rid] for rid in self._req_order]
        return report


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
