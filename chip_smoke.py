#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

  1. build    — compile the port's CUDA kernels from the sources in this
                checkout (nvcc, sm_90a) and print the card's name and
                power limit;
  2. kernels  — hold every kernel (K-sweep decode / split decode / verify
                with candidates, K-merge) against its plain PyTorch version
                on the same inputs at the serving path's shapes (Hq 9,
                Hkv 3, head_dim 64, page 16, 4 slots, bf16 pools), plus
                deep 4k-position cases (bf16 and fp32), a window /
                logit-cap case, and fp32 and head_dim-128 cases; tolerance
                atol = rtol = 2e-2 for bf16 (1e-4 for fp32).  Table ids past
                a request's length must never be read, and a bad id inside
                it must stop the kernel;
  3. reference — full-width smollm-135m at fp32 through the engine twice,
                once on the kernels and once on the plain torch path: the
                greedy streams must be equal and every logits call within
                1e-3;
  4. main path — ``repro_torch.launch.serve`` on smollm-135m at full width
                (bf16, random weights from a seed, FROST plane on): a
                Poisson trace of 8 requests over 4 slots with 2 shared
                32-token prompt heads; every request must finish its token
                budget with finite logits, and every kernel's launch count
                must have grown during this run;
  5. timing   — CUDA-event times of each kernel, its plain version and a
                library yardstick at the main path's shapes, beside the
                least time the card could take.

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BPS = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor peak, FLOP/s
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {
    "paged_attention_sweep (decode)":
        "src/repro/kernels/decode_attention.py:1232",
    "paged_attention_sweep (verify)":
        "src/repro/kernels/decode_attention.py:970",
    "lse_merge": "src/repro/kernels/decode_attention.py:172",
}
LAUNCH_KEY = {"paged_attention_sweep (decode)": "sweep_decode",
              "paged_attention_sweep (verify)": "sweep_verify",
              "lse_merge": "merge"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# phase 2 helpers
# --------------------------------------------------------------------------
def make_case(torch, np, dev, *, B, Hq, Hkv, D, ps, nb, pos, Q, dtype, seed):
    """Seeded inputs on the card: pools of B * nb shuffled private pages
    plus one scratch page per slot (page ids 0..B-1), ragged ``pos``."""
    rng = np.random.default_rng(seed)
    P = B * nb + B
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)

    bt = (B + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    return {
        "q": r(B, Q, Hq, D), "k_pages": r(P, ps, Hkv, D),
        "v_pages": r(P, ps, Hkv, D), "k_new": r(B, Q, Hkv, D),
        "v_new": r(B, Q, Hkv, D),
        "block_tables": torch.tensor(bt, device=dev),
        "pos": torch.tensor(np.asarray(pos, np.int32), device=dev),
    }


def sweep_args(c, verify):
    args = (c["q"], c["k_pages"], c["v_pages"], c["block_tables"], c["pos"])
    kw = {"k_new": c["k_new"], "v_new": c["v_new"]} if verify else {}
    return args, kw


def max_err(torch, a, b, tol, what):
    """max |a - b|, failing unless allclose at atol = rtol = tol."""
    a, b = a.float(), b.float()
    if not bool(torch.isfinite(a).all()):
        fail(f"{what}: non-finite kernel output")
    err = float((a - b).abs().max())
    if not torch.allclose(a, b, atol=tol, rtol=tol):
        fail(f"{what}: max |kernel - plain| = {err:.3e} > tol {tol}")
    return err


def check_kernels(torch, np, dev, da, ops):
    """Phase 2.  Returns max abs error per kernel entry."""
    errs = {k: 0.0 for k in REPLACES}
    main = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=5)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=256)
    cases = [
        ("main decode", main, [17, 40, 63, 79], 1, "bfloat16", {}),
        ("deep decode", deep, [4095, 3001, 2048, 777], 1, "bfloat16", {}),
        ("main verify Q=16", main, [32, 48, 0, 20], 16, "bfloat16", {}),
        ("deep verify Q=16", deep, [4000, 2900, 16, 1031], 16, "bfloat16",
         {}),
        ("window/cap decode", main, [17, 40, 63, 79], 1, "bfloat16",
         {"window": 24, "logit_cap": 30.0}),
        ("window/cap verify", main, [32, 48, 0, 20], 16, "bfloat16",
         {"window": 24, "logit_cap": 30.0}),
        ("fp32 decode", main, [17, 40, 63, 79], 1, "float32", {}),
        ("fp32 verify", main, [32, 48, 0, 20], 16, "float32", {}),
        # deep in fp32, where the tolerance is far below a typical output
        # value over ~4k keys: a dropped or misplaced page shows
        ("deep fp32 decode", deep, [4095, 3001, 2048, 777], 1, "float32",
         {}),
        ("deep fp32 verify Q=16", deep, [4000, 2900, 16, 1031], 16,
         "float32", {}),
        ("head_dim 128 decode", dict(main, D=128, Hq=8, Hkv=2),
         [17, 40, 63, 79], 1, "bfloat16", {}),
    ]
    for i, (label, shp, pos, Q, dtype, kw) in enumerate(cases):
        c = make_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype, seed=i,
                      **shp)
        verify = "verify" in label
        entry = ("paged_attention_sweep (verify)" if verify
                 else "paged_attention_sweep (decode)")
        auto = ops.choose_kv_splits(shp["B"], shp["nb"] * shp["ps"],
                                    shp["Hq"], block=shp["ps"], device=dev)
        tol = TOL[dtype]
        case_err = 0.0
        for n_splits in sorted({1, auto, 5}):
            args, vkw = sweep_args(c, verify)
            got = da.paged_attention_sweep(*args, **vkw, n_splits=n_splits,
                                           **kw)
            want = da.paged_attention_sweep_torch(*args, **vkw,
                                                  n_splits=n_splits, **kw)
            what = f"{label} n_splits={n_splits}"
            if n_splits == 1:
                e = max_err(torch, got, want, tol, what)
                errs[entry] = max(errs[entry], e)
                case_err = max(case_err, e)
                continue
            e = max(max_err(torch, got[0], want[0], tol, what + " partial"),
                    max_err(torch, got[1], want[1], tol, what + " lse"))
            errs[entry] = max(errs[entry], e)
            merged = da.lse_merge(*got, c["q"].dtype)
            plain = da.lse_merge_torch(*got, c["q"].dtype)
            em = max_err(torch, merged, plain, tol, what + " merge")
            errs["lse_merge"] = max(errs["lse_merge"], em)
            case_err = max(case_err, e, em)
        torch.cuda.synchronize()
        say(f"kernels ok: {label} (n_splits 1, {auto}, 5), max |kernel - "
            f"plain| {case_err:.3e} (tol {tol})")
    check_table_tail(torch, np, dev, da, main)
    check_bad_page_id()
    return errs


def check_table_tail(torch, np, dev, da, shp):
    """Table columns past a request's last key hold arbitrary ids.  Put ids
    past the pool and negative ones there: the sweep must not read them,
    so its output is bit-identical to the run with real page ids."""
    for verify, pos, Q in ((False, [17, 40, 3, 79], 1),
                           (True, [32, 48, 0, 20], 16)):
        c = make_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                      seed=50 + Q, **shp)
        P, ps = c["k_pages"].shape[0], shp["ps"]
        junk = dict(c)
        junk["block_tables"] = c["block_tables"].clone()
        for b, p in enumerate(pos):
            last = (p - 1 if verify else p) // ps
            junk["block_tables"][b, last + 1:] = (P + 1000 if b % 2 else -7)
        for n_splits in (1, 5):
            args, kw = sweep_args(c, verify)
            jargs, _ = sweep_args(junk, verify)
            a = da.paged_attention_sweep(*args, **kw, n_splits=n_splits)
            b = da.paged_attention_sweep(*jargs, **kw, n_splits=n_splits)
            same = (torch.equal(a, b) if n_splits == 1 else
                    torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            if not same:
                fail(f"{'verify' if verify else 'decode'} n_splits="
                     f"{n_splits}: output depends on table ids past pos")
    torch.cuda.synchronize()
    say("kernels ok: table ids past each request's length are never read")


BAD_ID_PROBE = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import decode_attention as da
dev = torch.device("cuda", 0)
q = torch.ones(1, 1, 3, 64, dtype=torch.bfloat16, device=dev)
pages = torch.ones(2, 16, 1, 64, dtype=torch.bfloat16, device=dev)
bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)  # 2: past the pool
# pos 15: column 1 lies past the request, so its id is never read
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [15], dtype=torch.int32, device=dev))
torch.cuda.synchronize()
print("past-length id skipped", flush=True)
# pos 20: key 20 lies in column 1, whose id names no page of the pool
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [20], dtype=torch.int32, device=dev))
torch.cuda.synchronize()
print("bad id accepted", flush=True)
"""


def check_bad_page_id():
    """A table id outside the pool inside a request's length must stop the
    kernel, not drop the page's keys.  The probe runs in a process of its
    own, since the failed launch leaves that process's CUDA context
    unusable."""
    proc = subprocess.run([sys.executable, "-c", BAD_ID_PROBE,
                           str(ROOT / "src")], capture_output=True,
                          text=True, timeout=120)
    if "past-length id skipped" not in proc.stdout:
        fail(f"bad-id probe did not run its control call:\n{proc.stderr}")
    if proc.returncode == 0 or "bad id accepted" in proc.stdout:
        fail("a page id outside the pool inside a request's length was "
             "accepted")
    if "CUDA error" not in proc.stderr:
        fail(f"bad-id probe failed for another reason:\n{proc.stderr}")
    why = next(x for x in proc.stderr.splitlines() if "CUDA error" in x)
    say("kernels ok: a page id outside the pool inside a request's length "
        f"stops the kernel ({why.strip()})")


# --------------------------------------------------------------------------
# phase 3 / 4 helpers
# --------------------------------------------------------------------------
class LogitsTap:
    """Wraps ``transformer.lm_logits``: keeps an on-device all-finite flag
    (no sync per call) and, when ``record`` is set, a host copy of every
    logits tensor."""

    def __init__(self, torch, tfm, record=False):
        self.torch, self.tfm, self.record = torch, tfm, record
        self.inner = tfm.lm_logits
        self.finite = None
        self.calls = []

    def __call__(self, *a, **kw):
        out = self.inner(*a, **kw)
        ok = self.torch.isfinite(out).all()
        self.finite = ok if self.finite is None else self.finite & ok
        if self.record:
            self.calls.append(out.float().cpu())
        return out

    def __enter__(self):
        self.tfm.lm_logits = self
        return self

    def __exit__(self, *exc):
        self.tfm.lm_logits = self.inner


def reference_check(torch, dev, cfg, tfm, serving, steps, bridge):
    """Phase 3: kernels vs plain torch path, full width, fp32."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = bridge.init_lm(cfg32, torch.Generator().manual_seed(1), dev)
    reqs = serving.poisson_trace(4, rate_per_step=0.5, seed=3,
                                 vocab_size=cfg.vocab_size,
                                 prompt_len=(8, 24), max_new_tokens=(6, 12),
                                 shared_prefix_len=21, prompt_pools=2)
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                decode_chunk=4, cache_dtype="float32")
    runs = {}
    for backend in ("cuda", "torch"):
        policy = dataclasses.replace(steps.StepConfig().kernel_policy,
                                     decode=backend)
        scfg = steps.StepConfig(kernel_policy=policy)
        with LogitsTap(torch, tfm, record=True) as tap:
            rep = serving.ServeEngine(cfg32, ecfg, params, step_cfg=scfg,
                                      device=dev).run(reqs)
        runs[backend] = (rep, tap.calls)
    (rep_k, calls_k), (rep_t, calls_t) = runs["cuda"], runs["torch"]
    if rep_t.prefill_tokens_saved <= 0:
        fail("reference trace had no prefix-cache hit")
    for a, b in zip(rep_k.results, rep_t.results):
        if a.tokens != b.tokens:
            fail(f"reference: rid {a.rid} kernel stream {a.tokens} != "
                 f"plain {b.tokens}")
    if len(calls_k) != len(calls_t):
        fail("reference: different numbers of logits calls")
    err = max(float((a - b).abs().max()) for a, b in zip(calls_k, calls_t))
    if err > 1e-3:
        fail(f"reference: logits differ by {err:.3e} > 1e-3")
    say(f"reference ok: fp32 full-width streams equal on kernels and plain "
        f"path ({sum(len(r.tokens) for r in rep_k.results)} tokens, "
        f"{len(calls_k)} logits calls, max |dlogits| {err:.3e})")


# --------------------------------------------------------------------------
# phase 5 helpers
# --------------------------------------------------------------------------
def _events_ms(torch, run, iters):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_ms(torch, fn, iters=20, reps=50, warmup=3):
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph, replayed ``iters`` times between CUDA events.  The host's
    launch cost (Python, ctypes, allocator) stays out of the number, and
    one replay holds enough work that the replay's own launch is hidden
    too."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, iters) / reps


def sweep_work(c, n_splits, verify):
    """(bytes, flops) the sweep needs on these inputs: q, the k/v rows of
    every page holding a valid key, their table entries and pos read once,
    candidates (verify), outputs written once."""
    q = c["q"]
    B, Q, Hq, D = q.shape
    ps, Hkv = c["k_pages"].shape[1], c["k_pages"].shape[2]
    nb = c["block_tables"].shape[1]
    es = q.element_size()
    pos = c["pos"].tolist()
    keys = [p if verify else p + 1 for p in pos]          # valid keys / req
    pages = sum(min(nb, -(-k // ps)) for k in keys)
    nbytes = q.numel() * es + 2 * pages * ps * Hkv * D * es + pages * 4 + B * 4
    if verify:
        nbytes += 2 * B * Q * Hkv * D * es
    S = max(1, min(n_splits, nb))
    nbytes += (B * Q * Hq * D * es if S == 1
               else B * Hq * S * Q * (D + 1) * 4)
    k_tot = sum(keys) + (Q if verify else 0) * B
    flops = 4.0 * Q * Hq * D * k_tot
    return nbytes, flops


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def sdpa_yardstick(torch, c, verify):
    """One F.scaled_dot_product_attention call over the pages gathered in
    logical order (GQA heads expanded), with the same masks."""
    F = torch.nn.functional
    q = c["q"]
    B, Q, Hq, D = q.shape
    ps, Hkv = c["k_pages"].shape[1], c["k_pages"].shape[2]
    nb = c["block_tables"].shape[1]
    G = Hq // Hkv
    bt = c["block_tables"].long()

    def gather(pages, new):
        g = pages[bt].reshape(B, nb * ps, Hkv, D)
        if verify:
            g = torch.cat([g, new], dim=1)
        return g.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    k, v = gather(c["k_pages"], c["k_new"]), gather(c["v_pages"], c["v_new"])
    pos = c["pos"].long()[:, None, None]
    qi = torch.arange(Q, device=q.device)[None, :, None]
    kp = torch.arange(nb * ps, device=q.device)[None, None, :]
    if verify:
        nj = torch.arange(Q, device=q.device)[None, None, :]
        mask = torch.cat([(kp < pos).expand(B, Q, nb * ps),
                          (nj <= qi).expand(B, Q, Q)], dim=-1)
    else:
        mask = kp <= pos
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask)


def timings(torch, np, dev, da, ops):
    """Phase 5 at the main path's shapes (4 slots, 5 pages of 16)."""
    out = {}
    main = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=5)
    for verify, pos, Q in ((False, [64, 71, 75, 79], 1),
                           (True, [32, 48, 16, 32], 16)):
        name = ("paged_attention_sweep (verify)" if verify
                else "paged_attention_sweep (decode)")
        c = make_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                      seed=100 + Q, **main)
        S = ops.choose_kv_splits(4, 80, 9, block=16, device=dev)
        args, kw = sweep_args(c, verify)
        ms = time_ms(torch, lambda: da.paged_attention_sweep(
            *args, **kw, n_splits=S))
        plain = time_ms(torch, lambda: da.paged_attention_sweep_torch(
            *args, **kw, n_splits=S), iters=5, reps=10)
        lib = time_ms(torch, sdpa_yardstick(torch, c, verify))
        nbytes, flops = sweep_work(c, S, verify)
        b_ms, b_by = bound(nbytes, flops)
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, n_splits=S)
        # the single-split form (the output written directly, no merge)
        one = time_ms(torch, lambda: da.paged_attention_sweep(
            *args, **kw, n_splits=1))
        one_plain = time_ms(torch, lambda: da.paged_attention_sweep_torch(
            *args, **kw, n_splits=1), iters=5, reps=10)
        say(f"{name} (n_splits 1): kernel {one * 1e3:.1f} us, plain "
            f"{one_plain * 1e3:.1f} us, bound "
            f"{bound(*sweep_work(c, 1, verify))[0] * 1e3:.3f} us")
        if not verify:
            partial, lse = da.paged_attention_sweep(*args, n_splits=S)
            m_ms = time_ms(torch, lambda: da.lse_merge(partial, lse,
                                                       torch.bfloat16))
            m_plain = time_ms(torch, lambda: da.lse_merge_torch(
                partial, lse, torch.bfloat16), iters=5, reps=10)
            m_bytes = (partial.numel() + lse.numel()) * 4 \
                + partial.numel() // S * 2
            m_flops = 3.0 * partial.numel()
            mb, mby = bound(m_bytes, m_flops)
            out["lse_merge"] = dict(ms=m_ms, plain_ms=m_plain,
                                    library_ms=None, bound_ms=mb,
                                    bound_by=mby, n_splits=S)
    # the deep case, for the record (not the main path's shape)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=256)
    c = make_case(torch, np, dev, pos=[4095, 3001, 2048, 777], Q=1,
                  dtype="bfloat16", seed=7, **deep)
    S = ops.choose_kv_splits(4, 4096, 9, block=16, device=dev)
    args, _ = sweep_args(c, False)
    d_ms = time_ms(torch, lambda: da.paged_attention(*args, n_splits=S))
    d_plain = time_ms(torch, lambda: da.lse_merge_torch(
        *da.paged_attention_sweep_torch(*args, n_splits=S), torch.bfloat16),
        iters=3, reps=5)
    d_lib = time_ms(torch, sdpa_yardstick(torch, c, False))
    nbytes, flops = sweep_work(c, S, False)
    say(f"deep decode (4 slots, 4096-position tables, n_splits {S}): "
        f"sweep+merge {d_ms * 1e3:.1f} us, plain {d_plain * 1e3:.1f} us, "
        f"sdpa {d_lib * 1e3:.1f} us, bound {bound(nbytes, flops)[0] * 1e3:.2f}"
        f" us ({nbytes / 1e6:.2f} MB)")
    return out


# --------------------------------------------------------------------------
def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {pathlib.Path(__file__).name}: "
             "run it from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import bridge
    from repro_torch import serving
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 1. build -------------------------------------------------------------
    build.build(force=True)
    build.library()
    say(f"built {SRC} in {build.build_seconds:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"  ptxas: {line.strip()}")

    # 2. kernels against their plain versions ---------------------------------
    errs = check_kernels(torch, np, dev, da, ops)

    # 3. reference: kernels vs plain torch, full width, fp32 ------------------
    cfg = get_arch("smollm-135m").config
    reference_check(torch, dev, cfg, tfm, serving, steps, bridge)

    # 4. the main path --------------------------------------------------------
    da.reset_launches()
    with LogitsTap(torch, tfm) as tap:
        rep = serve.run(["--arch", "smollm-135m", "--traffic", "poisson",
                         "--requests", "8", "--shared-prefix-len", "32",
                         "--prompt-pools", "2", "--n-slots", "4",
                         "--page-size", "16"])
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    if tap.finite is None or not bool(tap.finite):
        fail("main path: non-finite logits")
    for r in rep.results:
        if r.n_tokens != r.max_new_tokens:
            fail(f"main path: rid {r.rid} finished {r.n_tokens}/"
                 f"{r.max_new_tokens} tokens ({r.finish_reason})")
    if len(rep.results) != 8:
        fail(f"main path: {len(rep.results)} results, expected 8")
    if rep.prefill_tokens_saved <= 0:
        fail("main path: no prefix-cache hit, the verify sweep never ran")
    for key, n in launches.items():
        if n <= 0:
            fail(f"main path: kernel {key} was never launched")
    say(f"main path on {card}: {rep.tok_per_s:.1f} tok/s measured, "
        f"{rep.j_per_token:.4g} J/token (analytic H100 SXM model), "
        f"launches {launches}")

    # 5. timing ---------------------------------------------------------------
    times = timings(torch, np, dev, da, ops)
    kernels = []
    for name, t in times.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SRC,
            "replaces": REPLACES[name],
            "launches": launches[LAUNCH_KEY[name]],
            "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        lib = "n/a" if t["library_ms"] is None else \
            f"{t['library_ms'] * 1e3:.1f} us"
        say(f"{name} (n_splits {t['n_splits']}): kernel "
            f"{t['ms'] * 1e3:.1f} us, plain {t['plain_ms'] * 1e3:.1f} us, "
            f"library {lib}, bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}) on {card}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
