"""stablelm-1.6b and h2o-danube-3-4b in the PyTorch port, held against the
JAX package on the CPU at their smoke configs in float32.

stablelm is dense GQA at G 1 (as many kv heads as q heads) with a partial
rotary embedding (``rope_fraction`` 0.25); h2o-danube-3 windows every
layer (4096 at full width, 16 at smoke size) and has head dim 120.  The
same weights (a JAX ``init_lm`` tree carried across by
``repro_torch.bridge``) and the same numpy inputs must give:

* paged init and decode equal to the ring cache's (the port's mirror of
  ``tests/test_model_zoo_paged.py:47``), and to JAX's logits;
* prefill logits within 1e-5 of JAX's;
* engine greedy streams equal to the JAX engine's on a Poisson trace with
  joins, finishes and shared prompt heads, and with ``spec_k`` 2 and 3
  where the blockers allow (stablelm);
* h2o's engine streams equal to its solo ring streams (the mirror of
  ``tests/test_model_zoo_paged.py:135``), and its refusals of engine
  speculation and of int8 pages by ``sliding_window``, as in JAX.

``reduce_for_smoke`` sets head dim 32, so an h2o smoke config that keeps
head dim 120 (2 layers, 4 q / 1 kv heads, window 16) runs prefill and the
engine against JAX as well."""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import EngineConfig, ServeEngine, poisson_trace

ATOL = 1e-5
MAX_LEN = 48
ARCHS = ["stablelm-1.6b", "h2o-danube-3-4b", "h2o-d120"]
# h2o-danube-3's smoke config with its published head dim kept
D120 = dict(n_layers=2, n_heads=4, n_kv_heads=1, head_dim=120,
            sliding_window=16)


def _configs(arch):
    """(JAX config, port config) at fp32 for ``arch`` ("h2o-d120": h2o's
    smoke config at head dim 120)."""
    over = dict(D120) if arch == "h2o-d120" else {}
    name = "h2o-danube-3-4b" if arch == "h2o-d120" else arch
    return (dataclasses.replace(jax_arch(name).smoke, dtype="float32",
                                **over),
            dataclasses.replace(get_arch(name).smoke, dtype="float32",
                                **over))


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, tcfg = _configs(arch)
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(a, b, atol=ATOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


def test_configs_are_the_jax_packages():
    """Each config is JAX's field for field; full-width sizes in bf16 as
    the chip paths reckon them."""
    for arch in ("stablelm-1.6b", "h2o-danube-3-4b"):
        for which in ("config", "smoke"):
            j = getattr(jax_arch(arch), which)
            assert getattr(get_arch(arch), which) == ModelConfig(
                **{f.name: getattr(j, f.name) for f in dataclasses.fields(j)})
    s, h = get_arch("stablelm-1.6b").config, get_arch("h2o-danube-3-4b").config
    assert (s.n_heads, s.n_kv_heads, s.resolved_head_dim, s.rope_fraction) \
        == (32, 32, 64, 0.25)
    assert (h.n_heads, h.n_kv_heads, h.resolved_head_dim, h.sliding_window,
            h.d_model) == (32, 8, 120, 4096, 3840)
    assert round(s.param_count() * 2 / 2 ** 30, 1) == 3.1
    assert round(h.param_count() * 2 / 2 ** 30, 1) == 7.4


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_equals_ring_and_jax(arch):
    """The port's mirror of ``tests/test_model_zoo_paged.py:47``: nothing
    blocks paged serving; paged init and 3 decode steps give the ring
    cache's logits, and JAX's paged logits within 1e-5."""
    jcfg, params, cfg, tparams = _model(arch)
    assert tfm.paged_cache_blockers(cfg) == jtfm.paged_cache_blockers(jcfg) \
        == ()
    n_slots, ps, max_blocks = 2, 4, 8
    n_pages = n_slots + n_slots * max_blocks
    tables = np.stack([n_slots + s * max_blocks + np.arange(max_blocks)
                       for s in range(n_slots)]).astype(np.int32)
    pcache = {**tfm.init_paged_cache(cfg, n_slots, n_pages, ps, max_blocks,
                                     dtype="float32"),
              "block_tables": torch.tensor(tables)}
    rcache = tfm.init_cache(cfg, n_slots, ps * max_blocks, dtype="float32")
    jcache = {**jtfm.init_paged_cache(jcfg, n_slots, n_pages, ps,
                                      max_blocks, dtype="float32"),
              "block_tables": jnp.asarray(tables)}
    jstep = jax.jit(jtfm.decode_step, static_argnums=(3,))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab_size, (n_slots, 1)).astype(
                np.int32)
            pl_, pcache = tfm.decode_step(tparams, pcache, torch.tensor(tok),
                                          cfg)
            rl_, rcache = tfm.decode_step(tparams, rcache, torch.tensor(tok),
                                          cfg)
            jl_, jcache = jstep(params, jcache, jnp.asarray(tok), jcfg)
            _close(pl_, rl_, 1e-6)
            _close(pl_, jl_)


@functools.lru_cache(maxsize=None)
def _jprefill(max_len):
    return jax.jit(functools.partial(jtfm.prefill, max_len=max_len),
                   static_argnums=(2,))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    """24 prompt tokens (past h2o's smoke window of 16): logits within
    1e-5 of JAX's, whichever prefill backend the port runs (``cuda``: K4's
    plain version on CPU tensors)."""
    jcfg, params, cfg, tparams = _model(arch)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _ = _jprefill(MAX_LEN)(params, jnp.asarray(tokens), jcfg)
    for backend in ("auto", "cuda"):
        ctx = tfm.RunCtx(kernel_policy=ops.KernelPolicy(attention=backend))
        with torch.no_grad():
            tl, _ = tfm.prefill(tparams, torch.tensor(tokens), cfg, ctx,
                                max_len=MAX_LEN)
        _close(tl, jl)


def _both(arch, reqs, **over):
    """The JAX engine and the port's on ``reqs``: streams, finish reasons
    and the report's counts equal."""
    jcfg, params, cfg, tparams = _model(arch)
    kw = dict(n_slots=2, page_size=4, max_len=64, decode_chunk=4,
              cache_dtype="float32", **over)
    jrep = JaxServeEngine(jcfg, JaxEngineConfig(**kw), params).run(reqs)
    trep = ServeEngine(cfg, EngineConfig(**kw), tparams,
                       device="cpu").run(reqs)
    assert len(trep.results) == len(jrep.results) == len(reqs)
    for a, b in zip(trep.results, jrep.results):
        assert a.tokens == [int(t) for t in np.asarray(b.tokens).ravel()], \
            f"{arch} rid {a.rid}"
        assert (a.finish_reason, a.n_preemptions) == (b.finish_reason,
                                                      b.n_preemptions)
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens", "prefill_tokens_saved", "n_preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    return trep


def _trace(cfg, n=5):
    """Poisson joins and finishes over 2 slots, with 2 shared 11-token
    prompt heads (prefix hits where the family has a prefix cache)."""
    return poisson_trace(n, rate_per_step=0.3, seed=7,
                         vocab_size=cfg.vocab_size, prompt_len=(3, 9),
                         max_new_tokens=(4, 10), shared_prefix_len=11,
                         prompt_pools=2)


@pytest.mark.parametrize("spec_k", [0, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, spec_k):
    """Greedy engine streams equal JAX's; stablelm's shared heads hit the
    prefix cache (the paged verify sweep) and its speculation runs; h2o's
    engine has no prefix cache (``sliding_window``) and refuses
    speculation, in JAX as in the port."""
    cfg = _model(arch)[2]
    if arch != "stablelm-1.6b" and spec_k:
        jcfg, params, _, tparams = _model(arch)
        with pytest.raises(ValueError, match="blocked by sliding_window"):
            JaxServeEngine(jcfg, JaxEngineConfig(spec_k=spec_k), params)
        with pytest.raises(ValueError, match="blocked by sliding_window"):
            ServeEngine(cfg, EngineConfig(spec_k=spec_k), tparams,
                        device="cpu")
        return
    rep = _both(arch, _trace(cfg), spec_k=spec_k)
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
    assert any(r.wait_steps > 0 for r in rep.results)
    if arch == "stablelm-1.6b":
        assert rep.prefill_tokens_saved > 0
    else:
        assert rep.prefill_tokens_saved == 0
        assert max(r.prompt_len + r.n_tokens for r in rep.results) > 16


def _ring_reference(cfg, params, req, max_len):
    """Solo run of one request on the ring cache: prefill + decode
    steps."""
    with torch.no_grad():
        logits, cache = tfm.prefill(params, torch.tensor(req.prompt)[None],
                                    cfg, max_len=max_len)
        nxt = torch.argmax(logits[:, -1], -1).to(torch.int32)
        toks = [int(nxt[0])]
        for _ in range(req.max_new_tokens - 1):
            lg, cache = tfm.decode_step(params, cache, nxt[:, None], cfg)
            nxt = torch.argmax(lg[:, -1], -1).to(torch.int32)
            toks.append(int(nxt[0]))
    return toks


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "h2o-d120"])
def test_h2o_engine_streams_equal_solo_ring(arch):
    """The mirror of ``tests/test_model_zoo_paged.py:135``: the engine's
    private windowed rings are invisible in its greedy streams, which
    equal each request's solo ring-cache stream, past the window."""
    _, _, cfg, tparams = _model(arch)
    reqs = poisson_trace(3, rate_per_step=0.3, seed=7,
                         vocab_size=cfg.vocab_size, prompt_len=(3, 13),
                         max_new_tokens=(8, 14))
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=48, decode_chunk=4,
                        cache_dtype="float32")
    rep = ServeEngine(cfg, ecfg, tparams, device="cpu").run(reqs)
    assert max(r.prompt_len + r.n_tokens for r in rep.results) > 16
    for r, req in zip(rep.results, reqs):
        assert r.tokens == _ring_reference(cfg, tparams, req, 48), \
            f"rid {r.rid}"


def test_h2o_refuses_int8_pages_by_name():
    """int8 pages: one warning naming ``sliding_window`` and the cache
    dtype's pools, and ``init_paged_cache(dtype="int8")`` raising by name,
    with JAX's blockers."""
    jcfg, _, cfg, tparams = _model("h2o-danube-3-4b")
    assert tfm.int8_paged_blockers(cfg) == jtfm.int8_paged_blockers(jcfg) \
        == ("sliding_window",)
    assert tfm.chunked_prefill_blockers(cfg) \
        == jtfm.chunked_prefill_blockers(jcfg) == ("sliding_window",)
    ops._KV_DTYPE_FALLBACK_WARNED.discard(cfg.name)
    ecfg = EngineConfig(n_slots=2, page_size=4, max_len=32, kv_dtype="int8",
                        cache_dtype="float32")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = ServeEngine(cfg, ecfg, tparams, device="cpu")
        ServeEngine(cfg, ecfg, tparams, device="cpu")
    hits = [w for w in rec if "kv_dtype=int8" in str(w.message)]
    assert len(hits) == 1 and "sliding_window" in str(hits[0].message)
    assert eng.kv_dtype == "float32"
    with pytest.raises(ValueError, match="sliding_window"):
        tfm.init_paged_cache(cfg, 2, 8, 4, 4, dtype="int8")


@pytest.mark.parametrize("extra", [["--traffic", "batch"],
                                   ["--traffic", "batch", "--spec-k", "3"],
                                   ["--traffic", "poisson"]],
                         ids=["batch", "batch-spec3", "poisson"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "h2o-danube-3-4b"])
def test_serve_smoke_on_cpu(capsys, arch, extra):
    """The launcher serves both families at smoke size on the CPU in both
    traffic modes (h2o with ``--spec-k 3`` on the batch path, whose ring
    verify the window allows)."""
    out = serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "20", "--gen", "8",
                     "--shared-prefix-len", "8", "--prompt-pools", "2",
                     "--page-size", "4", *extra])
    text = capsys.readouterr().out
    if "batch" in extra:
        assert out["tokens"].shape == (3, 8)
        if "--spec-k" in extra:
            assert out["spec_steps"] > 0
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
    assert "[frost-ctrl]" in text
