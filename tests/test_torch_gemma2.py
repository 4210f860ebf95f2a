"""gemma2 in the PyTorch port — local/global layer pairs (window 16 at
smoke size), attention and final soft-caps, ``query_scale``, the four
``(1 + w)`` norms of each layer — held against the JAX package on the CPU
at smoke size (4 layers, d_model 128) in float32.

The same weights (carried across by ``repro_torch.bridge``, norm scales
drawn away from 0 so that the ``(1 + w)`` form is read) and the same numpy
inputs must give prefill logits within 1e-4, and greedy streams token for
token: the static batch past the window (the local rings wrap), and the
engine on a Poisson trace that wraps the slots' private rings and on a
preemption trace.  The blockers of gemma2, h2o-danube-3-4b and smollm
equal the JAX package's, and the launcher serves gemma2 in both traffic
modes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro.runtime import steps as jsteps
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import speculate, steps
from repro_torch.serving import (EngineConfig, ServeEngine, batch_trace,
                                 poisson_trace)

ATOL = 1e-4
STEP = steps.StepConfig()
JSTEP = jsteps.StepConfig(remat="none")
MAX_LEN = 48                        # batch ring: 12 prompt + 36 new


@pytest.fixture(scope="module")
def gemma():
    jcfg = dataclasses.replace(jax_arch("gemma2-27b").smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch("gemma2-27b").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(11)

    def perturb(t):
        return {k: perturb(v) if isinstance(v, dict) else
                (v + 0.3 * rng.standard_normal(v.shape).astype(v.dtype)
                 if "norm" in k else v) for k, v in t.items()}

    tree = perturb(tree)
    params = jax.tree.map(jnp.asarray, tree)
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


@functools.lru_cache(maxsize=None)
def _jprefill(max_len):
    return jax.jit(functools.partial(jtfm.prefill, max_len=max_len),
                   static_argnums=(2,))


def _prompts(cfg, n=2, length=12):
    pat = np.random.default_rng(5).integers(0, cfg.vocab_size, (n, 4))
    return np.tile(pat, (1, length // 4)).astype(np.int32)


def test_config_and_windows(gemma):
    jcfg, _, tcfg, _ = gemma
    assert tcfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    assert (tcfg.n_layers, tcfg.local_window, tfm.unit_size(tcfg)) == (4, 16,
                                                                        2)
    assert [tcfg.window_for_layer(i) for i in range(2)] == [16, 0]


@pytest.mark.parametrize("full_cache", [False, True])
def test_prefill_logits_and_caches_match_jax(gemma, full_cache):
    """40 prompt tokens, past the local window of 16: logits within 1e-4;
    the local sub's cache is a ring of 16 slots (linear at max_len with
    ``full_cache``), the global sub's linear at max_len."""
    jcfg, params, tcfg, tparams = gemma
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, max_len=MAX_LEN,
                                       full_cache=full_cache),
                     static_argnums=(2,))(params, jnp.asarray(tokens), jcfg)
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg,
                             max_len=MAX_LEN, full_cache=full_cache)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 40
    for name in ("sub0", "sub1"):
        for key in ("k", "v"):
            _close(tc["units"][name][key], jc["units"][name][key])
    local = tc["units"]["sub0"]["k"].shape[2]
    assert local == (MAX_LEN if full_cache else 16)


def test_batch_greedy_stream_matches_jax_past_the_window(gemma):
    """12 prompt tokens, then 30 ring decode steps: the local rings (16
    slots) wrap twice; the stream and the final caches equal JAX's."""
    jcfg, params, tcfg, tparams = gemma
    prompts = _prompts(tcfg)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(prompts), jcfg)
    tok0 = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jloop = jax.jit(jsteps.make_decode_loop(jcfg, JSTEP, n_tokens=30))
    jtoks, jc = jloop(params, jc, jnp.asarray(tok0))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(prompts), tcfg,
                             max_len=MAX_LEN)
        _close(tl, jl)
        ttoks, tc = steps.make_decode_loop(tcfg, STEP, 30)(
            tparams, tc, torch.tensor(tok0))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert int(tc["pos"]) == 42 and tc["units"]["sub0"]["k"].shape[2] == 16
    for name in ("sub0", "sub1"):
        _close(tc["units"][name]["v"], jc["units"][name]["v"])


def test_batch_speculative_equals_plain(gemma):
    """``--spec-k 2`` on the batch path (ring verify over the local rings,
    per-sub commit) emits the plain loop's greedy stream."""
    _, _, tcfg, tparams = gemma
    prompts = _prompts(tcfg)
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(prompts), tcfg,
                             max_len=MAX_LEN)
        tok0 = torch.argmax(tl[:, -1], dim=-1).to(torch.int32)[:, None]
        plain, _ = steps.make_decode_loop(tcfg, STEP, 24)(tparams, tc, tok0)
        _, tc = tfm.prefill(tparams, torch.tensor(prompts), tcfg,
                            max_len=MAX_LEN)
        drafter = speculate.get_drafter("ngram", 2)
        ds = drafter.init_state(2)
        drafter.seed_batch(ds, prompts, tok0.numpy())
        toks, counts, tc, _ = steps.make_speculative_decode_loop(
            tcfg, STEP, 8, drafter=drafter)(tparams, tc, tok0,
                                            speculate.state_to(ds, "cpu"))
    toks, counts = toks.numpy(), counts.numpy()
    flat = np.concatenate([toks[:, s, :counts[0, s]]
                           for s in range(counts.shape[1])], axis=1)
    np.testing.assert_array_equal(flat, plain.numpy()[:, :flat.shape[1]])
    assert int(tc["pos"]) == 12 + flat.shape[1] and int(tc["pos"]) > 16


def _both(gemma, reqs, **over):
    jcfg, params, tcfg, tparams = gemma
    kw = dict(n_slots=2, page_size=4, max_len=64, decode_chunk=4,
              cache_dtype="float32", **over)
    jrep = JaxServeEngine(jcfg, JaxEngineConfig(**kw), params).run(reqs)
    trep = ServeEngine(tcfg, EngineConfig(**kw), tparams,
                       device="cpu").run(reqs)
    for a, b in zip(trep.results, jrep.results):
        assert a.tokens == b.tokens, f"rid {a.rid}"
        assert (a.finish_reason, a.n_preemptions) == (b.finish_reason,
                                                      b.n_preemptions)
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens", "n_preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.prefill_tokens_saved == 0          # no prefix cache
    return trep


def test_engine_streams_match_jax_past_the_private_rings(gemma):
    """Poisson joins with prompts of 10 to 30 tokens and up to 24 new:
    the inject keeps the last 16 prompt rows at ring offset p % 16 of the
    slot's 4 private pages, and decode wraps the ring."""
    reqs = poisson_trace(4, rate_per_step=0.3, seed=7,
                         vocab_size=gemma[2].vocab_size,
                         prompt_len=(10, 30), max_new_tokens=(12, 24))
    rep = _both(gemma, reqs)
    assert any(r.wait_steps > 0 for r in rep.results)
    assert max(r.prompt_len + r.n_tokens for r in rep.results) > 32
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)


def test_engine_preemption_streams_match_jax(gemma):
    """The forced-preemption trace: 2 scratch + 6 usable pages for three
    5-page contexts of the global layers; preempted requests rejoin cold
    and re-inject their private rings."""
    reqs = batch_trace(3, seed=5, vocab_size=gemma[2].vocab_size,
                       prompt_len=6, max_new_tokens=14)
    rep = _both(gemma, reqs, n_pages=2 + 6, preempt=True)
    assert rep.n_preemptions > 0


def _port_cfg(jcfg):
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


@pytest.mark.parametrize("arch", ["gemma2-27b", "h2o-danube-3-4b",
                                  "smollm-135m"])
def test_blockers_equal_jax(arch):
    jcfg = jax_arch(arch).config
    cfg = _port_cfg(jcfg)
    assert tfm.paged_cache_blockers(cfg) == jtfm.paged_cache_blockers(jcfg)
    assert tfm.chunked_prefill_blockers(cfg) \
        == jtfm.chunked_prefill_blockers(jcfg)
    assert tfm.speculative_blockers(cfg) == jtfm.speculative_blockers(jcfg)
    assert tfm.int8_paged_blockers(cfg) == jtfm.int8_paged_blockers(jcfg)
    if arch == "smollm-135m":
        assert tfm.int8_paged_blockers(cfg) == ()


def test_engine_refuses_speculation_as_jax(gemma):
    _, _, tcfg, tparams = gemma
    with pytest.raises(ValueError, match="blocked by local_global"):
        ServeEngine(tcfg, EngineConfig(spec_k=2), tparams, device="cpu")


SERVE = ["--arch", "gemma2-27b", "--smoke", "--device", "cpu",
         "--requests", "3", "--prompt-len", "20", "--gen", "8"]


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_gemma2_smoke(capsys, traffic):
    out = serve.run(SERVE + ["--traffic", traffic])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 8)
        assert "[serve] prefill 3x20 in" in text
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
        assert "[serve] engine: 3 requests over" in text
    assert "[frost-ctrl]" in text
