"""mamba2 in the PyTorch port — Mamba2 layers (in-projections, causal
conv, SSD scan, gated RMSNorm) with their recurrent state in both cache
layouts — held against the JAX package on the CPU at smoke size (2
layers, d_model 128, N 16, P 16) in float32.

The same weights (a JAX ``init_lm`` tree carried across by
``repro_torch.bridge``) and the same numpy inputs must give the same
Mamba2 block outputs and states, prefill logits and ring decode logits
within 1e-4 (under every SSD backend of the port), and greedy streams token
for token: the static batch, and the engine on a join/finish trace and on
a trace where preemptions are forced (the state-slot layout has no page
pool to run dry, so the test refuses the pages itself, in both engines
alike).  Speculation is refused by name (``uses_ssm``), as in JAX, and the
launcher serves mamba2 in both traffic modes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.runtime import steps as jsteps
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import ssm, transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import speculate, steps
from repro_torch.serving import (EngineConfig, ServeEngine, batch_trace,
                                 poisson_trace)

ATOL = 1e-4
JSTEP = jsteps.StepConfig(remat="none")
MAX_LEN = 48


@pytest.fixture(scope="module")
def mamba():
    jcfg = dataclasses.replace(jax_arch("mamba2-370m").smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch("mamba2-370m").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


def _tokens(cfg, B=2, S=12, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_matches_jax_at_full_width(mamba):
    jcfg, _, tcfg, _ = mamba
    assert tcfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    full, jfull = get_arch("mamba2-370m").config, jax_arch("mamba2-370m").config
    assert (full.n_layers, full.d_model, full.d_inner,
            full.resolved_ssm_heads, full.ssm_head_dim, full.ssm_state,
            full.ssm_groups, full.ssm_chunk, full.conv_width,
            tfm.padded_vocab(full), full.tie_embeddings) == (
        48, 1024, 2048, 32, 64, 128, 1, 128, 4, 50432, True)
    assert (full.d_inner, full.resolved_ssm_heads, full.param_count()) \
        == (jfull.d_inner, jfull.resolved_ssm_heads, jfull.param_count())
    assert ssm.conv_dim(full) == jssm.conv_dim(jfull) == 2304


def test_bridge_carries_the_jax_tree(mamba):
    """Every leaf of the JAX tree lands under its own name, bit for bit;
    a missing leaf raises."""
    _, params, tcfg, tparams = mamba
    tree = jax.tree.map(np.asarray, params)
    sub = tparams["layers"]["sub0"]
    assert sorted(sub) == sorted(tree["layers"]["sub0"]) == sorted(
        ["pre_norm", "wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b",
         "A_log", "D", "dt_bias", "norm_scale", "wout"])
    for key, val in tree["layers"]["sub0"].items():
        np.testing.assert_array_equal(sub[key].numpy(), val)
    broken = jax.tree.map(lambda a: a, tree)
    del broken["layers"]["sub0"]["dt_bias"]
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(broken, tcfg, "cpu")


def test_init_lm_draws_mamba2s_deterministic_leaves(mamba):
    """``init_lm`` gives A_log, dt_bias, D and the conv as ``init_mamba``
    does: the same A_log, dt in [1e-3, 1e-1] after softplus, D and the
    norms at 1, conv_b at 0."""
    _, params, tcfg, _ = mamba
    tp = bridge.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    sub, jsub = tp["layers"]["sub0"], jax.tree.map(np.asarray,
                                                   params)["layers"]["sub0"]
    _close(sub["A_log"], jsub["A_log"], 1e-6)
    dt = torch.nn.functional.softplus(sub["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    for key in ("D", "pre_norm", "norm_scale"):
        assert torch.equal(sub[key], torch.ones_like(sub[key]))
    assert torch.equal(sub["conv_b"], torch.zeros_like(sub["conv_b"]))
    assert 0.05 < float(sub["conv_w"].std()) < 0.2
    assert all(t.dtype == torch.float32 for t in sub.values())


def test_mamba_block_forward_and_decode_match_jax(mamba):
    """Layer 0's block over 20 tokens with its state carried out (the
    chunked form at chunk 16 in both packages), then 4 decode steps."""
    jcfg, params, tcfg, tparams = mamba
    jsub = jax.tree.map(lambda a: a[0], params["layers"]["sub0"])
    tsub = {k: v[0] for k, v in tparams["layers"]["sub0"].items()}
    x = np.random.default_rng(3).standard_normal(
        (2, 20, tcfg.d_model)).astype(np.float32)
    jout, (jconv, jstate) = jssm.mamba_forward(
        jsub, jnp.asarray(x[:, :16]), jcfg, return_state=True,
        policy=jops.KernelPolicy(ssd="chunked", ssd_chunk=16))
    tout, (tconv, tstate) = ssm.mamba_forward(
        tsub, torch.tensor(x[:, :16]), tcfg, return_state=True,
        policy=ops.KernelPolicy(ssd="chunked", ssd_chunk=16))
    _close(tout, jout)
    _close(tconv, jconv)
    _close(tstate, jstate)
    jc, tc = (jconv, jstate), (tconv, tstate)
    for s in range(16, 20):
        jo, jc = jssm.mamba_decode(jsub, jnp.asarray(x[:, s:s + 1]), jc, jcfg)
        to, tc = ssm.mamba_decode(tsub, torch.tensor(x[:, s:s + 1]), tc, tcfg)
        _close(to, jo)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])


@functools.lru_cache(maxsize=None)
def _jprefill(max_len):
    return jax.jit(functools.partial(jtfm.prefill, max_len=max_len),
                   static_argnums=(2,))


@pytest.mark.parametrize("backend", ["auto", "ref", "chunked", "cuda"])
def test_prefill_logits_and_state_match_jax(mamba, backend):
    """32 prompt tokens: logits and every layer's conv tail and SSM state
    within 1e-4 of JAX's, whichever SSD backend the port runs (``cuda``:
    the kernel's twin on CPU tensors; chunk 16)."""
    jcfg, params, tcfg, tparams = mamba
    tokens = _tokens(tcfg, S=32, seed=2)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(tokens), jcfg)
    ctx = tfm.RunCtx(kernel_policy=ops.KernelPolicy(ssd=backend,
                                                    ssd_chunk=16))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg, ctx,
                             max_len=MAX_LEN)
    _close(tl, jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 32
    for key in ("conv", "ssm"):
        _close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])
    assert tc["units"]["sub0"]["ssm"].dtype == torch.float32


def test_ring_decode_logits_match_jax(mamba):
    """Prefill of 12 tokens, then 6 ring decode steps: logits and the
    final state within 1e-4."""
    jcfg, params, tcfg, tparams = mamba
    tokens = _tokens(tcfg)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(tokens), jcfg)
    jstep = jax.jit(functools.partial(jtfm.decode_step), static_argnums=(3,))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg,
                             max_len=MAX_LEN)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        for _ in range(6):
            jl, jc = jstep(params, jc, jnp.asarray(tok), jcfg)
            tl, tc = tfm.decode_step(tparams, tc, torch.tensor(tok), tcfg)
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1),
                             np.int32)[:, None]
    assert int(tc["pos"]) == 18
    for key in ("conv", "ssm"):
        _close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])


def test_init_caches_match_jax_layouts(mamba):
    jcfg, _, tcfg, _ = mamba
    jc = jtfm.init_cache(jcfg, 3, 16, dtype="float32")
    tc = tfm.init_cache(tcfg, 3, 16, dtype="float32")
    jp = jtfm.init_paged_cache(jcfg, 4, 8, 4, 4, dtype="float32")
    tp = tfm.init_paged_cache(tcfg, 4, 8, 4, 4, dtype="float32")
    for t, j in ((tc, jc), (tp, jp)):
        for key in ("conv", "ssm"):
            assert tuple(t["units"]["sub0"][key].shape) \
                == j["units"]["sub0"][key].shape
        assert t["units"]["sub0"]["ssm"].dtype == torch.float32
    assert tfm.init_cache(tcfg, 1, 8)["units"]["sub0"]["conv"].dtype \
        == torch.bfloat16


def test_batch_greedy_stream_matches_jax(mamba):
    """12 prompt tokens, then 30 ring decode steps: the stream and the
    final state equal JAX's."""
    jcfg, params, tcfg, tparams = mamba
    prompts = _tokens(tcfg)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(prompts), jcfg)
    tok0 = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jloop = jax.jit(jsteps.make_decode_loop(jcfg, JSTEP, n_tokens=30))
    jtoks, jc = jloop(params, jc, jnp.asarray(tok0))
    with torch.no_grad():
        _, tc = tfm.prefill(tparams, torch.tensor(prompts), tcfg,
                            max_len=MAX_LEN)
        ttoks, tc = steps.make_decode_loop(tcfg, steps.StepConfig(), 30)(
            tparams, tc, torch.tensor(tok0))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    assert int(tc["pos"]) == 42
    _close(tc["units"]["sub0"]["ssm"], jc["units"]["sub0"]["ssm"])


def _refuse_pages(engine, refusals):
    """Make the engine's page pool say no on the given calls of
    ``kv.ensure`` (counted from 1): the state-slot layout never runs dry
    by itself, so this is how a trace forces the engine to preempt."""
    inner, calls = engine.kv.ensure, [0]

    def ensure(slot, n_tokens):
        calls[0] += 1
        return calls[0] not in refusals and inner(slot, n_tokens)

    engine.kv.ensure = ensure
    return engine


def _both(mamba, reqs, refusals=(), **over):
    jcfg, params, tcfg, tparams = mamba
    kw = dict(n_slots=2, page_size=4, max_len=64, decode_chunk=4,
              cache_dtype="float32", **over)
    jeng = _refuse_pages(JaxServeEngine(jcfg, JaxEngineConfig(**kw), params),
                         refusals)
    teng = _refuse_pages(ServeEngine(tcfg, EngineConfig(**kw), tparams,
                                     device="cpu"), refusals)
    jrep, trep = jeng.run(reqs), teng.run(reqs)
    assert not teng.kv.tables_active and not teng._use_prefix
    for a, b in zip(trep.results, jrep.results):
        assert a.tokens == b.tokens, f"rid {a.rid}"
        assert (a.finish_reason, a.n_preemptions) == (b.finish_reason,
                                                      b.n_preemptions)
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens", "n_preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.prefill_tokens_saved == 0          # no prefix cache
    return trep


def test_engine_join_finish_streams_match_jax(mamba):
    """Poisson joins with prompts of 3 to 13 tokens (exact-length prefill,
    state slot overwritten at inject) while parked slots keep advancing
    their state."""
    reqs = poisson_trace(5, rate_per_step=0.3, seed=7,
                         vocab_size=mamba[2].vocab_size, prompt_len=(3, 13),
                         max_new_tokens=(4, 10))
    rep = _both(mamba, reqs)
    assert any(r.wait_steps > 0 for r in rep.results)
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)


def test_engine_preemption_streams_match_jax(mamba):
    """Refused pages preempt the most recent slot twice: its tokens fold
    into the requeued prompt, which prefills again at its exact length.
    The streams equal JAX's and those of the run without preemption."""
    reqs = batch_trace(3, seed=5, vocab_size=mamba[2].vocab_size,
                       prompt_len=6, max_new_tokens=14)
    rep = _both(mamba, reqs, refusals=(3, 9))
    assert rep.n_preemptions == 2
    plain = _both(mamba, reqs)
    assert plain.n_preemptions == 0
    assert [r.tokens for r in rep.results] == [r.tokens
                                               for r in plain.results]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_blockers_equal_jax(arch):
    """mamba2's and zamba2's blockers are JAX's: speculation, the paged
    verify sweep (so the prefix cache) and int8 pages name ``uses_ssm``
    first, and neither model is kept off the paged engine."""
    jcfg = jax_arch(arch).config
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(jcfg)})
    assert tfm.chunked_prefill_blockers(cfg)[0] == "uses_ssm"
    assert tfm.speculative_blockers(cfg) == jtfm.speculative_blockers(jcfg)
    assert tfm.int8_paged_blockers(cfg) == jtfm.int8_paged_blockers(jcfg)
    assert tfm.paged_cache_blockers(cfg) \
        == jtfm.paged_cache_blockers(jcfg) == ()
    assert tfm.chunked_prefill_blockers(cfg) \
        == jtfm.chunked_prefill_blockers(jcfg)


def test_speculation_is_refused_by_name(mamba):
    _, _, tcfg, tparams = mamba
    with pytest.raises(ValueError, match="blocked by uses_ssm"):
        ServeEngine(tcfg, EngineConfig(spec_k=2), tparams, device="cpu")
    with pytest.raises(ValueError, match="blocked by uses_ssm"):
        steps.make_speculative_decode_loop(
            tcfg, steps.StepConfig(), 2, drafter=speculate.RepeatDrafter(2))
    with pytest.raises(ValueError, match="uses_ssm"):
        tfm.verify_step(tparams, tfm.init_cache(tcfg, 1, 8),
                        torch.zeros((1, 3), dtype=torch.int32), tcfg)


SERVE = ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
         "--requests", "3", "--prompt-len", "20", "--gen", "8"]


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_mamba2_smoke(capsys, traffic):
    da.reset_launches()
    out = serve.run(SERVE + ["--traffic", traffic])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 8)
        assert "[serve] prefill 3x20 in" in text
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
        assert "[serve] engine: 3 requests over" in text
    assert "[frost-ctrl]" in text
    assert all(n == 0 for n in da.LAUNCHES.values())


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_spec_k_refuses_mamba2(traffic):
    with pytest.raises(ValueError, match="uses_ssm"):
        serve.run(SERVE + ["--traffic", traffic, "--spec-k", "2"])
