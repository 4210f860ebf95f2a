"""Checks that hold one LM architecture of the PyTorch port against the JAX
package on the CPU, at its smoke config in float32, from the same weights
(a JAX ``init_lm`` tree carried across by ``repro_torch.bridge``) and the
same numpy inputs.  ``tests/test_torch_musicgen.py`` and
``tests/test_torch_zamba2.py`` run them; each case runs torch on one
thread (``one_torch_thread``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro.runtime import steps as jsteps
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tfm
from repro_torch.serving import EngineConfig, ServeEngine, poisson_trace

ATOL = 1e-5
MAX_LEN = 48
# the engine of JAX's tests/test_model_zoo_paged.py, and its trace
ECFG = dict(n_slots=2, page_size=4, max_len=48, decode_chunk=4,
            cache_dtype="float32")
TRACE = dict(rate_per_step=0.3, seed=7, prompt_len=(3, 13),
             max_new_tokens=(4, 8))
BLOCKERS = ("paged_cache_blockers", "chunked_prefill_blockers",
            "int8_paged_blockers", "speculative_blockers")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch on one thread while a case runs: the test workers share the
    CPU's cores, and torch's thread pool stalls when they are
    oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch: str):
    """(jcfg, JAX params, tcfg, the port's params) at ``arch``'s smoke
    config in float32."""
    jcfg = dataclasses.replace(jax_arch(arch).smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    params = jax.jit(lambda key: jtfm.init_lm(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= atol, err


def tokens(cfg, B=2, S=12, seed=5):
    """(B, S) token ids, or a codebook model's (B, S, n_cb)."""
    shape = (B, S) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def check_tree(m):
    """The port's ``init_lm`` draws JAX's tree: the same leaves, shapes and
    dtypes (fp32 masters); the bridge carries JAX's leaves bit for bit."""
    jcfg, params, tcfg, tparams = m
    tree = dict(_flat(jax.tree.map(np.asarray, params)))
    got = dict(_flat(bridge.init_lm(tcfg, torch.Generator().manual_seed(0),
                                    "cpu", master=True)))
    assert sorted(got) == sorted(tree)
    for key, leaf in tree.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert got[key].dtype == torch.float32, key
    for key, leaf in _flat(tparams):
        np.testing.assert_array_equal(leaf.numpy(), tree[key])


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flat(t, f"{pre}/[{i}]")
    else:
        yield pre, tree


def check_forward_and_losses(m):
    """Forward logits, ``lm_loss`` and ``lm_loss_pre_shifted`` within 1e-5
    of JAX's."""
    jcfg, params, tcfg, tparams = m
    toks = tokens(tcfg, S=13)
    jl, _ = jax.jit(jtfm.forward, static_argnums=(2,))(
        params, jnp.asarray(toks[:, :-1]), jcfg)
    jloss = jax.jit(jtfm.lm_loss, static_argnums=(2,))(
        params, jnp.asarray(toks), jcfg)
    jpre = jax.jit(jtfm.lm_loss_pre_shifted, static_argnums=(3,))(
        params, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]), jcfg)
    with torch.no_grad():
        tl, aux = tfm.forward(tparams, torch.tensor(toks[:, :-1]), tcfg)
        tloss = tfm.lm_loss(tparams, torch.tensor(toks), tcfg)
        tpre = tfm.lm_loss_pre_shifted(tparams, torch.tensor(toks[:, :-1]),
                                       torch.tensor(toks[:, 1:]), tcfg)
    close(tl, jl)
    assert float(aux) == 0.0
    close(tloss, jloss)
    close(tpre, jpre)
    return tl


@functools.lru_cache(maxsize=None)
def _jax_prefill(jcfg, max_len):
    return jax.jit(lambda p, t: jtfm.prefill(p, t, jcfg, max_len=max_len))


def check_ring_stream(m, n_new=12):
    """Prefill of 12 tokens (logits within 1e-5), then ``n_new`` greedy
    ring decode steps (JAX's fused loop, the port's ``decode_step`` one
    step at a time): the streams equal.  Returns both final caches (the
    port's, JAX's)."""
    jcfg, params, tcfg, tparams = m
    toks = tokens(tcfg)
    jl, jc = _jax_prefill(jcfg, MAX_LEN)(params, jnp.asarray(toks))
    tok0 = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jloop = jax.jit(jsteps.make_decode_loop(
        jcfg, jsteps.StepConfig(remat="none"), n_tokens=n_new))
    jtoks, jc = jloop(params, jc, jnp.asarray(tok0))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(toks), tcfg,
                             max_len=MAX_LEN)
        close(tl, jl)
        tok, out = torch.tensor(tok0), []
        for _ in range(n_new):
            logits, tc = tfm.decode_step(tparams, tc, tok, tcfg)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            out.append(tok)
            tok = tok[:, None]
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(),
                                  np.asarray(jtoks))
    assert int(tc["pos"]) == int(jc["pos"]) == toks.shape[1] + n_new
    return tc, jc


def solo_ring_stream(tcfg, tparams, req):
    """One request alone on the port's ring cache: prefill, then greedy
    ``decode_step`` until its budget (JAX's ``_ring_reference`` in
    tests/test_model_zoo_paged.py)."""
    with torch.no_grad():
        logits, cache = tfm.prefill(
            tparams, torch.tensor(np.asarray(req.prompt)[None]), tcfg,
            max_len=ECFG["max_len"])
        nxt = torch.argmax(logits[:, req.prompt_len - 1], dim=-1).to(
            torch.int32)
        out = [nxt[0].tolist()]
        for _ in range(req.max_new_tokens - 1):
            logits, cache = tfm.decode_step(tparams, cache, nxt[:, None],
                                            tcfg)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            out.append(nxt[0].tolist())
    return out


def check_engine_streams(m):
    """JAX's zoo trace (tests/test_model_zoo_paged.py) on both engines: the
    port's greedy streams equal the JAX engine's and each request's solo
    ring stream; no prefix cache, no page on the tables for a state-slot
    model, every request served its budget."""
    jcfg, params, tcfg, tparams = m
    reqs = poisson_trace(3, vocab_size=tcfg.vocab_size,
                         n_codebooks=tcfg.n_codebooks, **TRACE)
    jreqs = jax_poisson_trace(3, vocab_size=jcfg.vocab_size,
                              n_codebooks=jcfg.n_codebooks, **TRACE)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    jrep = JaxServeEngine(jcfg, JaxEngineConfig(**ECFG), params).run(jreqs)
    eng = ServeEngine(tcfg, EngineConfig(**ECFG), tparams, device="cpu")
    rep = eng.run(reqs)
    assert not eng._use_prefix and rep.prefill_tokens_saved == 0
    for r, jr, req in zip(rep.results, jrep.results, reqs):
        assert r.tokens == jr.tokens, f"rid {r.rid}"
        assert r.tokens == solo_ring_stream(tcfg, tparams, req), \
            f"rid {r.rid}"
        assert r.n_tokens == r.max_new_tokens
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens"):
        assert getattr(rep, field) == getattr(jrep, field), field
    return eng, rep


def check_blockers(arch):
    """All four blocker lists equal JAX's, at the published config and the
    smoke one; ``paged_cache_blockers`` is empty."""
    for jcfg, tcfg in ((jax_arch(arch).config, get_arch(arch).config),
                       (jax_arch(arch).smoke, get_arch(arch).smoke)):
        for name in BLOCKERS:
            assert getattr(tfm, name)(tcfg) == getattr(jtfm, name)(jcfg), \
                name
        assert tfm.paged_cache_blockers(tcfg) == ()


def check_cache_layouts(m):
    """The ring and paged caches' leaves and shapes equal JAX's."""
    jcfg, _, tcfg, _ = m
    pairs = ((tfm.init_cache(tcfg, 3, 16, dtype="float32"),
              jtfm.init_cache(jcfg, 3, 16, dtype="float32")),
             (tfm.init_paged_cache(tcfg, 2, 10, 4, 4, dtype="float32"),
              jtfm.init_paged_cache(jcfg, 2, 10, 4, 4, dtype="float32")))
    for t, j in pairs:
        tl = {k: tuple(v.shape) for k, v in _flat(t)}
        jl = {k: tuple(np.shape(v)) for k, v in _flat(j)}
        assert tl == jl

