"""phi3.5-moe-42b-a6.6b and llava-next-34b in the PyTorch port, held
against the JAX package on the CPU at their smoke configs in float32.

phi3.5 routes each token to 2 of its experts (16 at full width, 8 at
smoke size) through the port's ``moe_forward``; llava-next is a Yi-class
decoder at G 7 (56 q / 8 kv heads at full width) whose vision prefix
exists only in the training ``forward`` (``src/repro/models/
transformer.py:269``), so serving ignores it, as JAX does.  The same
weights (a JAX ``init_lm`` tree carried across by ``repro_torch.bridge``)
and the same numpy inputs must give:

* paged init and decode equal to the ring cache's (the port's mirror of
  ``tests/test_model_zoo_paged.py:47``), and to JAX's logits;
* prefill logits within 1e-5 of JAX's;
* engine greedy streams equal to the JAX engine's on a Poisson trace with
  joins, finishes and shared prompt heads (prefix hits), and with
  ``spec_k`` 2 and 3 (neither family has a blocker).

bf16 streams are no gate across frameworks (an engine of phi3.5 in bf16
parted from JAX's in 1 of 6 streams, as ROADMAP.md notes), so every
comparison runs in fp32.  A smoke config of llava at its published G 7
(7 q heads over 1 kv head) runs prefill and the engine against JAX too."""
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
ARCHS = ["phi3.5-moe-42b-a6.6b", "llava-next-34b", "llava-g7"]
# llava-next's smoke config at its published G 7
G7 = dict(n_heads=7, n_kv_heads=1, head_dim=32)


def _configs(arch):
    """(JAX config, port config) at fp32 for ``arch`` ("llava-g7": llava's
    smoke config with 7 q heads a kv head)."""
    over = dict(G7) if arch == "llava-g7" else {}
    name = "llava-next-34b" if arch == "llava-g7" else arch
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
    the chip paths reckon them (phi3.5 at 32 and at the 24 layers it is
    cut to on one card, llava at its 60)."""
    for arch in ("phi3.5-moe-42b-a6.6b", "llava-next-34b"):
        for which in ("config", "smoke"):
            j = getattr(jax_arch(arch), which)
            assert getattr(get_arch(arch), which) == ModelConfig(
                **{f.name: getattr(j, f.name) for f in dataclasses.fields(j)})
    phi = get_arch("phi3.5-moe-42b-a6.6b").config
    llava = get_arch("llava-next-34b").config
    assert (phi.n_experts, phi.experts_per_token, phi.n_heads,
            phi.n_kv_heads, phi.resolved_head_dim) == (16, 2, 32, 8, 128)
    assert (llava.n_heads, llava.n_kv_heads, llava.resolved_head_dim,
            llava.d_model, llava.vision_tokens) == (56, 8, 128, 7168, 2880)
    gib = lambda c: round(c.param_count() * 2 / 2 ** 30, 1)
    assert gib(phi) == 78.0
    assert gib(dataclasses.replace(phi, n_layers=24)) == 58.6
    assert gib(llava) == 64.1


def test_launcher_refuses_weights_past_the_card():
    """The launcher names the cause when the weights alone exceed the
    card's free memory (79.1 GiB of an H100's 80 GB): deepseek-v2 at its
    60 layers is refused; phi3.5 at 24 layers and llava at 60 pass."""
    free = int(79.1 * 2 ** 30)
    with pytest.raises(SystemExit, match="deepseek.*GiB of bfloat16"):
        serve.refuse_oversized(get_arch("deepseek-v2-236b").config, free)
    phi = get_arch("phi3.5-moe-42b-a6.6b").config
    serve.refuse_oversized(dataclasses.replace(phi, n_layers=24), free)
    serve.refuse_oversized(get_arch("llava-next-34b").config, free)
    with pytest.raises(SystemExit, match="llava"):
        serve.refuse_oversized(get_arch("llava-next-34b").config,
                               int(64 * 2 ** 30))


def test_llava_serving_tree_has_no_vision_leaves():
    """The JAX tree of llava holds no vision leaves (its prefix is fed as
    embeddings to the training ``forward``), so the bridge carries the
    decoder alone."""
    _, params, _, tparams = _model("llava-next-34b")
    assert sorted(params) == sorted(tparams) == ["embed", "final_norm",
                                                 "layers", "lm_head"]


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
    """24 prompt tokens: logits within 1e-5 of JAX's, whichever prefill
    backend the port runs (``cuda``: K4's plain version on CPU tensors);
    phi3.5's tokens reach its experts through ``moe_forward``."""
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


@pytest.mark.parametrize("spec_k", [0, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_jax(arch, spec_k):
    """Poisson joins and finishes over 2 slots with 2 shared 11-token
    prompt heads: the prefix hits prefill their suffix through the paged
    verify sweep; speculative at ``spec_k`` 2 and 3."""
    cfg = _model(arch)[2]
    reqs = poisson_trace(5, rate_per_step=0.3, seed=7,
                         vocab_size=cfg.vocab_size, prompt_len=(3, 9),
                         max_new_tokens=(4, 10), shared_prefix_len=11,
                         prompt_pools=2)
    rep = _both(arch, reqs, spec_k=spec_k)
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
    assert any(r.wait_steps > 0 for r in rep.results)
    assert rep.prefill_tokens_saved > 0
    if spec_k:
        assert rep.drafts_proposed > 0


def test_blockers_equal_jax():
    for arch in ("phi3.5-moe-42b-a6.6b", "llava-next-34b"):
        jcfg, cfg = jax_arch(arch).config, get_arch(arch).config
        for fn in ("paged_cache_blockers", "chunked_prefill_blockers",
                   "speculative_blockers", "int8_paged_blockers"):
            assert getattr(tfm, fn)(cfg) == getattr(jtfm, fn)(jcfg) == (), fn


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "llava-next-34b"])
def test_serve_smoke_on_cpu(capsys, arch, traffic):
    """The launcher serves both families at smoke size on the CPU in both
    traffic modes."""
    out = serve.run(["--arch", arch, "--smoke", "--device", "cpu",
                     "--requests", "3", "--prompt-len", "20", "--gen", "8",
                     "--shared-prefix-len", "8", "--prompt-pools", "2",
                     "--page-size", "4", "--traffic", traffic])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 8)
        assert "[serve] prefill 3x28 in" in text
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
        assert out.prefill_tokens_saved > 0
    assert "[frost-ctrl]" in text
