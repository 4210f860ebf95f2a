"""deepseek-v2 in the PyTorch port — MLA attention with its compressed
latent cache, the 160-expert MoE FFN with shared experts, and the first
dense layer with its own cache group — held against the JAX package on
the CPU at smoke size (1 dense + 2 MoE layers, d_model 128, 4 heads,
kv_lora 32 + rope 16, q_lora 24, 8 experts top 2) in float32.

The same weights (a JAX ``init_lm`` tree carried across by
``repro_torch.bridge``) and the same numpy inputs must give the same MoE
outputs (with and without capacity drops), MLA block outputs, prefill
logits and ring decode logits within 1e-4, paged decode logits after a
suffix prefill within 1e-4, and greedy engine streams token for token on
a join/finish trace, a prefix-sharing trace and a preemption trace.
Speculation is refused by name (``use_mla``), as in JAX."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import save_pytree
from repro.configs import get_arch as jax_arch
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import layers, transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import speculate, steps
from repro_torch.serving import (EngineConfig, ServeEngine, batch_trace,
                                 poisson_trace)

ATOL = 1e-4
MAX_LEN = 48


@pytest.fixture(scope="module")
def deepseek():
    jcfg = dataclasses.replace(jax_arch("deepseek-v2-236b").smoke,
                               dtype="float32")
    tcfg = dataclasses.replace(get_arch("deepseek-v2-236b").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _close(a, b, atol=ATOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


def _tokens(cfg, B=2, S=12, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_config_matches_jax_at_full_width(deepseek):
    jcfg, _, tcfg, _ = deepseek
    assert tcfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    full = get_arch("deepseek-v2-236b").config
    jfull = jax_arch("deepseek-v2-236b").config
    assert (full.n_layers, full.d_model, full.n_heads, full.kv_lora_rank,
            full.q_lora_rank, full.rope_head_dim, full.nope_head_dim,
            full.v_head_dim, full.n_experts, full.experts_per_token,
            full.resolved_moe_d_ff, full.n_shared_experts,
            full.first_dense_layers, full.dense_d_ff,
            tfm.padded_vocab(full)) == (60, 5120, 128, 512, 1536, 64, 128,
                                        128, 160, 6, 1536, 2, 1, 12288,
                                        102400)
    assert full.param_count() == jfull.param_count()
    cut = dataclasses.replace(full, n_layers=8)
    assert tfm.n_units(cut) == 7
    # 8 layers in bf16: 54.1 GiB of weights, as the depth cut reckons
    assert abs(cut.param_count() * 2 / 2 ** 30 - 54.1) < 0.1


def test_bridge_carries_the_jax_tree(deepseek):
    """Every leaf lands under its own name, bit for bit: the MLA and MoE
    units, the shared experts and the first dense layer's list; a missing
    leaf raises."""
    _, params, tcfg, tparams = deepseek
    tree = jax.tree.map(np.asarray, params)
    sub = tparams["layers"]["sub0"]
    assert sorted(sub["attn"]) == sorted(tree["layers"]["sub0"]["attn"]) \
        == sorted(["wdkv", "kv_norm", "wuk", "wuv", "wo", "wdq", "q_norm",
                   "wuq"])
    assert sorted(sub["ffn"]) == ["router", "shared", "wi_gate", "wi_up",
                                  "wo"]
    assert isinstance(tparams["dense_layers"], list)
    assert len(tparams["dense_layers"]) == 1
    flat_t = {"/".join(map(str, p)): v for p, v in _leaves(tparams)}
    flat_j = {"/".join(map(str, p)): v for p, v in _leaves(tree)}
    assert sorted(flat_t) == sorted(flat_j)
    for key, val in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), val)
    broken = jax.tree.map(lambda a: a, tree)
    del broken["dense_layers"][0]["attn"]["kv_norm"]
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(broken, tcfg, "cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_checkpoint_round_trip(deepseek, tmp_path):
    """A JAX deepseek checkpoint step directory (the list of dense layers
    keyed ``[0]``) loads key for key into the port's tree."""
    _, params, tcfg, tparams = deepseek
    step = save_pytree(params, tmp_path, 3)
    loaded = bridge.params_from_numpy(bridge.load_step_dir(step), tcfg,
                                      "cpu")
    for (pa, a), (pb, b) in zip(_leaves(loaded), _leaves(tparams)):
        assert pa == pb
        assert torch.equal(a, b)


def test_init_lm_shapes_and_scales(deepseek):
    """``init_lm`` draws the JAX tree's shapes; the expert weights at
    1/sqrt(E), JAX's fan-in of their first axis; the dense layer's at
    1/sqrt(d); norms at 1 in ``param_dtype``."""
    _, _, tcfg, tparams = deepseek
    tp = bridge.init_lm(tcfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {p: tuple(v.shape) for p, v in _leaves(tp)}
    assert shapes == {p: tuple(v.shape) for p, v in _leaves(tparams)}
    wi = tp["layers"]["sub0"]["ffn"]["wi_gate"]
    assert abs(float(wi.std()) * np.sqrt(tcfg.n_experts) - 1) < 0.05
    dense_up = tp["dense_layers"][0]["ffn"]["wi_up"]
    assert abs(float(dense_up.std()) * np.sqrt(tcfg.d_model) - 1) < 0.05
    kvn = tp["layers"]["sub0"]["attn"]["kv_norm"]
    assert torch.equal(kvn, torch.ones_like(kvn))


@pytest.mark.parametrize("B,S", [(2, 12), (2, 200)], ids=["T24", "T400"])
def test_moe_forward_matches_jax(deepseek, B, S):
    """Layer 0's MoE FFN: output (of magnitude up to about 50) within 1e-4
    and the aux loss within 1e-6 of JAX's, at T <= 256 (no drops) and at
    T = 400 (capacity 125 of 8 experts x top 2, the routing skewed
    towards expert 0: the flattened (T * k) order decides which pairs
    drop)."""
    jcfg, params, tcfg, tparams = deepseek
    jffn = jax.tree.map(lambda a: a[0], params["layers"]["sub0"]["ffn"])
    tffn = tfm._layer(tparams["layers"]["sub0"]["ffn"], 0)
    x = np.random.default_rng(S).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32)
    # skew the routing towards expert 0, so that its queue overflows
    r0 = np.asarray(jffn["router"])[:, 0]
    x = x + 3.0 * r0 / np.linalg.norm(r0)
    jout, jaux = jlayers.moe_forward(jffn, jnp.asarray(x), jcfg)
    tout, taux = layers.moe_forward(tffn, torch.tensor(x), tcfg)
    _close(tout, jout)
    _close(taux, jaux, 1e-6)
    T = B * S
    cap = layers._capacity(tcfg, tcfg.experts_per_token, T, tcfg.n_experts)
    assert cap == jlayers._capacity(jcfg, jcfg.experts_per_token, T,
                                    jcfg.n_experts)
    probs = torch.softmax(torch.tensor(x).reshape(T, -1)
                          @ tffn["router"], dim=-1)
    _, idx = layers._top_k(probs, tcfg.experts_per_token)
    load = torch.bincount(idx.reshape(-1), minlength=tcfg.n_experts)
    assert (int(load.max()) > cap) == (T > 256)


def test_top_k_breaks_ties_as_jax():
    """Equal gates: the lower expert index first, as ``jax.lax.top_k``."""
    probs = np.asarray([[0.1, 0.3, 0.3, 0.05, 0.3, 0.05, 0.1, 0.0],
                        [0.2] * 4 + [0.05] * 4,
                        [0.0] * 8], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = layers._top_k(torch.tensor(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_mla_forward_matches_jax(deepseek):
    """Layer 0's MLA attention over 16 tokens: the output and the latent
    (c_kv, k_rope) within 1e-4; the prefill's latent cache in the ring
    layout (padded, and wrapped into a cache of 10)."""
    jcfg, params, tcfg, tparams = deepseek
    jp = jax.tree.map(lambda a: a[0], params["layers"]["sub0"]["attn"])
    tp = tfm._layer(tparams["layers"]["sub0"]["attn"], 0)
    x = np.random.default_rng(4).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    pos = np.arange(16)[None]
    jout, (jc, jr) = jattn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos),
                                       jcfg, return_latent=True)
    tout, (tc, tr) = attn.mla_forward(tp, torch.tensor(x),
                                      torch.tensor(pos), tcfg)
    _close(tout, jout)
    _close(tc, jc)
    _close(tr, jr)
    for cache_len in (20, 10):
        _, jlat = jattn.mla_prefill(jp, jnp.asarray(x), jnp.asarray(pos),
                                    jcfg, cache_len=cache_len)
        _, tlat = attn.mla_prefill(tp, torch.tensor(x), torch.tensor(pos),
                                   tcfg, cache_len=cache_len)
        _close(tlat, jlat)


@functools.lru_cache(maxsize=None)
def _jprefill(max_len):
    return jax.jit(functools.partial(jtfm.prefill, max_len=max_len),
                   static_argnums=(2,))


@pytest.mark.parametrize("backend", ["auto", "ref", "chunked", "cuda"])
def test_prefill_logits_and_cache_match_jax(deepseek, backend):
    """20 prompt tokens: logits, every MLA unit's latent cache and the
    first dense layer's within 1e-4, whichever prefill attention backend
    the port runs (``cuda``: K4's plain version on CPU tensors, at q/k
    head dim 48 and v head dim 32)."""
    jcfg, params, tcfg, tparams = deepseek
    tokens = _tokens(tcfg, S=20, seed=2)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(tokens), jcfg)
    ctx = tfm.RunCtx(kernel_policy=ops.KernelPolicy(
        attention=backend, q_chunk=4, k_chunk=4))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg, ctx,
                             max_len=MAX_LEN)
    _close(tl, jl)
    _close(tc["units"]["sub0"]["lat"], jc["units"]["sub0"]["lat"])
    assert len(tc["dense"]) == len(jc["dense"]) == 1
    _close(tc["dense"][0]["lat"], jc["dense"][0]["lat"])


def test_ring_decode_logits_match_jax(deepseek):
    """Prefill of 12 tokens, then 8 ring decode steps (the absorbed
    attend over the latent ring, the first dense layer's ring too):
    logits and caches within 1e-4."""
    jcfg, params, tcfg, tparams = deepseek
    tokens = _tokens(tcfg)
    jl, jc = _jprefill(MAX_LEN)(params, jnp.asarray(tokens), jcfg)
    jstep = jax.jit(jtfm.decode_step, static_argnums=(3,))
    with torch.no_grad():
        tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg,
                             max_len=MAX_LEN)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        for _ in range(8):
            jl, jc = jstep(params, jc, jnp.asarray(tok), jcfg)
            tl, tc = tfm.decode_step(tparams, tc, torch.tensor(tok), tcfg)
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1),
                             np.int32)[:, None]
    assert int(tc["pos"]) == 20
    _close(tc["units"]["sub0"]["lat"], jc["units"]["sub0"]["lat"])
    _close(tc["dense"][0]["lat"], jc["dense"][0]["lat"])


def test_init_caches_match_jax_layouts(deepseek):
    jcfg, _, tcfg, _ = deepseek
    jc = jtfm.init_cache(jcfg, 3, 16, dtype="float32")
    tc = tfm.init_cache(tcfg, 3, 16, dtype="float32")
    jp = jtfm.init_paged_cache(jcfg, 4, 8, 4, 4, dtype="float32")
    tp = tfm.init_paged_cache(tcfg, 4, 8, 4, 4, dtype="float32")
    assert tuple(tc["units"]["sub0"]["lat"].shape) \
        == jc["units"]["sub0"]["lat"].shape
    assert [tuple(c["lat"].shape) for c in tc["dense"]] \
        == [c["lat"].shape for c in jc["dense"]]
    assert tuple(tp["units"]["sub0"]["lat"].shape) \
        == jp["units"]["sub0"]["lat"].shape
    assert tuple(tp["dense"]["lat"].shape) == jp["dense"]["lat"].shape
    assert tfm.init_cache(tcfg, 1, 8)["dense"][0]["lat"].dtype \
        == torch.bfloat16


@pytest.mark.parametrize("backend", ["torch", "ref", "cuda"])
def test_paged_suffix_prefill_and_decode_match_jax(deepseek, backend):
    """Two slots on scrambled block tables: a 10-token suffix prefill from
    position 0 (the MLA verify sweep and the latent commit, the dense
    group's too), then 6 paged decode steps (K7's form; ``cuda`` is the
    latent sweep's plain version on CPU tensors, split as the policy
    says): logits within 1e-4 of JAX's ``jnp`` path, and the pools."""
    jcfg, params, tcfg, tparams = deepseek
    ps, nb, n_pages = 4, 6, 16
    tables = np.random.default_rng(1).permutation(n_pages)[:2 * nb] \
        .reshape(2, nb).astype(np.int32)
    jcache = jtfm.init_paged_cache(jcfg, 2, n_pages, ps, nb,
                                   dtype="float32")
    tcache = tfm.init_paged_cache(tcfg, 2, n_pages, ps, nb, dtype="float32")
    jcache = {**jcache, "block_tables": jnp.asarray(tables)}
    tcache = {**tcache, "block_tables": torch.tensor(tables)}
    tokens = _tokens(tcfg, S=10, seed=9)
    ncommit = np.asarray([10, 10], np.int32)
    jl, jcache = jax.jit(jtfm.prefill_suffix, static_argnums=(4,))(
        params, jcache, jnp.asarray(tokens), jnp.asarray(ncommit), jcfg)
    ctx = tfm.RunCtx(kernel_policy=ops.KernelPolicy(decode=backend,
                                                    kv_splits=2))
    jstep = jax.jit(jtfm.decode_step, static_argnums=(3,))
    with torch.no_grad():
        tl, tcache = tfm.prefill_suffix(tparams, tcache,
                                        torch.tensor(tokens),
                                        torch.tensor(ncommit), tcfg, ctx)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        for _ in range(6):
            jl, jcache = jstep(params, jcache, jnp.asarray(tok), jcfg)
            tl, tcache = tfm.decode_step(tparams, tcache, torch.tensor(tok),
                                         tcfg, ctx)
            _close(tl, jl)
            tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1),
                             np.int32)[:, None]
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    _close(tcache["units"]["sub0"]["lat"], jcache["units"]["sub0"]["lat"])
    _close(tcache["dense"]["lat"], jcache["dense"]["lat"])


def _both(deepseek, reqs, **over):
    jcfg, params, tcfg, tparams = deepseek
    kw = dict(n_slots=2, page_size=4, max_len=64, decode_chunk=4,
              cache_dtype="float32", **over)
    jrep = JaxServeEngine(jcfg, JaxEngineConfig(**kw), params).run(reqs)
    teng = ServeEngine(tcfg, EngineConfig(**kw), tparams, device="cpu")
    trep = teng.run(reqs)
    assert teng.kv.tables_active
    for a, b in zip(trep.results, jrep.results):
        assert a.tokens == [int(t) for t in np.asarray(b.tokens).ravel()], \
            f"rid {a.rid}"
        assert (a.finish_reason, a.n_preemptions) == (b.finish_reason,
                                                      b.n_preemptions)
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens", "prefill_tokens_saved", "n_preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    return trep


def test_engine_join_finish_streams_match_jax(deepseek):
    """Poisson joins with prompts of 3 to 13 tokens (bucketed cold prefill,
    latent rows and the dense group injected into the slot's pages)."""
    reqs = poisson_trace(5, rate_per_step=0.3, seed=7,
                         vocab_size=deepseek[2].vocab_size,
                         prompt_len=(3, 13), max_new_tokens=(4, 10))
    rep = _both(deepseek, reqs)
    assert any(r.wait_steps > 0 for r in rep.results)
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)


def test_engine_prefix_sharing_streams_match_jax(deepseek):
    """Shared 11-token prompt heads (as ``tests/test_model_zoo_paged.py``'s
    deepseek trace): prefix hits map shared latent and dense pages, the
    copy-on-write copy covers both groups, the suffix runs the MLA verify
    sweep.  Streams equal JAX's and the no-sharing engine's."""
    reqs = poisson_trace(4, rate_per_step=0.3, seed=7,
                         vocab_size=deepseek[2].vocab_size,
                         prompt_len=(3, 9), max_new_tokens=(4, 8),
                         shared_prefix_len=11, prompt_pools=2)
    rep = _both(deepseek, reqs)
    assert rep.prefill_tokens_saved > 0
    plain = _both(deepseek, reqs, prefix_cache=False, preempt=False)
    assert [r.tokens for r in rep.results] == [r.tokens
                                               for r in plain.results]


def test_engine_preemption_streams_match_jax(deepseek):
    """2 scratch + 6 usable pages for three 4-page contexts: page pressure
    preempts, the generated tokens fold into the requeued prompt, which
    the prefix cache mostly restores.  Streams equal JAX's and the ample
    run's."""
    reqs = batch_trace(3, seed=5, vocab_size=deepseek[2].vocab_size,
                       prompt_len=6, max_new_tokens=10)
    rep = _both(deepseek, reqs, n_pages=2 + 6, preempt=True)
    assert rep.n_preemptions > 0
    ample = _both(deepseek, reqs, prefix_cache=False, preempt=False)
    assert [r.tokens for r in rep.results] == [r.tokens
                                               for r in ample.results]


def test_blockers_equal_jax():
    """deepseek's blockers are JAX's: nothing blocks either cache layout
    or the paged verify sweep (so the prefix cache serves it);
    speculation and int8 pages name ``use_mla``."""
    jcfg = jax_arch("deepseek-v2-236b").config
    cfg = get_arch("deepseek-v2-236b").config
    assert tfm.paged_cache_blockers(cfg) == jtfm.paged_cache_blockers(jcfg) \
        == ()
    assert tfm.chunked_prefill_blockers(cfg) \
        == jtfm.chunked_prefill_blockers(jcfg) == ()
    assert tfm.speculative_blockers(cfg) == jtfm.speculative_blockers(jcfg) \
        == ("use_mla", "first_dense_layers")
    assert tfm.int8_paged_blockers(cfg) == jtfm.int8_paged_blockers(jcfg)
    assert set(("wdkv", "wuk", "wuv", "wdq", "wuq", "router")) \
        <= set(tfm._MATMUL_KEYS)


def test_prepare_params_casts_matmuls_only(deepseek):
    """The MLA and MoE matmul weights (and the dense layer's) go to the
    compute dtype; ``kv_norm`` and ``q_norm`` keep ``param_dtype``."""
    _, _, tcfg, tparams = deepseek
    bf = dataclasses.replace(tcfg, dtype="bfloat16")
    p = tfm.prepare_params(tparams, bf)
    for blk in (tfm._layer(p["layers"]["sub0"], 0), p["dense_layers"][0]):
        for key in ("wdkv", "wuk", "wuv", "wo", "wdq", "wuq"):
            assert blk["attn"][key].dtype == torch.bfloat16, key
        assert blk["attn"]["kv_norm"].dtype == torch.float32
        assert blk["attn"]["q_norm"].dtype == torch.float32
    ffn = p["layers"]["sub0"]["ffn"]
    assert ffn["router"].dtype == ffn["wi_gate"].dtype \
        == ffn["shared"]["wo"].dtype == torch.bfloat16


def test_speculation_is_refused_by_name(deepseek):
    _, _, tcfg, tparams = deepseek
    with pytest.raises(ValueError, match="blocked by use_mla"):
        ServeEngine(tcfg, EngineConfig(spec_k=2), tparams, device="cpu")
    with pytest.raises(ValueError, match="blocked by use_mla"):
        steps.make_speculative_decode_loop(
            tcfg, steps.StepConfig(), 2, drafter=speculate.RepeatDrafter(2))


SERVE = ["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu",
         "--requests", "3", "--prompt-len", "12", "--gen", "6"]


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_deepseek_smoke(capsys, traffic):
    da.reset_launches()
    out = serve.run(SERVE + ["--traffic", traffic, "--shared-prefix-len",
                             "8", "--prompt-pools", "2", "--page-size", "4"])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 6)
        assert "[serve] prefill 3x20 in" in text
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
        assert out.prefill_tokens_saved > 0
    assert "[frost-ctrl]" in text
    assert all(n == 0 for n in da.LAUNCHES.values())


def test_serve_takes_a_config_cut_in_depth():
    """``serve(args, cfg)`` serves a config the registry does not hold:
    the smoke config cut to its dense layer and one MoE layer."""
    args = serve.build_parser().parse_args(SERVE + ["--traffic", "batch"])
    cut = dataclasses.replace(get_arch("deepseek-v2-236b").smoke,
                              n_layers=2)
    out = serve.serve(args, cut)
    assert out["tokens"].shape == (3, 6)


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_spec_k_refuses_deepseek(traffic):
    with pytest.raises(ValueError, match="use_mla"):
        serve.run(SERVE + ["--traffic", traffic, "--spec-k", "2"])
