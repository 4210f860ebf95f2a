"""The PyTorch port's dense GQA model, held against the JAX package on the
CPU at smoke size in float32: the same weights (carried across by
``repro_torch.bridge``) and the same numpy inputs must give the same
prefill logits, paged decode steps, suffix prefill and page pools, within
1e-4.  The building blocks and the checkpoint bridge are checked the same
way."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree
from repro.configs import get_arch as jax_arch
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models import transformer as jtfm
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.models import common, layers
from repro_torch.models import transformer as tfm

ATOL = 1e-4
PS, N_PAGES, MAX_BLOCKS = 4, 24, 6


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_arch("smollm-135m").smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch("smollm-135m").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    tparams = tfm.prepare_params(bridge.params_from_numpy(tree, tcfg, "cpu"),
                                 tcfg)
    return jcfg, params, tcfg, tparams


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < atol, err


def _paged_state(cfg, seed):
    """Random pools, shuffled tables (page 0 = scratch), ragged pos."""
    rng = np.random.default_rng(seed)
    nu, hkv, hd = tfm.n_units(cfg), cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (nu, N_PAGES, PS, hkv, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    bt = (1 + rng.permutation(N_PAGES - 1)[:3 * MAX_BLOCKS]).reshape(
        3, MAX_BLOCKS).astype(np.int32)
    bt[2] = 0                             # a parked slot on its scratch page
    pos = np.asarray([5, 13, 2], np.int32)
    return {"k": k, "v": v, "bt": bt, "pos": pos}


def _jax_cache(s):
    return {"pos": jnp.asarray(s["pos"]), "block_tables": jnp.asarray(s["bt"]),
            "units": {"sub0": {"k": jnp.asarray(s["k"]),
                               "v": jnp.asarray(s["v"])}}}


def _torch_cache(s):
    # torch.tensor copies: the port writes its pools in place
    return {"pos": torch.tensor(s["pos"]),
            "block_tables": torch.tensor(s["bt"]),
            "units": {"sub0": {"k": torch.tensor(s["k"]),
                               "v": torch.tensor(s["v"])}}}


def _close_cache(tc, jc):
    _close(tc["pos"], jc["pos"], 0.5)
    for key in ("k", "v"):
        _close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])


# --------------------------------------------------------------------------
# the model functions of the serving path
# --------------------------------------------------------------------------
def test_prefill_matches_jax(models):
    jcfg, params, tcfg, tparams = models
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, jc = jtfm.prefill(params, jnp.asarray(tokens), jcfg, max_len=16,
                          full_cache=True)
    tl, tc = tfm.prefill(tparams, torch.tensor(tokens), tcfg, max_len=16)
    assert tl.shape == (2, 12, tfm.padded_vocab(tcfg))
    _close(tl, jl)
    assert tc["pos"] == int(jc["pos"])
    for key in ("k", "v"):
        _close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])


def test_three_paged_decode_steps_match_jax(models):
    jcfg, params, tcfg, tparams = models
    s = _paged_state(tcfg, seed=2)
    jc, tc = _jax_cache(s), _torch_cache(s)
    active = np.asarray([1, 1, 0], np.int32)
    tok = np.asarray([[3], [77], [5]], np.int32)
    for _ in range(3):
        jl, jc = jtfm._paged_decode_step(params, jc, jnp.asarray(tok), jcfg,
                                         jtfm.RunCtx(), jnp.asarray(active))
        tl, tc = tfm._paged_decode_step(tparams, tc, torch.tensor(tok), tcfg,
                                        tfm.RunCtx(), torch.tensor(active))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    _close_cache(tc, jc)
    assert tc["pos"].tolist() == [8, 16, 2]


def test_prefill_suffix_matches_jax(models):
    """One chunked paged prefill: slot 0 commits its whole 5-token chunk,
    slot 1 two rows, slot 2 (n_commit 0) neither writes nor advances."""
    jcfg, params, tcfg, tparams = models
    s = _paged_state(tcfg, seed=3)
    jc, tc = _jax_cache(s), _torch_cache(s)
    tokens = np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (3, 5)).astype(np.int32)
    n_commit = np.asarray([5, 2, 0], np.int32)
    jl, jc = jtfm.prefill_suffix(params, jc, jnp.asarray(tokens),
                                 jnp.asarray(n_commit), jcfg)
    tl, tc = tfm.prefill_suffix(tparams, tc, torch.tensor(tokens),
                                torch.tensor(n_commit), tcfg)
    _close(tl, jl)
    _close_cache(tc, jc)
    assert tc["pos"].tolist() == [10, 15, 2]


def test_verify_then_commit_matches_jax(models):
    """Speculative-style commit of a ragged accepted prefix per slot."""
    jcfg, params, tcfg, tparams = models
    s = _paged_state(tcfg, seed=5)
    jc, tc = _jax_cache(s), _torch_cache(s)
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (3, 3)).astype(np.int32)
    jl, jp = jtfm.verify_step(params, jc, jnp.asarray(tokens), jcfg)
    tl, tp = tfm.verify_step(tparams, tc, torch.tensor(tokens), tcfg)
    _close(tl, jl)
    for key in ("k", "v"):
        _close(tp["sub0"][key], jp["sub0"][key])
    n_acc = np.asarray([2, 0, 1], np.int32)
    active = np.asarray([1, 1, 0], np.int32)
    jc = jtfm.commit_spec_paged(jc, jp, jnp.asarray(n_acc),
                                jnp.asarray(active), jcfg)
    tc = tfm.commit_spec_paged(tc, tp, torch.tensor(n_acc),
                               torch.tensor(active), tcfg)
    _close_cache(tc, jc)


def test_init_paged_cache_matches_jax(models):
    jcfg, _, tcfg, _ = models
    jc = jtfm.init_paged_cache(jcfg, 3, N_PAGES, PS, MAX_BLOCKS,
                               dtype="float32")
    tc = tfm.init_paged_cache(tcfg, 3, N_PAGES, PS, MAX_BLOCKS,
                              dtype="float32", device="cpu")
    assert tuple(tc["pos"].shape) == jc["pos"].shape
    assert tuple(tc["block_tables"].shape) == jc["block_tables"].shape
    for key in ("k", "v"):
        assert tuple(tc["units"]["sub0"][key].shape) \
            == jc["units"]["sub0"][key].shape
        assert tc["units"]["sub0"][key].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="int8"):
        tfm.init_paged_cache(tcfg, 3, N_PAGES, PS, MAX_BLOCKS, dtype="int8")


def test_unported_features_are_named(models):
    _, _, tcfg, tparams = models
    assert tfm.paged_cache_blockers(tcfg) == ()
    assert tfm.chunked_prefill_blockers(tcfg) == ()
    assert tfm.int8_paged_blockers(tcfg)
    windowed = dataclasses.replace(tcfg, sliding_window=16)
    assert tfm.paged_cache_blockers(windowed) == ("sliding_window",)
    with pytest.raises(NotImplementedError, match="sliding_window"):
        tfm.init_paged_cache(windowed, 2, 8, PS, 4)


def test_lm_logits_masks_padded_vocab(models):
    jcfg, params, tcfg, tparams = models
    small_j = dataclasses.replace(jcfg, vocab_size=250)
    small_t = dataclasses.replace(tcfg, vocab_size=250)
    assert tfm.padded_vocab(small_t) == jtfm.padded_vocab(small_j) == 256
    x = np.random.default_rng(7).standard_normal(
        (2, 3, tcfg.d_model)).astype(np.float32)
    tl = tfm.lm_logits(tparams, torch.tensor(x), small_t)
    jl = jtfm.lm_logits(params, jnp.asarray(x), small_j, jtfm.RunCtx())
    _close(tl, jl)
    assert float(tl[..., 250:].max()) == np.float32(-1e30)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("gemma_style", [False, True])
def test_rmsnorm_matches_jax(gemma_style):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    _close(common.rmsnorm(torch.tensor(x), torch.tensor(w), 1e-5,
                          gemma_style=gemma_style),
           jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                           gemma_style=gemma_style), 1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.asarray([[0, 1, 2, 3, 40, 41, 999]] * 2, np.int32)
    _close(common.apply_rope_partial(torch.tensor(x), torch.tensor(pos),
                                     10_000.0, fraction),
           jcommon.apply_rope_partial(jnp.asarray(x), jnp.asarray(pos),
                                      10_000.0, fraction), 1e-4)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_and_softcap_match_jax(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    _close(common.activation(name)(torch.tensor(x)),
           jcommon.activation(name)(jnp.asarray(x)), 1e-5)
    _close(common.softcap(torch.tensor(x), 2.5),
           jcommon.softcap(jnp.asarray(x), 2.5), 1e-5)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(models, gated):
    _, _, tcfg, _ = models
    cfg = dataclasses.replace(tcfg, gated_mlp=gated,
                              act="silu" if gated else "gelu")
    rng = np.random.default_rng(10)
    d, ff = cfg.d_model, cfg.d_ff
    p = {"wi_up": rng.standard_normal((d, ff)).astype(np.float32) / 8,
         "wo": rng.standard_normal((ff, d)).astype(np.float32) / 8}
    if gated:
        p["wi_gate"] = rng.standard_normal((d, ff)).astype(np.float32) / 8
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    got = layers.mlp_forward({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x), cfg)
    want = jlayers.mlp_forward({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), cfg)
    _close(got, want)


# --------------------------------------------------------------------------
# the bridge
# --------------------------------------------------------------------------
def test_checkpoint_step_dir_round_trip(models, tmp_path):
    """A real ``repro.checkpoint`` step directory, with a bf16 leaf, reads
    back bit for bit and serves the same logits."""
    jcfg, params, tcfg, tparams = models
    tree = dict(params)
    tree["final_norm"] = params["final_norm"].astype(jnp.bfloat16)
    step = save_pytree(tree, tmp_path, 3)
    loaded = bridge.load_step_dir(step)
    assert loaded["final_norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        loaded["final_norm"].view(torch.int16).numpy(),
        np.asarray(tree["final_norm"]).view(np.int16))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat:
        node = loaded
        for p in path:
            node = node[p.key]
        if leaf.dtype == jnp.float32:
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    port = bridge.params_from_numpy(loaded, tcfg, "cpu")
    tokens = torch.tensor([[1, 2, 3, 4]])
    a, _ = tfm.prefill(tfm.prepare_params(port, tcfg), tokens, tcfg,
                       max_len=8)
    b, _ = jtfm.prefill(tree, jnp.asarray(tokens.numpy()), jcfg, max_len=8)
    _close(a, b)


def test_params_from_numpy_rejects_bad_trees(models):
    _, params, tcfg, _ = models
    tree = jax.tree.map(np.asarray, params)
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(missing, tcfg, "cpu")
    bad = dict(tree, final_norm=np.ones((3,), np.float32))
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_numpy(bad, tcfg, "cpu")


def test_init_lm_has_the_jax_layout(models):
    jcfg, params, tcfg, _ = models
    a = bridge.init_lm(tcfg, torch.Generator().manual_seed(5), "cpu")
    b = bridge.init_lm(tcfg, torch.Generator().manual_seed(5), "cpu")
    jflat = {"/".join(p.key for p in path): leaf.shape for path, leaf in
             jax.tree_util.tree_flatten_with_path(params)[0]}

    def walk(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    ta, tb = dict(walk(a)), dict(walk(b))
    assert {k: tuple(v.shape) for k, v in ta.items()} == jflat
    for k in ta:                         # deterministic from the generator
        assert ta[k].dtype == torch.float32
        assert torch.equal(ta[k], tb[k])
