"""The PyTorch port's static batch path — the ring cache, its decode step,
the speculative verify and commit, the drafters and the decode loops —
held against the JAX package on the CPU at smoke size in float32: the
same weights (carried across by ``repro_torch.bridge``) and the same numpy
inputs must give the same logits within 1e-4 and the same greedy streams
token for token."""
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
from repro.runtime import speculate as jspec
from repro.runtime import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.models import transformer as tfm
from repro_torch.runtime import speculate, steps

ATOL = 1e-4
STEP = steps.StepConfig()
JSTEP = jsteps.StepConfig(remat="none")
N_STEPS = 6

# the JAX functions jitted once per signature (eager mode would compile
# every primitive of every call)
_jdecode = jax.jit(jtfm.decode_step, static_argnums=(3,))
_jverify = jax.jit(jtfm.verify_step, static_argnums=(3,))
_jcommit = jax.jit(jtfm.commit_spec, static_argnums=(3,))


@functools.lru_cache(maxsize=None)
def _jprefill(max_len):
    return jax.jit(functools.partial(jtfm.prefill, max_len=max_len),
                   static_argnums=(2,))


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


def _close_ring(tc, jc):
    assert int(tc["pos"]) == int(jc["pos"])
    assert tc["pos"].dtype == torch.int32 and tc["pos"].ndim == 0
    for key in ("k", "v"):
        _close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])


def _prompts(cfg):
    """A repetitive prompt (the n-gram drafter finds its matches)."""
    pat = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 4))
    return np.tile(pat, (1, 2)).astype(np.int32)


def _prefilled(models, max_len):
    """Both packages' ring caches after the same prefill, and the greedy
    first token."""
    jcfg, params, tcfg, tparams = models
    prompts = _prompts(tcfg)
    jl, jc = _jprefill(max_len)(params, jnp.asarray(prompts), jcfg)
    tl, tc = tfm.prefill(tparams, torch.tensor(prompts), tcfg,
                         max_len=max_len)
    tok0 = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    return jc, tc, tok0, prompts


def _flatten(toks, counts):
    return [sum((toks[b, s, :counts[b, s]].tolist()
                 for s in range(toks.shape[1])), [])
            for b in range(toks.shape[0])]


# --------------------------------------------------------------------------
# the ring cache and its steps
# --------------------------------------------------------------------------
def test_init_cache_has_the_jax_layout(models):
    jcfg, _, tcfg, _ = models
    jc = jtfm.init_cache(jcfg, 3, 24, dtype="float32")
    tc = tfm.init_cache(tcfg, 3, 24, dtype="float32", device="cpu")
    assert tc["pos"].shape == jc["pos"].shape == ()
    assert tc["pos"].dtype == torch.int32 and int(tc["pos"]) == 0
    assert set(tc) == set(jc) and set(tc["units"]) == set(jc["units"])
    for key in ("k", "v"):
        assert tuple(tc["units"]["sub0"][key].shape) \
            == jc["units"]["sub0"][key].shape
        assert tc["units"]["sub0"][key].dtype == torch.float32
    assert tfm.init_cache(tcfg, 1, 8)["units"]["sub0"]["k"].dtype \
        == torch.bfloat16
    with pytest.raises(NotImplementedError, match="int8"):
        tfm.init_cache(tcfg, 1, 8, dtype="int8")


@pytest.mark.parametrize("cfg_over,name", [
    ({"sliding_window": 6}, "sliding_window"),
    ({"use_mla": True, "kv_lora_rank": 32, "rope_head_dim": 16}, "use_mla"),
    ({"family": "ssm", "ssm_state": 16}, "uses_ssm"),
    ({"first_dense_layers": 1}, "first_dense_layers"),
    ({"family": "hybrid", "hybrid_attn_every": 2, "ssm_state": 16},
     "hybrid_attn_every")])
def test_unported_ring_families_raise_by_name(models, cfg_over, name):
    """Every family builds its ring cache, as JAX's (the test kept its name
    from when some raised): a windowed config, of capacity min(max_len,
    window), an SSM config its state, one slot per batch row, an MLA
    config one latent row per slot, a first dense layer its own cache in
    the ``"dense"`` list and a hybrid config its state and its shared
    block's rings, one per application."""
    _, _, tcfg, _ = models
    cfg = dataclasses.replace(tcfg, **cfg_over)
    if name == "use_mla":
        c = tfm.init_cache(cfg, 1, 8)
        assert tuple(c["units"]["sub0"]["lat"].shape) == (
            tfm.n_units(cfg), 1, 8, 48)
        return
    if name == "first_dense_layers":
        c = tfm.init_cache(cfg, 1, 8)
        assert tuple(c["dense"][0]["k"].shape) == (
            1, 8, cfg.n_kv_heads, cfg.resolved_head_dim)
        assert tfm.n_units(cfg) == tfm.n_units(tcfg) - 1
        return
    if name == "sliding_window":
        c = tfm.init_cache(cfg, 1, 8)
        assert c["units"]["sub0"]["k"].shape[2] == 6
        return
    if name == "uses_ssm":
        c = tfm.init_cache(cfg, 1, 8)
        assert tuple(c["units"]["sub0"]["ssm"].shape) == (
            tfm.n_units(cfg), 1, cfg.resolved_ssm_heads, cfg.ssm_head_dim,
            16)
        return
    c = tfm.init_cache(cfg, 1, 8, dtype="float32")
    jc = jtfm.init_cache(dataclasses.replace(models[0], **cfg_over), 1, 8,
                         dtype="float32")
    assert set(c) == set(jc) and set(c["units"]) == set(jc["units"])
    for key in ("k", "v"):
        assert tuple(c["shared"][key].shape) == jc["shared"][key].shape == (
            tfm.n_units(cfg), 1, 8, cfg.n_kv_heads, cfg.resolved_head_dim)


def test_prefill_and_three_ring_decode_steps_match_jax(models):
    """Prefill of 8 tokens into a 10-slot ring, then three decode steps:
    the third wraps to slot 0."""
    jcfg, params, tcfg, tparams = models
    jc, tc, tok, _ = _prefilled(models, 10)
    assert tc["pos"].dtype == torch.int32 and tc["pos"].ndim == 0
    _close_ring(tc, jc)
    for _ in range(3):
        jl, jc = _jdecode(params, jc, jnp.asarray(tok), jcfg)
        tl, tc = tfm.decode_step(tparams, tc, torch.tensor(tok), tcfg)
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    _close_ring(tc, jc)
    assert int(tc["pos"]) == 11


def test_verify_commit_partial_prefix_matches_jax(models):
    """tests/test_speculative.py's no-rollback invariant on a ring that
    wraps: verify 4 tokens, commit only rows 0..1, re-verify from the
    accepted prefix; logits and caches track JAX's and the sequential
    decode's."""
    jcfg, params, tcfg, tparams = models
    jc, tc, tok0, _ = _prefilled(models, 16)
    jc0 = jc
    stream, seq_logits = [tok0[:, 0]], []
    c, t = jc, jnp.asarray(tok0)
    for _ in range(8):
        lg, c = _jdecode(params, c, t, jcfg)
        seq_logits.append(np.asarray(lg[:, -1]))
        t = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None]
        stream.append(np.asarray(t[:, 0]))
    fed = np.stack(stream[:4], axis=1)
    jl, jp = _jverify(params, jc0, jnp.asarray(fed), jcfg)
    tl, tp = tfm.verify_step(tparams, tc, torch.tensor(fed), tcfg)
    _close(tl, jl)
    for j in range(4):
        _close(tl[:, j], seq_logits[j], 2e-4)
    for key in ("k", "v"):
        _close(tp["sub0"][key], jp["sub0"][key])
    jc2 = _jcommit(jc0, jp, jnp.asarray(1), jcfg)
    tc2 = tfm.commit_spec(tc, tp, torch.tensor(1, dtype=torch.int32), tcfg)
    _close_ring(tc2, jc2)
    fed2 = np.stack(stream[2:6], axis=1)
    jl2, _ = _jverify(params, jc2, jnp.asarray(fed2), jcfg)
    tl2, _ = tfm.verify_step(tparams, tc2, torch.tensor(fed2), tcfg)
    _close(tl2, jl2)
    for j in range(4):
        _close(tl2[:, j], seq_logits[2 + j], 2e-4)


def test_commit_past_capacity_wraps_like_jax(models):
    """A commit that runs past the ring's end lands at (pos + i) % C."""
    jcfg, params, tcfg, tparams = models
    jc, tc, _, _ = _prefilled(models, 10)
    fed = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                            (2, 4)).astype(np.int32)
    _, jp = _jverify(params, jc, jnp.asarray(fed), jcfg)
    _, tp = tfm.verify_step(tparams, tc, torch.tensor(fed), tcfg)
    jc = _jcommit(jc, jp, jnp.asarray(3), jcfg)
    tc = tfm.commit_spec(tc, tp, torch.tensor(3, dtype=torch.int32), tcfg)
    _close_ring(tc, jc)
    assert int(tc["pos"]) == 12


def test_ring_verify_gate_names_the_feature(models):
    _, _, tcfg, tparams = models
    assert tfm.speculative_blockers(tcfg) == ()
    assert tfm.supports_speculative(tcfg)
    ssm = dataclasses.replace(tcfg, family="ssm", ssm_state=16)
    assert tfm.speculative_blockers(ssm) == ("uses_ssm",)
    with pytest.raises(ValueError, match="uses_ssm"):
        steps.make_speculative_decode_loop(ssm, STEP, 2,
                                           drafter=speculate.RepeatDrafter(2))


# --------------------------------------------------------------------------
# the decode loops
# --------------------------------------------------------------------------
def test_decode_loop_greedy_stream_matches_jax(models):
    """The ring chunk loop against JAX's jitted ``lax.scan`` loop, over a
    ring that wraps (8 prompt + 12 tokens in 16 slots)."""
    jcfg, params, tcfg, tparams = models
    jc, tc, tok0, _ = _prefilled(models, 16)
    jloop = jax.jit(jsteps.make_decode_loop(jcfg, JSTEP, n_tokens=12))
    jtoks, jc = jloop(params, jc, jnp.asarray(tok0))
    with torch.no_grad():
        ttoks, tc = steps.make_decode_loop(tcfg, STEP, 12)(
            tparams, tc, torch.tensor(tok0))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    _close_ring(tc, jc)


def test_prefill_step_matches_jax(models):
    jcfg, params, tcfg, tparams = models
    prompts = _prompts(tcfg)
    jl, jc = jsteps.make_prefill_step(jcfg, JSTEP, max_len=12)(
        params, {"inputs": jnp.asarray(prompts)})
    tl, tc = steps.make_prefill_step(tcfg, STEP, max_len=12)(
        tparams, {"inputs": torch.tensor(prompts)})
    _close(tl, jl)
    _close_ring(tc, jc)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("drafter_name", ["ngram", "repeat", "replay"])
def test_greedy_speculative_equals_plain_loop(models, drafter_name, k):
    """Greedy speculative == the plain loop, token for token, over a
    10-slot ring that every run wraps (8 prompt + at least 6 positions)."""
    _, _, tcfg, tparams = models
    _, tc, tok0, prompts = _prefilled(models, 10)
    n = N_STEPS * (k + 1)
    with torch.no_grad():
        ref_toks, _ = steps.make_decode_loop(tcfg, STEP, n)(
            tparams, tc, torch.tensor(tok0))
        _, tc, _, _ = _prefilled(models, 10)
        if drafter_name == "replay":
            drafter = speculate.ReplayDrafter(k, ref_toks.numpy())
        else:
            drafter = speculate.get_drafter(drafter_name, k, hist_len=32)
        ds = drafter.init_state(2)
        drafter.seed_batch(ds, prompts, tok0)
        loop = steps.make_speculative_decode_loop(tcfg, STEP, N_STEPS,
                                                  drafter=drafter)
        toks, counts, tc2, _ = loop(tparams, tc, torch.tensor(tok0),
                                    speculate.state_to(ds, "cpu"))
    toks, counts = toks.numpy(), counts.numpy()
    assert (counts == counts[0]).all()             # ring lockstep
    assert (counts >= 1).all() and (counts <= k + 1).all()
    flat = np.asarray(_flatten(toks, counts))
    np.testing.assert_array_equal(flat, ref_toks.numpy()[:, :flat.shape[1]])
    assert int(tc2["pos"]) == 8 + flat.shape[1]
    assert int(tc2["pos"]) > 10                    # the ring wrapped
    if drafter_name == "replay":
        assert (counts == k + 1).all()             # acceptance 1.0


def test_spec_loop_launches_no_kernel_on_cpu(models):
    _, _, tcfg, tparams = models
    _, tc, tok0, prompts = _prefilled(models, 16)
    da.reset_launches()
    drafter = speculate.NgramDrafter(2, hist_len=32)
    ds = drafter.init_state(2)
    drafter.seed_batch(ds, prompts, tok0)
    with torch.no_grad():
        steps.make_speculative_decode_loop(tcfg, STEP, 2, drafter=drafter)(
            tparams, tc, torch.tensor(tok0), speculate.state_to(ds, "cpu"))
    assert all(n == 0 for n in da.LAUNCHES.values())


def test_sampled_speculative_is_seeded(models):
    """Temperature rejection sampling draws from the generator: the same
    seed gives the same stream and counts, another seed another stream."""
    _, _, tcfg, tparams = models
    drafter = speculate.NgramDrafter(2, hist_len=32)
    loop = steps.make_speculative_decode_loop(tcfg, STEP, N_STEPS,
                                              drafter=drafter, greedy=False,
                                              temperature=0.8)

    def run(seed):
        _, tc, tok0, prompts = _prefilled(models, 64)
        ds = drafter.init_state(2)
        drafter.seed_batch(ds, prompts, tok0)
        with torch.no_grad():
            toks, counts, _, _ = loop(
                tparams, tc, torch.tensor(tok0),
                speculate.state_to(ds, "cpu"),
                torch.Generator().manual_seed(seed))
        return toks.numpy(), counts.numpy()

    a, ca = run(7)
    b, cb = run(7)
    c, _ = run(8)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ca, cb)
    assert np.any(a != c)
    assert (ca >= 1).all() and (ca <= 3).all()


# --------------------------------------------------------------------------
# the drafters
# --------------------------------------------------------------------------
def _both_states(jd, td, state):
    return ({k: jnp.asarray(v) for k, v in state.items()},
            speculate.state_to(state, "cpu"))


def _check_drafter(jd, td, state, lasts, blocks, counts):
    """propose / observe of both packages on the same numpy state and
    tokens, step by step."""
    js, ts = _both_states(jd, td, state)
    for last, block, count in zip(lasts, blocks, counts):
        last = np.asarray(last, np.int32)
        jp = np.asarray(jd.propose(js, jnp.asarray(last)))
        tp = td.propose(ts, torch.tensor(last))
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(tp.numpy(), jp)
        block = np.asarray(block, np.int32)
        count = np.asarray(count, np.int32)
        js = jd.observe(js, jnp.asarray(block), jnp.asarray(count))
        ts = td.observe(ts, torch.tensor(block), torch.tensor(count))
        for key in js:
            np.testing.assert_array_equal(ts[key].numpy(),
                                          np.asarray(js[key]))


def test_ngram_drafter_matches_jax():
    jd, td = jspec.NgramDrafter(3, hist_len=16), speculate.NgramDrafter(
        3, hist_len=16)
    ds = td.init_state(2)
    td.seed_row(ds, 0, [7, 1, 2, 3, 9, 4])   # no earlier 4 -> repeat
    td.seed_row(ds, 1, [5, 1, 2, 3, 5])      # earlier 5 -> 1, 2, 3
    jds = jd.init_state(2)
    jd.seed_row(jds, 0, [7, 1, 2, 3, 9, 4])
    jd.seed_row(jds, 1, [5, 1, 2, 3, 5])
    for key in ds:
        np.testing.assert_array_equal(ds[key], jds[key])
    _check_drafter(jd, td, ds, lasts=[[4, 5], [4, 2], [9, 3]],
                   blocks=[[[9, 9, 9, 9], [1, 2, 0, 0]],
                           [[4, 4, 9, 1], [3, 5, 1, 2]],
                           [[1, 2, 3, 4], [6, 6, 6, 6]]],
                   counts=[[0, 2], [3, 4], [4, 1]])


def test_ngram_drafter_history_wrap_matches_jax():
    """Seeding more tokens than hist_len keeps the most recent ones, and
    observing past the end wraps the ring."""
    jd, td = jspec.NgramDrafter(2, hist_len=8), speculate.NgramDrafter(
        2, hist_len=8)
    toks = [1, 2, 3, 111, 112, 113, 9, 8, 111]
    ds, jds = td.init_state(1), jd.init_state(1)
    td.seed_row(ds, 0, toks)
    jd.seed_row(jds, 0, toks)
    np.testing.assert_array_equal(ds["hist"], jds["hist"])
    _check_drafter(jd, td, ds, lasts=[[111], [113], [5]],
                   blocks=[[[112, 113, 7]], [[5, 6, 7]], [[8, 111, 112]]],
                   counts=[[3], [3], [2]])


def test_replay_drafter_exhaustion_matches_jax():
    stream = np.asarray([[10, 11, 12, 13, 14], [20, 21, 22, 23, 24]],
                        np.int32)
    jd, td = jspec.ReplayDrafter(3, stream), speculate.ReplayDrafter(3,
                                                                      stream)
    ds = td.init_state(2)
    _check_drafter(jd, td, ds, lasts=[[9, 19], [12, 21], [14, 24], [7, 7]],
                   blocks=[[[10, 11, 12, 0]] * 2, [[13, 14, 0, 0]] * 2,
                           [[0, 0, 0, 0]] * 2, [[0, 0, 0, 0]] * 2],
                   counts=[[3, 2], [2, 4], [1, 1], [0, 0]])
    with pytest.raises(ValueError):
        td.init_state(3)


def test_repeat_drafter_and_factory():
    td = speculate.RepeatDrafter(3)
    ds = speculate.state_to(td.init_state(2), "cpu")
    np.testing.assert_array_equal(
        td.propose(ds, torch.tensor([4, 9], dtype=torch.int32)).numpy(),
        [[4, 4, 4], [9, 9, 9]])
    assert isinstance(speculate.get_drafter("ngram", 2),
                      speculate.NgramDrafter)
    assert isinstance(speculate.get_drafter("repeat", 3),
                      speculate.RepeatDrafter)
    for bad in ("replay", "nope"):
        with pytest.raises(ValueError):
            speculate.get_drafter(bad, 2)
