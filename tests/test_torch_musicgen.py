"""musicgen-medium in the PyTorch port — a decoder over 4 EnCodec
codebooks: tokens (B, S, n_cb), the per-codebook embeddings summed, four
heads (``einsum("bsd,cdv->bscv")``), the loss the mean CE over the
codebooks — held against the JAX package on the CPU at its smoke config
(2 layers, d_model 128, 4 heads of 32, vocab 256) in float32.

Logits and both losses within 1e-5 of JAX's; greedy streams token for
token on the ring cache and on the paged engine (JAX's zoo trace of
tests/test_model_zoo_paged.py), whose streams also equal each request's
solo ring stream; the four blocker lists JAX's (no prefix cache, no
speculation: ``n_codebooks``); the launcher serves it in both traffic
modes.  The train step is ``tests/test_torch_train.py``'s."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import (check_blockers, check_cache_layouts,
                       check_engine_streams, check_forward_and_losses,
                       check_ring_stream, check_tree, close, models)
from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import steps

ARCH = "musicgen-medium"


@pytest.fixture(scope="module")
def musicgen():
    return models(ARCH)


def test_config_matches_jax(musicgen):
    jcfg, _, tcfg, _ = musicgen
    assert tcfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    full, jfull = get_arch(ARCH).config, jax_arch(ARCH).config
    assert full == ModelConfig(**{f.name: getattr(jfull, f.name)
                                  for f in dataclasses.fields(jfull)})
    assert (full.n_codebooks, tfm.padded_vocab(full), full.param_count()) \
        == (4, 2048, jfull.param_count())


def test_bridge_and_init_lm_carry_the_codebook_tree(musicgen):
    """embed (n_cb, Vp, d) and lm_head (n_cb, d, Vp), as JAX's tree."""
    check_tree(musicgen)
    _, _, tcfg, tparams = musicgen
    assert tuple(tparams["embed"].shape) == (4, 256, tcfg.d_model)
    assert tuple(tparams["lm_head"].shape) == (4, tcfg.d_model, 256)


def test_embedding_and_head_match_jax(musicgen):
    """The summed embeddings and the four heads, with a padded vocab's
    tail (250 of 256) masked to -1e30, as JAX computes them."""
    jcfg, params, tcfg, tparams = musicgen
    jsmall = dataclasses.replace(jcfg, vocab_size=250)
    tsmall = dataclasses.replace(tcfg, vocab_size=250)
    toks = np.random.default_rng(1).integers(0, 250, (2, 5, 4)).astype(
        np.int32)
    jx = jtfm.embed_tokens(params, jnp.asarray(toks), jsmall, jtfm.RunCtx())
    tx = tfm.embed_tokens(tparams, torch.tensor(toks), tsmall)
    close(tx, jx)
    jl = jtfm.lm_logits(params, jx, jsmall, jtfm.RunCtx())
    tl = tfm.lm_logits(tparams, tx, tsmall)
    assert tuple(tl.shape) == (2, 5, 4, 256)
    assert bool((tl[..., 250:] == -1e30).all())
    close(tl, jl)
    close(tfm._train_logits(tparams, tx, tsmall), jl)


def test_forward_and_losses_match_jax(musicgen):
    logits = check_forward_and_losses(musicgen)
    assert tuple(logits.shape) == (2, 12, 4, 256)


def test_ring_greedy_stream_matches_jax(musicgen):
    """(B, 1, n_cb) tokens a step; the ring's k/v equal JAX's."""
    tc, jc = check_ring_stream(musicgen)
    for key in ("k", "v"):
        close(tc["units"]["sub0"][key], jc["units"]["sub0"][key])


def test_engine_streams_match_jax_and_solo_ring(musicgen):
    _, rep = check_engine_streams(musicgen)
    assert all(len(t) == 4 for r in rep.results for t in r.tokens)


def test_blockers_and_caches_equal_jax(musicgen):
    check_blockers(ARCH)
    assert tfm.speculative_blockers(get_arch(ARCH).config) \
        == ("n_codebooks",)
    check_cache_layouts(musicgen)


def test_sample_draws_each_codebook():
    """Temperature sampling over (B, n_cb, V) logits draws one code per
    codebook from its own row; greedy is the argmax of each."""
    logits = torch.full((2, 4, 16), -1e4)
    for b in range(2):
        for c in range(4):
            logits[b, c, 3 * c + b] = 0.0
    gen = torch.Generator().manual_seed(0)
    want = torch.tensor([[3 * c + b for c in range(4)] for b in range(2)],
                        dtype=torch.int32)
    for greedy in (True, False):
        got = steps.sample(logits, greedy=greedy, temperature=1.0,
                           generator=gen)
        assert torch.equal(got, want)


SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
         "--prompt-len", "12", "--gen", "6"]


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_musicgen_smoke(capsys, traffic):
    da.reset_launches()
    out = serve.run(SERVE + ["--traffic", traffic])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 6, 4)
        assert "[serve] prefill 3x12 in" in text
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
        assert "[serve] engine: 3 requests over" in text
    assert "[frost-ctrl]" in text
    assert all(n == 0 for n in da.LAUNCHES.values())
    with pytest.raises(ValueError, match="n_codebooks"):
        serve.run(SERVE + ["--traffic", traffic, "--spec-k", "2"])
