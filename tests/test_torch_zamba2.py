"""zamba2-1.2b in the PyTorch port — Mamba2 layers with ONE shared
attention block (a single copy of its parameters) applied after every
``hybrid_attn_every`` of them to ``concat(x, emb0) @ w_in``, its residual
``x + (out - h)``, and its own cache: a ring per application, a linear
buffer per engine slot — held against the JAX package on the CPU at its
smoke config (4 layers in 2 units, d_model 128, N 16, P 16, 4 heads of
32) in float32.

Logits and both losses within 1e-5 of JAX's; greedy streams token for
token on the ring cache (the shared rings equal JAX's) and on the paged
engine (JAX's zoo trace of tests/test_model_zoo_paged.py), whose streams
also equal each request's solo ring stream; the four blocker lists JAX's
(no int8 pages, no speculation, no suffix prefill); ``train_step_cost``
counts the shared block once an application; the launcher serves it in
both traffic modes.  The train step is ``tests/test_torch_train.py``'s."""
import dataclasses

import numpy as np
import pytest

from lm_parity import (check_blockers, check_cache_layouts,
                       check_engine_streams, check_forward_and_losses,
                       check_ring_stream, check_tree, close, models)
from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve, train
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig

ARCH = "zamba2-1.2b"


@pytest.fixture(scope="module")
def zamba():
    return models(ARCH)


def test_config_matches_jax(zamba):
    jcfg, _, tcfg, _ = zamba
    assert tcfg == ModelConfig(**{f.name: getattr(jcfg, f.name)
                                  for f in dataclasses.fields(jcfg)})
    full, jfull = get_arch(ARCH).config, jax_arch(ARCH).config
    assert full == ModelConfig(**{f.name: getattr(jfull, f.name)
                                  for f in dataclasses.fields(jfull)})
    assert (tfm.unit_size(full), tfm.n_units(full), full.resolved_ssm_heads,
            full.ssm_state, full.param_count()) \
        == (2, 19, 64, 64, jfull.param_count())


def test_bridge_and_init_lm_carry_the_shared_block(zamba):
    """``shared_attn`` = {w_in (2d, d), block}: one unstacked block."""
    check_tree(zamba)
    _, _, tcfg, tparams = zamba
    d = tcfg.d_model
    sh = tparams["shared_attn"]
    assert tuple(sh["w_in"].shape) == (2 * d, d)
    assert tuple(sh["block"]["attn"]["wq"].shape) == (d, 4, 32)
    assert tuple(sh["block"]["norm1"].shape) == (d,)


def test_forward_and_losses_match_jax(zamba):
    logits = check_forward_and_losses(zamba)
    assert tuple(logits.shape) == (2, 12, 256)


def test_ring_greedy_stream_matches_jax(zamba):
    """The SSM state and the shared block's rings (one an application)
    equal JAX's after prefill and 12 decode steps."""
    tc, jc = check_ring_stream(zamba)
    for key in ("k", "v"):
        close(tc["shared"][key], jc["shared"][key])
    close(tc["units"]["sub1"]["ssm"], jc["units"]["sub1"]["ssm"], 1e-4)


def test_engine_streams_match_jax_and_solo_ring(zamba):
    """State slots and the shared buffer (injected at ``slot * cs + p``)
    through joins and finishes; no table-backed pool."""
    eng, _ = check_engine_streams(zamba)
    assert not eng.kv.tables_active and not eng._table_groups()


def test_blockers_and_caches_equal_jax(zamba):
    check_blockers(ARCH)
    assert tfm.int8_paged_blockers(get_arch(ARCH).config) \
        == ("uses_ssm", "hybrid_attn_every")
    check_cache_layouts(zamba)


def test_step_cost_counts_the_shared_block_per_application():
    """Less the same model without its shared block, the analytic step
    costs n_units x (6 T x the block's matmul weights, which
    ``param_count`` counts once, + 3 x its attention's 4 B S^2 H D)."""
    cfg = get_arch(ARCH).config
    B, S = 8, 512
    bare = dataclasses.replace(cfg, hybrid_attn_every=0)
    weights = cfg.param_count() - bare.param_count() - 2 * cfg.d_model
    want = tfm.n_units(cfg) * (
        6 * weights * B * S
        + 3 * 4 * B * S ** 2 * cfg.n_heads * cfg.resolved_head_dim)
    got = train.train_step_cost(cfg, B, S)[0] \
        - train.train_step_cost(bare, B, S)[0]
    assert got == want


SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
         "--prompt-len", "12", "--gen", "6"]


@pytest.mark.parametrize("traffic", ["batch", "poisson"])
def test_serve_zamba2_smoke(capsys, traffic):
    da.reset_launches()
    out = serve.run(SERVE + ["--traffic", traffic])
    text = capsys.readouterr().out
    if traffic == "batch":
        assert out["tokens"].shape == (3, 6)
    else:
        assert all(r.n_tokens == r.max_new_tokens for r in out.results)
    assert "[frost-ctrl]" in text
    assert all(n == 0 for n in da.LAUNCHES.values())
    with pytest.raises(ValueError, match="uses_ssm"):
        serve.run(SERVE + ["--traffic", traffic, "--spec-k", "2"])
