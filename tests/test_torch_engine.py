"""The PyTorch port's continuous-batching engine and serving launcher, held
against the JAX package on the CPU.

With the same smoke ``smollm-135m`` weights at float32 (model and KV
pages), the port's greedy streams must equal the JAX ``ServeEngine``'s
token for token on the traces of ``tests/test_serving.py``: mid-stream
join/finish, prefix sharing with copy-on-write, and forced preemption."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as jtfm
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve
from repro_torch.serving import (EngineConfig, ServeEngine, batch_trace,
                                 poisson_trace)

BASE = dict(n_slots=2, page_size=4, max_len=48, decode_chunk=4,
            cache_dtype="float32")


@pytest.fixture(scope="module")
def smollm():
    jcfg = dataclasses.replace(jax_arch("smollm-135m").smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch("smollm-135m").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _both(smollm, reqs, **over):
    jcfg, params, tcfg, tparams = smollm
    kw = dict(BASE, **over)
    jrep = JaxServeEngine(jcfg, JaxEngineConfig(**kw), params).run(reqs)
    trep = ServeEngine(tcfg, EngineConfig(**kw), tparams,
                       device="cpu").run(reqs)
    assert len(trep.results) == len(jrep.results) == len(reqs)
    for a, b in zip(trep.results, jrep.results):
        assert a.tokens == b.tokens, f"rid {a.rid}"
        assert (a.finish_reason, a.n_preemptions, a.prefill_tokens_saved) \
            == (b.finish_reason, b.n_preemptions, b.prefill_tokens_saved)
    for field in ("n_chunks", "tokens_kept", "tokens_computed",
                  "prompt_tokens", "prefill_tokens_saved", "n_preemptions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    return trep


def test_join_finish_streams_match_jax(smollm):
    """tests/test_serving.py's join/finish trace: requests join and finish
    mid-decode, and some wait for a slot."""
    reqs = poisson_trace(5, rate_per_step=0.3, seed=7,
                         vocab_size=smollm[2].vocab_size, prompt_len=(3, 13),
                         max_new_tokens=(4, 10))
    rep = _both(smollm, reqs)
    assert any(r.wait_steps > 0 for r in rep.results)
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)


def test_prefix_sharing_streams_match_jax(smollm):
    """tests/test_serving.py's prefix-sharing trace: an 11-token shared
    head over 4-token pages ends mid-page, so joins copy-on-write a
    partial page and prefill only their suffix (the paged verify sweep)."""
    reqs = poisson_trace(6, rate_per_step=0.3, seed=7,
                         vocab_size=smollm[2].vocab_size, prompt_len=(3, 9),
                         max_new_tokens=(4, 10), shared_prefix_len=11,
                         prompt_pools=2)
    rep = _both(smollm, reqs, max_len=64)
    assert rep.prefill_tokens_saved > 0


@pytest.mark.parametrize("prefix", [True, False])
def test_preemption_streams_match_jax(smollm, prefix):
    """tests/test_serving.py's forced-preemption trace: 2 scratch + 6
    usable pages for three 5-page contexts."""
    reqs = batch_trace(3, seed=5, vocab_size=smollm[2].vocab_size,
                       prompt_len=6, max_new_tokens=14)
    rep = _both(smollm, reqs, n_pages=2 + 6, preempt=True,
                prefix_cache=prefix)
    assert rep.n_preemptions > 0


def test_cpu_engine_launches_no_kernel(smollm):
    _, _, tcfg, tparams = smollm
    da.reset_launches()
    reqs = batch_trace(2, seed=1, vocab_size=tcfg.vocab_size, prompt_len=5,
                       max_new_tokens=3)
    ServeEngine(tcfg, EngineConfig(**BASE), tparams, device="cpu").run(reqs)
    assert da.LAUNCHES == {"sweep_decode": 0, "sweep_verify": 0, "merge": 0}


def test_sampled_streams_are_deterministic(smollm):
    """Temperature sampling draws from a generator seeded by
    ``sample_seed``: same seed, same streams; another seed, others."""
    _, _, tcfg, tparams = smollm
    reqs = batch_trace(2, seed=3, vocab_size=tcfg.vocab_size, prompt_len=6,
                       max_new_tokens=8)

    def run(seed):
        ecfg = EngineConfig(**BASE, greedy=False, temperature=0.9,
                            sample_seed=seed)
        rep = ServeEngine(tcfg, ecfg, tparams, device="cpu").run(reqs)
        return [r.tokens for r in rep.results]

    assert run(3) == run(3)
    assert run(3) != run(4)


@pytest.mark.parametrize("over,kw,feature", [
    ({"spec_k": 2}, {}, "speculative"), ({"kv_dtype": "int8"}, {}, "int8"),
    ({"host_tier": True}, {}, "host-memory"),
    ({}, {"injector": object()}, "fault injection"),
    ({}, {"snapshot_dir": "snapshots"}, "snapshots")])
def test_unported_engine_features_raise(smollm, over, kw, feature):
    _, _, tcfg, tparams = smollm
    with pytest.raises(NotImplementedError, match=feature):
        ServeEngine(tcfg, EngineConfig(**BASE, **over), tparams,
                    device="cpu", **kw)


def test_engine_defaults_to_the_card(smollm, monkeypatch):
    _, _, tcfg, tparams = smollm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(tcfg, EngineConfig(**BASE), tparams)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_serve_poisson_prints_the_jax_lines(capsys):
    rep = serve.run(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                     "--traffic", "poisson", "--requests", "3",
                     "--prompt-len", "8", "--gen", "4",
                     "--shared-prefix-len", "8", "--prompt-pools", "1"])
    out = capsys.readouterr().out
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
    assert "[serve] engine: 3 requests over" in out
    assert "tok/s measured" in out and "J/token" in out
    assert "[serve] prefix cache:" in out
    assert "[frost-ctrl]" in out and "cap commands mid-run" in out


@pytest.mark.parametrize("extra,item", [
    (["--traffic", "batch"], "ring decode"),
    (["--traffic", "poisson", "--spec-k", "2"], "speculative"),
    (["--traffic", "poisson", "--kv-dtype", "int8"], "KV tiers"),
    (["--traffic", "poisson", "--host-tier"], "KV tiers"),
    (["--traffic", "poisson", "--chaos", "crash@4"], "chaos")])
def test_serve_refuses_unported_flags(extra, item):
    with pytest.raises(SystemExit) as exc:
        serve.run(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                   *extra])
    assert exc.value.code != 0
    assert "not yet ported" in str(exc.value.code)
    assert item in str(exc.value.code)


def test_serve_unknown_arch_names_the_ported_ones():
    with pytest.raises(KeyError, match="smollm-135m"):
        serve.run(["--arch", "gemma2-27b", "--device", "cpu",
                   "--traffic", "poisson"])
