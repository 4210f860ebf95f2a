"""The PyTorch port's continuous-batching engine and serving launcher, held
against the JAX package on the CPU.

With the same smoke ``smollm-135m`` weights at float32 (model and KV
pages), the port's greedy streams must equal the JAX ``ServeEngine``'s
token for token on the traces of ``tests/test_serving.py``: mid-stream
join/finish, prefix sharing with copy-on-write, forced preemption, and
speculative decoding.  The launcher's static batch path is held against
the JAX launcher's ``run_batch`` on the same weights."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro.runtime.steps import StepConfig as JaxStepConfig
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


def _both(smollm, reqs, fields=(), **over):
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
                  "prompt_tokens", "prefill_tokens_saved", "n_preemptions",
                  *fields):
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


@pytest.mark.parametrize("drafter", ["ngram", "repeat"])
def test_speculative_streams_match_jax_and_plain(smollm, drafter):
    """spec_k = 2 on the prefix-sharing trace: the port's greedy streams,
    token counts and draft counts equal the JAX engine's with spec_k = 2,
    and its streams equal its own without speculation."""
    _, _, tcfg, tparams = smollm
    reqs = poisson_trace(5, rate_per_step=0.3, seed=7,
                         vocab_size=tcfg.vocab_size, prompt_len=(3, 13),
                         max_new_tokens=(4, 10), shared_prefix_len=11,
                         prompt_pools=2)
    rep = _both(smollm, reqs, fields=("drafts_proposed", "drafts_accepted"),
                max_len=64, spec_k=2, drafter=drafter)
    assert rep.drafts_proposed > 0 and rep.spec_k == 2
    assert rep.prefill_tokens_saved > 0
    plain = ServeEngine(tcfg, EngineConfig(**dict(BASE, max_len=64)),
                        tparams, device="cpu").run(reqs)
    assert [r.tokens for r in rep.results] \
        == [r.tokens for r in plain.results]


def test_speculative_preemption_streams_match_jax(smollm):
    """Speculation under page pressure: the chunk asks for K+1 rows per
    step, so slots are preempted and re-queued as in the JAX engine."""
    reqs = batch_trace(3, seed=5, vocab_size=smollm[2].vocab_size,
                       prompt_len=6, max_new_tokens=14)
    rep = _both(smollm, reqs, fields=("drafts_proposed", "drafts_accepted"),
                n_pages=2 + 8, preempt=True, spec_k=2)
    assert rep.n_preemptions > 0


def test_cpu_engine_launches_no_kernel(smollm):
    _, _, tcfg, tparams = smollm
    da.reset_launches()
    reqs = batch_trace(2, seed=1, vocab_size=tcfg.vocab_size, prompt_len=5,
                       max_new_tokens=3)
    for spec_k in (0, 2):
        ServeEngine(tcfg, EngineConfig(**BASE, spec_k=spec_k), tparams,
                    device="cpu").run(reqs)
    assert set(da.LAUNCHES) == {"sweep_decode", "sweep_verify", "merge",
                                "merge_fused", "ring_decode", "ring_verify",
                                "flash_attention", "rmsnorm", "ssd",
                                "flash_attention_bwd", "rmsnorm_bwd",
                                "mla_decode", "mla_verify",
                                "sweep_decode_int8", "sweep_verify_int8",
                                "ring_decode_int8", "ring_verify_int8"}
    assert all(n == 0 for n in da.LAUNCHES.values())


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


def test_sampled_speculative_streams_are_deterministic(smollm):
    _, _, tcfg, tparams = smollm
    reqs = batch_trace(2, seed=3, vocab_size=tcfg.vocab_size, prompt_len=6,
                       max_new_tokens=8)

    def run(seed):
        ecfg = EngineConfig(**BASE, greedy=False, temperature=0.9,
                            sample_seed=seed, spec_k=2)
        rep = ServeEngine(tcfg, ecfg, tparams, device="cpu").run(reqs)
        assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
        return [r.tokens for r in rep.results]

    assert run(3) == run(3)
    assert run(3) != run(4)


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


def test_serve_unknown_arch_names_the_ported_ones():
    with pytest.raises(KeyError, match="deepseek-v2-236b.*gemma2-27b.*"
                                       "mamba2-370m.*smollm"):
        serve.run(["--arch", "zamba2-1.2b", "--device", "cpu",
                   "--traffic", "poisson"])


SERVE = ["--arch", "smollm-135m", "--smoke", "--device", "cpu",
         "--requests", "3", "--prompt-len", "8", "--gen", "6"]


def test_serve_default_traffic_is_the_batch_path(capsys):
    out = serve.run(SERVE)
    text = capsys.readouterr().out
    assert out["tokens"].shape == (3, 6)
    assert "[serve] prefill 3x8 in" in text
    assert "tok/s measured, chunks of 8" in text
    assert "J/token analytic" in text and "spec K=" not in text
    assert "[serve] sample continuation:" in text
    assert "[frost-ctrl]" in text and "cap commands mid-run" in text


def test_serve_batch_spec_prints_the_jax_lines(capsys):
    """Greedy output is the same with and without --spec-k."""
    plain = serve.run(SERVE)["tokens"]
    out = serve.run(SERVE + ["--traffic", "batch", "--spec-k", "2"])
    text = capsys.readouterr().out
    np.testing.assert_array_equal(out["tokens"], plain)
    assert out["spec_steps"] > 0
    assert "spec K=2 acceptance" in text and "tok/sweep)" in text


def test_serve_poisson_spec_prints_the_jax_lines(capsys):
    rep = serve.run(SERVE + ["--traffic", "poisson", "--spec-k", "2",
                             "--drafter", "repeat"])
    text = capsys.readouterr().out
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
    assert rep.drafts_proposed > 0
    assert "[serve] speculative K=2 (repeat): acceptance" in text
    assert "tokens/slot-sweep (admission sees" in text
    assert "J/accepted-token" in text


def _batch_args(**over):
    """The JAX launcher's ``run_batch`` arguments (its parser is local to
    its ``main``), at the port's defaults."""
    port = vars(serve.build_parser().parse_args(SERVE))
    port.update(over)
    return argparse.Namespace(**port)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_run_batch_matches_the_jax_launcher(smollm, capsys, spec_k):
    """The same fp32 smoke weights through both launchers' static batch
    paths (prompts from the same synthetic corpus, prefill, ring decode
    chunks, speculation): the same sample continuation."""
    jcfg, params, tcfg, tparams = smollm
    args = _batch_args(spec_k=spec_k, gen=12)
    jserve.run_batch(args, jcfg, JaxStepConfig(remat="none"), None, params,
                     None)
    jline = capsys.readouterr().out.splitlines()[-1]
    out = serve.run_batch(args, tcfg, serve.StepConfig(), tparams, None,
                          torch.device("cpu"))
    tline = capsys.readouterr().out.splitlines()[-1]
    assert jline.startswith("[serve] sample continuation:")
    assert tline == jline
    assert out["tokens"].shape == (3, 12)
