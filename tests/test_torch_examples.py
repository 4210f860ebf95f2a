"""The port's five FROST examples (``repro_torch.examples``) held against
the JAX package's ``examples/`` on the CPU: ``quickstart`` and
``cluster_powershift``, given the JAX scripts' ``TPU_V5E``, print exactly
the JAX scripts' lines; ``serve_batched``'s decode-step FLOPs equal the
HLO count JAX's script reads; ``serve_model_zoo``'s gate column equals
JAX's blockers' and every request is served; ``train_lm_frost`` with an
injected failure restarts once and its loss falls.  Torch runs on one
thread in every case (``one_torch_thread``)."""
import pathlib
import runpy
import sys

import pytest

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jax_arch
from repro.launch import hloparse
from repro.models import transformer as jtfm
from repro_torch.core import TPU_V5E
from repro_torch.examples import (cluster_powershift, quickstart,
                                  serve_batched, serve_model_zoo,
                                  train_lm_frost)

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _run_jax(name, argv, monkeypatch, capsys):
    """JAX's ``examples/<name>.py`` in this process, its stdout captured."""
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name,port", [("quickstart", quickstart),
                                       ("cluster_powershift",
                                        cluster_powershift)])
def test_control_examples_print_jax_lines(name, port, monkeypatch, capsys):
    want = _run_jax(name, [], monkeypatch, capsys)
    assert port.main([], device_spec=TPU_V5E) == 0
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) >= 8


def test_serve_batched_flops_match_jax_hlo(monkeypatch, capsys):
    """The [frost] decode step's FLOPs equal the ``hloparse.analyze``
    dot_flops of JAX's script on the same arguments; the port's greedy
    stream has its shape."""
    argv = ["--requests", "2", "--prompt-len", "8", "--gen", "4"]
    seen = []
    analyze = hloparse.analyze
    monkeypatch.setattr(hloparse, "analyze",
                        lambda txt: seen.append(analyze(txt)) or seen[-1])
    _run_jax("serve_batched", argv, monkeypatch, capsys)
    out = serve_batched.main(argv + ["--device", "cpu"],
                             device_spec=TPU_V5E)
    assert out["flops"] == seen[0]["dot_flops"]
    assert out["tokens"].shape == (2, 4)
    assert "[frost] decode step" in capsys.readouterr().out


def test_serve_model_zoo_gates_match_jax(capsys):
    """Every arch of the zoo serves all its requests on the port's engine;
    the printed gate column is JAX's blockers'."""
    reports = serve_model_zoo.main(["--device", "cpu", "--requests", "2",
                                    "--gen", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert list(reports) == serve_model_zoo.ZOO
    for arch, rep in reports.items():
        assert len(rep.results) == 2
        assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
        jcfg = jax_arch(arch).smoke
        want = " ".join(f"{n}:{b[0] if b else 'ok'}" for n, b in [
            ("int8", jtfm.int8_paged_blockers(jcfg)),
            ("spec", jtfm.speculative_blockers(jcfg)
             or jtfm.chunked_prefill_blockers(jcfg)),
            ("prefix", jtfm.chunked_prefill_blockers(jcfg))])
        row = next(l for l in lines if l.startswith(f"[{arch}]")
                   and "reqs" in l)
        assert row.endswith(want), (row, want)


def test_train_lm_frost_restarts_once(capsys):
    out = train_lm_frost.main(["--device", "cpu", "--steps", "6",
                               "--inject-failure", "3"])
    assert out["restarts"] == 1
    assert out["losses"][-1] < out["losses"][0]
    assert out["peak_gib"] is None
    text = capsys.readouterr().out
    assert "restarts=1" in text and "[frost] step profile" in text
