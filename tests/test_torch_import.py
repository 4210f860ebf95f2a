"""Import hygiene and device rules of the PyTorch port: it imports neither
JAX nor the JAX package, it runs on the card unless the caller names the
CPU, and a CPU run never touches a kernel's launch count."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import DEVICES as JAX_DEVICES
from repro_torch import device
from repro_torch.configs import ARCH_SPECS, get_arch
from repro_torch.core import DEVICES, H100_SXM
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.bridge\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(','.join(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_jax_or_repro_import_in_the_port(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_resolve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            device.resolve(dev)
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")


def test_cpu_calls_launch_no_kernel():
    """On CPU tensors every wrapper and every backend runs the plain
    versions; the launch counts stay at zero."""
    da.reset_launches()
    rng = np.random.default_rng(0)
    r = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    q, kp, vp = r(2, 1, 6, 16), r(8, 4, 2, 16), r(8, 4, 2, 16)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    pos = torch.tensor([5, 10], dtype=torch.int32)
    for backend in ("auto", "cuda", "torch", "ref"):
        ops.paged_decode_attention(q, kp, vp, bt, pos, policy=ops.KernelPolicy(
            decode=backend, kv_splits=2))
    partial, lse = da.paged_attention_sweep(q, kp, vp, bt, pos, n_splits=3)
    da.lse_merge(partial, lse, torch.float32)
    assert da.LAUNCHES == {"sweep_decode": 0, "sweep_verify": 0, "merge": 0}


def test_only_ported_archs_are_listed():
    assert sorted(ARCH_SPECS) == ["smollm-135m"]
    cfg = get_arch("smollm-135m").config
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == (30, 576, 9, 3, 64,
                                                       49152)
    with pytest.raises(KeyError, match="smollm-135m"):
        get_arch("mamba2-370m")


def test_h100_device_model_is_the_ports_own():
    assert DEVICES["h100-sxm"] is H100_SXM
    assert "h100-sxm" not in JAX_DEVICES
    assert (H100_SXM.tdp_w, H100_SXM.peak_flops, H100_SXM.hbm_bw,
            H100_SXM.link_bw, H100_SXM.hbm_bytes) == (700.0, 989e12, 3.35e12,
                                                      450e9, 80 * 2 ** 30)
