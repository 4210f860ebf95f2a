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

from repro.configs import get_arch as jax_arch
from repro.core import DEVICES as JAX_DEVICES
from repro_torch import device, quant
from repro_torch.configs import ARCH_SPECS, get_arch
from repro_torch.core import DEVICES, H100_SXM
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import ssd_scan as ss

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_import_pulls_in_no_jax():
    code = ("import sys, repro_torch.launch.serve, repro_torch.bridge, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.rmsnorm, repro_torch.kernels.ssd_scan, "
            "repro_torch.models.ssm, repro_torch.models.layers, "
            "repro_torch.models.attention, repro_torch.quant, "
            "repro_torch.configs.deepseek_v2_236b, repro_torch.checkpoint, "
            "repro_torch.runtime.chaos, repro_torch.launch.train, "
            "repro_torch.optim, repro_torch.launch.mesh, "
            "repro_torch.launch.specs, repro_torch.launch.stepcost, "
            "repro_torch.launch.dryrun, repro_torch.runtime.compress, "
            "repro_torch.runtime.sharding, repro_torch.examples.quickstart, "
            "repro_torch.examples.cluster_powershift, "
            "repro_torch.examples.serve_batched, "
            "repro_torch.examples.serve_model_zoo, "
            "repro_torch.examples.train_lm_frost\n"
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
    kc, vc = r(2, 12, 2, 16), r(2, 12, 2, 16)
    qv, kn, vn = r(2, 3, 6, 16), r(2, 3, 2, 16), r(2, 3, 2, 16)
    rpos = torch.tensor(17, dtype=torch.int32)
    for backend in ("auto", "cuda", "torch", "ref"):
        policy = ops.KernelPolicy(decode=backend, kv_splits=2,
                                  decode_k_chunk=4)
        ops.decode_attention(q, kc, vc, rpos, policy=policy)
        ops.verify_attention(qv, kc, vc, kn, vn, rpos, policy=policy)
    da.ring_attention(qv, kc, vc, rpos.reshape(1), k_new=kn, v_new=vn,
                      n_splits=3, block_k=4)
    # int8 caches: the same wrappers and backends, the int8 launch keys
    k8, ks = quant.quantize_int8_rows(kp)
    c8, cs = quant.quantize_int8_rows(kc)
    qv2, kn2 = r(2, 3, 6, 16), r(2, 3, 2, 16)
    for backend in ("auto", "cuda", "torch", "ref"):
        policy = ops.KernelPolicy(decode=backend, kv_splits=2,
                                  decode_k_chunk=4)
        ops.paged_decode_attention(q, k8, k8, bt, pos, k_scale=ks,
                                   v_scale=ks, policy=policy)
        ops.paged_verify_attention(qv2, k8, k8, kn2, kn2, bt, pos,
                                   k_scale=ks, v_scale=ks, policy=policy)
        ops.decode_attention(q, c8, c8, rpos, k_scale=cs, v_scale=cs,
                             policy=policy)
        ops.verify_attention(qv, c8, c8, kn, vn, rpos, k_scale=cs,
                             v_scale=cs, policy=policy)
    qp, kk, vv = r(2, 9, 6, 16), r(2, 9, 2, 16), r(2, 9, 2, 16)
    x, w = r(2, 5, 16), r(16)
    for backend in ("auto", "cuda", "ref"):
        ops.rmsnorm(x, w, gemma_style=True,
                    policy=ops.KernelPolicy(rmsnorm=backend))
    for backend in ("auto", "cuda", "ref", "chunked"):
        ops.attention(qp, kk, vv, window=4, logit_cap=5.0,
                      policy=ops.KernelPolicy(attention=backend))
    fa.flash_attention(qp, kk, vv, q_offset=3)
    rms.rmsnorm(x, w)
    # the backward wrappers, directly and through autograd
    out, lse = fa.attention_lse_torch(qp, kk, vv, window=4)
    fa.flash_attention_bwd(qp, kk, vv, out, lse, out, window=4)
    y, rstd = rms.rmsnorm_rstd_torch(x, w)
    rms.rmsnorm_bwd(x, w, y, rstd)
    qg = qp.clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    fa.FlashAttentionFn.apply(qg, kk, vv, True, 0, 0.0, None, 0).sum() \
        .backward()
    rms.RMSNormFn.apply(xg, w, 1e-6, False).sum().backward()
    xs, dt = r(2, 9, 4, 8), torch.rand(2, 9, 4) + 0.1
    A, bc = -torch.rand(4) - 0.5, r(2, 9, 2, 16)
    for backend in ("auto", "cuda", "ref", "chunked"):
        ops.ssd(xs, dt, A, bc, bc, r(4), return_state=True,
                policy=ops.KernelPolicy(ssd=backend, ssd_chunk=4))
    ss.ssd_scan(xs, dt, A, bc, bc, chunk=4, initial_state=r(2, 4, 8, 16))
    ss.ssd_scan_bwd(xs, dt, A, bc, bc, r(4), xs, chunk=4,
                    initial_state=r(2, 4, 8, 16), dh_T=r(2, 4, 8, 16))
    xsg = xs.clone().requires_grad_(True)
    ss.SSDScanFn.apply(xsg, dt, A, bc, bc, None, None, 4, False).sum() \
        .backward()
    ql, pool, pend = r(2, 2, 6, 24), r(8, 4, 24), r(2, 2, 24)
    for backend in ("auto", "cuda", "torch", "ref"):
        policy = ops.KernelPolicy(decode=backend, kv_splits=2)
        ops.mla_decode_paged(ql[:, :1], pool, bt, pos, r_kv=16, scale=0.2,
                             policy=policy)
        ops.paged_verify_attention(ql, pool[:, :, None],
                                   pool[:, :, None, :16], pend[:, :, None],
                                   pend[:, :, None, :16], bt, pos, scale=0.2,
                                   policy=policy)
    da.mla_attention(ql, pool, bt, pos, r_kv=16, pending=pend, scale=0.2,
                     n_splits=3)
    assert set(da.LAUNCHES) == {"sweep_decode", "sweep_verify", "merge",
                                "merge_fused", "ring_decode", "ring_verify",
                                "flash_attention", "rmsnorm", "ssd",
                                "ssd_bwd", "flash_attention_bwd",
                                "rmsnorm_bwd",
                                "mla_decode", "mla_verify",
                                "sweep_decode_int8", "sweep_verify_int8",
                                "ring_decode_int8", "ring_verify_int8",
                                "ring_shard_decode"}
    assert all(n == 0 for n in da.LAUNCHES.values())


def test_only_ported_archs_are_listed():
    assert sorted(ARCH_SPECS) == ["deepseek-v2-236b", "gemma2-27b",
                                  "h2o-danube-3-4b", "llava-next-34b",
                                  "mamba2-370m", "musicgen-medium",
                                  "phi3.5-moe-42b-a6.6b", "smollm-135m",
                                  "stablelm-1.6b", "zamba2-1.2b"]
    cfg = get_arch("smollm-135m").config
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.vocab_size) == (30, 576, 9, 3, 64,
                                                       49152)
    g = get_arch("gemma2-27b").config
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv_heads,
            g.resolved_head_dim, g.d_ff, g.vocab_size, g.local_window,
            g.attn_logit_softcap, g.final_logit_softcap) == (
        46, 4608, 32, 16, 128, 36864, 256000, 4096, 50.0, 30.0)
    assert g.query_scale == 144.0 ** -0.5 and g.post_norms
    m = get_arch("mamba2-370m").config
    assert (m.n_layers, m.d_model, m.d_inner, m.resolved_ssm_heads,
            m.ssm_head_dim, m.ssm_state, m.ssm_groups, m.ssm_chunk,
            m.conv_width, m.vocab_size) == (48, 1024, 2048, 32, 64, 128, 1,
                                            128, 4, 50280)
    d = get_arch("deepseek-v2-236b").config
    assert (d.n_layers, d.d_model, d.n_heads, d.kv_lora_rank,
            d.q_lora_rank, d.rope_head_dim, d.nope_head_dim, d.v_head_dim,
            d.n_experts, d.experts_per_token, d.n_shared_experts,
            d.first_dense_layers, d.dense_d_ff, d.vocab_size) == (
        60, 5120, 128, 512, 1536, 64, 128, 128, 160, 6, 2, 1, 12288, 102400)
    h = get_arch("h2o-danube-3-4b").config
    assert (h.n_layers, h.d_model, h.n_heads, h.n_kv_heads,
            h.resolved_head_dim, h.sliding_window) == (24, 3840, 32, 8, 120,
                                                       4096)
    assert get_arch("stablelm-1.6b").config.rope_fraction == 0.25
    assert get_arch("phi3.5-moe-42b-a6.6b").config.n_experts == 16
    assert get_arch("llava-next-34b").config.n_heads == 56
    # the last two architectures: their published widths, as JAX's
    mg, jmg = get_arch("musicgen-medium").config, \
        jax_arch("musicgen-medium").config
    z, jz = get_arch("zamba2-1.2b").config, jax_arch("zamba2-1.2b").config
    widths = lambda c: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                        c.resolved_head_dim, c.d_ff, c.vocab_size,
                        c.n_codebooks, c.act, c.gated_mlp, c.tie_embeddings,
                        c.hybrid_attn_every, c.ssm_state, c.ssm_head_dim,
                        c.d_inner, c.resolved_ssm_heads, c.param_count())
    assert widths(mg) == widths(jmg)
    assert widths(z) == widths(jz)
    assert widths(mg)[:11] == (48, 1536, 24, 24, 64, 6144, 2048, 4, "gelu",
                               False, False)
    assert widths(z)[:7] + widths(z)[11:16] == (38, 2048, 32, 32, 64, 8192,
                                               32000, 2, 64, 64, 4096, 64)


def test_h100_device_model_is_the_ports_own():
    assert DEVICES["h100-sxm"] is H100_SXM
    assert "h100-sxm" not in JAX_DEVICES
    assert (H100_SXM.tdp_w, H100_SXM.peak_flops, H100_SXM.hbm_bw,
            H100_SXM.link_bw, H100_SXM.hbm_bytes) == (700.0, 989e12, 3.35e12,
                                                      450e9, 80 * 2 ** 30)
