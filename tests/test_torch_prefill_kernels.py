"""The port's prefill flash attention (K4) and fused RMSNorm (K9), held
against the JAX package on the CPU.

On the CPU the wrappers ``repro_torch.kernels.flash_attention`` and
``repro_torch.kernels.rmsnorm`` run their plain versions
(``ops.flash_attention_torch`` and ``models.common.rmsnorm``).  The same
numpy inputs go through the JAX Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), the JAX oracles and the JAX chunked
twin, and all must agree: 5e-6 in fp32, 2e-2 in bf16 (one bf16 rounding
of outputs that agree in fp32).  Rows that see no key are only required
to be finite: their value depends on the block size, in JAX as in the
port.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrms
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms
from repro_torch.models import common

TOL = {"float32": 5e-6, "bfloat16": 2e-2}

# (id, B, Sq, Sk, Hq, Hkv, D, keyword arguments[, Dv when it is not D])
FA_CASES = [
    ("causal-G1-D64", 2, 32, 32, 2, 2, 64, {}),
    ("window-cap-scale-G2-D128", 1, 64, 64, 4, 2, 128,
     {"window": 12, "logit_cap": 5.0, "scale": 0.3}),
    ("window-G3-D64", 2, 48, 48, 6, 2, 64, {"window": 20}),
    ("q_offset-G2-D64", 1, 16, 48, 4, 2, 64, {"q_offset": 32,
                                              "logit_cap": 4.0}),
    ("q_offset-window-G2-D128", 1, 32, 64, 4, 2, 128,
     {"q_offset": 32, "window": 24, "scale": 144.0 ** -0.5}),
    ("noncausal-G2-D64", 1, 32, 48, 4, 2, 64, {"causal": False}),
    ("ragged-37-G3-D64", 2, 37, 37, 6, 2, 64, {"window": 9,
                                                "logit_cap": 5.0}),
    ("ragged-q_offset-G2-D128", 1, 21, 45, 4, 2, 128, {"q_offset": 24}),
    # h2o-danube-3's head dim 120 (Dv 120: the fp32 kernel predicates its
    # last column slot, the bf16 one runs 15 n8 tiles) at its G 4,
    # windowed; ragged with a q_offset
    ("window-G4-D120", 1, 48, 48, 8, 2, 120, {"window": 16}),
    ("ragged-q_offset-G4-D120", 2, 21, 45, 8, 2, 120, {"q_offset": 24}),
    # llava-next's G 7, which does not divide the kernel's 128 rows
    ("ragged-G7-D128", 1, 37, 37, 14, 2, 128, {}),
    # the tensor-core kernel's tile edges: one key past a 64-key tile and
    # one short of two, a one-token prompt, D 120 over 17 keys, G 7 one
    # position past a block's 18, the last batch's rows past a ragged Sk,
    # and deepseek's (D, Dv) = (192, 128) ragged against 128 positions a
    # block
    ("Sk65-cap-G2-D128", 2, 65, 65, 4, 2, 128,
     {"logit_cap": 50.0, "scale": 144.0 ** -0.5}),
    ("Sk127-G2-D64", 1, 127, 127, 4, 2, 64, {}),
    ("Sq1-G2-D128", 2, 1, 1, 4, 2, 128, {}),
    ("Sk17-window-G4-D120", 2, 17, 17, 8, 2, 120, {"window": 4096}),
    ("Sq19-G7-D128", 1, 19, 19, 14, 2, 128, {}),
    ("ragged-Sk100-B3-G2-D64", 3, 100, 100, 4, 2, 64, {"logit_cap": 5.0}),
    ("ragged-1000-G1-D192-Dv128", 1, 1000, 1000, 2, 2, 192,
     {"scale": 192 ** -0.5}, 128),
]


def _fa_inputs(B, Sq, Sk, Hq, Hkv, D, seed, Dv=None):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return r(B, Sq, Hq, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, Dv or D)


def _to_jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _to_torch(a, dtype):
    return torch.tensor(a).to(getattr(torch, dtype))


def _close(a, b, tol):
    a = np.asarray(torch.as_tensor(a).float()) if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))
    b = np.asarray(torch.as_tensor(b).float()) if isinstance(b, torch.Tensor) \
        else np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= tol, err


@functools.lru_cache(maxsize=None)
def _jfa(kw_items, block):
    kw = dict(kw_items)
    return jax.jit(functools.partial(jfa.flash_attention, block_q=block,
                                     block_k=block, interpret=True, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES, ids=[c[0] for c in FA_CASES])
def test_flash_attention_plain_matches_jax(case, dtype):
    """K4's plain path (the wrapper on CPU tensors) against the Pallas
    kernel in interpret mode (blocks of 16; ragged shapes take JAX's own
    chunked twin) and the oracle."""
    _, B, Sq, Sk, Hq, Hkv, D, kw, *dv = case
    Dv = dv[0] if dv else D
    q, k, v = _fa_inputs(B, Sq, Sk, Hq, Hkv, D, seed=len(case[0]), Dv=Dv)
    tq, tk, tv = (_to_torch(a, dtype) for a in (q, k, v))
    jq, jk, jv = (_to_jax(a, dtype) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (B, Sq, Hq, Dv)
    pallas = _jfa(tuple(sorted(kw.items())), 16)(jq, jk, jv)
    oracle = jref.attention_ref(jq, jk, jv, **kw)
    _close(got, pallas, TOL[dtype])
    _close(got, oracle, TOL[dtype])
    # the ops dispatch: the cuda backend takes the same plain version here
    same = ops.attention(tq, tk, tv, policy=ops.KernelPolicy(
        attention="cuda"), **kw)
    assert torch.equal(same, got)


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_twin_matches_jax_chunks(chunk):
    """The chunked twin with small chunks (band skip, several q and k
    chunks) against JAX's ``flash_attention_jnp`` with the same chunks."""
    q, k, v = _fa_inputs(2, 64, 64, 4, 2, 64, seed=9)
    kw = {"window": 20, "logit_cap": 5.0, "scale": 0.2}
    got = ops.flash_attention_torch(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), q_chunk=chunk,
                                    k_chunk=chunk, **kw)
    want = jops.flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), q_chunk=chunk,
                                    k_chunk=chunk, **kw)
    _close(got, want, TOL["float32"])


def test_rows_without_keys_are_finite():
    """q rows at 40..55 with a window of 8 over 32 keys see none: finite."""
    q, k, v = _fa_inputs(1, 16, 32, 4, 2, 64, seed=3)
    got = fa.flash_attention(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), q_offset=40, window=8)
    assert bool(torch.isfinite(got).all())
    pallas = _jfa((("q_offset", 40), ("window", 8)), 16)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert bool(jnp.isfinite(pallas).all())


def test_attention_auto_on_cpu_chooses_as_jax():
    """``auto`` on CPU tensors: the oracle up to 512 x 512 scores, the
    chunked twin above, as the JAX package; unknown backends raise."""
    rng = np.random.default_rng(4)
    r = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    q, k, v = r(1, 16, 2, 64), r(1, 16, 2, 64), r(1, 16, 2, 64)
    assert torch.equal(ops.attention(q, k, v, window=5),
                       ref.attention_ref(q, k, v, window=5))
    q, k, v = r(1, 520, 2, 64), r(1, 520, 2, 64), r(1, 520, 2, 64)
    assert torch.equal(ops.attention(q, k, v),
                       ops.flash_attention_torch(q, k, v))
    with pytest.raises(ValueError, match="attention backend"):
        ops.attention(q, k, v, policy=ops.KernelPolicy(attention="pallas"))


RMS_CASES = [(64, 7), (576, 8), (576, 512), (4608, 3)]


@pytest.mark.parametrize("gemma_style", [False, True])
@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"),
                                             ("bfloat16", "float32"),
                                             ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("d,rows", RMS_CASES)
def test_rmsnorm_plain_matches_jax(d, rows, x_dtype, w_dtype, gemma_style):
    """K9's plain path against ``rmsnorm_pallas`` in interpret mode and
    the oracles; ragged row counts take JAX's one-row blocks."""
    rng = np.random.default_rng(d + rows)
    x = (3.0 * rng.standard_normal((rows, d))).astype(np.float32)
    w = (0.5 * rng.standard_normal(d)).astype(np.float32)
    tx, tw = _to_torch(x, x_dtype), _to_torch(w, w_dtype)
    jx, jw = _to_jax(x, x_dtype), _to_jax(w, w_dtype)
    got = rms.rmsnorm(tx, tw, eps=1e-6, gemma_style=gemma_style)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want = jrms.rmsnorm_pallas(jx, jw, eps=1e-6, gemma_style=gemma_style,
                               interpret=True)
    _close(got, want, TOL[x_dtype])
    _close(ref.rmsnorm_ref(tx, tw, gemma_style=gemma_style),
           jref.rmsnorm_ref(jx, jw, gemma_style=gemma_style), TOL[x_dtype])
    assert torch.equal(ops.rmsnorm(tx, tw, gemma_style=gemma_style), got)


def test_rmsnorm_dispatch_and_leading_dims():
    """``ops.rmsnorm``: auto and ref are the oracle on CPU tensors, cuda
    the plain path of K9; leading dims flatten into rows."""
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((2, 3, 5, 64)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal(64), dtype=torch.float32)
    want = common.rmsnorm(x, w, 1e-5, gemma_style=True)
    for backend in ("auto", "ref", "cuda"):
        got = ops.rmsnorm(x, w, eps=1e-5, gemma_style=True,
                          policy=ops.KernelPolicy(rmsnorm=backend))
        assert torch.allclose(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="rmsnorm backend"):
        ops.rmsnorm(x, w, policy=ops.KernelPolicy(rmsnorm="pallas"))


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain versions: any other device launches
    the kernel (CUDA) or raises, and never counts a launch it did not
    make."""
    da.reset_launches()
    q = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        rms.rmsnorm(torch.empty((4, 64), device="meta"),
                    torch.empty((64,), device="meta"))
    assert da.LAUNCHES["flash_attention"] == da.LAUNCHES["rmsnorm"] == 0
