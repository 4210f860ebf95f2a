"""The PyTorch port's int8 KV pages and host-memory KV tier, held against
the JAX package on the CPU.

* The row quantizer: bit-equal int8 values and fp32 scales on equal fp32
  inputs, ties and all-zero rows included.
* The four sweep families (paged and ring, decode and verify) on int8
  caches: the port's ``torch`` and ``ref`` backends and the kernels' plain
  twins (``cuda`` on CPU tensors) against JAX's quantized oracle and its
  Pallas kernels in interpret mode, within 5e-6, the tolerance of
  ``tests/test_kv_tier.py``.
* One int8 paged decode step and one verify + commit at fp32 on a narrow
  smollm: logits within 1e-4 of JAX's, pools and scale leaves equal.
* The engine on ``tests/test_kv_tier.py``'s narrow smollm and trace at
  fp32: int8 streams equal JAX's int8 streams (not its bf16 ones: the two
  differ in JAX itself), roomy and tight; with the host tier, bf16 and
  int8 streams, demotions, promotions, transfer bytes and ``transfer_j``
  equal JAX's; the tier on or off moves no token.  The same for the host
  tier on deepseek's smoke config (latent pool and dense group).
* int8 on a blocked family warns once and serves unquantized pools; the
  launcher prints the ``[serve] kv tier:`` line.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro import quant as jquant
from repro.configs import get_arch as jax_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import transformer as jtfm
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServeEngine as JaxServeEngine
from repro.serving import poisson_trace as jax_poisson_trace
from repro_torch import bridge, quant
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import transformer as tfm
from repro_torch.serving import EngineConfig, ServeEngine, poisson_trace

C = 80                 # ring capacity: 5 blocks of 16
BLOCK_K = 16
PS, NB = 16, 5         # paged: 5 pages of 16
D = 16
Q = 4                  # verify block (K+1)
TOL = 5e-6             # fp32, as tests/test_kv_tier.py
HEADS = [(4, 2), (4, 1)]
# (Hq, Hkv, head dim): HEADS at D, and h2o-danube-3's head dim 120, whose
# int8 rows take 8-byte loads on the card
HEAD_CASES = [pytest.param(hq, hkv, D, id=f"{hq}-{hkv}")
              for hq, hkv in HEADS] + [pytest.param(8, 2, 120, id="8-2-D120")]
# the paged sweeps also at 3 kv heads of 120: int8 rows of 120 bytes put
# every odd kv head 8 bytes off a 16-byte boundary
PAGED_HEAD_CASES = HEAD_CASES + [pytest.param(6, 3, 120, id="6-3-D120")]
RING_POS = {"wrap": C + 15, "partial": 10}
PORT_BACKENDS = ["torch", "ref", "cuda"]   # cuda on CPU: the kernels' twins


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, atol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))
    assert err < atol, err


def _bits(x):
    return _np(x).view(np.uint32) if _np(x).dtype == np.float32 \
        else _np(x)


# --------------------------------------------------------------------------
# the row quantizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quantize_rows_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5, 2, 16))
         * 10.0 ** rng.integers(-3, 3)).astype(np.float32)
    jq, js = jquant.quantize_int8_rows(jnp.asarray(x))
    tq, ts = quant.quantize_int8_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(
        _bits(quant.dequantize_int8_rows(tq, ts)),
        _bits(jquant.dequantize_int8_rows(jq, js)))


def test_quantize_rows_zero_rows_and_half_step_ties():
    """A row of amax 127 has scale exactly 1, so x.5 values are exact
    ties: both round half to even.  An all-zero row keeps exact zeros."""
    ties = np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5,
                       -126.5, 126.5, 0.0, 4.5, -4.5, 5.5, 6.5, 7.5],
                      np.float32)
    x = np.stack([ties, np.zeros(16, np.float32), -ties * 0.25])
    jq, js = jquant.quantize_int8_rows(jnp.asarray(x))
    tq, ts = quant.quantize_int8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert _np(tq)[0, 1:4].tolist() == [0, 2, 2]
    assert not _np(tq)[1].any()
    assert float(_np(ts)[0, 0]) == 1.0


def test_quantize_per_tensor_bit_equal_to_jax():
    x = np.random.default_rng(9).standard_normal((7, 33)).astype(np.float32)
    jq, js = jquant.quantize_int8(jnp.asarray(x))
    tq, ts = quant.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    assert _bits(ts).tolist() == _bits(js).tolist()
    np.testing.assert_array_equal(_bits(quant.dequantize_int8(tq, ts)),
                                  _bits(jquant.dequantize_int8(jq, js)))


# --------------------------------------------------------------------------
# op level: the four sweep families on int8 caches
# --------------------------------------------------------------------------
def _arrays(B, Hq, Hkv, *, seed, hd=D):
    """Seeded q / candidates plus int8 ring caches and page pools with
    their per-row fp32 scales, quantized by the JAX package (the port's
    quantizer is bit-equal, above), as numpy."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = {"q1": r(B, 1, Hq, hd), "qv": r(B, Q, Hq, hd),
         "kn": r(B, Q, Hkv, hd), "vn": r(B, Q, Hkv, hd),
         "bt": rng.permutation(16)[:B * NB].reshape(B, NB).astype(np.int32)}
    for name, shape in (("k", (B, C, Hkv, hd)), ("v", (B, C, Hkv, hd)),
                        ("kp", (16, PS, Hkv, hd)),
                        ("vp", (16, PS, Hkv, hd))):
        qv, sc = jquant.quantize_int8_rows(jnp.asarray(r(*shape)))
        a[name], a[name + "s"] = np.asarray(qv), np.asarray(sc)
    return a


def _jpol(backend, n_splits):
    return jops.KernelPolicy(decode=backend, kv_splits=n_splits,
                             decode_k_chunk=BLOCK_K)


def _tpol(backend, n_splits):
    return ops.KernelPolicy(decode=backend, kv_splits=n_splits,
                            decode_k_chunk=BLOCK_K)


def _check_family(jfn, tfn, oracle, n_splits, **kw):
    """JAX's quantized oracle and pallas_interpret, then every port backend
    on the same numpy inputs, all within TOL of the oracle."""
    want = np.asarray(oracle())
    _close(jfn(_jpol("pallas_interpret", n_splits), **kw), want)
    for backend in PORT_BACKENDS:
        _close(tfn(_tpol(backend, n_splits), **kw), want)


@pytest.mark.parametrize("Hq,Hkv,hd", HEAD_CASES)
@pytest.mark.parametrize("n_splits", [1, 2])
def test_ring_decode_int8_matches_jax(Hq, Hkv, hd, n_splits):
    a = _arrays(2, Hq, Hkv, seed=Hq * 10 + Hkv + n_splits, hd=hd)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for pos_v in RING_POS.values():
        pos = jnp.int32(pos_v)
        _check_family(
            lambda pol: jops.decode_attention(
                j["q1"], j["k"], j["v"], pos, k_scale=j["ks"],
                v_scale=j["vs"], policy=pol),
            lambda pol: ops.decode_attention(
                _t(a["q1"]), _t(a["k"]), _t(a["v"]), torch.tensor(pos_v),
                k_scale=_t(a["ks"]), v_scale=_t(a["vs"]), policy=pol),
            lambda: jref.decode_attention_ref(
                j["q1"], j["k"], j["v"], jops.ring_positions(pos, C), pos,
                k_scale=j["ks"], v_scale=j["vs"]),
            n_splits)


@pytest.mark.parametrize("Hq,Hkv,hd", HEAD_CASES)
@pytest.mark.parametrize("n_splits", [1, 2])
def test_ring_verify_int8_matches_jax(Hq, Hkv, hd, n_splits):
    a = _arrays(2, Hq, Hkv, seed=Hq * 20 + Hkv + n_splits, hd=hd)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for pos_v in RING_POS.values():
        pos = jnp.int32(pos_v)
        _check_family(
            lambda pol: jops.verify_attention(
                j["qv"], j["k"], j["v"], j["kn"], j["vn"], pos,
                k_scale=j["ks"], v_scale=j["vs"], policy=pol),
            lambda pol: ops.verify_attention(
                _t(a["qv"]), _t(a["k"]), _t(a["v"]), _t(a["kn"]),
                _t(a["vn"]), torch.tensor(pos_v), k_scale=_t(a["ks"]),
                v_scale=_t(a["vs"]), policy=pol),
            lambda: jref.verify_attention_ref(
                j["qv"], j["k"], j["v"], j["kn"], j["vn"],
                jops.ring_positions(pos - 1, C), pos, k_scale=j["ks"],
                v_scale=j["vs"]),
            n_splits)


@pytest.mark.parametrize("Hq,Hkv,hd", PAGED_HEAD_CASES)
@pytest.mark.parametrize("n_splits", [1, 2])
def test_paged_decode_int8_matches_jax(Hq, Hkv, hd, n_splits):
    a = _arrays(3, Hq, Hkv, seed=Hq * 30 + Hkv + n_splits, hd=hd)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    pos = np.asarray([3, 37, 79], np.int32)            # ragged occupancy
    _check_family(
        lambda pol: jops.paged_decode_attention(
            j["q1"], j["kp"], j["vp"], j["bt"], jnp.asarray(pos),
            k_scale=j["kps"], v_scale=j["vps"], policy=pol),
        lambda pol: ops.paged_decode_attention(
            _t(a["q1"]), _t(a["kp"]), _t(a["vp"]), _t(a["bt"]), _t(pos),
            k_scale=_t(a["kps"]), v_scale=_t(a["vps"]), policy=pol),
        lambda: jref.paged_decode_attention_ref(
            j["q1"], j["kp"], j["vp"], j["bt"], jnp.asarray(pos),
            k_scale=j["kps"], v_scale=j["vps"]),
        n_splits)


@pytest.mark.parametrize("Hq,Hkv,hd", PAGED_HEAD_CASES)
@pytest.mark.parametrize("n_splits", [1, 2])
def test_paged_verify_int8_matches_jax(Hq, Hkv, hd, n_splits):
    a = _arrays(3, Hq, Hkv, seed=Hq * 40 + Hkv + n_splits, hd=hd)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    pos = np.asarray([5, 41, 76], np.int32)
    _check_family(
        lambda pol: jops.paged_verify_attention(
            j["qv"], j["kp"], j["vp"], j["kn"], j["vn"], j["bt"],
            jnp.asarray(pos), k_scale=j["kps"], v_scale=j["vps"],
            policy=pol),
        lambda pol: ops.paged_verify_attention(
            _t(a["qv"]), _t(a["kp"]), _t(a["vp"]), _t(a["kn"]), _t(a["vn"]),
            _t(a["bt"]), _t(pos), k_scale=_t(a["kps"]),
            v_scale=_t(a["vps"]), policy=pol),
        lambda: jref.paged_verify_attention_ref(
            j["qv"], j["kp"], j["vp"], j["kn"], j["vn"], j["bt"],
            jnp.asarray(pos), k_scale=j["kps"], v_scale=j["vps"]),
        n_splits)


@pytest.mark.parametrize("kw", [{"window": 24}, {"logit_cap": 30.0}],
                         ids=["window", "softcap"])
def test_int8_window_and_softcap_match_jax(kw):
    """The ring decode (as tests/test_kv_tier.py) and the paged decode
    with a window or a soft-cap, at 2 splits."""
    a = _arrays(3, 4, 2, seed=5)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    pos_v = RING_POS["wrap"]
    pos = jnp.int32(pos_v)
    _check_family(
        lambda pol, **k: jops.decode_attention(
            j["q1"], j["k"], j["v"], pos, k_scale=j["ks"], v_scale=j["vs"],
            policy=pol, **k),
        lambda pol, **k: ops.decode_attention(
            _t(a["q1"]), _t(a["k"]), _t(a["v"]), torch.tensor(pos_v),
            k_scale=_t(a["ks"]), v_scale=_t(a["vs"]), policy=pol, **k),
        lambda: jref.decode_attention_ref(
            j["q1"], j["k"], j["v"], jops.ring_positions(pos, C), pos,
            k_scale=j["ks"], v_scale=j["vs"], **kw),
        2, **kw)
    ppos = np.asarray([3, 37, 79], np.int32)
    _check_family(
        lambda pol, **k: jops.paged_decode_attention(
            j["q1"], j["kp"], j["vp"], j["bt"], jnp.asarray(ppos),
            k_scale=j["kps"], v_scale=j["vps"], policy=pol, **k),
        lambda pol, **k: ops.paged_decode_attention(
            _t(a["q1"]), _t(a["kp"]), _t(a["vp"]), _t(a["bt"]), _t(ppos),
            k_scale=_t(a["kps"]), v_scale=_t(a["vps"]), policy=pol, **k),
        lambda: jref.paged_decode_attention_ref(
            j["q1"], j["kp"], j["vp"], j["bt"], jnp.asarray(ppos),
            k_scale=j["kps"], v_scale=j["vps"], **kw),
        2, **kw)


def test_split_oracles_match_jax():
    """The stage-1 oracles of the split sweeps, quantized: partials and
    log-sum-exps equal JAX's."""
    a = _arrays(3, 4, 2, seed=11)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    pos = jnp.int32(RING_POS["wrap"])
    jp, jl = jref.decode_attention_split_ref(
        j["q1"], j["k"], j["v"], jops.ring_positions(pos, C), pos,
        n_splits=2, block_k=BLOCK_K, k_scale=j["ks"], v_scale=j["vs"])
    tp, tl = ref.decode_attention_split_ref(
        _t(a["q1"]), _t(a["k"]), _t(a["v"]),
        ops.ring_positions(torch.tensor(RING_POS["wrap"]), C),
        torch.tensor(RING_POS["wrap"]), n_splits=2, block_k=BLOCK_K,
        k_scale=_t(a["ks"]), v_scale=_t(a["vs"]))
    _close(tp, jp)
    _close(tl, jl, 1e-4)
    ppos = np.asarray([3, 37, 79], np.int32)
    jp, jl = jref.paged_decode_attention_split_ref(
        j["q1"], j["kp"], j["vp"], j["bt"], jnp.asarray(ppos), n_splits=2,
        k_scale=j["kps"], v_scale=j["vps"])
    tp, tl = ref.paged_decode_attention_split_ref(
        _t(a["q1"]), _t(a["kp"]), _t(a["vp"]), _t(a["bt"]), _t(ppos),
        n_splits=2, k_scale=_t(a["kps"]), v_scale=_t(a["vps"]))
    _close(tp, jp)
    _close(tl, jl, 1e-4)


# --------------------------------------------------------------------------
# model level: one int8 decode step, one verify + commit
# --------------------------------------------------------------------------
M_PS, M_PAGES, M_BLOCKS = 4, 24, 6


@pytest.fixture(scope="module")
def smollm_smoke():
    jcfg = dataclasses.replace(jax_arch("smollm-135m").smoke, dtype="float32")
    tcfg = dataclasses.replace(get_arch("smollm-135m").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = tfm.prepare_params(bridge.params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu"), tcfg)
    return jcfg, params, tcfg, tparams


def _int8_state(cfg, seed):
    """Random int8 pools with their scales (quantized by JAX), shuffled
    tables (page 0 the scratch page), ragged positions."""
    rng = np.random.default_rng(seed)
    shape = (tfm.n_units(cfg), M_PAGES, M_PS, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    s = {}
    for key in ("k", "v"):
        qv, sc = jquant.quantize_int8_rows(
            jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
        s[key], s[key + "_scale"] = np.asarray(qv), np.asarray(sc)
    bt = (1 + rng.permutation(M_PAGES - 1)[:3 * M_BLOCKS]).reshape(
        3, M_BLOCKS).astype(np.int32)
    bt[2] = 0
    s["bt"], s["pos"] = bt, np.asarray([5, 13, 2], np.int32)
    return s


_LEAVES = ("k", "v", "k_scale", "v_scale")


def _caches(s):
    jc = {"pos": jnp.asarray(s["pos"]), "block_tables": jnp.asarray(s["bt"]),
          "units": {"sub0": {k: jnp.asarray(s[k]) for k in _LEAVES}}}
    tc = {"pos": torch.tensor(s["pos"]), "block_tables": torch.tensor(s["bt"]),
          "units": {"sub0": {k: torch.tensor(s[k]) for k in _LEAVES}}}
    return jc, tc


def _pools_equal(tc, jc):
    """int8 pools equal; scale leaves equal but for the rows just written,
    whose k/v projections come from two frameworks' matmuls and so may
    differ in the last bits of fp32 (their scales within 1e-6, the int8
    values still equal)."""
    for key in _LEAVES:
        t, j = _np(tc["units"]["sub0"][key]), np.asarray(
            jc["units"]["sub0"][key])
        assert t.dtype == j.dtype, key
        if key.endswith("_scale"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(t, j, err_msg=key)


def test_init_int8_paged_cache_matches_jax(smollm_smoke):
    jcfg, _, tcfg, _ = smollm_smoke
    jc = jtfm.init_paged_cache(jcfg, 3, M_PAGES, M_PS, M_BLOCKS,
                               dtype="int8")
    tc = tfm.init_paged_cache(tcfg, 3, M_PAGES, M_PS, M_BLOCKS,
                              dtype="int8", device="cpu")
    for key in _LEAVES:
        assert tuple(tc["units"]["sub0"][key].shape) \
            == jc["units"]["sub0"][key].shape
        assert _np(tc["units"]["sub0"][key]).dtype \
            == np.asarray(jc["units"]["sub0"][key]).dtype


def test_int8_paged_decode_step_matches_jax(smollm_smoke):
    jcfg, params, tcfg, tparams = smollm_smoke
    jc, tc = _caches(_int8_state(tcfg, seed=2))
    active = np.asarray([1, 1, 0], np.int32)
    tok = np.asarray([[3], [77], [5]], np.int32)
    jl, jc = jtfm._paged_decode_step(params, jc, jnp.asarray(tok), jcfg,
                                     jtfm.RunCtx(), jnp.asarray(active))
    tl, tc = tfm._paged_decode_step(tparams, tc, torch.tensor(tok), tcfg,
                                    tfm.RunCtx(), torch.tensor(active))
    _close(tl, jl, 1e-4)
    _pools_equal(tc, jc)
    assert tc["pos"].tolist() == [6, 14, 2]


def test_int8_verify_and_commit_match_jax(smollm_smoke):
    """A 3-token verify sweep over int8 pools (candidates through the row
    quantizer and back), then a ragged commit that quantizes the accepted
    rows: logits within 1e-4, pools and scales equal."""
    jcfg, params, tcfg, tparams = smollm_smoke
    jc, tc = _caches(_int8_state(tcfg, seed=5))
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (3, 3)).astype(np.int32)
    jl, jp = jtfm.verify_step(params, jc, jnp.asarray(tokens), jcfg)
    tl, tp = tfm.verify_step(tparams, tc, torch.tensor(tokens), tcfg)
    _close(tl, jl, 1e-4)
    n_acc = np.asarray([2, 0, 1], np.int32)
    active = np.asarray([1, 1, 0], np.int32)
    jc = jtfm.commit_spec_paged(jc, jp, jnp.asarray(n_acc),
                                jnp.asarray(active), jcfg)
    tc = tfm.commit_spec_paged(tc, tp, torch.tensor(n_acc),
                               torch.tensor(active), tcfg)
    _pools_equal(tc, jc)
    assert tc["pos"].tolist() == [8, 14, 2]


# --------------------------------------------------------------------------
# engine level: tests/test_kv_tier.py's narrow smollm and trace, fp32
# --------------------------------------------------------------------------
N_SLOTS, PAGE, CHUNK = 4, 8, 8
SHARED, SUFFIX, GEN = 44, (4, 12), (6, 16)
MAX_LEN = SHARED + SUFFIX[1] + GEN[1]
FULL_PAGES = N_SLOTS + 2 * -(-MAX_LEN // PAGE)       # roomy: no pressure
TIGHT_PAGES = N_SLOTS + -(-MAX_LEN // PAGE) + 2      # ~1 context + slack


@functools.lru_cache(maxsize=1)
def _tier_models():
    over = dict(d_model=64, d_ff=128, head_dim=16, dtype="float32")
    jcfg = dataclasses.replace(jax_arch("smollm-135m").smoke, **over)
    tcfg = dataclasses.replace(get_arch("smollm-135m").smoke, **over)
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")
    return jcfg, params, tcfg, tparams


def _trace(vocab):
    return poisson_trace(8, rate_per_step=0.5, seed=23, vocab_size=vocab,
                         prompt_len=SUFFIX, max_new_tokens=GEN,
                         shared_prefix_len=SHARED, prompt_pools=1)


def _ecfg(**kw):
    kw.setdefault("n_pages", FULL_PAGES)
    return dict(n_slots=N_SLOTS, page_size=PAGE, max_len=MAX_LEN,
                decode_chunk=CHUNK, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(**kw):
    jcfg, params, _, _ = _tier_models()
    eng = JaxServeEngine(jcfg, JaxEngineConfig(**_ecfg(**kw)), params)
    rep = eng.run([dataclasses.replace(r) for r in jax_poisson_trace(
        8, rate_per_step=0.5, seed=23, vocab_size=jcfg.vocab_size,
        prompt_len=SUFFIX, max_new_tokens=GEN, shared_prefix_len=SHARED,
        prompt_pools=1)])
    return eng, rep


@functools.lru_cache(maxsize=None)
def _port_run(**kw):
    _, _, tcfg, tparams = _tier_models()
    eng = ServeEngine(tcfg, EngineConfig(**_ecfg(**kw)), tparams,
                      device="cpu")
    return eng, eng.run(_trace(tcfg.vocab_size))


def _streams(rep):
    return [[int(t) for t in np.asarray(r.tokens).ravel()]
            for r in rep.results]


def _same_run(kw):
    """The port's and JAX's engines on the same config: equal streams and
    equal tier counters."""
    jeng, jrep = _jax_run(**kw)
    teng, trep = _port_run(**kw)
    assert _streams(trep) == _streams(jrep)
    for field in ("n_chunks", "tokens_kept", "prefill_tokens_saved",
                  "n_preemptions", "n_demotions", "n_promotions"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.transfer_j == pytest.approx(jrep.transfer_j, rel=1e-12)
    assert teng.kv.transfer_bytes_d2h == jeng.kv.transfer_bytes_d2h
    assert teng.kv.transfer_bytes_h2d == jeng.kv.transfer_bytes_h2d
    assert teng._cache_page_bytes() == jeng._cache_page_bytes()
    return teng, trep


@pytest.mark.parametrize("pool", ["roomy", "tight"])
def test_int8_engine_streams_match_jax_int8(pool):
    n_pages = FULL_PAGES if pool == "roomy" else TIGHT_PAGES
    teng, trep = _same_run(dict(kv_dtype="int8", n_pages=n_pages))
    assert teng.kv_dtype == "int8"
    for c in teng.cache["units"].values():
        assert c["k"].dtype == torch.int8 and c["v"].dtype == torch.int8
        assert c["k_scale"].dtype == torch.float32
    if pool == "tight":
        assert trep.n_preemptions > 0
    assert all(r.n_tokens == r.max_new_tokens for r in trep.results)


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_host_tier_matches_jax(kv_dtype):
    """A tight pool with the host tier: cold prefix pages go to host
    memory and come back on hits.  bf16 pools go out as their uint16 bits
    and come back bit for bit."""
    kw = dict(kv_dtype=kv_dtype, n_pages=TIGHT_PAGES, host_tier=True,
              host_pages=16)
    teng, trep = _same_run(kw)
    assert trep.n_demotions > 0 and trep.n_promotions > 0
    assert trep.transfer_j > 0.0
    assert trep.energy_j >= trep.transfer_j
    assert trep.transfer_j == pytest.approx(
        (teng.kv.transfer_bytes_d2h + teng.kv.transfer_bytes_h2d) * 1e-9)
    assert teng.kv.verify_invariants() == []
    # layers x rows x kv heads x (row bytes + the int8 row's scale), k + v
    cfg = teng.cfg
    row = {"bfloat16": 16 * 2, "int8": 16 + 4}[kv_dtype]
    assert teng._cache_page_bytes() \
        == cfg.n_layers * PAGE * cfg.padded_kv_heads * row * 2


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_host_tier_on_and_off_give_equal_streams(kv_dtype):
    _, on = _port_run(kv_dtype=kv_dtype, n_pages=TIGHT_PAGES, host_tier=True,
                      host_pages=16)
    _, off = _port_run(kv_dtype=kv_dtype, n_pages=TIGHT_PAGES)
    assert _streams(on) == _streams(off)
    assert off.n_demotions == 0 and off.transfer_j == 0.0


def test_default_engine_has_no_tier_state():
    teng, trep = _port_run()
    for c in teng.cache["units"].values():
        assert "k_scale" not in c
    assert not teng.kv.host_tier and teng.kv._fetch_page is None
    assert trep.transfer_j == 0.0 and trep.n_demotions == 0


# --------------------------------------------------------------------------
# the host tier on deepseek's smoke config: latent pool and dense group
# --------------------------------------------------------------------------
def test_host_tier_on_deepseek_matches_jax():
    jcfg = dataclasses.replace(jax_arch("deepseek-v2-236b").smoke,
                               dtype="float32")
    tcfg = dataclasses.replace(get_arch("deepseek-v2-236b").smoke,
                               dtype="float32")
    params, _ = jtfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       tcfg, "cpu")
    kw = _ecfg(n_pages=TIGHT_PAGES, host_tier=True, host_pages=16,
               cache_dtype="bfloat16")
    jeng = JaxServeEngine(jcfg, JaxEngineConfig(**kw), params)
    jrep = jeng.run([dataclasses.replace(r) for r in jax_poisson_trace(
        8, rate_per_step=0.5, seed=23, vocab_size=jcfg.vocab_size,
        prompt_len=SUFFIX, max_new_tokens=GEN, shared_prefix_len=SHARED,
        prompt_pools=1)])
    teng = ServeEngine(tcfg, EngineConfig(**kw), tparams, device="cpu")
    trep = teng.run(_trace(tcfg.vocab_size))
    assert _streams(trep) == _streams(jrep)
    assert teng._cache_page_bytes() == jeng._cache_page_bytes()
    assert "lat" in teng.cache["dense"]
    assert teng.cache["units"]["sub0"]["lat"].dtype == torch.bfloat16
    for field in ("n_demotions", "n_promotions", "n_preemptions",
                  "prefill_tokens_saved"):
        assert getattr(trep, field) == getattr(jrep, field), field
    assert trep.n_demotions > 0 and trep.n_promotions > 0
    assert trep.transfer_j == pytest.approx(jrep.transfer_j, rel=1e-12)
    assert teng.kv.verify_invariants() == []


# --------------------------------------------------------------------------
# blocked families, blockers, the launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,feature", [("gemma2-27b", "local_global"),
                                          ("mamba2-370m", "uses_ssm")])
def test_int8_on_a_blocked_family_warns_once(arch, feature):
    """As JAX: one RuntimeWarning naming the feature, and the cache dtype's
    pools (no scale leaves)."""
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    tparams = bridge.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    ops._KV_DTYPE_FALLBACK_WARNED.discard(cfg.name)
    ecfg = EngineConfig(n_slots=2, page_size=8, max_len=32, kv_dtype="int8",
                        cache_dtype="float32")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = ServeEngine(cfg, ecfg, tparams, device="cpu")
        ServeEngine(cfg, ecfg, tparams, device="cpu")
    hits = [w for w in rec if "kv_dtype=int8" in str(w.message)]
    assert len(hits) == 1 and issubclass(hits[0].category, RuntimeWarning)
    assert feature in str(hits[0].message)
    assert eng.kv_dtype == "float32"
    for c in eng.cache["units"].values():
        assert "k_scale" not in c
    with pytest.raises(ValueError, match=feature):
        tfm.init_paged_cache(cfg, 2, 8, 8, 4, dtype="int8")


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b",
                                  "mamba2-370m", "deepseek-v2-236b"])
def test_int8_blockers_equal_jax(arch):
    assert tfm.int8_paged_blockers(get_arch(arch).config) \
        == jtfm.int8_paged_blockers(jax_arch(arch).config)


def test_serve_int8_host_tier_prints_the_tier_line(capsys):
    rep = serve.run(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                     "--traffic", "poisson", "--kv-dtype", "int8",
                     "--host-tier", "--shared-prefix-len", "16",
                     "--prompt-pools", "2", "--page-size", "8",
                     "--requests", "6", "--n-pages", "14"])
    out = capsys.readouterr().out
    assert all(r.n_tokens == r.max_new_tokens for r in rep.results)
    assert rep.n_demotions > 0 and rep.n_promotions > 0
    assert rep.transfer_j > 0.0
    line = next(x for x in out.splitlines()
                if x.startswith("[serve] kv tier:"))
    assert line.startswith("[serve] kv tier: int8 pages, "
                           f"{rep.n_demotions} paged out / "
                           f"{rep.n_promotions} paged in, transfer ")
