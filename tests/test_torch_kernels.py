"""The PyTorch port's paged-attention kernels, held against the JAX package
on the CPU.

On the CPU each kernel wrapper of ``repro_torch.kernels.decode_attention``
runs its plain PyTorch version: the K-sweep (``paged_attention_sweep``,
stage 1 of paged GQA decode and verify, with the in-flight candidate fold)
and the K-merge (``lse_merge``).  The same numpy inputs go through the JAX
oracles (``repro.kernels.ref``), the JAX ``jnp`` backends and the Pallas
kernels in interpret mode, as ``tests/test_split_kv.py`` runs them, and all
must agree at the fp32 tolerance that file uses.  The port's own oracles
and ``ops`` dispatch are checked the same way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import decode_attention as jda
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref

PS, NB = 16, 5         # 5 pages of 16 per request
P = 24                 # pool pages (shuffled; some never mapped)
D = 16
Q = 4                  # verify / suffix-prefill rows
SPLITS = [1, 2, 5]     # 2 does not divide 5 pages; 5 = one page per split
TOL = 5e-6             # fp32, as tests/test_split_kv.py
HEADS = [(4, 2), (4, 1), (9, 3)]   # GQA, MQA, smollm's G = 3
# (Hq, Hkv, head dim): HEADS at D, and h2o-danube-3's head dim 120 (G 4)
HEAD_CASES = [pytest.param(hq, hkv, D, id=f"{hq}-{hkv}")
              for hq, hkv in HEADS] + [pytest.param(8, 2, 120, id="8-2-D120")]
# the bf16 checks: smollm's heads at D, and h2o-danube-3's at 120
BF16_HEADS = [HEAD_CASES[2], HEAD_CASES[3]]
DECODE_POS = [3, 37, 79]           # ragged: 1 page, 3 pages, all 5
VERIFY_POS = [0, 41, 76]           # pos 0: only the candidates are visible
# The kernel's edges, as more cases of the decode and verify tests: (Hq,
# Hkv, head dim, query rows, page size, positions).  G 7 (llava) and G 1
# (stablelm); row tiles of 32 (Q 17 at G 4 is 68 rows, Q 128 512); pages
# of 8 (two a key tile); positions at page edges; every split but the
# first wholly past each request.
EDGE_CASES = [
    pytest.param(7, 1, D, Q, PS, None, id="G7"),
    pytest.param(2, 2, D, Q, PS, None, id="G1"),
    pytest.param(4, 2, D, Q, 8, None, id="page8"),
    pytest.param(4, 2, D, Q, PS, ([15, 16, 17], [16, 17, 15]),
                 id="page-edges"),
    pytest.param(4, 2, D, Q, PS, ([0, 5, 15], [0, 5, 16]),
                 id="past-the-request")]
ROW_TILE_CASES = [pytest.param(4, 1, D, 17, PS, None, id="G4-Q17"),
                  pytest.param(4, 1, D, 128, PS, None, id="G4-Q128")]
# the existing cases at Q 4, pages of 16 and the default positions
BASE_CASES = [pytest.param(*c.values, Q, PS, None, id=c.id)
              for c in HEAD_CASES]


def _inputs(Hq, Hkv, *, seed, hd=D, q=Q, ps=PS):
    """Seeded numpy inputs: shuffled page tables (80 positions a request
    in pages of ``ps``), and columns past each request's length pointing
    at page 0 (the engine's scratch page)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    B = 3
    nb = NB * PS // ps
    n_pages = (P - 1) * PS // ps + 1
    bt = (1 + rng.permutation(n_pages - 1)[:B * nb]).reshape(
        B, nb).astype(np.int32)
    return {"q1": r(B, 1, Hq, hd), "qv": r(B, q, Hq, hd),
            "kp": r(n_pages, ps, Hkv, hd), "vp": r(n_pages, ps, Hkv, hd),
            "kn": r(B, q, Hkv, hd), "vn": r(B, q, Hkv, hd), "bt": bt}


def _park_tail(bt, pos, *, verify, ps=PS):
    """Columns wholly past each request's last key -> scratch page 0."""
    bt = bt.copy()
    for b, p in enumerate(pos):
        last = (p - 1 if verify else p) // ps
        bt[b, last + 1:] = 0
    return bt


_JITTED = {}


def _jx(fn, *args, **kw):
    """Call a JAX function jitted (one compile per signature, where eager
    mode compiles each primitive) with ``kw`` static."""
    key = (fn, tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, **kw))
    return _JITTED[key](*args)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(a)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    err = float(np.max(np.abs(a - b)))
    assert err < tol, err


def _port_decode(a, pos, bt, n_splits, **kw):
    return da.paged_attention(_t(a["q1"]), _t(a["kp"]), _t(a["vp"]), _t(bt),
                              _t(pos), n_splits=n_splits, **kw)


def _port_verify(a, pos, bt, n_splits, **kw):
    return da.paged_attention(_t(a["qv"]), _t(a["kp"]), _t(a["vp"]), _t(bt),
                              _t(pos), k_new=_t(a["kn"]), v_new=_t(a["vn"]),
                              n_splits=n_splits, **kw)


# --------------------------------------------------------------------------
# K-sweep + K-merge, end to end
# --------------------------------------------------------------------------
@pytest.mark.parametrize("Hq,Hkv,hd,q,ps,edge_pos", BASE_CASES + EDGE_CASES)
@pytest.mark.parametrize("n_splits", SPLITS)
def test_paged_decode_matches_jax(Hq, Hkv, hd, q, ps, edge_pos, n_splits):
    a = _inputs(Hq, Hkv, seed=Hq * 30 + Hkv + n_splits, hd=hd, ps=ps)
    pos = np.asarray(edge_pos[0] if edge_pos else DECODE_POS, np.int32)
    bt = _park_tail(a["bt"], pos, verify=False, ps=ps)
    got = _port_decode(a, pos, bt, n_splits)
    assert got.shape == (3, 1, Hq, hd) and got.dtype == torch.float32
    args = (_j(a["q1"]), _j(a["kp"]), _j(a["vp"]), _j(bt), _j(pos))
    _close(got, _jx(jref.paged_decode_attention_ref, *args))
    _close(got, _jx(jops.paged_decode_attention_jnp, *args,
                    n_splits=n_splits))
    if Hq == 9 or hd == 120:             # interpret mode is slow: one G
        _close(got, _jx(jda.paged_decode_attention_pallas, *args,
                        n_splits=n_splits, interpret=True))
    targs = tuple(_t(x) for x in (a["q1"], a["kp"], a["vp"], bt, pos))
    _close(got, ref.paged_decode_attention_ref(*targs))
    _close(got, ops.paged_decode_attention_torch(*targs, n_splits=n_splits))


@pytest.mark.parametrize("Hq,Hkv,hd,q,ps,edge_pos",
                         BASE_CASES + EDGE_CASES + ROW_TILE_CASES)
@pytest.mark.parametrize("n_splits", SPLITS)
def test_paged_verify_matches_jax(Hq, Hkv, hd, q, ps, edge_pos, n_splits):
    a = _inputs(Hq, Hkv, seed=Hq * 40 + Hkv + n_splits, hd=hd, q=q, ps=ps)
    pos = np.asarray(edge_pos[1] if edge_pos else VERIFY_POS, np.int32)
    bt = _park_tail(a["bt"], pos, verify=True, ps=ps)
    got = _port_verify(a, pos, bt, n_splits)
    assert got.shape == (3, q, Hq, hd) and got.dtype == torch.float32
    args = (_j(a["qv"]), _j(a["kp"]), _j(a["vp"]), _j(a["kn"]), _j(a["vn"]),
            _j(bt), _j(pos))
    _close(got, _jx(jref.paged_verify_attention_ref, *args))
    _close(got, _jx(jops.paged_verify_attention_jnp, *args,
                    n_splits=n_splits))
    if Hq == 9 or hd == 120:
        _close(got, _jx(jda.paged_verify_attention_pallas, *args,
                        n_splits=n_splits, interpret=True))
    targs = tuple(_t(x) for x in (a["qv"], a["kp"], a["vp"], a["kn"],
                                  a["vn"], bt, pos))
    _close(got, ref.paged_verify_attention_ref(*targs))
    _close(got, ops.paged_verify_attention_torch(*targs, n_splits=n_splits))


# --------------------------------------------------------------------------
# K-sweep stage 1: partials and log-sum-exps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_splits", [2, 5])
def test_decode_partials_match_pallas(n_splits):
    """Stage-1 contract, empty splits included (request 0 holds one page:
    its other splits have no valid key -> zero partial, NEG_INF lse)."""
    a = _inputs(9, 3, seed=7)
    pos = np.asarray(DECODE_POS, np.int32)
    bt = _park_tail(a["bt"], pos, verify=False)
    pp, lp = da.paged_attention_sweep(_t(a["q1"]), _t(a["kp"]), _t(a["vp"]),
                                      _t(bt), _t(pos), n_splits=n_splits)
    args = (_j(a["q1"]), _j(a["kp"]), _j(a["vp"]), _j(bt), _j(pos))
    jp, jl = _jx(jda.paged_decode_attention_pallas_partials, *args,
                 n_splits=n_splits, interpret=True)
    _close(pp, jp)
    _close(lp, jl, 1e-5)
    rp, rl = _jx(jref.paged_decode_attention_split_ref, *args,
                 n_splits=n_splits)
    _close(pp, rp)
    _close(lp, rl, 1e-5)
    tp, tl = ref.paged_decode_attention_split_ref(
        *(_t(x) for x in (a["q1"], a["kp"], a["vp"], bt, pos)),
        n_splits=n_splits)
    _close(tp, rp)
    _close(tl, rl, 1e-5)
    assert float(lp[0, :, 1:].max()) == np.float32(ref.NEG_INF)


@pytest.mark.parametrize("n_splits", [2, 5])
def test_verify_partials_match_pallas(n_splits):
    """Candidates fold into the last split only."""
    a = _inputs(9, 3, seed=8)
    pos = np.asarray(VERIFY_POS, np.int32)
    bt = _park_tail(a["bt"], pos, verify=True)
    pp, lp = da.paged_attention_sweep(
        _t(a["qv"]), _t(a["kp"]), _t(a["vp"]), _t(bt), _t(pos),
        k_new=_t(a["kn"]), v_new=_t(a["vn"]), n_splits=n_splits)
    jp, jl = _jx(jda.paged_verify_attention_pallas_partials,
                 _j(a["qv"]), _j(a["kp"]), _j(a["vp"]), _j(a["kn"]),
                 _j(a["vn"]), _j(bt), _j(pos), n_splits=n_splits,
                 interpret=True)
    _close(pp, jp)
    _close(lp, jl, 1e-5)
    # pos 0: every split but the last (the candidates' one) is empty
    assert float(lp[0, :, :-1].max()) == np.float32(ref.NEG_INF)
    assert float(lp[0, :, -1].min()) > ref.NEG_INF


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("kw", [{"window": 24}, {"logit_cap": 2.0},
                                {"window": 20, "logit_cap": 2.0},
                                # shorter than the verify block: each row
                                # its own key range
                                {"window": 3}])
def test_window_and_softcap_match_jax(verify, kw):
    a = _inputs(9, 3, seed=11 + verify)
    if verify:
        pos = np.asarray(VERIFY_POS, np.int32)
        bt = _park_tail(a["bt"], pos, verify=True)
        got = _port_verify(a, pos, bt, 2, **kw)
        want = _jx(jref.paged_verify_attention_ref, _j(a["qv"]),
                   _j(a["kp"]), _j(a["vp"]), _j(a["kn"]), _j(a["vn"]),
                   _j(bt), _j(pos), **kw)
    else:
        pos = np.asarray(DECODE_POS, np.int32)
        bt = _park_tail(a["bt"], pos, verify=False)
        got = _port_decode(a, pos, bt, 2, **kw)
        want = _jx(jref.paged_decode_attention_ref, _j(a["q1"]),
                   _j(a["kp"]), _j(a["vp"]), _j(bt), _j(pos), **kw)
    _close(got, want)


@pytest.mark.parametrize("Hq,Hkv,hd", BF16_HEADS)
@pytest.mark.parametrize("verify", [False, True])
def test_sweep_single_split_keeps_query_dtype(Hq, Hkv, hd, verify):
    """One split writes the normalised output in q's dtype (no merge),
    within one bf16 rounding (2e-2) of JAX's reference at bf16."""
    a = _inputs(Hq, Hkv, seed=12 + verify, hd=hd)
    pos = np.asarray(VERIFY_POS if verify else DECODE_POS, np.int32)
    bt = _park_tail(a["bt"], pos, verify=verify)
    names = ("qv", "kp", "vp", "kn", "vn") if verify else ("q1", "kp", "vp")
    bf = [_t(a[n]).to(torch.bfloat16) for n in names]
    jbf = [_j(a[n]).astype(jnp.bfloat16) for n in names]
    if verify:
        out = da.paged_attention_sweep(*bf[:3], _t(bt), _t(pos), k_new=bf[3],
                                       v_new=bf[4], n_splits=1)
        want = _jx(jref.paged_verify_attention_ref, *jbf, _j(bt), _j(pos))
    else:
        out = da.paged_attention_sweep(*bf, _t(bt), _t(pos), n_splits=1)
        want = _jx(jref.paged_decode_attention_ref, *jbf, _j(bt), _j(pos))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(want, np.float32), 2e-2)


# --------------------------------------------------------------------------
# K-merge
# --------------------------------------------------------------------------
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_merge_matches_jax(out_dtype):
    rng = np.random.default_rng(23)
    partial = rng.standard_normal((2, 4, 3, Q, D)).astype(np.float32)
    lse = rng.standard_normal((2, 4, 3, Q)).astype(np.float32)
    lse[:, :, 2] = ref.NEG_INF           # one empty split per row
    partial[:, :, 2] = 0.0
    got = da.lse_merge(_t(partial), _t(lse), out_dtype)
    assert got.shape == (2, 4, Q, D) and got.dtype == out_dtype
    want = _jx(jref.merge_kv_splits_ref, _j(partial), _j(lse))
    tol = TOL if out_dtype == torch.float32 else 2e-2
    _close(got.float(), want, tol)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    pallas = _jx(jda.merge_kv_splits_pallas, _j(partial), _j(lse),
                 out_dtype=jdt, interpret=True)
    _close(got.float(), np.asarray(pallas, np.float32), tol)
    _close(ref.merge_kv_splits_ref(_t(partial), _t(lse)), want)


# --------------------------------------------------------------------------
# dispatch, split heuristic, prefill attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv_splits", ["auto", 1, 3])
def test_ops_dispatch_backends_agree(kv_splits):
    """Every CPU backend of both paged entry points gives the JAX ``auto``
    answer for the same ``kv_splits``."""
    a = _inputs(9, 3, seed=13)
    dpos = np.asarray(DECODE_POS, np.int32)
    vpos = np.asarray(VERIFY_POS, np.int32)
    jpol = jops.KernelPolicy(kv_splits=kv_splits)
    jd = _jx(jops.paged_decode_attention, _j(a["q1"]), _j(a["kp"]),
             _j(a["vp"]), _j(a["bt"]), _j(dpos), policy=jpol)
    jv = _jx(jops.paged_verify_attention, _j(a["qv"]), _j(a["kp"]),
             _j(a["vp"]), _j(a["kn"]), _j(a["vn"]), _j(a["bt"]), _j(vpos),
             policy=jpol)
    for backend in ("auto", "ref", "torch", "cuda"):
        pol = ops.KernelPolicy(decode=backend, kv_splits=kv_splits)
        _close(ops.paged_decode_attention(
            _t(a["q1"]), _t(a["kp"]), _t(a["vp"]), _t(a["bt"]), _t(dpos),
            policy=pol), jd)
        _close(ops.paged_verify_attention(
            _t(a["qv"]), _t(a["kp"]), _t(a["vp"]), _t(a["kn"]), _t(a["vn"]),
            _t(a["bt"]), _t(vpos), policy=pol), jv)


def test_int8_pools_raise_by_name():
    """int8 pools are served now: the K-sweep's twin (through
    ``paged_attention``, 1 and 5 splits) and the port's ``ref`` / ``torch``
    dispatch on int8 pools with per-row scales match the JAX ``jnp``
    backend's int8 form; a pool whose scales come alone raises by name."""
    a = _inputs(4, 2, seed=1)
    rng = np.random.default_rng(2)
    kq = rng.integers(-127, 128, a["kp"].shape).astype(np.int8)
    vq = rng.integers(-127, 128, a["vp"].shape).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (P, PS, 2, 1)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (P, PS, 2, 1)).astype(np.float32)
    q8 = dict(a, kp=kq, vp=vq)
    for verify, pos in ((False, DECODE_POS), (True, VERIFY_POS)):
        pos = np.asarray(pos, np.int32)
        bt = _park_tail(a["bt"], pos, verify=verify)
        if verify:
            want = jops.paged_verify_attention_jnp(
                _j(a["qv"]), _j(kq), _j(vq), _j(a["kn"]), _j(a["vn"]),
                _j(bt), _j(pos), k_scale=_j(ks), v_scale=_j(vs))
        else:
            want = jops.paged_decode_attention_jnp(
                _j(a["q1"]), _j(kq), _j(vq), _j(bt), _j(pos),
                k_scale=_j(ks), v_scale=_j(vs))
        run = _port_verify if verify else _port_decode
        for n_splits in (1, 5):
            _close(run(q8, pos, bt, n_splits, k_scale=_t(ks),
                       v_scale=_t(vs)), want)
        entry = ops.paged_verify_attention if verify \
            else ops.paged_decode_attention
        args = ((a["qv"], kq, vq, a["kn"], a["vn"], bt, pos) if verify
                else (a["q1"], kq, vq, bt, pos))
        for backend in ("ref", "torch"):
            _close(entry(*map(_t, args), k_scale=_t(ks), v_scale=_t(vs),
                         policy=ops.KernelPolicy(decode=backend)), want)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        da.paged_attention_sweep(_t(a["q1"]), _t(kq), _t(vq), _t(a["bt"]),
                                 _t(DECODE_POS), k_scale=_t(ks))


@pytest.mark.parametrize("batch,kv_len,heads,cores,block", [
    (8, 32768, 4, 4, 256), (1, 256, 4, 64, 256), (1, 32768, 4, 8, 256),
    (1, 512, 1, 64, 256), (1, 10 ** 6, 1, 512, 256), (4, 80, 9, 132, 16),
    (4, 4096, 9, 132, 16), (16, 4096, 9, 132, 16), (2, 48, 4, 8, 4)])
def test_choose_kv_splits_matches_jax(batch, kv_len, heads, cores, block):
    assert ops.choose_kv_splits(batch, kv_len, heads, cores, block=block) \
        == jops.choose_kv_splits(batch, kv_len, heads, cores, block=block)


def test_kv_split_executors_on_cpu_match_jax():
    """Without a card the executors are the host's threads, as in JAX, so
    the CPU tests pick the JAX package's split counts."""
    for args in ((2, 48, 4), (4, 80, 9), (1, 4096, 9)):
        assert ops.choose_kv_splits(*args, block=16) \
            == jops.choose_kv_splits(*args, block=16)
    assert ops.effective_kv_len(32768, 512) == jops.effective_kv_len(32768,
                                                                     512)
    assert ops.effective_kv_len(100, 0) == 100


@pytest.mark.parametrize("backend", ["ref", "chunked"])
@pytest.mark.parametrize("kw", [{}, {"window": 5}, {"logit_cap": 3.0}])
def test_prefill_attention_matches_jax(backend, kw):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((2, 16, 6, D)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, D)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, D)).astype(np.float32)
    got = ops.attention(_t(q), _t(k), _t(v), policy=ops.KernelPolicy(
        attention=backend, q_chunk=4, k_chunk=4), **kw)
    want = _jx(jops.attention, _j(q), _j(k), _j(v), policy=jops.KernelPolicy(
        attention=backend, q_chunk=4, k_chunk=4), **kw)
    _close(got, want)
    _close(got, _jx(jref.attention_ref, _j(q), _j(k), _j(v), **kw))


def _zoo_norm_widths():
    """Every width K9 normalizes in the registry's configs at their
    published sizes: d_model, and MLA's latent widths."""
    from repro_torch.configs import ARCH_SPECS
    out = set()
    for spec in ARCH_SPECS.values():
        cfg = spec.config
        out.add(cfg.d_model)
        if cfg.use_mla:
            out.update(w for w in (cfg.kv_lora_rank, cfg.q_lora_rank) if w)
    return sorted(out)


ZOO_NORM_WIDTHS = _zoo_norm_widths()


@pytest.mark.parametrize("rows", [4, 4096])
@pytest.mark.parametrize("d", sorted({8, 8192, *ZOO_NORM_WIDTHS}))
def test_rmsnorm_launch_shape_is_whole_at_zoo_widths(d, rows):
    """K9's launch shape at every zoo width (and phase 2's 8 and 8192),
    for a decode step's rows and a prefill's: each thread of a row holds a
    whole, equal count of 16-byte vectors (8 values), no row has more
    threads than vectors, a row is a power of two up to 32 threads or a
    multiple of 32, and a block is whole warps of at most ``BLOCK``
    threads."""
    from repro_torch.kernels import rmsnorm as rms
    tpr, nvec, rpb = rms.launch_shape(d, rows)
    assert tpr * nvec == d // 8
    assert 1 <= tpr <= d // 8 and 1 <= nvec <= rms.VMAX
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    assert tpr * rpb <= rms.BLOCK and (tpr * rpb) % 32 == 0


@pytest.mark.parametrize("d", [512, 1024, 1536, 2048])
def test_rmsnorm_launch_shape_takes_fewer_vectors_for_few_rows(d):
    """A decode step's rows take the fewest vectors a thread (a call is one
    row's chain of latencies), a prefill's at least two where the width
    allows; both whole."""
    from repro_torch.kernels import rmsnorm as rms
    few, many = rms.launch_shape(d, 8), rms.launch_shape(d, 2048)
    assert few[1] == 1 and many[1] == 2
    assert few[0] * few[1] == many[0] * many[1] == d // 8


def test_zoo_norm_widths_are_the_zoos():
    assert ZOO_NORM_WIDTHS == [512, 576, 1024, 1536, 2048, 3840, 4096, 4608,
                               5120, 7168]


@pytest.mark.parametrize("rows", [4, 4096])
@pytest.mark.parametrize("d", [24, 136, 296, 1000, 5000, 8192, 8200, 16384])
def test_rmsnorm_launch_shape_covers_other_widths(d, rows):
    """Widths with no whole, equal split give the last threads of a row
    fewer vectors (none for the last lanes of its last warp) but cover the
    row; past ``MAX_WIDTH`` the two-pass kernel takes it."""
    from repro_torch.kernels import rmsnorm as rms
    tpr, nvec, rpb = rms.launch_shape(d, rows)
    if d > rms.MAX_WIDTH:
        assert (tpr, nvec, rpb) == (0, 0, 1)
        return
    assert tpr * nvec >= d // 8
    assert tpr <= 32 or (tpr - 32) * nvec < d // 8
    assert 1 <= nvec <= rms.VMAX
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    assert tpr * rpb <= rms.BLOCK and (tpr * rpb) % 32 == 0
