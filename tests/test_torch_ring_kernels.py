"""The PyTorch port's ring-cache attention sweep, held against the JAX
package on the CPU.

On the CPU the ring sweep's wrapper (``ring_attention_sweep``, stage 1 of
GQA decode and speculative verify over a ring-buffer cache, with the
in-flight candidate fold) runs its plain PyTorch twin, and ``lse_merge``
its plain version.  The same numpy inputs go through the JAX oracles
(``repro.kernels.ref``), the JAX ``jnp`` backends and the Pallas ring
kernels in interpret mode, as ``tests/test_split_kv.py`` runs them, and
all must agree at the fp32 tolerance that file uses.  The port's own
oracles, ``ops`` dispatch and ``ring_positions`` are checked the same way.

Beside the default ring (40 slots in blocks of 8), the decode, verify and
partials tests take the edges of the kernel's tiling (tiles of 16 slots,
one block per kv head): blocks of 17 that straddle tiles, blocks of one
slot (a prime ring), a split past the blocks, G 7 with Q 4, G 1, wrapped
verify rows that differ inside one running block, per-row positions under
a window, and a cap.
"""
import functools
import warnings

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

C, BK = 40, 8          # ring of 40 slots in 5 blocks of 8
D = 16
Q = 4                  # verify rows (K = 3)
B = 3
SPLITS = [1, 2, 5]     # 2 does not divide 5 blocks; 5 = one block per split
TOL = 5e-6             # fp32, as tests/test_split_kv.py
HEADS = [(4, 2), (4, 1), (9, 3)]   # GQA, MQA, smollm's G = 3
# (Hq, Hkv, head dim): HEADS at D, and h2o-danube-3's head dim 120 (G 4)
HEAD_CASES = [pytest.param(hq, hkv, D, id=f"{hq}-{hkv}")
              for hq, hkv in HEADS] + [pytest.param(8, 2, 120, id="8-2-D120")]
# the bf16 checks: smollm's heads at D, and h2o-danube-3's at 120
BF16_HEADS = [HEAD_CASES[2], HEAD_CASES[3]]
DECODE_POS = [13, 131]             # ring not yet full; wrapped 3 times
VERIFY_POS = [0, 13, 131]          # pos 0: only the candidates are visible
HEAD_IDS = [(*c.values, c.id) for c in HEAD_CASES]
# edge geometries: a ring of 51 under a requested block of 20 (3 blocks of
# 17, straddling 16-slot tiles), a prime ring of 37 (blocks of 1); cap and
# window on the 51-slot ring
C51 = {"C": 51, "bk": 20}
PRIME = {"C": 37, "bk": 8}


def _edges(pos_by_edge, splits_by_edge):
    """The edge cases of the decode or verify test: (n_splits, Hq, Hkv,
    hd, pos, geometry) with ids ``<n>-<Hq>-<Hkv>-<edge>-<pos>``."""
    out = []
    for edge, (hq, hkv, geom) in {
            "C51-bk17": (9, 3, C51), "prime37": (9, 3, PRIME),
            "cap": (9, 3, dict(C51, cap=2.0)),
            "window": (9, 3, dict(C51, window=12)),
            "past-the-blocks": (9, 3, {}), "G7": (14, 2, {}),
            "G1": (3, 3, {}), "rows-differ": (9, 3, {}),
            "ragged-window": (9, 3, {"window": 12})}.items():
        for n in splits_by_edge.get(edge, ()):
            for pos in pos_by_edge[edge]:
                pid = "-".join(map(str, np.ravel(pos)))
                out.append(pytest.param(n, hq, hkv, D, pos, geom,
                                        id=f"{n}-{hq}-{hkv}-{edge}-{pid}"))
    return out


DECODE_CASES = [pytest.param(n, hq, hkv, hd, pos, {}, id=f"{n}-{hid}-{pos}")
                for n in SPLITS for hq, hkv, hd, hid in HEAD_IDS
                for pos in DECODE_POS] + _edges(
    {"C51-bk17": (30, 170), "prime37": (100,), "cap": (170,),
     "past-the-blocks": (131,), "G7": (131,), "G1": (131,),
     "ragged-window": ([5, 70, 131],)},
    {"C51-bk17": (1, 3), "prime37": (1, 5), "cap": (1, 3),
     "past-the-blocks": (4,), "G7": (1, 2), "G1": (1, 2),
     "ragged-window": (1, 2)})
VERIFY_CASES = [pytest.param(n, hq, hkv, hd, pos, {}, id=f"{n}-{hid}-{pos}")
                for n in SPLITS for hq, hkv, hd, hid in HEAD_IDS
                for pos in VERIFY_POS] + _edges(
    {"C51-bk17": (30, 170), "prime37": (100,), "cap": (170,),
     "window": (170,), "past-the-blocks": (131,), "G7": (131,),
     "G1": (131,), "rows-differ": (121, 127)},
    {"C51-bk17": (1, 3), "prime37": (1, 5), "cap": (1, 3), "window": (2,),
     "past-the-blocks": (4,), "G7": (1, 2), "G1": (1, 2),
     "rows-differ": (1, 5)})


def _inputs(Hq, Hkv, *, seed, cache_len=C, hd=D):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"q1": r(B, 1, Hq, hd), "qv": r(B, Q, Hq, hd),
            "k": r(B, cache_len, Hkv, hd), "v": r(B, cache_len, Hkv, hd),
            "kn": r(B, Q, Hkv, hd), "vn": r(B, Q, Hkv, hd)}


_JITTED = {}


def _jx(fn, *args, **kw):
    """Call a JAX function jitted (one compile per signature) with ``kw``
    static."""
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
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < tol, err


def _policy(n_splits, bk=BK, **kw):
    return ops.KernelPolicy(decode="cuda", kv_splits=n_splits,
                            decode_k_chunk=bk, **kw)


def _pos(p):
    return np.asarray(p, np.int32)


def _geom(g):
    """A case's ring length, requested block and the window / cap keyword
    arguments of every entry point."""
    kw = {k: v for k, v in (("window", g.get("window", 0)),
                            ("logit_cap", g.get("cap", 0.0))) if v}
    return g.get("C", C), g.get("bk", BK), kw


def _by_row(call, p, *arrs):
    """``call(*arrs, pos)`` where ``pos`` is one position; row by row,
    stacked, where ``p`` holds one per batch row (the oracles take one)."""
    if np.ndim(p) == 0:
        return jax.tree.map(_np, call(*arrs, p))
    rows = [jax.tree.map(_np, call(*(a[b:b + 1] for a in arrs), p[b]))
            for b in range(len(p))]
    return jax.tree.map(lambda *x: np.concatenate(x, axis=0), *rows)


# --------------------------------------------------------------------------
# ring sweep + K-merge, end to end
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_splits,Hq,Hkv,hd,pos,geom", DECODE_CASES)
def test_ring_decode_matches_jax(Hq, Hkv, hd, n_splits, pos, geom):
    cl, bk, kw = _geom(geom)
    a = _inputs(Hq, Hkv, seed=Hq * 30 + Hkv + n_splits + int(np.sum(pos)),
                hd=hd, cache_len=cl)
    p = _pos(pos)
    x = (a["q1"], a["k"], a["v"])
    got = ops.decode_attention(*map(_t, x), _t(p),
                               policy=_policy(n_splits, bk), **kw)
    assert got.shape == (B, 1, Hq, hd) and got.dtype == torch.float32
    kp = jops.ring_positions(_j(p), cl)
    _close(got, _jx(jops.decode_attention_jnp, *map(_j, x), kp, _j(p),
                    n_splits=n_splits, **kw))
    _close(got, _by_row(lambda q, k, v, pp: _jx(
        jref.decode_attention_ref, _j(q), _j(k), _j(v),
        jops.ring_positions(_j(pp), cl), _j(pp), **kw), p, *x))
    if Hq != 4:                 # interpret mode is slow: not the G 2 / G 4
        _close(got, _jx(jda.decode_attention_pallas, *map(_j, x), _j(p),
                        block_k=bk, n_splits=n_splits, interpret=True, **kw))
    _close(got, _by_row(lambda q, k, v, pp: ref.decode_attention_ref(
        _t(q), _t(k), _t(v), ops.ring_positions(_t(pp), cl), _t(pp), **kw),
        p, *x))
    _close(got, _by_row(lambda q, k, v, pp: ops.decode_attention_torch(
        _t(q), _t(k), _t(v), ops.ring_positions(_t(pp), cl), _t(pp),
        n_splits=n_splits, **kw), p, *x))


@pytest.mark.parametrize("n_splits,Hq,Hkv,hd,pos,geom", VERIFY_CASES)
def test_ring_verify_matches_jax(Hq, Hkv, hd, n_splits, pos, geom):
    cl, bk, kw = _geom(geom)
    a = _inputs(Hq, Hkv, seed=Hq * 40 + Hkv + n_splits + pos, hd=hd,
                cache_len=cl)
    p = _pos(pos)
    got = ops.verify_attention(_t(a["qv"]), _t(a["k"]), _t(a["v"]),
                               _t(a["kn"]), _t(a["vn"]), _t(p),
                               policy=_policy(n_splits, bk), **kw)
    assert got.shape == (B, Q, Hq, hd) and got.dtype == torch.float32
    kp = jops.ring_positions(_j(p) - 1, cl)
    args = (_j(a["qv"]), _j(a["k"]), _j(a["v"]), _j(a["kn"]), _j(a["vn"]),
            kp, _j(p))
    _close(got, _jx(jref.verify_attention_ref, *args, **kw))
    _close(got, _jx(jops.verify_attention_jnp, *args, n_splits=n_splits,
                    **kw))
    if Hq != 4:
        _close(got, _jx(jda.verify_attention_pallas, *args[:5], _j(p),
                        block_k=bk, n_splits=n_splits, interpret=True, **kw))
    targs = (_t(a["qv"]), _t(a["k"]), _t(a["v"]), _t(a["kn"]), _t(a["vn"]),
             ops.ring_positions(_t(p) - 1, cl), _t(p))
    _close(got, ref.verify_attention_ref(*targs, **kw))
    _close(got, ops.verify_attention_torch(*targs, n_splits=n_splits, **kw))


# --------------------------------------------------------------------------
# stage 1: partials and log-sum-exps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n_splits,pos,geom", [
    pytest.param(2, 13, {}, id="2"), pytest.param(5, 13, {}, id="5"),
    pytest.param(4, 13, {}, id="4-past-the-blocks"),
    pytest.param(3, 30, C51, id="3-C51-bk17"),
    pytest.param(3, 170, C51, id="3-C51-bk17-wrapped"),
    pytest.param(5, 100, PRIME, id="5-prime37"),
    pytest.param(3, 170, dict(C51, cap=2.0), id="3-cap"),
    pytest.param(2, [5, 70, 131], {"window": 12}, id="2-ragged-window")])
def test_ring_decode_partials_match_pallas(n_splits, pos, geom):
    """Stage-1 contract, empty splits included (pos 13 fills two of the
    five blocks: the later splits see no valid slot -> zero partial,
    NEG_INF lse), and the merge after it; and at the tiling's edges, where
    a row whose keys in a running split are all masked weighs them alike."""
    cl, bk, kw = _geom(geom)
    a = _inputs(9, 3, seed=7, cache_len=cl)
    p = _pos(pos)
    x = (a["q1"], a["k"], a["v"])
    pp, lp = da.ring_attention_sweep(*map(_t, x), _t(p).reshape(-1),
                                     n_splits=n_splits, block_k=bk, **kw)
    jp, jl = _jx(jda.decode_attention_pallas_partials, *map(_j, x), _j(p),
                 n_splits=n_splits, block_k=bk, interpret=True, **kw)
    _close(pp, jp)
    _close(lp, jl, 1e-5)
    rp, rl = _by_row(lambda q, k, v, pp_: _jx(
        jref.decode_attention_split_ref, _j(q), _j(k), _j(v),
        jops.ring_positions(_j(pp_), cl), _j(pp_), n_splits=n_splits,
        block_k=bk, **kw), p, *x)
    _close(pp, rp)
    _close(lp, rl, 1e-5)
    tp, tl = _by_row(lambda q, k, v, pp_: ref.decode_attention_split_ref(
        _t(q), _t(k), _t(v), ops.ring_positions(_t(pp_), cl), _t(pp_),
        n_splits=n_splits, block_k=bk, **kw), p, *x)
    _close(tp, rp)
    _close(tl, rl, 1e-5)
    if pos == 13:
        assert float(lp[:, :, -1].max()) == np.float32(ref.NEG_INF)
    merged = da.lse_merge(pp, lp, torch.float32)
    _close(merged, _jx(jda.merge_kv_splits_pallas, jp, jl,
                       out_dtype=jnp.float32, interpret=True))


@pytest.mark.parametrize("n_splits,positions,geom", [
    pytest.param(2, (0, 131), {}, id="2"),
    pytest.param(5, (0, 131), {}, id="5"),
    pytest.param(4, (0, 131), {}, id="4-past-the-blocks"),
    pytest.param(3, (30, 170), C51, id="3-C51-bk17"),
    pytest.param(5, (0, 100), PRIME, id="5-prime37"),
    pytest.param(5, (121, 127), {}, id="5-rows-differ"),
    pytest.param(3, (170,), dict(C51, cap=2.0, window=12),
                 id="3-cap-window")])
def test_ring_verify_partials_match_pallas(n_splits, positions, geom):
    """Verify at pos 0: every split but the last (the candidates' one) is
    empty; at pos 131 the wrapped ring is live in every split.  At 121 and
    127 (3 C + 1, 3 C + 7) the Q rows see different slots of one running
    block: each row's partial is its own, rows whose keys in a split are
    all masked included."""
    cl, bk, kw = _geom(geom)
    a = _inputs(9, 3, seed=8, cache_len=cl)
    for pos in positions:
        p = _pos(pos)
        pp, lp = da.ring_attention_sweep(
            _t(a["qv"]), _t(a["k"]), _t(a["v"]), _t(p).reshape(1),
            k_new=_t(a["kn"]), v_new=_t(a["vn"]), n_splits=n_splits,
            block_k=bk, **kw)
        jp, jl = _jx(jda.verify_attention_pallas_partials, _j(a["qv"]),
                     _j(a["k"]), _j(a["v"]), _j(a["kn"]), _j(a["vn"]),
                     _j(p), n_splits=n_splits, block_k=bk, interpret=True,
                     **kw)
        _close(pp, jp)
        _close(lp, jl, 1e-5)
        if pos == 0:
            assert float(lp[:, :, :-1].max()) == np.float32(ref.NEG_INF)
            assert float(lp[:, :, -1].min()) > ref.NEG_INF
        elif pos == 131 and not geom:
            # a split past the blocks is the last: it holds the candidates
            assert float(lp.min()) > ref.NEG_INF


@pytest.mark.parametrize("verify", [False, True])
@pytest.mark.parametrize("pos", [13, 131])
def test_window_and_softcap_match_jax(verify, pos):
    a = _inputs(9, 3, seed=11 + verify + pos)
    p = _pos(pos)
    kw = {"window": 12, "logit_cap": 2.0}
    if verify:
        got = ops.verify_attention(_t(a["qv"]), _t(a["k"]), _t(a["v"]),
                                   _t(a["kn"]), _t(a["vn"]), _t(p),
                                   policy=_policy(2), **kw)
        want = _jx(jref.verify_attention_ref, _j(a["qv"]), _j(a["k"]),
                   _j(a["v"]), _j(a["kn"]), _j(a["vn"]),
                   jops.ring_positions(_j(p) - 1, C), _j(p), **kw)
        pallas = _jx(jda.verify_attention_pallas, _j(a["qv"]), _j(a["k"]),
                     _j(a["v"]), _j(a["kn"]), _j(a["vn"]), _j(p),
                     block_k=BK, n_splits=2, interpret=True, **kw)
    else:
        got = ops.decode_attention(_t(a["q1"]), _t(a["k"]), _t(a["v"]),
                                   _t(p), policy=_policy(2), **kw)
        want = _jx(jref.decode_attention_ref, _j(a["q1"]), _j(a["k"]),
                   _j(a["v"]), jops.ring_positions(_j(p), C), _j(p), **kw)
        pallas = _jx(jda.decode_attention_pallas, _j(a["q1"]), _j(a["k"]),
                     _j(a["v"]), _j(p), block_k=BK, n_splits=2,
                     interpret=True, **kw)
    _close(got, want)
    _close(got, pallas)


@pytest.mark.parametrize("verify", [False, True])
def test_block_divisor_rule_matches_jax(verify):
    """C = 45 with a requested block of 16: the block is 15 (the largest
    divisor of 45 not above 16), so 3 blocks split 2 ways as the Pallas
    kernel splits them."""
    a = _inputs(9, 3, seed=21, cache_len=45)
    p = _pos(100)
    assert da.ring_block_k(45, 16) == 15 and da.ring_block_k(40, 256) == 40
    if verify:
        got = da.ring_attention_sweep(
            _t(a["qv"]), _t(a["k"]), _t(a["v"]), _t(p).reshape(1),
            k_new=_t(a["kn"]), v_new=_t(a["vn"]), n_splits=2, block_k=16)
        want = _jx(jda.verify_attention_pallas_partials, _j(a["qv"]),
                   _j(a["k"]), _j(a["v"]), _j(a["kn"]), _j(a["vn"]), _j(p),
                   n_splits=2, block_k=16, interpret=True)
    else:
        got = da.ring_attention_sweep(_t(a["q1"]), _t(a["k"]), _t(a["v"]),
                                      _t(p).reshape(1), n_splits=2,
                                      block_k=16)
        want = _jx(jda.decode_attention_pallas_partials, _j(a["q1"]),
                   _j(a["k"]), _j(a["v"]), _j(p), n_splits=2, block_k=16,
                   interpret=True)
    _close(got[0], want[0])
    _close(got[1], want[1], 1e-5)


def test_ragged_decode_pos_matches_jax():
    """A (B,) pos: every batch row decodes against its own ring depth."""
    a = _inputs(9, 3, seed=31)
    p = np.asarray([5, 40, 131], np.int32)
    got = ops.decode_attention(_t(a["q1"]), _t(a["k"]), _t(a["v"]), _t(p),
                               policy=_policy(2))
    want = _jx(jda.decode_attention_pallas, _j(a["q1"]), _j(a["k"]),
               _j(a["v"]), _j(p), block_k=BK, n_splits=2, interpret=True)
    _close(got, want)
    _close(got, _jx(jops.decode_attention_jnp, _j(a["q1"]), _j(a["k"]),
                    _j(a["v"]), jops.ring_positions(_j(p), C), _j(p)))


@pytest.mark.parametrize("Hq,Hkv,hd", BF16_HEADS)
@pytest.mark.parametrize("verify", [False, True])
def test_sweep_single_split_keeps_query_dtype(Hq, Hkv, hd, verify):
    """One split writes the normalised output in q's dtype (no merge), on
    a wrapped ring, within one bf16 rounding (2e-2) of JAX's reference at
    bf16."""
    a = _inputs(Hq, Hkv, seed=12 + verify, hd=hd)
    p = _pos(131)
    names = ("qv", "k", "v", "kn", "vn") if verify else ("q1", "k", "v")
    bf = [_t(a[n]).to(torch.bfloat16) for n in names]
    jbf = [_j(a[n]).astype(jnp.bfloat16) for n in names]
    if verify:
        out = da.ring_attention_sweep(*bf[:3], _t(p).reshape(1), k_new=bf[3],
                                      v_new=bf[4], n_splits=1, block_k=BK)
        want = _jx(jref.verify_attention_ref, *jbf,
                   jops.ring_positions(_j(p) - 1, C), _j(p))
    else:
        out = da.ring_attention_sweep(*bf, _t(p).reshape(1), n_splits=1,
                                      block_k=BK)
        want = _jx(jref.decode_attention_ref, *jbf,
                   jops.ring_positions(_j(p), C), _j(p))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    _close(out.float(), np.asarray(want, np.float32), 2e-2)


# --------------------------------------------------------------------------
# dispatch, positions, split heuristic
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kv_splits", ["auto", 1, 3])
def test_ops_dispatch_backends_agree(kv_splits):
    """Every CPU backend of both ring entry points gives the JAX ``auto``
    answer for the same ``kv_splits`` and ``decode_k_chunk``."""
    a = _inputs(9, 3, seed=13)
    p = _pos(131)
    jpol = jops.KernelPolicy(kv_splits=kv_splits, decode_k_chunk=BK)
    jd = _jx(jops.decode_attention, _j(a["q1"]), _j(a["k"]), _j(a["v"]),
             _j(p), policy=jpol)
    jv = _jx(jops.verify_attention, _j(a["qv"]), _j(a["k"]), _j(a["v"]),
             _j(a["kn"]), _j(a["vn"]), _j(p), policy=jpol)
    for backend in ("auto", "ref", "torch", "cuda"):
        pol = ops.KernelPolicy(decode=backend, kv_splits=kv_splits,
                               decode_k_chunk=BK)
        _close(ops.decode_attention(_t(a["q1"]), _t(a["k"]), _t(a["v"]),
                                    _t(p), policy=pol), jd)
        _close(ops.verify_attention(_t(a["qv"]), _t(a["k"]), _t(a["v"]),
                                    _t(a["kn"]), _t(a["vn"]), _t(p),
                                    policy=pol), jv)


def test_ring_positions_match_jax():
    for pos in (0, 7, 39, 40, 131):
        _close(ops.ring_positions(torch.tensor(pos), C),
               jops.ring_positions(jnp.asarray(pos), C), 0.5)
    batch = np.asarray([0, 13, 131], np.int32)
    got = ops.ring_positions(_t(batch), C)
    assert got.shape == (3, C)
    _close(got, jops.ring_positions(_j(batch), C), 0.5)
    assert int(got[1].max()) == 13 and int(got[1].min()) < 0


def test_custom_k_pos_routes_to_torch_with_one_warning(monkeypatch):
    """A custom slot layout cannot use the ring kernel: on CPU tensors
    ``cuda`` runs the torch backend for it, warns once per entry point, and
    launches nothing (on CUDA tensors it raises; ``chip_smoke.py`` checks
    that)."""
    monkeypatch.setattr(ops, "_KPOS_FALLBACK_WARNED", set())
    a = _inputs(9, 3, seed=14)
    p = _pos(20)
    k_pos = np.arange(C, dtype=np.int32)[::-1].copy()     # reversed layout
    k_pos[30:] = -1
    da.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(2):
            got = ops.decode_attention(_t(a["q1"]), _t(a["k"]), _t(a["v"]),
                                       _t(p), k_pos=_t(k_pos),
                                       policy=_policy(2))
            gv = ops.verify_attention(_t(a["qv"]), _t(a["k"]), _t(a["v"]),
                                      _t(a["kn"]), _t(a["vn"]), _t(p),
                                      k_pos=_t(k_pos), policy=_policy(2))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 2 and "decode_attention" in msgs[0] \
        and "verify_attention" in msgs[1]
    _close(got, _jx(jops.decode_attention_jnp, _j(a["q1"]), _j(a["k"]),
                    _j(a["v"]), _j(k_pos), _j(p), n_splits=2))
    _close(gv, _jx(jops.verify_attention_jnp, _j(a["qv"]), _j(a["k"]),
                   _j(a["v"]), _j(a["kn"]), _j(a["vn"]), _j(k_pos), _j(p),
                   n_splits=2))
    assert da.LAUNCHES["ring_decode"] == da.LAUNCHES["ring_verify"] == 0


@pytest.mark.parametrize("batch,kv_len,heads,cores,block", [
    (8, 545, 9, 132, 256), (4, 4096, 9, 132, 256), (1, 545, 9, 132, 256),
    (32, 545, 9, 132, 256), (3, 40, 9, 8, 8), (2, 64, 4, 8, 256)])
def test_choose_kv_splits_on_ring_shapes_matches_jax(batch, kv_len, heads,
                                                     cores, block):
    assert ops.choose_kv_splits(batch, kv_len, heads, cores, block=block) \
        == jops.choose_kv_splits(batch, kv_len, heads, cores, block=block)


def test_smoke_batch_shape_splits_three_ways():
    """chip_smoke's batch path: 8 requests x 9 heads = 72 cells under 2 x
    132 SMs, C = 545 in 5 blocks of 109; the requested 256-key chunk gives
    3 blocks, so S = 3, and 3 splits of 2, 2 and 1 blocks."""
    assert ops.choose_kv_splits(8, 545, 9, 132, block=256) == 3
    assert da.ring_block_k(545, 256) == 109
    assert da.split_blocks(545 // 109, 3) == (3, 2)


def test_int8_ring_caches_raise_by_name():
    """int8 ring caches are served now at op level: the ring sweep's twin
    (through ``ring_attention``, 1 and 5 splits) and the port's ``ref`` /
    ``torch`` dispatch on int8 caches with per-row scales match the JAX
    ``jnp`` backend's int8 form, wrapped and not; scales that come alone
    raise by name."""
    a = _inputs(4, 2, seed=1)
    rng = np.random.default_rng(2)
    kq = rng.integers(-127, 128, a["k"].shape).astype(np.int8)
    vq = rng.integers(-127, 128, a["v"].shape).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, C, 2, 1)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, C, 2, 1)).astype(np.float32)
    i8 = {"k_scale": _t(ks), "v_scale": _t(vs)}
    for p in (13, 131):
        pos = _t(_pos(p))
        want = jops.decode_attention_jnp(
            _j(a["q1"]), _j(kq), _j(vq), jops.ring_positions(p, C), p,
            k_scale=_j(ks), v_scale=_j(vs))
        for n_splits in (1, 5):
            _close(da.ring_attention(_t(a["q1"]), _t(kq), _t(vq), pos[None],
                                     n_splits=n_splits, block_k=BK, **i8),
                   want)
        for backend in ("ref", "torch"):
            _close(ops.decode_attention(
                _t(a["q1"]), _t(kq), _t(vq), pos, policy=ops.KernelPolicy(
                    decode=backend, decode_k_chunk=BK), **i8), want)
        want = jops.verify_attention_jnp(
            _j(a["qv"]), _j(kq), _j(vq), _j(a["kn"]), _j(a["vn"]),
            jops.ring_positions(p - 1, C), p, k_scale=_j(ks), v_scale=_j(vs))
        for n_splits in (1, 5):
            _close(da.ring_attention(_t(a["qv"]), _t(kq), _t(vq), pos[None],
                                     k_new=_t(a["kn"]), v_new=_t(a["vn"]),
                                     n_splits=n_splits, block_k=BK, **i8),
                   want)
        for backend in ("ref", "torch"):
            _close(ops.verify_attention(
                _t(a["qv"]), _t(kq), _t(vq), _t(a["kn"]), _t(a["vn"]), pos,
                policy=ops.KernelPolicy(decode=backend, decode_k_chunk=BK),
                **i8), want)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        da.ring_attention_sweep(_t(a["q1"]), _t(kq), _t(vq), _t(_pos([13])),
                                v_scale=_t(vs))
