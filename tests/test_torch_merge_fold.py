"""The merge K2b folded into the split sweeps (``merge=True``), held
against the JAX package's two-stage results on the CPU.

On the CPU a sweep's wrapper with ``merge=True`` runs its plain version,
then ``lse_merge_torch``, and returns ``(B, Q, Hq, Dv)`` in q's dtype,
contiguous, at every split count: the function the card's fused launch
computes (its last block of each row tile merges the splits).  The same
numpy inputs go through the JAX ops' two-stage paths with the same split
count: the paged, ring and latent sweeps, decode and verify, S 2, 3, 5 and
16, with splits that hold no key; fp32 within 1e-5, bf16 within 2e-2.
``merge=False`` keeps the partials and log-sum-exps.  The merge itself,
with an all-empty row, against JAX's oracle and the Pallas merge in
interpret mode; the counter workspace's growth, and its refusal to grow
inside a CUDA-graph capture.
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
from repro_torch.kernels import ref

B, HQ, HKV, D = 3, 4, 2, 8
Q = 3                         # verify rows
PS, NB = 4, 16                # paged: 16 pages of 4, so up to 16 splits
C, BK = 64, 4                 # ring: 16 blocks of 4
R_KV, D_ROPE = 16, 8          # latent rows of 24, values of 16
SCALE_MLA = 0.3
SPLITS = [2, 3, 5, 16]
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# positions with splits that hold no key: request 0 sees one page (or,
# verifying at pos 0, only its candidates); the ring's first row and its
# verify have filled a few slots of 64
POS = {("paged", False): [3, 37, 63], ("paged", True): [0, 30, 60],
       ("ring", False): [5, 40, 150], ("ring", True): 10,
       ("latent", False): [2, 40, 63], ("latent", True): [0, 20, 57]}

_JITTED = {}


def _jx(fn, *args, **kw):
    key = (fn, tuple(sorted(kw.items())))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(functools.partial(fn, **kw))
    return _JITTED[key](*args)


def _inputs(family, verify, seed):
    """Seeded numpy inputs of one family: (port arguments, keyword
    arguments, JAX reference as a function of the split count)."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    pos = np.asarray(POS[family, verify], np.int32)
    if family == "ring":
        q = r(B, Q if verify else 1, HQ, D)
        k, v, kn, vn = r(B, C, HKV, D), r(B, C, HKV, D), r(B, Q, HKV, D), \
            r(B, Q, HKV, D)
        kw = {"block_k": BK}
        if verify:
            kw.update(k_new=kn, v_new=vn)
            kp = jops.ring_positions(jnp.asarray(pos) - 1, C)
            want = lambda S, x: _jx(jops.verify_attention_jnp, x(q), x(k),
                                    x(v), x(kn), x(vn), kp, jnp.asarray(pos),
                                    n_splits=S)
        else:
            kp = jops.ring_positions(jnp.asarray(pos), C)
            want = lambda S, x: _jx(jops.decode_attention_jnp, x(q), x(k),
                                    x(v), kp, jnp.asarray(pos), n_splits=S)
        return (q, k, v, pos.reshape(-1)), kw, want
    n_pages = B * NB + 2
    bt = (1 + rng.permutation(n_pages - 1)[:B * NB]).reshape(B, NB)
    bt = bt.astype(np.int32)
    if family == "latent":
        R = R_KV + D_ROPE
        q, pool, pend = r(B, Q if verify else 1, HQ, R), r(n_pages, PS, R), \
            r(B, Q, R)
        kw = {"r_kv": R_KV, "scale": SCALE_MLA}
        if verify:
            kw["pending"] = pend
            want = lambda S, x: _jx(
                jops.paged_verify_attention_jnp, x(q), x(pool)[:, :, None],
                x(pool)[:, :, None, :R_KV], x(pend)[:, :, None],
                x(pend)[:, :, None, :R_KV], jnp.asarray(bt),
                jnp.asarray(pos), n_splits=S, scale=SCALE_MLA)
        else:
            want = lambda S, x: _jx(
                jops.mla_decode_paged_jnp, x(q), x(pool), jnp.asarray(bt),
                jnp.asarray(pos), r_kv=R_KV, scale=SCALE_MLA, n_splits=S)
        return (q, pool, bt, pos), kw, want
    q = r(B, Q if verify else 1, HQ, D)
    kp, vp, kn, vn = r(n_pages, PS, HKV, D), r(n_pages, PS, HKV, D), \
        r(B, Q, HKV, D), r(B, Q, HKV, D)
    kw = {}
    if verify:
        kw.update(k_new=kn, v_new=vn)
        want = lambda S, x: _jx(jops.paged_verify_attention_jnp, x(q), x(kp),
                                x(vp), x(kn), x(vn), jnp.asarray(bt),
                                jnp.asarray(pos), n_splits=S)
    else:
        want = lambda S, x: _jx(jops.paged_decode_attention_jnp, x(q), x(kp),
                                x(vp), jnp.asarray(bt), jnp.asarray(pos),
                                n_splits=S)
    return (q, kp, vp, bt, pos), kw, want


SWEEPS = {"paged": da.paged_attention_sweep, "ring": da.ring_attention_sweep,
          "latent": da.mla_latent_sweep}


def _port(family, args, kw, S, dtype, **extra):
    """The port's sweep on the CPU, float inputs in ``dtype``."""
    def t(a):
        x = torch.from_numpy(np.asarray(a))
        return x.to(dtype) if x.is_floating_point() else x
    return SWEEPS[family](*map(t, args), **{k: t(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()}, n_splits=S, **extra)


def _check_merged(family, verify, S, dtype, seed):
    args, kw, want = _inputs(family, verify, seed)
    got = _port(family, args, kw, S, dtype, merge=True)
    Dv = R_KV if family == "latent" else D
    assert got.shape == (B, Q if verify else 1, HQ, Dv)
    assert got.dtype == dtype and got.is_contiguous()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = lambda a: jnp.asarray(a).astype(jdt)
    w = np.asarray(jnp.asarray(want(S, x), jnp.float32))
    err = float(np.max(np.abs(got.float().numpy() - w)))
    assert err < TOL[dtype], err
    return args, kw, got


@pytest.mark.parametrize("S", SPLITS)
@pytest.mark.parametrize("verify", [False, True], ids=["decode", "verify"])
@pytest.mark.parametrize("family", list(SWEEPS))
def test_merged_sweep_matches_jax_two_stage(family, verify, S):
    """fp32: the merged sweep against JAX's two-stage op with the same
    split count; ``merge=False`` still returns the partials (B, Hq, S, Q,
    Dv) and lse (B, Hq, S, Q), whose merge, transposed, is the merged
    output bit for bit, with an empty split among them."""
    args, kw, got = _check_merged(family, verify, S, torch.float32,
                                  seed=10 * S + verify)
    partial, lse = _port(family, args, kw, S, torch.float32)
    Dv = got.shape[-1]
    n_blocks = C // BK if family == "ring" else NB
    assert partial.shape == (B, HQ, min(S, n_blocks), got.shape[1], Dv)
    assert lse.shape == partial.shape[:-1]
    if (family, verify, S) != ("ring", True, 2):
        # an empty split (the ring's verify at pos 10 fills half a split
        # and folds its candidates into the other)
        assert float(lse.min()) == np.float32(ref.NEG_INF)
    merged = da.lse_merge(partial, lse, torch.float32).transpose(1, 2)
    assert torch.equal(merged, got)


@pytest.mark.parametrize("family,verify,S", [
    ("paged", False, 5), ("paged", True, 16), ("ring", True, 3),
    ("latent", False, 2), ("paged", True, 2), ("ring", False, 16),
    ("latent", True, 5), ("latent", False, 16)])
def test_merged_sweep_keeps_bf16(family, verify, S):
    """bf16 inputs: the merged output in bf16, within one bf16 rounding of
    JAX's two-stage op on the same bf16 inputs."""
    _check_merged(family, verify, S, torch.bfloat16, seed=50 + S)


def test_merge_of_an_all_empty_row_matches_jax():
    """K2b's contract at its edge: a row whose every split is empty (lse
    NEG_INF, partial 0) is the uniform average of zeros; beside it rows
    with one empty split.  Against JAX's oracle and the Pallas merge in
    interpret mode."""
    rng = np.random.default_rng(23)
    partial = rng.standard_normal((2, 3, 5, Q, D)).astype(np.float32)
    lse = rng.standard_normal((2, 3, 5, Q)).astype(np.float32)
    lse[:, :, 3] = ref.NEG_INF
    partial[:, :, 3] = 0.0
    lse[1, 2, :, 0] = ref.NEG_INF                          # all empty
    partial[1, 2, :, 0] = 0.0
    got = da.lse_merge(torch.from_numpy(partial), torch.from_numpy(lse),
                       torch.float32)
    want = _jx(jref.merge_kv_splits_ref, jnp.asarray(partial),
               jnp.asarray(lse))
    pallas = _jx(jda.merge_kv_splits_pallas, jnp.asarray(partial),
                 jnp.asarray(lse), out_dtype=jnp.float32, interpret=True)
    for w in (want, pallas):
        assert float(np.max(np.abs(got.numpy() - np.asarray(w)))) < 1e-5
    assert torch.equal(got[1, 2, 0], torch.zeros(D))


def test_counters_grow_zeroed_and_never_inside_a_capture(monkeypatch):
    """The workspace is allocated zeroed, grows (keeping the outgrown one,
    which a captured graph may still address) only outside a capture, and
    a merging launch inside a capture that would need it grown raises."""
    monkeypatch.setattr(da, "_COUNTERS", {})
    monkeypatch.setattr(da, "_OUTGROWN", [])
    dev = torch.device("cpu")
    ws = da.merge_counters(dev, 12)
    assert ws.dtype == torch.int32 and ws.numel() >= 12
    assert int(ws.count_nonzero()) == 0
    assert da.merge_counters(dev, 5) is ws
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert da.merge_counters(dev, ws.numel()) is ws
    with pytest.raises(RuntimeError, match="capture"):
        da.merge_counters(dev, ws.numel() + 1)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    big = da.merge_counters(dev, ws.numel() + 1)
    assert big.numel() > ws.numel() and da._OUTGROWN == [ws]
    assert int(big.count_nonzero()) == 0
