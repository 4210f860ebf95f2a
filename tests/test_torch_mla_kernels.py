"""The port's absorbed-MLA latent sweep (K7a, K7b and K3's MLA form), its
split merge and K4 at Dv != D, held against the JAX package on the CPU.

On the CPU the wrapper ``decode_attention.mla_latent_sweep`` runs its
plain version (the paged K-sweep's twin at the latent form: one kv head,
k = the whole latent row, v = its first ``r_kv`` lanes), and
``decode_attention.mla_attention`` its merge.  The same numpy inputs go
through the JAX oracles ``ref.mla_decode_paged_ref`` /
``mla_decode_split_ref`` / ``paged_verify_attention_ref``, the jnp path
and the Pallas kernels in interpret mode (as ``tests/test_mla_paged.py``
runs them), all within 5e-6 in fp32.  Shapes as in that file: 2 slots, 8
heads, r_kv 32 + rope 16, 8 pages of 4, split counts 1, 2 and 5, full,
ragged and nearly empty positions.  The edge cases (``EDGES``) pin the
function the card's tensor-core kernel computes at each edge of its
design: 16-key tiles over pages of 8 (two pages a tile) and 16, positions
at page edges, splits wholly past the request, a logit cap, and verify
blocks whose Q x 8 rows are no multiple of 16, 32 or 64 (Q 3, 17), whose
pending rows fill more than one 16-key tile (Q 17, 40), or that start at
pos 0, where only the pending rows are visible."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import decode_attention as jda
from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref

B, HQ = 2, 8
R_KV, D_ROPE = 32, 16
R = R_KV + D_ROPE
PS, NB = 4, 8
SPLITS = [1, 2, 5]
SCALE = (2 * R_KV / HQ) ** -0.5
TOL = 5e-6
POS = {"full": [NB * PS - 1, NB * PS - 1], "ragged": [NB * PS - 1, 9],
       "partial": [6, 2]}
# the edges: page size, table columns, positions (a verify's first row's)
# and logit cap
EDGES = {
    "page-edges": dict(ps=PS, nb=NB, pos=[3, 4], cap=0.0),
    "page8-edges": dict(ps=8, nb=6, pos=[7, 8], cap=0.0),
    "page16": dict(ps=16, nb=3, pos=[15, 16], cap=0.0),
    "past-the-request": dict(ps=PS, nb=NB, pos=[2, 1], cap=0.0),
    "cap": dict(ps=PS, nb=NB, pos=[25, 9], cap=3.0),
    "pos0": dict(ps=PS, nb=NB, pos=[0, 0], cap=0.0),
    "page8-q17": dict(ps=8, nb=6, pos=[8, 23], cap=0.0),
    "page16-q17": dict(ps=16, nb=4, pos=[16, 31], cap=0.0),
    "q17-pos0": dict(ps=PS, nb=12, pos=[0, 20], cap=0.0),
    "q40": dict(ps=8, nb=8, pos=[0, 17], cap=0.0),
    "cap-verify": dict(ps=PS, nb=NB, pos=[25, 4], cap=3.0),
    "past-the-request-verify": dict(ps=PS, nb=NB, pos=[2, 5], cap=0.0),
}
DECODE_EDGES = ["page-edges", "page8-edges", "page16", "past-the-request",
                "cap"]
VERIFY_CASES = (
    [(Q, n, kind) for kind in ("ragged", "partial") for n in (1, 2, 5)
     for Q in (1, 3, 6)]
    + [(3, 1, "page8-q17"), (3, 3, "page8-q17"), (17, 1, "page8-q17"),
       (17, 1, "page16-q17"), (17, 5, "page16-q17"), (17, 1, "q17-pos0"),
       (17, 2, "q17-pos0"), (6, 1, "pos0"), (6, 2, "pos0"), (6, 5, "pos0"),
       (40, 1, "q40"), (40, 2, "q40"), (3, 1, "cap-verify"),
       (3, 5, "cap-verify"), (3, 5, "past-the-request-verify")])


def _case(kind):
    """(page size, table columns, positions, logit cap) of a case."""
    if kind in POS:
        return PS, NB, POS[kind], 0.0
    e = EDGES[kind]
    return e["ps"], e["nb"], e["pos"], e["cap"]


def _arrays(seed=0, Q=1, ps=PS, nb=NB):
    rng = np.random.default_rng(seed)
    n_pages = B * nb + 3                         # spare pages stay unread
    q = rng.standard_normal((B, Q, HQ, R)).astype(np.float32)
    pages = rng.standard_normal((n_pages, ps, R)).astype(np.float32)
    tables = rng.permutation(n_pages)[:B * nb].reshape(B, nb).astype(
        np.int32)
    pend = rng.standard_normal((B, Q, R)).astype(np.float32)
    return q, pages, tables, pend


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a, jnp.float32))
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err < tol, err


@pytest.mark.parametrize("pos_kind", list(POS))
def test_oracles_match_jax(pos_kind):
    q, pages, tables, _ = _arrays(seed=1)
    pos = np.asarray(POS[pos_kind], np.int32)
    want = jref.mla_decode_paged_ref(*_j(q, pages, tables, pos), r_kv=R_KV,
                                     scale=SCALE)
    got = ref.mla_decode_paged_ref(*_t(q, pages, tables, pos), r_kv=R_KV,
                                   scale=SCALE)
    _close(got, want)
    for S in SPLITS:
        jp, jl = jref.mla_decode_split_ref(*_j(q, pages, tables, pos),
                                           r_kv=R_KV, n_splits=S,
                                           scale=SCALE)
        tp, tl = ref.mla_decode_split_ref(*_t(q, pages, tables, pos),
                                          r_kv=R_KV, n_splits=S,
                                          scale=SCALE)
        _close(tp, jp)
        _close(tl, jl)


@pytest.mark.parametrize("pos_kind", list(POS) + DECODE_EDGES)
@pytest.mark.parametrize("n_splits", SPLITS)
def test_latent_sweep_decode_matches_jax(pos_kind, n_splits):
    """K7a / K7b's plain version against the JAX oracle, the Pallas kernel
    in interpret mode and the jnp path; the torch mirror of the jnp path
    too."""
    ps, nb, pos, cap = _case(pos_kind)
    q, pages, tables, _ = _arrays(seed=n_splits, ps=ps, nb=nb)
    pos = np.asarray(pos, np.int32)
    kw = dict(r_kv=R_KV, scale=SCALE, logit_cap=cap)
    jargs = _j(q, pages, tables, pos)
    want = jref.mla_decode_paged_ref(*jargs, **kw)
    pallas = jda.mla_paged_decode_attention_pallas(
        *jargs, **kw, n_splits=n_splits, interpret=True)
    targs = _t(q, pages, tables, pos)
    got = da.mla_attention(*targs, **kw, n_splits=n_splits)
    _close(got, want)
    _close(got, pallas)
    mirror = ops.mla_decode_paged_torch(*targs, **kw, n_splits=n_splits)
    _close(mirror, jops.mla_decode_paged_jnp(*jargs, **kw,
                                             n_splits=n_splits))
    _close(mirror, want)


@pytest.mark.parametrize("pos_kind", list(POS) + DECODE_EDGES)
@pytest.mark.parametrize("n_splits", [2, 5])
def test_latent_sweep_partials_match_jax(pos_kind, n_splits):
    """The split form's canonical (B, Hq, S, 1, r_kv) partials and (B, Hq,
    S, 1) lse against the stage-1 oracle and the Pallas partials kernel,
    empty splits included (lse NEG_INF); the merge against JAX's."""
    ps, nb, pos, cap = _case(pos_kind)
    q, pages, tables, _ = _arrays(seed=20 + n_splits, ps=ps, nb=nb)
    pos = np.asarray(pos, np.int32)
    kw = dict(r_kv=R_KV, n_splits=n_splits, scale=SCALE, logit_cap=cap)
    jargs = _j(q, pages, tables, pos)
    jp, jl = jref.mla_decode_split_ref(*jargs, **kw)
    pp, pl_ = jda.mla_paged_decode_attention_pallas_partials(
        *jargs, **kw, interpret=True)
    tp, tl = da.mla_latent_sweep(*_t(q, pages, tables, pos), **kw)
    S = min(n_splits, nb)
    assert tuple(tp.shape) == (B, HQ, S, 1, R_KV)
    assert tuple(tl.shape) == (B, HQ, S, 1)
    for a, b in ((tp, jp), (tl, jl), (tp, pp), (tl, pl_)):
        _close(a, b)
    empty = np.asarray(jl) <= 0.5 * ref.NEG_INF
    np.testing.assert_array_equal(tl.numpy() <= 0.5 * ref.NEG_INF, empty)
    merged = da.lse_merge(tp, tl, torch.float32)
    _close(merged, jref.merge_kv_splits_ref(jp, jl))
    _close(ref.merge_kv_splits_ref(tp, tl), jref.merge_kv_splits_ref(jp, jl))


@pytest.mark.parametrize(
    "Q,n_splits,pos_kind", VERIFY_CASES,
    ids=[f"{kind}-{n}-{Q}" for Q, n, kind in VERIFY_CASES])
def test_latent_sweep_verify_matches_jax(Q, n_splits, pos_kind):
    """K3's MLA form (what ``mla_verify_paged`` hands the paged verify):
    query i at ``pos + i`` sees pool rows ``k_pos < pos`` and pending rows
    ``j <= i``.  The latent sweep's plain version (the ``cuda`` dispatch on
    CPU tensors) against the JAX oracle and the Pallas verify kernel in
    interpret mode at D = R, Dv = r_kv, one kv head.  The ``POS`` kinds'
    blocks end at their positions; an edge names its first row's."""
    ps, nb, pos, cap = _case(pos_kind)
    q, pages, tables, pend = _arrays(seed=40 + Q, Q=Q, ps=ps, nb=nb)
    if pos_kind in POS:
        pos = [p - Q + 1 for p in pos]
    pos = np.asarray(pos, np.int32)
    kw = dict(scale=SCALE, logit_cap=cap)
    jq, jpages, jt, jpend, jpos = _j(q, pages, tables, pend, pos)
    jargs = (jq, jpages[:, :, None], jpages[:, :, None, :R_KV],
             jpend[:, :, None], jpend[:, :, None, :R_KV], jt, jpos)
    want = jref.paged_verify_attention_ref(*jargs, **kw)
    pallas = jda.paged_verify_attention_pallas(*jargs, **kw,
                                               n_splits=n_splits,
                                               interpret=True)
    tq, tpages, tt, tpend, tpos = _t(q, pages, tables, pend, pos)
    got = da.mla_attention(tq, tpages, tt, tpos, r_kv=R_KV, pending=tpend,
                           **kw, n_splits=n_splits)
    assert tuple(got.shape) == (B, Q, HQ, R_KV)
    _close(got, want)
    _close(got, pallas)
    targs = (tq, tpages[:, :, None], tpages[:, :, None, :R_KV],
             tpend[:, :, None], tpend[:, :, None, :R_KV], tt, tpos)
    assert ops._latent_form(*targs[1:5])
    for backend in ("cuda", "torch", "ref"):
        pol = ops.KernelPolicy(decode=backend, kv_splits=n_splits)
        _close(ops.paged_verify_attention(*targs, **kw, policy=pol), want)


def test_latent_form_is_told_apart():
    """Only one kv head whose v rows are a leading slice of the SAME
    memory as its k rows is the latent form."""
    pool = torch.randn(5, PS, R)
    pend = torch.randn(B, 2, R)
    k, v = pool[:, :, None], pool[:, :, None, :R_KV]
    kn, vn = pend[:, :, None], pend[:, :, None, :R_KV]
    assert ops._latent_form(k, v, kn, vn)
    assert not ops._latent_form(k, v.clone(), kn, vn)
    assert not ops._latent_form(k, k, kn, kn)
    two = torch.randn(5, PS, 2, R)
    assert not ops._latent_form(two, two[..., :R_KV], kn, vn)


def test_mla_decode_paged_split_count_is_jaxs(monkeypatch):
    """``ops.mla_decode_paged`` asks the occupancy rule with q_heads 1 and
    the page as block (the MLA grid), as JAX does, and gets JAX's split
    count on the same box; the outputs agree under every backend."""
    seen = {}

    def spy(pkg, mod):
        inner = mod._resolve_kv_splits

        def wrapped(policy, batch, kv_len, q_heads, *, block, **kw):
            n = inner(policy, batch, kv_len, q_heads, block=block, **kw)
            seen[pkg] = (batch, kv_len, q_heads, block, n)
            return n
        monkeypatch.setattr(mod, "_resolve_kv_splits", wrapped)

    spy("jax", jops)
    spy("torch", ops)
    q, pages, tables, _ = _arrays(seed=7)
    pos = np.asarray(POS["ragged"], np.int32)
    want = jops.mla_decode_paged(*_j(q, pages, tables, pos), r_kv=R_KV,
                                 scale=SCALE)
    for backend in ("auto", "torch", "ref", "cuda"):
        got = ops.mla_decode_paged(*_t(q, pages, tables, pos), r_kv=R_KV,
                                   scale=SCALE,
                                   policy=ops.KernelPolicy(decode=backend))
        _close(got, want)
        assert seen["torch"] == seen["jax"]
    assert seen["jax"][2:4] == (1, PS)


@pytest.mark.parametrize("batch,kv_len,n_cores,want", [
    (1, 32768, 8, 16), (8, 32768, 8, 2), (16, 32768, 8, 1),
    (1, 8 * PS, 64, None), (4, 4096, 132, 16), (4, 512, 132, 16),
    (4, 96, 132, 6), (8, 4096, 132, 16), (132, 4096, 132, 2),
    (264, 4096, 132, 1)])
def test_choose_kv_splits_mla_grid(batch, kv_len, n_cores, want):
    """The split count at the MLA grid (q_heads 1), as
    ``tests/test_split_kv.py``'s MLA cases ask of JAX, and at the engine's
    shapes on the card's 132 SMs with pages of 16."""
    block = PS if want is None else (256 if n_cores == 8 else 16)
    got = ops.choose_kv_splits(batch, kv_len, 1, n_cores, block=block)
    assert got == jops.choose_kv_splits(batch, kv_len, 1, n_cores,
                                        block=block)
    if want is None:
        assert got <= 8
    else:
        assert got == want


@functools.lru_cache(maxsize=None)
def _jfa(kw_items):
    return jax.jit(functools.partial(jfa.flash_attention, block_q=16,
                                     block_k=16, interpret=True,
                                     **dict(kw_items)))


@pytest.mark.parametrize("case", [
    ("causal", 2, 32, 32, {}),
    ("ragged-37", 1, 37, 37, {}),
    ("q_offset", 1, 16, 48, {"q_offset": 32}),
    ("cap-scale", 2, 32, 32, {"logit_cap": 5.0, "scale": 0.2})],
    ids=lambda c: c[0])
def test_flash_attention_dv_ne_d_matches_jax(case):
    """K4's plain version at MLA's prefill form, q/k head dim 48 (nope 32
    + rope 16) and v head dim 32, one kv head per q head: against JAX's
    ``ops.attention`` (oracle and chunked twin) and the Pallas kernel in
    interpret mode (JAX's own chunked twin on ragged shapes); every
    backend of the port's ``ops.attention`` takes Dv != D."""
    _, Bt, Sq, Sk, kw = case
    rng = np.random.default_rng(len(case[0]))
    q = rng.standard_normal((Bt, Sq, 4, 48)).astype(np.float32)
    k = rng.standard_normal((Bt, Sk, 4, 48)).astype(np.float32)
    v = rng.standard_normal((Bt, Sk, 4, 32)).astype(np.float32)
    jq, jk, jv = _j(q, k, v)
    tq, tk, tv = _t(q, k, v)
    want = jref.attention_ref(jq, jk, jv, **kw)
    ragged = Sq % 16 or Sk % 16
    pallas = jops.flash_attention_jnp(jq, jk, jv, q_chunk=16, k_chunk=16,
                                      **kw) if ragged \
        else _jfa(tuple(sorted(kw.items())))(jq, jk, jv)
    for backend in ("auto", "ref", "chunked", "cuda"):
        got = ops.attention(tq, tk, tv, policy=ops.KernelPolicy(
            attention=backend, q_chunk=16, k_chunk=16), **kw)
        assert tuple(got.shape) == (Bt, Sq, 4, 32)
        _close(got, want)
        _close(got, pallas)
    jnp_backend = jops.attention(jq, jk, jv, policy=jops.KernelPolicy(
        attention="chunked", q_chunk=16, k_chunk=16), **kw)
    _close(ops.flash_attention_torch(tq, tk, tv, q_chunk=16, k_chunk=16,
                                     **kw), jnp_backend)


def test_wrappers_refuse_other_devices_and_shapes():
    """A tensor on neither the CPU nor the card is refused by name; on the
    CPU every latent width runs the plain version."""
    q, pages, tables, _ = _arrays(seed=3)
    pos = torch.tensor(POS["full"], dtype=torch.int32)
    meta = torch.empty((B, 1, HQ, R), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        da.mla_latent_sweep(meta, torch.tensor(pages), torch.tensor(tables),
                            pos, r_kv=R_KV, scale=SCALE)
    assert (R, R_KV) not in da.MLA_DIMS
    out = da.mla_latent_sweep(*_t(q, pages, tables), pos, r_kv=R_KV,
                              scale=SCALE)
    assert tuple(out.shape) == (B, 1, HQ, R_KV)
    for dtype in da.MLA_ROWS:
        for rows in da.MLA_ROWS[dtype]:
            assert da.mla_smem_bytes(dtype, rows=rows) <= 227 * 1024
    assert da.LAUNCHES["mla_decode"] == da.LAUNCHES["mla_verify"] == 0
