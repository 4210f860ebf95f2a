"""The arithmetic and the host-side plan of K8's bf16 backward kernels
(``csrc/ssd_scan_bwd.cu``: ``ssd_bwd_dhin_mma_kernel``,
``ssd_bwd_chunk_mma_kernel``, ``ssd_bwd_bc_sum_kernel``), on the CPU.

``_mirror`` repeats the bf16 path in fp32 torch: the x, dy, B and C
operands rounded once to bf16; every fp32 operand of a tensor-core
product (the forward's w x, exp(cs) dy, g_out, h_in, M^T, dS^T and dS)
split into bf16 hi + lo, the hi product added before the lo one; every
product summed over 16-step tiles in the kernels' order (the chunk
kernel's warp i: the column side's state terms, then its band tiles t >=
s, then the row side's state term and its band tiles s <= t); the
chunk's scan of dt A in the warp's order; the heads' dB and dC partials
summed in head order.  It returns the kernels' fp32 values before dx,
dB and dC are cast to bf16.

* Against ``jax.vjp`` of ``ssd_chunked_jnp`` on inputs that lie on the
  bf16 grid (so that rounding x, dy, B and C changes nothing): every
  gradient within 5e-5 of its scale.  A hi + lo pair holds about 16 bits
  of an fp32 operand (2^-17 of its size): the products' gradients land
  within 6e-6 of scale; dA, a sum of da dt over every step whose terms
  cancel, carries that to about 3e-5 (the twin is 6e-6 from JAX there).
  The twin itself is held to 1e-4 (``tests/test_torch_ssd_bwd.py``).
* Against ``ssd_scan_bwd_torch`` bit for bit with no rounding mirrored,
  on dyadic inputs (small integers, dt in {1/4, 1/2, 1}, A = 0) whose
  every product and sum is exact in fp32, so that the tile order cannot
  change a bit: the mirror's bookkeeping of tiles, bands and edges equals
  the twin's.
* ``ssd_scan.ssd_bwd_plan`` at mamba2-370m's shapes: the workspace's
  pieces (no d scores in bf16), the launch grids, the tiles a chunk.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro_torch.kernels import ssd_scan as ss

TOL = 5e-5
H, P, N, CHUNK = 4, 16, 32, 32
NAMES = ("x", "dt", "A", "B_mat", "C_mat", "D", "initial_state")


def _split(a, on):
    """bf16 hi + lo of an fp32 operand (``split_bf16``), as fp32 values."""
    if not on:
        return a, torch.zeros_like(a)
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _acc(acc, a, b, on):
    """acc + a @ b with a an fp32 operand: its hi product, then its lo."""
    hi, lo = _split(a, on)
    return (acc + hi @ b) + lo @ b


def _scan(dts, A):
    """The inclusive scan of dt A over 128 steps as ``chunk_scan`` runs it:
    four steps a lane in order, a Hillis-Steele scan of the lanes' totals,
    each lane's exclusive start as its inclusive total less its own."""
    v = (dts * A).reshape(32, 4)
    run = [v[:, 0]]
    for k in range(1, 4):
        run.append(run[-1] + v[:, k])
    run = torch.stack(run, 1)
    incl = run[:, 3].clone()
    for o in (1, 2, 4, 8, 16):
        nxt = incl.clone()
        nxt[o:] = incl[o:] + incl[:-o]
        incl = nxt
    return ((incl - run[:, 3])[:, None] + run).reshape(128)


def _mirror(x, dt, A, Bm, Cm, D, dy, *, chunk, h0=None, dhT=None,
            rounding=True):
    """The bf16 backward's arithmetic in fp32 torch (module docstring):
    (dx, ddt, dA, dB, dC, dD, dh0), fp32."""
    rnd = (lambda t: t.to(torch.bfloat16).float()) if rounding else (
        lambda t: t.float())
    x, dy, Bm, Cm = rnd(x), rnd(dy), rnd(Bm), rnd(Cm)
    dt, A = dt.float(), A.float()
    Bb, S, Hh, Pd = x.shape
    G, Nd = Bm.shape[2], Bm.shape[3]
    rep, nc = Hh // G, -(-S // chunk)
    Pp, Np = -(-Pd // 16) * 16, -(-Nd // 16) * 16
    dx = torch.zeros(Bb, S, Hh, Pd)
    ddt = torch.zeros(Bb, S, Hh)
    dBp, dCp = torch.zeros(Bb, S, Hh, Nd), torch.zeros(Bb, S, Hh, Nd)
    dAp, dDp = torch.zeros(Bb, Hh, nc), torch.zeros(Bb, Hh, nc)
    dh0 = None if h0 is None else torch.zeros(Bb, Hh, Pd, Nd)

    def pad(t, r, c):
        out = torch.zeros(r, c)
        out[:t.shape[0], :t.shape[1]] = t
        return out

    for b in range(Bb):
        for h in range(Hh):
            g = h // rep
            blk = []
            for c in range(nc):
                c0 = c * chunk
                rows = min(chunk, S - c0)
                MT = -(-rows // 16)
                Qr = 16 * MT
                dts = torch.zeros(128)
                dts[:rows] = dt[b, c0:c0 + rows, h]
                cum = _scan(dts, A[h])
                live = torch.arange(128) < rows
                last = cum[rows - 1]
                blk.append(dict(
                    c0=c0, rows=rows, MT=MT, dts=dts, cum=cum, last=last,
                    xs=pad(x[b, c0:c0 + rows, h], Qr, Pp),
                    ys=pad(dy[b, c0:c0 + rows, h], Qr, Pp),
                    bs=pad(Bm[b, c0:c0 + rows, g], Qr, Np),
                    cs=pad(Cm[b, c0:c0 + rows, g], Qr, Np),
                    w=torch.where(live, dts * torch.exp(last - cum), 0.0),
                    rel=torch.where(live, torch.exp(last - cum), 0.0),
                    ex=torch.where(live, torch.exp(cum), 0.0)))
            # the forward's incoming states (ssd_states_kernel, the pass)
            hin = [torch.zeros(Pp, Np) if h0 is None
                   else pad(h0[b, h].float(), Pp, Np)]
            for k in blk[:-1]:
                st = torch.zeros(Pp, Np)
                wf = torch.zeros(128)
                wf[:k["MT"] * 16] = k["dts"][:k["MT"] * 16] * torch.exp(
                    k["cum"][k["MT"] * 16 - 1] - k["cum"][:k["MT"] * 16])
                for kk in range(k["MT"]):
                    r = slice(16 * kk, 16 * kk + 16)
                    st = _acc(st, (k["xs"][r] * wf[r, None]).T,
                              k["bs"][r], rounding)
                hin.append(torch.exp(k["last"]) * hin[-1] + st)
            # d h_in and the reversed pass
            dloc = []
            for k in blk:
                acc = torch.zeros(Pp, Np)
                for kk in range(k["MT"]):
                    r = slice(16 * kk, 16 * kk + 16)
                    acc = _acc(acc, (k["ex"][r, None] * k["ys"][r]).T,
                               k["cs"][r], rounding)
                dloc.append(acc)
            gv = torch.zeros(Pp, Np) if dhT is None else pad(
                dhT[b, h].float(), Pp, Np)
            gout = [None] * nc
            for c in reversed(range(nc)):
                gout[c] = gv
                gv = dloc[c] + torch.exp(blk[c]["cum"][blk[c]["rows"] - 1]) \
                    * gv
            if dh0 is not None:
                dh0[b, h] = gv[:Pd, :Nd]
            # the chunk kernel
            for c, k in enumerate(blk):
                xs, ys, bs, cs = k["xs"], k["ys"], k["bs"], k["cs"]
                dts, cum, rows, MT = k["dts"], k["cum"], k["rows"], k["MT"]
                has_in = h0 is not None or c > 0
                ghi, glo = _split(gout[c], rounding)
                hh = hin[c] if has_in else torch.zeros(Pp, Np)
                hhi, hlo = _split(hh, rounding)
                dec = (gout[c] * hh).sum()
                scores = cs @ bs.T                       # [t, s]
                ddd, dcs = torch.zeros(128), torch.zeros(128)
                dct, dww = torch.zeros(128), torch.zeros(128)
                dxc = torch.zeros(16 * MT, Pp)
                dbc, dcc = torch.zeros(16 * MT, Np), torch.zeros(16 * MT, Np)

                def band(ti, si):
                    t = torch.arange(16 * ti, 16 * ti + 16)
                    s = torch.arange(16 * si, 16 * si + 16)
                    on = t[:, None] >= s[None, :]
                    L = torch.exp(torch.clamp(cum[t][:, None]
                                              - cum[s][None, :], max=0.0))
                    return on, L, scores[t][:, s], dts[s][None, :]

                for i in range(MT):                     # columns s
                    r = slice(16 * i, 16 * i + 16)
                    u = torch.zeros(16, Pp)
                    for kk in range(Np // 16):
                        q = slice(16 * kk, 16 * kk + 16)
                        u = (u + bs[r, q] @ ghi[:, q].T) + bs[r, q] @ glo[:,
                                                                         q].T
                    dw = (xs[r] * u).sum(1)
                    dxa = k["w"][r, None] * u
                    dba = torch.zeros(16, Np)
                    for kk in range(Pp // 16):
                        q = slice(16 * kk, 16 * kk + 16)
                        dba = (dba + xs[r, q] @ ghi[q]) + xs[r, q] @ glo[q]
                    dba = dba * k["w"][r, None]
                    ddt_r, zs = torch.zeros(16), torch.zeros(16)
                    for jt in range(i, MT):
                        tr = slice(16 * jt, 16 * jt + 16)
                        on, L, sc, dt_s = band(jt, i)
                        dmt = torch.zeros(16, 16)
                        for kk in range(Pp // 16):
                            q = slice(16 * kk, 16 * kk + 16)
                            dmt = dmt + xs[r, q] @ ys[tr, q].T
                        on, L, sc, dt_s = on.T, L.T, sc.T, dt_s.T
                        dmv = torch.where(on, dmt, 0.0)
                        m = torch.where(on, sc * L * dt_s, 0.0)
                        dv = dmv * L * dt_s
                        ddt_r = ddt_r + (dmv * sc * L).sum(1)
                        zs = zs + (dmv * m).sum(1)
                        dxa = _acc(dxa, m, ys[tr], rounding)
                        dba = _acc(dba, dv, cs[tr], rounding)
                    ddd[r] = ddt_r + dw * k["rel"][r]
                    dcs[r] = -zs - dw * k["w"][r]
                    dww[r] = dw * k["w"][r]
                    dxc[r], dbc[r] = dxa, dba
                for i in range(MT):                     # rows t
                    r = slice(16 * i, 16 * i + 16)
                    dca = torch.zeros(16, Np)
                    carried = torch.zeros(16)
                    if has_in:
                        for kk in range(Pp // 16):
                            q = slice(16 * kk, 16 * kk + 16)
                            dca = (dca + ys[r, q] @ hhi[q]) + ys[r, q] @ hlo[q]
                        dca = dca * k["ex"][r, None]
                        carried = (cs[r] * dca).sum(1)
                    zt = torch.zeros(16)
                    for js in range(i + 1):
                        sr = slice(16 * js, 16 * js + 16)
                        on, L, sc, dt_s = band(i, js)
                        dm = torch.zeros(16, 16)
                        for kk in range(Pp // 16):
                            q = slice(16 * kk, 16 * kk + 16)
                            dm = dm + ys[r, q] @ xs[sr, q].T
                        dmv = torch.where(on, dm, 0.0)
                        m = torch.where(on, sc * L * dt_s, 0.0)
                        zt = zt + (dmv * m).sum(1)
                        dca = _acc(dca, dmv * L * dt_s, bs[sr], rounding)
                    dct[r] = zt + carried
                    dcc[r] = dca
                dcs = dcs + dct
                dcs[rows - 1] += dww[:rows].sum() + torch.exp(k["last"]) * dec
                dcs[rows:] = 0.0
                zc = torch.flip(torch.cumsum(torch.flip(dcs, (0,)), 0), (0,))
                sl = slice(k["c0"], k["c0"] + rows)
                ddt[b, sl, h] = (ddd + zc * A[h])[:rows]
                dAp[b, h, c] = (zc * dts)[:rows].sum()
                dDp[b, h, c] = (xs * ys).sum()
                Dh = 0.0 if D is None else float(D[h])
                dx[b, sl, h] = (dxc + Dh * ys)[:rows, :Pd]
                dBp[b, sl, h] = dbc[:rows, :Nd]
                dCp[b, sl, h] = dcc[:rows, :Nd]
    dA = torch.zeros(Hh)
    dDv = torch.zeros(Hh)
    for b in range(Bb):
        for c in range(nc):
            dA = dA + dAp[:, :, c][b]
            dDv = dDv + dDp[:, :, c][b]
    dB = torch.zeros(Bb, S, G, Nd)
    dC = torch.zeros(Bb, S, G, Nd)
    for r in range(rep):                               # head order
        dB = dB + dBp.reshape(Bb, S, G, rep, Nd)[:, :, :, r]
        dC = dC + dCp.reshape(Bb, S, G, rep, Nd)[:, :, :, r]
    return dx, ddt, dA, dB, dC, (None if D is None else dDv), dh0


# (S, G, D, initial state, dh_T): a ragged last chunk (75 = 2 x 32 + 11)
# and whole chunks, G 1 and 2
CASES = [(75, 2, True, True, True), (64, 1, True, False, True),
         (75, 1, False, True, False), (40, 2, True, False, False)]


def _case_id(c):
    S, G, D, init, dh = c
    return (f"S{S}-G{G}" + ("-D" if D else "") + ("-init" if init else "")
            + ("-dhT" if dh else ""))


@functools.lru_cache(maxsize=None)
def _bf16_grid_inputs(S, G, D, init, dh, B=2):
    """Inputs on the bf16 grid from a numpy seed: x, B, C, dy unit normals
    rounded to bf16; dt = softplus(n - 1), A = -exp(n / 2), D, the initial
    state and dh_T fp32."""
    rng = np.random.default_rng(4000 + S + 7 * G + 3 * D + 2 * init + dh)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    bf = lambda a: torch.tensor(a).to(torch.bfloat16).float().numpy()
    inp = {"x": bf(r(B, S, H, P)),
           "dt": np.log1p(np.exp(r(B, S, H) - 1.0)).astype(np.float32),
           "A": -np.exp(0.5 * r(H)).astype(np.float32),
           "B_mat": bf(r(B, S, G, N)), "C_mat": bf(r(B, S, G, N)),
           "D": r(H) if D else None,
           "initial_state": r(B, H, P, N) if init else None}
    return inp, bf(r(B, S, H, P)), (r(B, H, P, N) if dh else None)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    inp, dy, dh_T = _bf16_grid_inputs(*case)
    given = [k for k in NAMES if inp[k] is not None]

    def f(*args):
        kw = dict(zip(given, args))
        return jops.ssd_chunked_jnp(
            kw["x"], kw["dt"], kw["A"], kw["B_mat"], kw["C_mat"],
            kw.get("D"), chunk=CHUNK,
            initial_state=kw.get("initial_state"), return_state=True)

    _, vjp = jax.vjp(f, *[jax.numpy.asarray(inp[k]) for k in given])
    hT = np.zeros((dy.shape[0], H, P, N), np.float32) if dh_T is None \
        else dh_T
    grads = vjp((jax.numpy.asarray(dy), jax.numpy.asarray(hT)))
    return {k: np.asarray(g) for k, g in zip(given, grads)}


def _t(a):
    return None if a is None else torch.tensor(a)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ssd_bwd_mirror_matches_jax_vjp(case):
    """The bf16 path's rounding and order against jax.vjp: within 5e-5 of
    each gradient's scale (module docstring)."""
    inp, dy, dh_T = _bf16_grid_inputs(*case)
    got = dict(zip(NAMES, _mirror(
        *[_t(inp[k]) for k in NAMES[:6]], torch.tensor(dy), chunk=CHUNK,
        h0=_t(inp["initial_state"]), dhT=_t(dh_T))))
    for k, want in _jax_grads(case).items():
        g = got[k].numpy()
        assert g.shape == want.shape, k
        err = float(np.max(np.abs(g - want)))
        assert err <= TOL * float(np.max(np.abs(want))), (k, err)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ssd_bwd_mirror_twin_bits_on_exact_inputs(case):
    """No rounding mirrored, on dyadic inputs: the mirror's tile sums equal
    ``ssd_scan_bwd_torch``'s bit for bit."""
    S, G, D, init, dh = case
    rng = np.random.default_rng(5000 + S + G)
    ints = lambda *s: torch.tensor(rng.integers(-2, 3, s), dtype=torch.float32)
    x, dy = ints(2, S, H, P), ints(2, S, H, P)
    Bm, Cm = ints(2, S, G, N), ints(2, S, G, N)
    dt = torch.tensor(rng.choice([0.25, 0.5, 1.0], (2, S, H)),
                      dtype=torch.float32)
    A = torch.zeros(H)
    Dv = ints(H) if D else None
    h0 = ints(2, H, P, N) if init else None
    dhT = ints(2, H, P, N) if dh else None
    got = _mirror(x, dt, A, Bm, Cm, Dv, dy, chunk=CHUNK, h0=h0, dhT=dhT,
                  rounding=False)
    want = ss.ssd_scan_bwd_torch(x, dt, A, Bm, Cm, Dv, dy, chunk=CHUNK,
                                 initial_state=h0, dh_T=dhT)
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    # with rounding on, the same inputs are bf16 numbers and every split
    # exact: the same bits again
    again = _mirror(x, dt, A, Bm, Cm, Dv, dy, chunk=CHUNK, h0=h0, dhT=dhT)
    for name, a, b in zip(NAMES, again, want):
        if a is not None:
            assert torch.equal(a, b), name


MAMBA2 = dict(H=32, P=64, G=1, N=128)


@pytest.mark.parametrize("B, S", [(8, 512), (2, 4000), (2, 1), (1, 32)])
def test_ssd_bwd_plan_at_mamba2(B, S):
    """The workspace's pieces and the launch grids at mamba2-370m's heads
    (chunk 128), as ``csrc/ssd_scan_bwd.cu`` lays them out."""
    H_, P_, G_, N_ = MAMBA2["H"], MAMBA2["P"], MAMBA2["G"], MAMBA2["N"]
    Q, nc, bh = 128, -(-S // 128), B * H_
    bf = ss.ssd_bwd_plan(B, S, H_, P_, G_, N_, Q, torch.bfloat16)
    f32 = ss.ssd_bwd_plan(B, S, H_, P_, G_, N_, Q, torch.float32)
    shared = {"states": bh * (nc + 1) * P_ * N_, "decays": bh * nc,
              "state grads": bh * nc * P_ * N_, "grad decays": bh * nc,
              "scores": B * G_ * nc * Q * Q, "dC partials": B * S * H_ * N_,
              "dB partials": B * S * H_ * N_, "dA partials": bh * nc,
              "dD partials": bh * nc}
    a4 = {k: -(-v // 4) * 4 for k, v in shared.items()}
    assert bf["pieces"] == a4
    assert list(bf["pieces"]) == list(shared)
    assert f32["pieces"] == dict(a4, **{"d scores": bh * nc * Q * Q})
    bf16 = ss.ssd_bwd_workspace(B, S, H_, P_, G_, N_, Q, torch.bfloat16)
    assert bf16 == sum(a4.values())
    assert (ss.ssd_bwd_workspace(B, S, H_, P_, G_, N_, Q, torch.float32)
            - bf16 == bh * nc * Q * Q)
    assert bf["grids"]["d h_in"] == ((nc, H_, B), 128)
    assert bf["grids"]["chunk"] == ((nc, H_, B), 256)
    (blocks, halves), threads = bf["grids"]["dB / dC"]
    assert halves == 2 and blocks * threads >= B * S * G_ * N_ // 4 \
        > (blocks - 1) * threads
    assert bf["tiles"] == -(-min(Q, S) // 16) <= 256 // 32
    assert "grids" not in f32
    if (B, S) == (8, 512):
        # the fp32 layout's 279 MB less the heads' d scores: at most 212 MB
        assert 4 * sum(f32["pieces"].values()) == 278_937_600
        assert 4 * sum(bf["pieces"].values()) <= 212e6


@pytest.mark.parametrize("chunk, S, N_", [(37, 300, 72), (16, 40, 16),
                                          (100, 77, 128)])
def test_ssd_bwd_plan_pads_scores_to_16(chunk, S, N_):
    """bf16 keeps the forward's score slots (Qp x Qp, Qp the chunk rounded
    up to 16), fp32 its own Q x Q and the d scores; every piece a multiple
    of 4."""
    bf = ss.ssd_bwd_plan(2, S, 4, 40, 2, N_, chunk, torch.bfloat16)
    f32 = ss.ssd_bwd_plan(2, S, 4, 40, 2, N_, chunk, torch.float32)
    nc, qp = -(-S // chunk), -(-chunk // 16) * 16
    assert bf["pieces"]["scores"] == -(-2 * 2 * nc * qp * qp // 4) * 4
    assert f32["pieces"]["scores"] == -(-2 * 2 * nc * chunk * chunk // 4) * 4
    assert "d scores" not in bf["pieces"]
    assert all(v % 4 == 0 for p in (bf, f32) for v in p["pieces"].values())
    assert bf["tiles"] == -(-min(chunk, S) // 16)
