"""K8's backward on the CPU, held against the JAX package in fp32.

The same numpy inputs and cotangents go through ``jax.vjp`` of
``repro.kernels.ops.ssd_chunked_jnp`` with ``return_state=True`` (so the
final state's gradient dh_T is covered; at a ragged S the JAX function
itself takes the sequential ``ref.ssd_ref``) and through the port's plain
twin of the backward kernels, ``ssd_scan.ssd_scan_bwd_torch``, and
``SSDScanFn`` run through ``torch.autograd.grad`` on CPU tensors.  Every
gradient (x, dt, A, B, C, D, the initial state) agrees within 1e-4 of its
scale.  The zero steps that pad a ragged sequence to whole chunks add
nothing to any gradient, and the padded steps' own dx, dB and dC are
zero.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro_torch.kernels import ssd_scan as ss

TOL = 1e-4
H, P, N, CHUNK = 4, 8, 16, 16
NAMES = ("x", "dt", "A", "B_mat", "C_mat", "D", "initial_state")

# (S, G, D, initial state): whole chunks (48) and a ragged 37, G 1 and 2
CASES = [(48, 1, True, False), (48, 2, True, True), (48, 2, False, True),
         (37, 1, True, True), (37, 2, False, False), (37, 2, True, True)]


def _case_id(c):
    S, G, D, init = c
    return f"S{S}-G{G}" + ("-D" if D else "") + ("-init" if init else "")


@functools.lru_cache(maxsize=None)
def _inputs(S, G, D, init, B=2):
    """Inputs and cotangents from a numpy seed: x, B, C, dy, dh_T unit
    normals, dt = softplus(n - 1), A = -exp(n / 2), D, initial state."""
    rng = np.random.default_rng(1000 + S * 10 + G + 4 * D + 2 * init)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = {"x": r(B, S, H, P),
           "dt": np.log1p(np.exp(r(B, S, H) - 1.0)).astype(np.float32),
           "A": -np.exp(0.5 * r(H)).astype(np.float32),
           "B_mat": r(B, S, G, N), "C_mat": r(B, S, G, N),
           "D": r(H) if D else None,
           "initial_state": r(B, H, P, N) if init else None}
    return inp, r(B, S, H, P), r(B, H, P, N)


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    """jax.vjp of ssd_chunked_jnp (y and the final state) at the case's
    inputs and cotangents: the gradients of the inputs given, by name."""
    inp, dy, dh_T = _inputs(*case)
    given = [k for k in NAMES if inp[k] is not None]

    def f(*args):
        kw = dict(zip(given, args))
        return jops.ssd_chunked_jnp(
            kw["x"], kw["dt"], kw["A"], kw["B_mat"], kw["C_mat"],
            kw.get("D"), chunk=CHUNK,
            initial_state=kw.get("initial_state"), return_state=True)

    _, vjp = jax.vjp(f, *[jax.numpy.asarray(inp[k]) for k in given])
    grads = vjp((jax.numpy.asarray(dy), jax.numpy.asarray(dh_T)))
    return {k: np.asarray(g) for k, g in zip(given, grads)}


def _t(a):
    return None if a is None else torch.tensor(a)


def _close(got, want, what):
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert err <= TOL * scale, (what, err / scale)


def _twin(inp, dy, dh_T):
    return dict(zip(NAMES, ss.ssd_scan_bwd_torch(
        *[_t(inp[k]) for k in NAMES[:6]], torch.tensor(dy), chunk=CHUNK,
        initial_state=_t(inp["initial_state"]), dh_T=torch.tensor(dh_T))))


@pytest.mark.parametrize("path", ["twin", "autograd"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ssd_backward_matches_jax_vjp(case, path):
    """``ssd_scan_bwd_torch`` (path "twin") and ``SSDScanFn`` through
    ``torch.autograd.grad`` (path "autograd") against jax.vjp of
    ``ssd_chunked_jnp``: dx, ddt, dA, dB, dC, and dD and the initial
    state's gradient where given, each within 1e-4 of its scale."""
    inp, dy, dh_T = _inputs(*case)
    want = _jax_grads(case)
    if path == "twin":
        got = _twin(inp, dy, dh_T)
    else:
        args = {k: _t(inp[k]) for k in NAMES}
        leaves = [k for k in NAMES if args[k] is not None]
        for k in leaves:
            args[k].requires_grad_(True)
        y, h_T = ss.SSDScanFn.apply(*[args[k] for k in NAMES], CHUNK, True)
        got = dict(zip(leaves, torch.autograd.grad(
            (y, h_T), [args[k] for k in leaves],
            (torch.tensor(dy), torch.tensor(dh_T)))))
    assert sorted(k for k in got if got[k] is not None) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        _close(got[k], w, f"{path} d{k}")


@pytest.mark.parametrize("case", [c for c in CASES if c[0] % CHUNK],
                         ids=_case_id)
def test_ssd_backward_zero_steps(case):
    """At the ragged S, the staged backward over the sequence padded with
    zero steps (dt = 0, x = B = C = dy = 0) to whole chunks gives the
    unpadded call's gradients on the real steps, dA, dD and the initial
    state's gradient, within 1e-6 of their scale, and leaves dx, dB and dC
    of the padded steps zero."""
    inp, dy, dh_T = _inputs(*case)
    S = case[0]
    pad = -S % CHUNK
    padded = dict(inp)
    for k in ("x", "dt", "B_mat", "C_mat"):
        a = inp[k]
        padded[k] = np.concatenate(
            [a, np.zeros((a.shape[0], pad, *a.shape[2:]), np.float32)], 1)
    dy_p = np.concatenate(
        [dy, np.zeros((dy.shape[0], pad, *dy.shape[2:]), np.float32)], 1)
    got, full = _twin(inp, dy, dh_T), _twin(padded, dy_p, dh_T)
    for k, g in got.items():
        if g is None:
            assert full[k] is None
            continue
        f = full[k][:, :S] if k in ("x", "dt", "B_mat", "C_mat") else full[k]
        assert float((g - f).abs().max()) <= 1e-6 * float(f.abs().max()), k
    for k in ("x", "B_mat", "C_mat"):
        assert torch.count_nonzero(full[k][:, S:]) == 0, k
