"""The port's SSD scan (K8) and the Mamba2 building blocks, held against
the JAX package on the CPU in fp32.

The same numpy inputs go through the JAX oracle ``ref.ssd_ref``, the JAX
chunked form ``ops.ssd_chunked_jnp``, the Pallas kernel ``ssd_pallas`` in
interpret mode (as ``tests/test_kernels.py`` runs it) and the JAX ``ops``
dispatch, and through the port's ``ref.ssd_ref``, ``ops.ssd_chunked_torch``
and the ``cuda`` backend, whose wrapper runs the kernel's twin
(``ssd_scan.ssd_scan_torch``, the chunked form over a padded sequence) on
CPU tensors.  Like for like (oracle, chunked form) they agree within 1e-4
of the output's scale; across algorithms (sequential against chunked, a
different order of the same sums) within 1e-4 as well.  The bf16 kernels'
own form, Mamba2's chunk-parallel stages over chunks padded to a multiple
of 16 steps, is held the same way through its plain mirror
``ssd_scan.ssd_staged_torch``, with the padding property it rests on.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_pallas
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import common, ssm

TOL = 1e-4

# B, S, H, P, G, N, chunk: tests/test_kernels.py's SSD_SHAPES
SSD_SHAPES = [
    (1, 64, 2, 8, 1, 16, 16),
    (2, 128, 4, 16, 2, 24, 32),
    (1, 128, 8, 64, 1, 128, 64),      # mamba2-370m-like head shape
]


def _inputs(B, S, H, P, G, N, seed, *, D=True, init=False):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {"x": r(B, S, H, P),
           "dt": np.log1p(np.exp(r(B, S, H))).astype(np.float32),
           "A": -np.exp(r(H)).astype(np.float32),
           "B_mat": r(B, S, G, N), "C_mat": r(B, S, G, N),
           "D": r(H) if D else None}
    init_state = r(B, H, P, N) if init else None
    return out, init_state


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.tensor(a)


def _jargs(inp):
    return [_j(inp[k]) for k in ("x", "dt", "A", "B_mat", "C_mat", "D")]


def _targs(inp):
    return [_t(inp[k]) for k in ("x", "dt", "A", "B_mat", "C_mat", "D")]


def _close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b))) if a.size else 0.0
    assert err <= tol * max(1.0, float(np.max(np.abs(b)))), err


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_ref_matches_jax(shape, init):
    B, S, H, P, G, N, _ = shape
    inp, h0 = _inputs(B, S, H, P, G, N, 1, init=init)
    jy, jh = jref.ssd_ref(*_jargs(inp), initial_state=_j(h0),
                          return_state=True)
    ty, th = ref.ssd_ref(*_targs(inp), initial_state=_t(h0),
                         return_state=True)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_chunked_matches_jax(shape, init):
    B, S, H, P, G, N, chunk = shape
    inp, h0 = _inputs(B, S, H, P, G, N, 2, init=init)
    jy, jh = jops.ssd_chunked_jnp(*_jargs(inp), chunk=chunk,
                                  initial_state=_j(h0), return_state=True)
    ty, th = ops.ssd_chunked_torch(*_targs(inp), chunk=chunk,
                                   initial_state=_t(h0), return_state=True)
    _close(ty, jy)
    _close(th, jh)
    # and against the exact recurrence, as tests/test_kernels.py holds JAX
    ry, rh = jref.ssd_ref(*_jargs(inp), initial_state=_j(h0),
                          return_state=True)
    _close(ty, ry)
    _close(th, rh)


@functools.lru_cache(maxsize=None)
def _jpallas(chunk):
    return jax.jit(functools.partial(ssd_pallas, chunk=chunk, interpret=True))


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_cuda_backend_twin_matches_pallas(shape):
    """The ``cuda`` backend on CPU tensors (the kernel's twin) against the
    Pallas kernel in interpret mode: y; and with ``return_state`` and an
    initial state (which ``ssd_pallas`` hands to the jnp path) y and h_T
    against ``ssd_chunked_jnp``."""
    B, S, H, P, G, N, chunk = shape
    inp, h0 = _inputs(B, S, H, P, G, N, 3, init=True)
    policy = ops.KernelPolicy(ssd="cuda", ssd_chunk=chunk)
    jy = _jpallas(chunk)(*_jargs(inp))
    _close(ops.ssd(*_targs(inp), policy=policy), jy)
    jy, jh = ssd_pallas(*_jargs(inp), chunk=chunk, initial_state=_j(h0),
                        return_state=True, interpret=True)
    ty, th = ops.ssd(*_targs(inp), initial_state=_t(h0), return_state=True,
                     policy=policy)
    _close(ty, jy)
    _close(th, jh)


def _pad_chunks(a, Q, Qp):
    """``a`` (B, S, ...) with S a multiple of Q: Qp - Q zero steps after
    each chunk of Q steps."""
    B, S = a.shape[:2]
    a = a.reshape(B, S // Q, Q, *a.shape[2:])
    zeros = np.zeros((B, S // Q, Qp - Q, *a.shape[3:]), a.dtype)
    return np.concatenate([a, zeros], axis=2).reshape(
        B, S // Q * Qp, *a.shape[3:])


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("Q", [37, 100])
def test_zero_steps_after_each_chunk_leave_the_scan(Q, G, init):
    """The property K8's bf16 kernels pad by: Qp - Q zero steps (dt = 0, x
    = B = C = 0) after each chunk of Q steps, Qp = Q rounded up to 16,
    give JAX's ``ssd_chunked_jnp`` (at chunk Qp) its y at the real steps
    (at chunk Q) and its final state, with and without an initial state;
    the port's staged mirror, which pads so itself, agrees."""
    Qp, nc = -(-Q // 16) * 16, 3
    inp, h0 = _inputs(2, nc * Q, 4, 8, G, 16, 20 + Q + G, init=init)
    padded = {k: (_pad_chunks(v, Q, Qp)
                  if k in ("x", "dt", "B_mat", "C_mat") else v)
              for k, v in inp.items()}
    jy, jh = jops.ssd_chunked_jnp(*_jargs(inp), chunk=Q,
                                  initial_state=_j(h0), return_state=True)
    py, ph = jops.ssd_chunked_jnp(*_jargs(padded), chunk=Qp,
                                  initial_state=_j(h0), return_state=True)
    real = np.asarray(py).reshape(2, nc, Qp, 4, 8)[:, :, :Q]
    _close(real.reshape(2, nc * Q, 4, 8), jy)
    _close(ph, jh)
    ty, th = ss.ssd_staged_torch(*_targs(inp), chunk=Q, initial_state=_t(h0),
                                 return_state=True)
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("chunk", [16, 37, 128])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_staged_mirror_matches_jax(shape, chunk, init):
    """``ssd_staged_torch``, the plain mirror of the bf16 kernels' stages
    (scores per group and chunk, chunk states, the state pass, the
    outputs), against JAX's ``ssd_chunked_jnp`` (the exact recurrence
    where ``chunk`` does not divide S), y and the final state; and
    without an initial state against ``ssd_pallas`` in interpret mode
    where its chunk divides S."""
    B, S, H, P, G, N, _ = shape
    inp, h0 = _inputs(B, S, H, P, G, N, 12, init=init)
    ty, th = ss.ssd_staged_torch(*_targs(inp), chunk=chunk,
                                 initial_state=_t(h0), return_state=True)
    jy, jh = jops.ssd_chunked_jnp(*_jargs(inp), chunk=chunk,
                                  initial_state=_j(h0), return_state=True)
    _close(ty, jy)
    _close(th, jh)
    if not init and S % min(chunk, S) == 0:
        _close(ss.ssd_staged_torch(*_targs(inp), chunk=chunk),
               _jpallas(chunk)(*_jargs(inp)))


@pytest.mark.parametrize("B,S,chunk", [(8, 512, 128), (2, 4000, 128),
                                       (1, 32, 128), (2, 512, 16)])
def test_workspace_holds_the_serving_shapes_in_one_group(B, S, chunk):
    """At mamba2-370m's heads the bf16 kernels' workspace takes every
    chunk in one group: one chunk's scores for a one-chunk prompt, else
    per chunk its scores, a state slot and a decay, plus a slot and the
    carry."""
    H, P, G, N = 32, 64, 1, 128
    n, group = ss.ssd_workspace(B, S, H, P, G, N, chunk)
    nc = -(-S // chunk)
    if nc == 1:
        assert (n, group) == (B * G * chunk * chunk, 1)
    else:
        assert group == nc
        assert n == (nc * (B * G * chunk * chunk + B * H * P * N + B * H)
                     + 2 * B * H * P * N)
    assert n <= ss.WORKSPACE_FLOATS


def test_workspace_groups_long_runs_of_small_chunks():
    """Chunks of one step over 600 steps do not fit one workspace: they go
    in groups, the workspace within its bound."""
    n, group = ss.ssd_workspace(2, 600, 32, 64, 1, 128, 1)
    assert 1 <= group < 600
    assert n <= ss.WORKSPACE_FLOATS


@pytest.mark.parametrize("backend", ["auto", "ref", "chunked", "cuda"])
@pytest.mark.parametrize("S", [1, 37, 100])
def test_ragged_sequences_match_jax_ops(backend, S):
    """S not a multiple of the chunk: JAX's ``ops.ssd`` (chunked falls back
    to the oracle) against every port backend, the ``cuda`` twin padding
    its last chunk with dt = 0 steps.  y and h_T."""
    inp, h0 = _inputs(2, S, 4, 16, 2, 16, 4, init=True)
    jy, jh = jops.ssd(*_jargs(inp), initial_state=_j(h0), return_state=True,
                      policy=jops.KernelPolicy(ssd="chunked", ssd_chunk=32))
    ty, th = ops.ssd(*_targs(inp), initial_state=_t(h0), return_state=True,
                     policy=ops.KernelPolicy(ssd=backend, ssd_chunk=32))
    _close(ty, jy)
    _close(th, jh)


def test_padded_twin_leaves_the_state_unchanged():
    """The zero steps the twin (and the kernel) append are exact no-ops:
    the state after 40 steps padded to 64 equals the oracle's after 40."""
    inp, h0 = _inputs(1, 40, 2, 8, 1, 16, 5, init=True)
    ty, th = ss.ssd_scan_torch(*_targs(inp), chunk=32, initial_state=_t(h0),
                               return_state=True)
    ry, rh = ref.ssd_ref(*_targs(inp), initial_state=_t(h0),
                         return_state=True)
    assert ty.shape == ry.shape == (1, 40, 2, 8)
    _close(ty, ry)
    _close(th, rh)


def test_prefill_then_decode_chain_matches_jax():
    """Chunked prefill of 64 steps with its state carried out, then 32
    O(1) decode steps: equal to JAX's chain and to one exact scan."""
    B, S, H, P, G, N = 1, 96, 2, 8, 1, 16
    inp, _ = _inputs(B, S, H, P, G, N, 6, D=False)
    split = 64
    cut = lambda a, sl: a[:, sl]
    j, t = _jargs(inp), _targs(inp)
    jy1, jh = jops.ssd_chunked_jnp(*[cut(a, slice(0, split)) if a.ndim > 1
                                     else a for a in j[:5]], None, chunk=32,
                                   return_state=True)
    ty1, th = ops.ssd_chunked_torch(*[cut(a, slice(0, split)) if a.ndim > 1
                                      else a for a in t[:5]], None, chunk=32,
                                    return_state=True)
    _close(ty1, jy1)
    jys, tys = [jy1], [ty1]
    for s in range(split, S):
        jh, jyt = jops.ssd_decode_step(jh, j[0][:, s], j[1][:, s], j[2],
                                       j[3][:, s], j[4][:, s], None)
        th, tyt = ops.ssd_decode_step(th, t[0][:, s], t[1][:, s], t[2],
                                      t[3][:, s], t[4][:, s], None)
        _close(tyt, jyt)
        jys.append(jyt[:, None])
        tys.append(tyt[:, None])
    _close(th, jh)
    chain = torch.cat(tys, dim=1)
    _close(chain, jnp.concatenate(jys, axis=1))
    _close(chain, jref.ssd_ref(*j[:5], None))


def test_decode_step_with_groups_and_d_matches_jax():
    inp, h0 = _inputs(3, 1, 4, 8, 2, 16, 7, init=True)
    j, t = _jargs(inp), _targs(inp)
    jh, jy = jops.ssd_decode_step(_j(h0), j[0][:, 0], j[1][:, 0], j[2],
                                  j[3][:, 0], j[4][:, 0], j[5])
    th, ty = ops.ssd_decode_step(_t(h0), t[0][:, 0], t[1][:, 0], t[2],
                                 t[3][:, 0], t[4][:, 0], t[5])
    _close(th, jh)
    _close(ty, jy)


@pytest.mark.parametrize("S", [64, 65, 128])
def test_auto_on_cpu_chooses_as_jax(S):
    """Under ``auto``, CPU tensors take JAX's choice: the oracle up to 64
    steps, the chunked form above (bit for bit the chosen backend)."""
    inp, _ = _inputs(1, S, 2, 8, 1, 16, 8)
    t = _targs(inp)
    auto = ops.ssd(*t, policy=ops.KernelPolicy(ssd_chunk=32))
    want = "ref" if S <= 64 else "chunked"
    chosen = ops.ssd(*t, policy=ops.KernelPolicy(ssd=want, ssd_chunk=32))
    assert torch.equal(auto, chosen)
    other = ops.ssd(*t, policy=ops.KernelPolicy(
        ssd="chunked" if want == "ref" else "ref", ssd_chunk=32))
    if S % 32 == 0:          # the two forms differ in their last bits
        assert not torch.equal(auto, other)
    j = _jargs(inp)
    jauto = jops.ssd(*j, policy=jops.KernelPolicy(ssd_chunk=32))
    jchosen = jops.ssd(*j, policy=jops.KernelPolicy(ssd=want, ssd_chunk=32))
    np.testing.assert_array_equal(np.asarray(jauto), np.asarray(jchosen))
    _close(auto, jauto)


def test_unknown_backend_raises():
    inp, _ = _inputs(1, 4, 2, 8, 1, 16, 9)
    with pytest.raises(ValueError, match="unknown ssd backend"):
        ops.ssd(*_targs(inp), policy=ops.KernelPolicy(ssd="pallas"))


def test_wrapper_refuses_other_devices():
    """Only CPU tensors take the twin: any other device launches the kernel
    (CUDA) or raises, and never counts a launch it did not make."""
    da.reset_launches()
    meta = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ss.ssd_scan(meta(1, 4, 2, 8), meta(1, 4, 2), meta(2),
                    meta(1, 4, 1, 16), meta(1, 4, 1, 16))
    assert da.LAUNCHES["ssd"] == 0


@pytest.mark.parametrize("rows,d", [(5, 32), (3, 256)])
def test_gated_rmsnorm_matches_jax(rows, d):
    rng = np.random.default_rng(10)
    x, z = (rng.standard_normal((2, rows, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal(d).astype(np.float32)
    _close(common.gated_rmsnorm(torch.tensor(x), torch.tensor(z),
                                torch.tensor(w), 1e-6),
           jcommon.gated_rmsnorm(jnp.asarray(x), jnp.asarray(z),
                                 jnp.asarray(w), 1e-6), 1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    ty, ttail = ssm._causal_conv(torch.tensor(x), torch.tensor(w),
                                 torch.tensor(b), _t(st))
    jy, jtail = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), _j(st))
    _close(ty, jy, 1e-6)
    _close(ttail, jtail, 1e-6)
