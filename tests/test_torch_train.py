"""The PyTorch port's training path, held against the JAX package on the
CPU at smoke size in float32: AdamW for every kind, schedule, clip and
moment dtype; the losses; one train step of eight smoke configs (loss,
gradients, updated params and moments within 1e-5 of each leaf's scale),
``n_micro`` 2 and ``remat``; the plain backward twins that K4's and K9's
backward kernels mirror; ``train_step_cost``'s FLOPs against the HLO
``dot_flops`` of JAX's compiled step; the guard that keeps kernels without
a backward off a gradient; and the launcher."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.kernels import ref as jref
from repro.launch import hloparse
from repro.models import common as jcommon
from repro.optim import OptimizerConfig as JOpt
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import make_schedule as jmake_schedule
from repro.runtime import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_arch
from repro_torch.kernels import binding
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms
from repro_torch.launch import train as launch_train
from repro_torch.models import common
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               make_schedule)
from repro_torch.runtime import steps

RTOL = 1e-5
ARCHS = ["smollm-135m", "stablelm-1.6b", "h2o-danube-3-4b", "gemma2-27b",
         "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b", "llava-next-34b",
         "mamba2-370m"]
B, S, N_IMG = 4, 16, 4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _flat(tree, pre=""):
    """(path, leaf) pairs of a nested dict / list tree, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flat(t, f"{pre}/[{i}]")
    else:
        yield pre, tree


def _rel(a, b) -> float:
    """max |a - b| / max |b| (the leaf's scale)."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _close_trees(port, jax_tree, rtol=RTOL, what=""):
    want = dict(_flat(jax.tree.map(np.asarray, jax_tree)))
    got = dict(_flat(port))
    assert sorted(got) == sorted(want), what
    worst = max((_rel(got[k], want[k]), k) for k in want)
    assert worst[0] <= rtol, (what, worst)


# --------------------------------------------------------------------------
# optimizer and losses
# --------------------------------------------------------------------------
OPT_CASES = [("adamw", "cosine", 1.0, "float32"),
             ("adamw", "linear", 0.0, "bfloat16"),
             ("adamw", "constant", 0.05, "float32"),
             ("adam", "cosine", 0.05, "bfloat16"),
             ("adam", "constant", 0.0, "float32"),
             ("sgd", "linear", 1.0, "float32"),
             ("sgd", "cosine", 0.05, "bfloat16")]


@pytest.mark.parametrize("kind,schedule,clip,mdt", OPT_CASES,
                         ids=["-".join(map(str, c)) for c in OPT_CASES])
def test_adamw_matches_jax(kind, schedule, clip, mdt):
    """Three updates of a small tree (a matrix, a vector: no decay, and a
    list) from the same numpy params and gradients."""
    kw = dict(kind=kind, schedule=schedule, clip_norm=clip, moment_dtype=mdt,
              warmup_steps=2, total_steps=5, learning_rate=1e-2)
    jcfg, tcfg = JOpt(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((6, 5)).astype(np.float32),
          "norm": rng.standard_normal(5).astype(np.float32),
          "dense": [{"w": rng.standard_normal((5, 3)).astype(np.float32)}]}
    jp = jax.tree.map(jnp.asarray, p0)
    tp = common.tree_map(torch.tensor, p0)
    js, ts = jadamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
            np.float32) * (i + 1), p0)
        jp, js, jm = jadamw_update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts, tm = adamw_update(common.tree_map(torch.tensor, g), ts, tp,
                                  tcfg)
        assert _rel(tm["lr"], jm["lr"]) <= 1e-6
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-6
        _close_trees(tp, jp, what=f"params, update {i}")
        for key in ("mu", "nu"):
            if key in js:
                assert ts[key]["w"].dtype == common.dt(mdt)
                _close_trees(ts[key], js[key], what=f"{key}, update {i}")
    assert int(ts["count"]) == int(js["count"]) == 3
    sched_j, sched_t = jmake_schedule(jcfg), make_schedule(tcfg)
    for step in (0, 1, 2, 3, 5, 9):
        assert _rel(sched_t(step), sched_j(step)) <= 1e-6


def test_cross_entropy_and_shift_labels():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 4
    tokens = rng.integers(0, 11, (3, 8)).astype(np.int32)
    tokens[1, 3] = 0                                   # a pad label
    ji, jl, jmask = jcommon.shift_labels(jnp.asarray(tokens))
    ti, tl, tmask = common.shift_labels(torch.tensor(tokens))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for mask in (None, (jmask, tmask)):
        want = jcommon.cross_entropy(jnp.asarray(logits), jl,
                                     None if mask is None else mask[0])
        got = common.cross_entropy(torch.tensor(logits), tl,
                                   None if mask is None else mask[1])
        assert _rel(got, want) <= 1e-6
    tree = {"a": torch.zeros(2, 3), "b": [torch.zeros(4, dtype=torch.bfloat16)]}
    assert common.tree_count(tree) == 10
    assert common.tree_size_bytes(tree) == 2 * 3 * 4 + 4 * 2


# --------------------------------------------------------------------------
# the train step against JAX's, and its cost against JAX's HLO
# --------------------------------------------------------------------------
def _configs(arch):
    return (dataclasses.replace(jax_arch(arch).smoke, dtype="float32"),
            dataclasses.replace(get_arch(arch).smoke, dtype="float32"))


def _batch(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.integers(0, cfg.vocab_size, (batch, S)).astype(
               np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (batch, S)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (batch, N_IMG, cfg.d_model)).astype(np.float32)
    return out


# the optimizer of the step tests: no clipping, so that JAX's first moment
# is (1 - b1) times its raw gradient
STEP_OPT = dict(clip_norm=0.0, warmup_steps=2, total_steps=10)
_COMPILED = {}


def _jax_step(arch, n_micro=1):
    """JAX's train step for ``arch``'s smoke config, compiled once per
    module, with its initial state and batch."""
    key = (arch, n_micro)
    if key not in _COMPILED:
        jcfg, _ = _configs(arch)
        jsc = jsteps.StepConfig(n_micro=n_micro, remat="none",
                                optimizer=JOpt(**STEP_OPT))
        state, _ = jsteps.init_train_state(jax.random.PRNGKey(1), jcfg, jsc)
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
        compiled = jax.jit(jsteps.make_train_step(jcfg, jsc)).lower(
            state, batch).compile()
        _COMPILED[key] = (compiled, state, batch)
    return _COMPILED[key]


STEP_OPT_EPS = JOpt().eps


def _close_params(tnew, jnew, lr, eps):
    """The updated params, each element within 1e-5 of its leaf's scale
    plus what Adam's first step makes of the two gradients' difference.
    At count 1 the step is lr g / (|g| + eps) (+ decay), whose slope is at
    most lr / eps, largest for a gradient near eps: there a gradient that
    agrees within 1e-7 of its leaf's scale moves the update by up to lr /
    eps times that difference.  The gradients are held to 1e-5 on their
    own (the first moments)."""
    b1 = JOpt().b1
    tg = dict(_flat(tnew["opt"]["mu"]))
    jg = dict(_flat(jax.tree.map(np.asarray, jnew["opt"]["mu"])))
    for key, want in _flat(jax.tree.map(np.asarray, jnew["params"])):
        got = _np(dict(_flat(tnew["params"]))[key])
        dg = np.abs(_np(tg[key]) - _np(jg[key])) / (1 - b1)
        allowed = RTOL * np.max(np.abs(want)) + lr / eps * dg
        assert np.all(np.abs(got - want) <= allowed), key


@pytest.mark.parametrize("arch,n_micro",
                         [(a, 1) for a in ARCHS] + [("smollm-135m", 2)])
def test_train_step_matches_jax(arch, n_micro):
    """One step from the same initial state: the loss, every gradient
    (JAX's through its first moment, (1 - b1) g) and both moments, each
    leaf within 1e-5 of its scale; the updated params as
    ``_close_params`` says."""
    compiled, jstate, jbatch = _jax_step(arch, n_micro)
    _, tcfg = _configs(arch)
    tsc = steps.StepConfig(n_micro=n_micro, remat="none",
                           optimizer=OptimizerConfig(**STEP_OPT))
    tstate = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                           tcfg, "cpu")
    batch = {k: np.asarray(v) for k, v in jbatch.items()}
    jnew, jm = compiled(jstate, jbatch)
    if n_micro == 1:
        loss, grads = steps.make_loss_and_grads(tcfg, tsc)(
            tstate["params"], torch.tensor(batch["inputs"]),
            torch.tensor(batch["targets"]),
            torch.tensor(batch["image_embeds"]) if "image_embeds" in batch
            else None)
        jgrads = jax.tree.map(lambda m: np.asarray(m) / (1 - JOpt().b1),
                              jnew["opt"]["mu"])
        _close_trees(grads, jgrads, what=f"{arch} gradients")
        assert _rel(loss, jm["loss"]) <= RTOL
    tnew, tm = steps.make_train_step(tcfg, tsc)(tstate, batch)
    assert _rel(tm["loss"], jm["loss"]) <= RTOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= RTOL
    _close_params(tnew, jnew, float(jm["lr"]), STEP_OPT_EPS)
    for key in ("mu", "nu"):
        _close_trees(tnew["opt"][key], jnew["opt"][key], what=f"{arch} {key}")
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert all(p.requires_grad for p in common.tree_leaves(tnew["params"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_cost_matches_hlo(arch):
    """train_step_cost's FLOPs equal the HLO dot_flops of JAX's compiled
    step (remat none) at the step tests' shapes."""
    compiled, _, _ = _jax_step(arch)
    _, tcfg = _configs(arch)
    seq = S + (N_IMG if tcfg.family == "vlm" else 0)
    flops, nbytes = launch_train.train_step_cost(tcfg, B, seq)
    assert flops == hloparse.analyze(compiled.as_text())["dot_flops"]
    assert nbytes > 0


def test_train_step_cost_smollm_smoke():
    """smollm's smoke config at the launcher's 8 x 64: 6 N T (N = 311,296
    matmul weights, the tied head included; T = 512) plus 3 x the two
    layers' 4 B S^2 Hq D, as JAX's HLO reads it."""
    cfg = get_arch("smollm-135m").smoke
    want = 6 * 311_296 * 512 + 3 * 2 * 4 * 8 * 64 ** 2 * 4 * 32
    assert want == 1_056_964_608
    assert launch_train.train_step_cost(cfg, 8, 64)[0] == want
    assert launch_train.train_step_cost(cfg, 8, 64, n_micro=2)[0] == want


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-27b"])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_equals_none(arch, remat):
    _, tcfg = _configs(arch)
    gen = torch.Generator().manual_seed(5)
    params = bridge.init_lm(tcfg, gen, "cpu", master=True)
    for p in common.tree_leaves(params):
        p.requires_grad_(True)
    batch = _batch(tcfg, seed=6)
    args = (params, torch.tensor(batch["inputs"]),
            torch.tensor(batch["targets"]))
    out = {}
    for mode in ("none", remat):
        fn = steps.make_loss_and_grads(tcfg, steps.StepConfig(remat=mode))
        out[mode] = fn(*args)
    assert torch.equal(out["none"][0], out[remat][0])
    for (k, a), (_, b) in zip(_flat(out["none"][1]), _flat(out[remat][1])):
        assert torch.allclose(a, b, rtol=0, atol=1e-7), k


# --------------------------------------------------------------------------
# the plain backward twins the kernels mirror
# --------------------------------------------------------------------------
# (B, Sq, Sk, Hq, Hkv, D, Dv, keyword arguments)
ATTN_CASES = [
    (2, 24, 24, 6, 2, 16, 16, {}),
    (2, 24, 24, 6, 2, 16, 16, {"window": 5, "logit_cap": 3.0}),
    (1, 20, 20, 4, 1, 16, 16, {"logit_cap": 2.0, "scale": 0.4}),   # G 4
    (1, 17, 17, 7, 1, 8, 8, {}),                                    # G 7
    (2, 16, 16, 3, 3, 24, 16, {"scale": 24 ** -0.5}),    # (D, Dv), G 1
    (1, 9, 30, 6, 2, 16, 16, {"q_offset": 21, "window": 12}),
    (1, 12, 12, 4, 2, 8, 8, {"causal": False}),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(
    map(str, c[:7])) + "".join(f"-{k}{v}" for k, v in c[7].items()))
def test_attention_backward_twin(case):
    """K4's backward twin (p from the saved lse) against torch.autograd of
    the plain forward, jax.grad of ``repro.kernels.ref.attention_ref`` and
    ``FlashAttentionFn`` run through autograd on CPU tensors."""
    Bb, Sq, Sk, Hq, Hkv, D, Dv, kw = case
    rng = np.random.default_rng(Sq * 7 + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((Bb, Sq, Hq, D), (Bb, Sk, Hkv, D), (Bb, Sk, Hkv, Dv)))
    dout = rng.standard_normal((Bb, Sq, Hq, Dv)).astype(np.float32)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    plain = ops.flash_attention_torch(tq, tk, tv, q_chunk=8, k_chunk=8, **kw)
    want = torch.autograd.grad(plain, (tq, tk, tv), torch.tensor(dout))
    out, lse = fa.attention_lse_torch(tq.detach(), tk.detach(), tv.detach(),
                                      **kw)
    assert _rel(out, plain) <= 1e-6
    twin = fa.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out,
                                  lse, torch.tensor(dout), **kw)
    fn_kw = dict(causal=True, window=0, logit_cap=0.0, scale=None,
                 q_offset=0)
    fn_kw.update(kw)
    via_fn = torch.autograd.grad(
        fa.FlashAttentionFn.apply(tq, tk, tv, *fn_kw.values()), (tq, tk, tv),
        torch.tensor(dout))
    jgrads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jref.attention_ref(
        a, b, c, **kw) * dout), argnums=(0, 1, 2)))(q, k, v)
    for got, ref_t, ref_j in zip(twin, want, jgrads):
        assert _rel(got, ref_t) <= 1e-5
        assert _rel(got, ref_j) <= 1e-5
    for got, ref_t in zip(via_fn, want):
        assert _rel(got, ref_t) <= 1e-5


@pytest.mark.parametrize("gemma", [False, True], ids=["plain", "gemma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_backward_twin(gemma, dtype):
    """K9's backward twin (dx and d scale from the saved rstd) against
    torch.autograd of the plain forward (in its dtype), jax.grad of
    ``repro.kernels.ref.rmsnorm_ref`` (fp32) and ``RMSNormFn`` through
    autograd on CPU tensors."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 64)).astype(np.float32)
    tdt = common.dt(dtype)
    tx = torch.tensor(x).to(tdt).requires_grad_(True)
    tw = torch.tensor(w, requires_grad=True)
    tdy = torch.tensor(dy).to(tdt)
    want = torch.autograd.grad(common.rmsnorm(tx, tw, 1e-6, gemma_style=gemma),
                               (tx, tw), tdy)
    out, rstd = rms.rmsnorm_rstd_torch(tx.detach(), tw.detach(), 1e-6, gemma)
    twin = rms.rmsnorm_bwd(tx.detach(), tw.detach(), tdy, rstd,
                           gemma_style=gemma)
    via_fn = torch.autograd.grad(rms.RMSNormFn.apply(tx, tw, 1e-6, gemma),
                                 (tx, tw), tdy)
    tol = 1e-5 if dtype == "float32" else 1e-2
    for got, ref_t, fn in zip(twin, want, via_fn):
        assert got.dtype == ref_t.dtype
        assert _rel(got, ref_t) <= tol
        assert torch.equal(fn, got)
    if dtype == "float32":
        jgrads = jax.jit(jax.grad(lambda a, b: jnp.sum(jref.rmsnorm_ref(
            a, b, gemma_style=gemma) * dy), argnums=(0, 1)))(x, w)
        for got, ref_j in zip(twin, jgrads):
            assert _rel(got, ref_j) <= 1e-5


def test_refuse_grad_guard():
    """The guard of K8 and the decode, verify and latent sweeps: it raises,
    naming the kernel, for an input that requires grad while grad mode is
    on, and lets everything else through."""
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="ssd_scan: no backward kernel"):
        binding.refuse_grad("ssd_scan", None, torch.zeros(2), x)
    binding.refuse_grad("ssd_scan", torch.zeros(2), None)
    with torch.no_grad():
        binding.refuse_grad("paged_attention_sweep", x)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launcher_trains_and_restores(tmp_path, capsys):
    """``--smoke --device cpu --frost``: the [train], [frost] and
    [frost-ctrl] lines, a loss that falls, and a node that goes silent at
    step 3 restored from the checkpoint of step 2."""
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps",
            "5", "--frost", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--fail-at", "3"]
    rep = launch_train.train(launch_train.build_parser().parse_args(argv))
    out = capsys.readouterr().out
    for tag in ("[train] arch=smollm-135m-smoke", "[frost] selected cap",
                "[frost-ctrl]", "steps/s", "tokens/s", "1 restarts"):
        assert tag in out, tag
    assert rep["restarts"] == 1
    assert rep["losses"][-1] < rep["losses"][0]
    assert (tmp_path / "step_00000002" / "_COMMITTED").exists()
