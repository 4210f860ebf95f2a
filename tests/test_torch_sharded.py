"""Sharded execution of the PyTorch port on the CPU: a (2, 2) ("data",
"model") mesh of four gloo ranks, held against the port's one-rank run
and JAX's unsharded step at the smoke configs in float32.

One module-scoped spawn runs every sharded case (this file is also the
ranks' program: ``python tests/test_torch_sharded.py DIR`` under
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``), each rank
on one torch thread:

  * one train step of smollm-135m, h2o-danube-3-4b, phi3.5-moe,
    mamba2-370m and zamba2-1.2b (and smollm at ``n_micro`` 2) from JAX's
    initial state: loss, gradient norm, the gathered params and first
    moments against the one-rank port and JAX's compiled
    ``make_train_step``; the SSM families' at a sequence of two SSD
    chunks of the chunked scan, in both packages;
  * prefill and greedy decode over the sharded ring caches, against the
    one-rank port and JAX's compiled prefill and serve steps: the
    attention smoke configs have one kv head, so their ring's capacity
    goes over "model" (h2o's windowed ring of 16 slots too); a copy of
    h2o's smoke config with two kv heads, given to both packages, puts
    the heads over "model" instead; mamba2's and zamba2's SSM state goes
    over "model" by heads, zamba2's shared block's rings by its four kv
    heads, and those of a copy with one kv head (``zamba2-kv1``) by
    capacity; each prefill's cache, gathered, against the one-rank
    cache;
  * the serve launcher's static batch under the ranks (a 1-D "data"
    mesh of four), with requests that divide over the ranks and requests
    that do not, against its one-rank run, and mamba2's;
  * ``ShardingRules.constrain`` laying an activation out on the live
    mesh, and ``make_run_ctx`` refusing, by name, what is not ported.

In-process cases hold the capacity-shard ring sweep's plain version plus
``lse_merge_torch`` against the whole ring's sweep."""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ATOL = 1e-5
MESH = (2, 2)
TRAIN = [("smollm-135m", 1), ("h2o-danube-3-4b", 1),
         ("phi3.5-moe-42b-a6.6b", 1), ("smollm-135m", 2),
         ("mamba2-370m", 1), ("zamba2-1.2b", 1)]
DECODE = ["smollm-135m", "h2o-danube-3-4b", "phi3.5-moe-42b-a6.6b",
          "h2o-kv2", "mamba2-370m", "zamba2-1.2b", "zamba2-kv1"]
# the ring whose capacity goes over "model", and its length
RING_CUT = {"smollm-135m": ("sub0", 48), "h2o-danube-3-4b": ("sub0", 16),
            "phi3.5-moe-42b-a6.6b": ("sub0", 48),
            "zamba2-kv1": ("shared", 48)}
REFUSED = {"deepseek-v2-236b": "use_mla", "musicgen-medium": "n_codebooks",
           "llava-next-34b": "vision_tokens"}
B, S = 4, 16                   # the train batch
SSD_CHUNK = 16                 # the SSM train cases: S = 2 chunks
PROMPT, GEN, MAX_LEN = 12, 8, 48
SERVE_REQUESTS = (4, 3)        # rows cut over the ranks; rows whole
STEP_OPT = dict(clip_norm=0.0, warmup_steps=2, total_steps=10)


VARIANTS = {"h2o-kv2": ("h2o-danube-3-4b", 2),
            "zamba2-kv1": ("zamba2-1.2b", 1)}


def _cfg(name: str, pkg: str):
    """``name``'s smoke config of the port or of JAX in float32;
    ``h2o-kv2`` is h2o's with two kv heads (heads over "model"),
    ``zamba2-kv1`` zamba2's with one (its shared rings' capacity over
    "model")."""
    if pkg == "jax":
        from repro.configs import get_arch
    else:
        from repro_torch.configs import get_arch
    arch, kv = VARIANTS.get(name, (name, None))
    cfg = dataclasses.replace(get_arch(arch).smoke, dtype="float32")
    if kv is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    return cfg


def _seq(cfg) -> int:
    return 2 * SSD_CHUNK if cfg.uses_ssm else S


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (B, _seq(cfg))).astype(
        np.int32) for k in ("inputs", "targets")}


def _prompt(cfg, seed=5):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)


def _step_cfg(n_micro=1, ssm=False):
    """The port's step config; ``ssm``: the chunked SSD scan at
    ``SSD_CHUNK``, as :func:`_jax_step_cfg` runs JAX's."""
    from repro_torch.kernels.ops import KernelPolicy
    from repro_torch.optim import OptimizerConfig
    from repro_torch.runtime import steps
    policy = KernelPolicy(ssd="chunked", ssd_chunk=SSD_CHUNK) if ssm \
        else KernelPolicy()
    return steps.StepConfig(n_micro=n_micro, remat="none",
                            kernel_policy=policy,
                            optimizer=OptimizerConfig(**STEP_OPT))


def _jax_step_cfg(n_micro=1, ssm=False):
    from repro.kernels.ops import KernelPolicy
    from repro.optim import OptimizerConfig as JOpt
    from repro.runtime import steps as jsteps
    policy = KernelPolicy(ssd="chunked", ssd_chunk=SSD_CHUNK) if ssm \
        else KernelPolicy()
    return jsteps.StepConfig(n_micro=n_micro, remat="none",
                             kernel_policy=policy, optimizer=JOpt(**STEP_OPT))


# --------------------------------------------------------------------------
# the runs: the same code on one rank (rules None) and on every rank
# --------------------------------------------------------------------------
def train_run(arch, n_micro, jstate, batch, rules=None):
    """One train step from JAX's state: (loss, grad_norm, params, mu), the
    trees whole (gathered over the mesh)."""
    from repro_torch import bridge
    from repro_torch.runtime import sharding, steps
    cfg = _cfg(arch, "torch")
    state = bridge.train_state_from_numpy(jstate, cfg, "cpu", rules)
    new, m = steps.make_train_step(cfg, _step_cfg(n_micro, cfg.uses_ssm),
                                   rules)(state, batch)
    params, mu = new["params"], new["opt"]["mu"]
    if rules is not None:
        specs = rules.param_sharding(bridge.param_axes(cfg))
        params = sharding.gather_params(params, specs, rules.mesh)
        mu = sharding.gather_params(mu, specs, rules.mesh)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _numpy(params), "mu": _numpy(mu)}


def decode_run(name, jparams, prompt, rules=None):
    """Prefill, then GEN greedy serve steps: the logits of every step
    (whole batch, whole vocab), the tokens, the ring's shard record and
    the prefill's cache, whole."""
    from repro_torch import bridge
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime import sharding, steps
    cfg = _cfg(name, "torch")
    sc = _step_cfg()
    params = bridge.params_from_numpy(jparams, cfg, "cpu", rules)
    prefill = steps.make_prefill_step(cfg, sc, max_len=MAX_LEN, rules=rules)
    serve = steps.make_serve_step(cfg, sc, rules, greedy=False)
    group = None if rules is None else rules.mesh.group("data")

    def whole(x):          # this rank's batch rows -> the whole batch
        return x if len(x) == len(prompt) else col._all_gather(x, 0, group)

    with torch.no_grad():
        last, cache = prefill(params, {"inputs": torch.tensor(prompt)})
        filled = cache if rules is None else sharding.gather_cache(
            cache, rules, cfg, batch=len(prompt), max_len=MAX_LEN)
        filled = _numpy({k: v for k, v in filled.items() if k != "pos"})
        logits = [whole(last)]
        tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None]
        toks = [tok]
        for _ in range(GEN):
            lg, cache = serve(params, cache, tok)
            logits.append(whole(lg[:, -1]))
            tok = torch.argmax(logits[-1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
    return {"logits": np.stack([x.numpy() for x in logits]),
            "tokens": torch.cat(toks, dim=1).numpy(),
            "shard": cache.get("shard"), "cache": filled}


def serve_run(requests, arch="smollm-135m"):
    """The serve launcher's static batch of ``arch``'s fp32 smoke config:
    the generated tokens, whole."""
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--requests", str(requests), "--prompt-len",
         "8", "--gen", "6", "--decode-chunk", "2", "--no-frost"])
    with torch.no_grad():
        return serve.serve(args, _cfg(arch, "torch"))["tokens"]


def refuse_run(mesh):
    """``make_run_ctx`` on the live mesh for each config whose sharded
    execution is not ported: {arch: the refusal's message}."""
    from repro_torch.configs import get_arch
    from repro_torch.runtime import sharding, steps
    out = {}
    for arch in REFUSED:
        cfg = get_arch(arch).smoke
        try:
            steps.make_run_ctx(cfg, steps.StepConfig(),
                               sharding.build_rules(cfg, mesh))
            out[arch] = None
        except NotImplementedError as e:
            out[arch] = str(e)
    return out


def jax_decode_run(name, jparams, prompt):
    """JAX's unsharded compiled prefill and GEN greedy serve steps on the
    same params and prompt: every step's logits and the tokens."""
    import jax
    import jax.numpy as jnp

    from repro.runtime import steps as jsteps
    jcfg = _cfg(name, "jax")
    jsc = _jax_step_cfg()
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, jsc, max_len=MAX_LEN))
    serve = jax.jit(jsteps.make_serve_step(jcfg, jsc, greedy=False))
    params = jax.tree.map(jnp.asarray, jparams)
    last, cache = prefill(params, {"inputs": jnp.asarray(prompt)})
    logits = [np.asarray(last)]
    toks = [np.argmax(logits[-1], axis=-1).astype(np.int32)[:, None]]
    for _ in range(GEN):
        lg, cache = serve(params, cache, jnp.asarray(toks[-1]))
        logits.append(np.asarray(lg[:, -1]))
        toks.append(np.argmax(logits[-1], axis=-1).astype(np.int32)[:, None])
    return {"logits": np.stack(logits), "tokens": np.concatenate(toks, 1)}


def _numpy(tree):
    from repro_torch.models import common
    return common.tree_map(lambda t: t.detach().numpy().copy(), tree)


def constrain_run(mesh):
    """``constrain`` on the live mesh: a replicated (B, S, H, hd) laid out
    with its heads over "model" is this rank's heads; laid back out
    replicated it is the whole again; and a dim the spec leaves alone is
    untouched."""
    from repro_torch.launch import mesh as tmesh  # noqa: F401
    from repro_torch.runtime import sharding
    cfg = _cfg("smollm-135m", "torch")
    rules = sharding.build_rules(cfg, mesh)
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    mine = sharding.shard_index(mesh, "model")
    heads = rules.constrain(x, ("batch", None, "q_heads", None))
    back = rules.constrain(heads, ("batch", None, None, None),
                           held=(None, None, "model", None))
    same = rules.constrain(heads, ("batch", None, "q_heads", None),
                           held=(None, None, "model", None))
    return {"split": bool(torch.equal(heads, x[:, :, 2 * mine:2 * mine + 2])),
            "gathered": bool(torch.equal(back, x)),
            "held": same is heads}


def worker(path: str) -> None:
    """One rank: every sharded case, results written by rank 0."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import sharding
    with open(os.path.join(path, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    mesh = tmesh.make_host_mesh("cpu", axes=("data", "model"), shape=MESH)
    out = {"train": {}, "decode": {}, "constrain": constrain_run(mesh),
           "refuse": refuse_run(mesh)}
    for arch, n_micro in TRAIN:
        rules = sharding.build_rules(_cfg(arch, "torch"), mesh)
        out["train"][arch, n_micro] = train_run(
            arch, n_micro, inputs["train"][arch], inputs["batch"][arch],
            rules)
    for name in DECODE:
        rules = sharding.build_rules(_cfg(name, "torch"), mesh)
        out["decode"][name] = decode_run(name, inputs["params"][name],
                                         inputs["prompt"][name], rules)
    out["serve"] = {n: serve_run(n) for n in SERVE_REQUESTS}
    out["serve_mamba2"] = serve_run(SERVE_REQUESTS[0], "mamba2-370m")
    if torch.distributed.get_rank() == 0:
        with open(os.path.join(path, "out.pkl"), "wb") as f:
            pickle.dump(out, f)
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------
# fixtures: JAX's states and steps, the one-rank runs, the spawn
# --------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(path):
    """The four ranks, started on ``path``'s inputs (this file is their
    program), each on one torch thread."""
    n = MESH[0] * MESH[1]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(path)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]


def _wait(procs, path):
    """Rank 0's results; a rank that fails (or passes 300 s) fails every
    case."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    assert not bad, (bad, [log[-3000:] for log in logs])
    with open(path / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the file: JAX's initial states (numpy), batches, its
    init_lm params for the decode cases and the prompts; the four ranks'
    sharded runs, started first and running while JAX's compiled steps
    and the port's one-rank runs of the same cases are computed here."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as jtfm
    from repro.runtime import steps as jsteps
    inputs = {"train": {}, "batch": {}, "params": {}, "prompt": {}}
    for arch, _ in TRAIN:
        jcfg = _cfg(arch, "jax")
        state, _ = jsteps.init_train_state(jax.random.PRNGKey(1), jcfg,
                                           _jax_step_cfg())
        inputs["train"][arch] = jax.tree.map(np.asarray, state)
        inputs["batch"][arch] = _batch(jcfg)
    for name in DECODE:
        jcfg = _cfg(name, "jax")
        params = jax.jit(lambda key: jtfm.init_lm(key, jcfg)[0])(
            jax.random.PRNGKey(0))
        inputs["params"][name] = jax.tree.map(np.asarray, params)
        inputs["prompt"][name] = _prompt(jcfg)
    path = tmp_path_factory.mktemp("sharded")
    with open(path / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = _spawn(path)
    out = {"jax": {}, "jax_decode": {},
           "one_rank": {"train": {}, "decode": {}}}
    try:
        for arch, n_micro in TRAIN:
            jcfg = _cfg(arch, "jax")
            jsc = _jax_step_cfg(n_micro, jcfg.uses_ssm)
            new, m = jax.jit(jsteps.make_train_step(jcfg, jsc))(
                jax.tree.map(jnp.asarray, inputs["train"][arch]),
                {k: jnp.asarray(v) for k, v in inputs["batch"][arch].items()})
            out["jax"][arch, n_micro] = (jax.tree.map(np.asarray, new),
                                         jax.tree.map(float, m))
        for name in DECODE:
            out["jax_decode"][name] = jax_decode_run(
                name, inputs["params"][name], inputs["prompt"][name])
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        for arch, n_micro in TRAIN:
            out["one_rank"]["train"][arch, n_micro] = train_run(
                arch, n_micro, inputs["train"][arch], inputs["batch"][arch])
        for name in DECODE:
            out["one_rank"]["decode"][name] = decode_run(
                name, inputs["params"][name], inputs["prompt"][name])
        out["one_rank"]["serve"] = {n: serve_run(n) for n in SERVE_REQUESTS}
        out["one_rank"]["serve_mamba2"] = serve_run(SERVE_REQUESTS[0],
                                                    "mamba2-370m")
        torch.set_num_threads(n)
    finally:
        out["sharded"] = _wait(procs, path)
    return out


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------
def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flat(t, f"{pre}/[{i}]")
    else:
        yield pre, np.asarray(tree, dtype=np.float32)


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _close_step(got, want_params, want_mu, loss, gnorm, lr):
    """Loss and gradient norm within 1e-5 (relative); each first moment
    within 1e-5 of its leaf's scale; each param within 1e-5 of its leaf's
    scale plus Adam's first-step slope lr / eps times the gradients'
    difference (``tests/test_torch_train.py``'s ``_close_params``)."""
    from repro_torch.optim import OptimizerConfig
    opt = OptimizerConfig()
    assert abs(got["loss"] - loss) <= ATOL * abs(loss)
    assert abs(got["grad_norm"] - gnorm) <= ATOL * abs(gnorm)
    mus, wmu = dict(_flat(got["mu"])), dict(_flat(want_mu))
    assert sorted(mus) == sorted(wmu)
    for key, w in wmu.items():
        assert _rel(mus[key], w) <= ATOL, key
    params = dict(_flat(got["params"]))
    for key, w in _flat(want_params):
        dg = np.abs(mus[key] - wmu[key]) / (1 - opt.b1)
        allowed = ATOL * np.max(np.abs(w)) + lr / opt.eps * dg
        assert np.all(np.abs(params[key] - w) <= allowed), key


@pytest.mark.parametrize("arch,n_micro", TRAIN,
                         ids=[f"{a}-micro{m}" for a, m in TRAIN])
def test_sharded_train_step_matches_one_rank(runs, arch, n_micro):
    ref = runs["one_rank"]["train"][arch, n_micro]
    lr = runs["jax"][arch, n_micro][1]["lr"]
    _close_step(runs["sharded"]["train"][arch, n_micro], ref["params"],
                ref["mu"], ref["loss"], ref["grad_norm"], lr)


@pytest.mark.parametrize("arch,n_micro", TRAIN,
                         ids=[f"{a}-micro{m}" for a, m in TRAIN])
def test_sharded_train_step_matches_jax(runs, arch, n_micro):
    new, m = runs["jax"][arch, n_micro]
    _close_step(runs["sharded"]["train"][arch, n_micro], new["params"],
                new["opt"]["mu"], m["loss"], m["grad_norm"], m["lr"])


@pytest.mark.parametrize("name", DECODE)
def test_sharded_decode_matches_one_rank(runs, name):
    """Prefill and 8 decode steps: every step's logits within 1e-5, the
    greedy tokens equal; the ring's layout as the rules resolve it."""
    got = runs["sharded"]["decode"][name]
    want = runs["one_rank"]["decode"][name]
    assert got["logits"].shape == want["logits"].shape
    assert float(np.max(np.abs(got["logits"] - want["logits"]))) <= ATOL
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    if name in RING_CUT:                       # one kv head: the capacity
        ring, cap = RING_CUT[name]
        assert sorted(got["shard"]) == [ring]
        assert got["shard"][ring][1] == cap
    else:                                      # heads over "model", or
        assert got["shard"] is None            # no ring


@pytest.mark.parametrize("name", DECODE)
def test_sharded_prefill_cache_gathers_to_one_rank(runs, name):
    """Each rank's part of the prefill's cache (its rows, its kv or SSM
    heads, its slots of a ring cut by capacity, its conv channels in the
    compute layout), gathered, equals the one-rank cache within 1e-5."""
    got = dict(_flat(runs["sharded"]["decode"][name]["cache"]))
    want = dict(_flat(runs["one_rank"]["decode"][name]["cache"]))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        assert float(np.max(np.abs(got[key] - w))) <= ATOL, key


@pytest.mark.parametrize("name", DECODE)
def test_sharded_decode_matches_jax(runs, name):
    """The same decode against JAX's unsharded compiled prefill and serve
    steps on the same params, prompt and config: every step's logits
    within 1e-5, the greedy tokens equal."""
    got = runs["sharded"]["decode"][name]
    want = runs["jax_decode"][name]
    assert got["logits"].shape == want["logits"].shape
    assert float(np.max(np.abs(got["logits"] - want["logits"]))) <= ATOL
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("requests", SERVE_REQUESTS)
def test_sharded_serve_batch_matches_one_rank(runs, requests):
    """The serve launcher's static batch over four ranks returns the
    one-rank run's tokens, whole: rows cut over the ranks (4 requests)
    and rows every rank decodes (3 requests, which do not divide)."""
    got = runs["sharded"]["serve"][requests]
    want = runs["one_rank"]["serve"][requests]
    assert got.shape == want.shape == (requests, 6)
    np.testing.assert_array_equal(got, want)


def test_sharded_serve_batch_mamba2_matches_one_rank(runs):
    """mamba2's static batch under the four ranks, rows cut over them,
    returns the one-rank run's tokens."""
    got = runs["sharded"]["serve_mamba2"]
    want = runs["one_rank"]["serve_mamba2"]
    assert got.shape == want.shape == (SERVE_REQUESTS[0], 6)
    np.testing.assert_array_equal(got, want)


def test_sharded_blockers_name_what_is_not_ported():
    """mamba2 and zamba2 run sharded; deepseek, musicgen and llava are
    refused by name."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    names = {a: tfm.sharded_blockers(get_arch(a).config)
             for a in ("mamba2-370m", "zamba2-1.2b", *REFUSED)}
    assert names["mamba2-370m"] == names["zamba2-1.2b"] == ()
    assert {"use_mla", "first_dense_layers"} <= set(
        names["deepseek-v2-236b"])
    assert "n_codebooks" in names["musicgen-medium"]
    assert "vision_tokens" in names["llava-next-34b"]


@pytest.mark.parametrize("arch", list(REFUSED))
def test_make_run_ctx_refuses_on_the_live_mesh(runs, arch):
    msg = runs["sharded"]["refuse"][arch]
    assert msg is not None and REFUSED[arch] in msg


def test_constrain_lays_out_on_the_live_mesh(runs):
    assert runs["sharded"]["constrain"] == {"split": True, "gathered": True,
                                            "held": True}


@pytest.mark.parametrize("H,N", [(16, 128), (32, 64)],
                         ids=["mamba2-local", "zamba2-local"])
def test_local_conv_views_are_read_in_place(H, N):
    """A rank's conv output in the compute layout (its x channels, then B
    and C) at the sharded train step's local widths: K8 reads the views
    the model takes of it (x as (B, S, H, P), B as (B, S, 1, N)) in
    place, with no copy."""
    from repro_torch.kernels import ssd_scan as ss
    Bl, S, P = 4, 128, 64
    conv = torch.zeros((Bl, S, H * P + 2 * N))
    for t, width in ((conv[..., :H * P].reshape(Bl, S, H, P), P),
                     (conv[..., H * P:H * P + N].reshape(Bl, S, 1, N), N)):
        got, row_stride = ss._rows(t, S, width)
        assert got.data_ptr() == t.data_ptr()
        assert row_stride == H * P + 2 * N


# --------------------------------------------------------------------------
# the capacity-shard sweep's plain version, in process
# --------------------------------------------------------------------------
SWEEPS = {"window": dict(pos=37, window=5), "cap": dict(pos=29, cap=30.0),
          "wrapped": dict(pos=70), "empty-shard": dict(pos=3),
          "splits": dict(pos=45, n_splits=3, block_k=4)}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_capacity_shard_sweep_merges_to_the_ring(case):
    """A ring of 32 slots cut into 2 or 4 shards: each shard swept into
    unmerged partials at its slot offset, the shards' partials merged by
    ``lse_merge_torch``, equal the whole ring's sweep within 1e-5; a
    shard with no visible slot gives ``lse = NEG_INF``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.ref import NEG_INF
    kw = SWEEPS[case]
    rng = np.random.default_rng(11)
    Bq, C, Hq, Hkv, D = 2, 32, 4, 2, 16
    q = torch.tensor(rng.standard_normal((Bq, 1, Hq, D)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((Bq, C, Hkv, D)),
                         dtype=torch.float32) for _ in range(2))
    pos = torch.tensor([kw["pos"]], dtype=torch.int32)
    common = dict(window=kw.get("window", 0), logit_cap=kw.get("cap", 0.0),
                  block_k=kw.get("block_k", 256))
    whole = da.ring_attention_sweep_torch(q, k, v, pos, **common)
    for n in (2, 4):
        Cl = C // n
        parts = [da.ring_attention_sweep_torch(
            q, k[:, r * Cl:(r + 1) * Cl], v[:, r * Cl:(r + 1) * Cl], pos,
            slot_offset=r * Cl, ring_len=C, partials=True,
            n_splits=kw.get("n_splits", 1), **common) for r in range(n)]
        partial = torch.cat([p for p, _ in parts], dim=2)
        lse = torch.cat([s for _, s in parts], dim=2)
        got = da.lse_merge_torch(partial, lse, q.dtype).transpose(1, 2)
        assert float((got - whole).abs().max()) <= ATOL
        if case == "empty-shard":
            assert bool((parts[-1][1] == NEG_INF).all())
    one = da.ring_attention_sweep_torch(q, k, v, pos, slot_offset=0,
                                        ring_len=C, **common)
    assert torch.equal(one, whole)


if __name__ == "__main__":
    worker(sys.argv[1])
