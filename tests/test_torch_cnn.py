"""The CNN zoo's mini-library, bridge and train step in the PyTorch port
(``repro_torch.models.cnn``, ``repro_torch.bridge``), held against the
JAX package's ``repro.models.cnn`` on the CPU, on numpy inputs from a
seed, in float32 within 1e-5 of each output's scale:

* ``conv`` against ``lax.conv_general_dilated`` at strides 1 and 2, k 1,
  3, 5 and 7, even and odd sizes, SAME and VALID, groups 1, 2 and c (XLA's
  SAME pads the odd element after, which ``same_pads`` must reproduce);
* ``bn`` (forward and gradient), ``maxpool``, ``avgpool``, GoogLeNet's
  SAME pool, ``_channel_shuffle`` and LeNet's NHWC flatten;
* ``cnn_params_from_numpy`` over trees with ``None`` slots, and its
  refusals; ``init_cnn``'s shapes against ``jax.eval_shape`` for all 16
  models, its scales, and its refusal of a missing card;
* PreActResNet18's unread leaves (``stem.bn``, every ``short.bn``) get
  zero gradients;
* one train step (``loss_and_grads``, then ``adamw_update`` with the
  paper benchmark's optimizer) equal to JAX's for LeNet in float32 and
  float64 and for ResNet18 and PreActResNet18 in float64 (in float32
  their gradients are ill-conditioned at a small batch; see
  ``test_torch_cnn_zoo.py``), at the zoo tests' batch, params within the
  Adam-eps bound of ``tests/test_torch_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CifarBatches
from repro.models import cnn as jcnn
from repro.optim import OptimizerConfig as JOpt
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch import bridge
from repro_torch.models import cnn, common
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
from test_torch_cnn_zoo import BATCH, as_np, flat, numpy_params, rel
from lm_parity import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-5
OPT = cnn.OPTIMIZER


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# the mini-library
# --------------------------------------------------------------------------
@pytest.mark.parametrize("size", [8, 9, 16, 32])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_pads_match_xla(size, k, stride):
    assert cnn.same_pads(size, k, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0])


def test_same_pads_asymmetric_cases():
    assert cnn.same_pads(32, 3, 2) == (0, 1)       # every strided 3x3
    assert cnn.same_pads(32, 7, 2) == (2, 3)       # PNASNet's 7x7 sep


@pytest.mark.parametrize("groups", [1, 2, "c"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("k", [1, 3, 5, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_lax(stride, k, size, padding, groups):
    cin = 4
    g = cin if groups == "c" else groups
    cout = cin if groups == "c" else 6
    rng = np.random.default_rng(k * 100 + size)
    x = images((2, size, size, cin), seed=size + k)
    w = rng.standard_normal((k, k, cin // g, cout)).astype(np.float32)
    p = {"w": w}
    if g == 1:
        p["b"] = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jcnn.conv({k_: jnp.asarray(v) for k_, v in p.items()},
                                jnp.asarray(x), stride, padding, g))
    tp = {"w": torch.from_numpy(w.transpose(3, 2, 0, 1).copy())}
    if "b" in p:
        tp["b"] = torch.from_numpy(p["b"])
    got = nhwc(cnn.conv(tp, nchw(x), stride, padding, g))
    assert rel(got, want) <= TOL


def test_conv_refuses_an_unknown_padding():
    with pytest.raises(ValueError, match="padding"):
        cnn.conv({"w": torch.zeros(1, 1, 3, 3)}, torch.zeros(1, 1, 4, 4),
                 padding="FULL")


@pytest.mark.parametrize("shape", [(4, 5, 5, 8), (2, 2, 2, 16),
                                   (8, 1, 1, 3)])
def test_bn_and_its_gradient_match_jax(shape):
    rng = np.random.default_rng(1)
    x = (images(shape) * 3 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    want, vjp = jax.vjp(lambda p, x: jcnn.bn(p, x), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))
    tp = {"scale": torch.from_numpy(scale).requires_grad_(),
          "bias": torch.from_numpy(bias).requires_grad_()}
    tx = nchw(x).requires_grad_()
    got = cnn.bn(tp, tx)
    gs, gb, gx = torch.autograd.grad(got, (tp["scale"], tp["bias"], tx),
                                     nchw(ct))
    assert rel(nhwc(got), want) <= TOL
    assert rel(nhwc(gx), jgx) <= TOL
    assert rel(gs, jgp["scale"]) <= TOL
    assert rel(gb, jgp["bias"]) <= TOL


@pytest.mark.parametrize("size", [8, 9, 32])
@pytest.mark.parametrize("k,s", [(2, 2), (3, 2)])
def test_pools_match_reduce_window(size, k, s):
    x = images((2, size, size, 5))
    assert rel(nhwc(cnn.maxpool(nchw(x), k, s)),
               jcnn.maxpool(jnp.asarray(x), k, s)) <= TOL
    assert rel(nhwc(cnn.avgpool(nchw(x), k, s)),
               jcnn.avgpool(jnp.asarray(x), k, s)) <= TOL


@pytest.mark.parametrize("size", [4, 7, 32])
def test_inception_pool_matches_same_reduce_window(size):
    x = images((2, size, size, 6))
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 1, 1, 1), "SAME")
    assert rel(nhwc(cnn._inception_pool(nchw(x))), want) <= TOL


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_matches_jax(groups):
    x = images((2, 3, 3, 8))
    assert np.array_equal(nhwc(cnn._channel_shuffle(nchw(x), groups)),
                          np.asarray(jcnn._channel_shuffle(jnp.asarray(x),
                                                           groups)))


def test_lenet_flattens_in_nhwc_order():
    """f1's rows are laid out (h, w, c): the logits equal JAX's on the
    same weights, and a flatten in NCHW order would not give them."""
    tree = numpy_params("LeNet")
    x = CifarBatches(seed=0, batch=4).batch_at(0)[0]
    want = np.asarray(jcnn.lenet_apply(tree, jnp.asarray(x)))
    p = bridge.cnn_params_from_numpy("LeNet", tree, "cpu")
    with torch.no_grad():
        assert rel(cnn.lenet_apply(p, nchw(x)), want) <= TOL
        h = cnn.maxpool(cnn.relu(cnn.conv(p["c1"], nchw(x),
                                          padding="VALID")))
        h = cnn.maxpool(cnn.relu(cnn.conv(p["c2"], h, padding="VALID")))
        wrong = cnn.fc(p["f1"], h.reshape(4, -1))
        right = cnn.fc(p["f1"], h.permute(0, 2, 3, 1).reshape(4, -1))
    assert rel(wrong, right) > 0.1


# --------------------------------------------------------------------------
# the bridge and the inits
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["LeNet", "VGG16", "GoogLeNet",
                                  "PreActResNet18"])
def test_params_from_numpy_round_trip(name):
    """Every leaf crosses unchanged (conv weights as OIHW), each ``None``
    slot stays in its place, every leaf requires grad; back in HWIO the
    tree equals JAX's leaf for leaf."""
    tree = numpy_params(name)
    p = bridge.cnn_params_from_numpy(name, tree, "cpu")
    jflat, tflat = dict(flat(tree)), dict(flat(p))
    assert list(jflat) == list(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert got.requires_grad and got.dtype == torch.float32
        back = got.detach().permute(2, 3, 1, 0) if got.ndim == 4 else got
        assert np.array_equal(back.detach().numpy(), want), key
    slots = {"VGG16": ("layers", [2, 5, 9, 13, 17]),
             "GoogLeNet": ("cells", [2, 8])}
    if name in slots:
        key, idx = slots[name]
        assert [i for i, t in enumerate(p[key]) if t is None] == idx
    assert [tuple(x.shape) for x in common.tree_leaves(p)] == [
        tuple(x.shape) for x in common.tree_leaves(
            bridge.init_cnn(name, torch.Generator().manual_seed(0), "cpu"))]


def test_params_from_numpy_refuses_a_bad_tree():
    tree = numpy_params("VGG16")
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="keys"):
        bridge.cnn_params_from_numpy("VGG16", bad, "cpu")
    layers = list(tree["layers"])
    layers[2] = layers[0]                       # a pool slot filled
    with pytest.raises(ValueError, match="None"):
        bridge.cnn_params_from_numpy("VGG16", dict(tree, layers=layers),
                                     "cpu")
    fc = dict(tree["fc"], w=tree["fc"]["w"].T)
    with pytest.raises(ValueError, match="shape"):
        bridge.cnn_params_from_numpy("VGG16", dict(tree, fc=fc), "cpu")
    with pytest.raises(ValueError, match="unknown CNN"):
        bridge.cnn_params_from_numpy("AlexNet", tree, "cpu")


@pytest.mark.parametrize("name", list(jcnn.CNN_ZOO))
def test_init_cnn_matches_jax_shapes_and_scales(name):
    """The port's tree has JAX's paths and shapes (conv weights as OIHW);
    conv weights are N(0, 2 / fan_in), fc weights N(0, 1 / cin), biases
    and shifts 0, bn scales 1."""
    shapes = jax.eval_shape(jcnn.CNN_ZOO[name][0], jax.random.PRNGKey(0))
    p = bridge.init_cnn(name, torch.Generator().manual_seed(0), "cpu")
    want, got = dict(flat(shapes)), dict(flat(p))
    assert list(want) == list(got)
    for key, s in want.items():
        assert got[key].requires_grad, key
        t = got[key].detach()
        shape = (s.shape[3], s.shape[2], s.shape[0], s.shape[1]) \
            if len(s.shape) == 4 else s.shape
        assert tuple(t.shape) == tuple(shape), key
        assert t.dtype == torch.float32
        leaf = key.rsplit("/", 1)[1]
        if leaf == "w":
            fan_in = np.prod(s.shape[:-1])
            std = np.sqrt((2.0 if t.ndim == 4 else 1.0) / fan_in)
            if t.numel() >= 4096:
                assert abs(float(t.std()) / std - 1) < 0.1, key
        else:
            assert torch.all(t == float(leaf == "scale")), key


def test_init_cnn_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.init_cnn("LeNet", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        cnn.Draws(None, "cpu")


def test_preact_unread_leaves_get_zero_gradients():
    """PreActResNet18 never reads ``stem.bn`` or a shortcut's ``bn``:
    their gradients are zero (JAX's cotangent), every other leaf's not."""
    p = bridge.init_cnn("PreActResNet18", torch.Generator().manual_seed(0),
                        "cpu")
    x, y = CifarBatches(seed=0, batch=4).batch_at(0)
    _, grads = cnn.loss_and_grads(cnn.preactresnet18_apply, p, nchw(x),
                                  torch.from_numpy(y))
    unread = {k for k, _ in flat(grads)
              if k.startswith("/stem/bn/") or "/short/bn/" in k}
    assert len(unread) == 2 + 2 * 3
    for key, g in flat(grads):
        assert g.shape == dict(flat(p))[key].shape
        assert bool(torch.all(g == 0)) == (key in unread), key


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name,dtype", [("LeNet", "float32"),
                                        ("LeNet", "float64"),
                                        ("ResNet18", "float64"),
                                        ("PreActResNet18", "float64")])
def test_train_step_matches_jax(name, dtype):
    """``loss_and_grads`` then ``adamw_update`` from the same weights:
    the loss, both moments within 1e-5 of each leaf's scale (an all-zero
    leaf zero in both), the params within 1e-5 of their scale plus what
    Adam's first step makes of the gradients' difference, lr / eps times
    it (``tests/test_torch_train.py``)."""
    x, y = CifarBatches(seed=0, batch=BATCH).batch_at(0)
    tree = jax.tree.map(lambda a: a.astype(dtype), numpy_params(name))
    apply = jcnn.CNN_ZOO[name][1]
    jcfg = JOpt(**OPT)

    def step(params, opt, images, labels):
        loss, grads = jax.value_and_grad(
            lambda p: jcnn.cnn_loss(apply, p, images, labels))(params)
        params, opt, m = jadamw_update(grads, opt, params, jcfg)
        return params, opt, loss, m["lr"]

    with jax.enable_x64(True):
        jparams = jax.tree.map(jnp.asarray, tree)
        jnew, jopt, jloss, lr = jax.jit(step)(
            jparams, jadamw_init(jparams, jcfg), jnp.asarray(x, dtype),
            jnp.asarray(y))
        jnew, jopt = jax.tree.map(np.asarray, (jnew, jopt))
        jloss, lr = float(jloss), float(lr)

    cfg = OptimizerConfig(**OPT)
    p = bridge.cnn_params_from_numpy(name, tree, "cpu")
    opt = adamw_init(p, cfg)
    (loss, _), grads = cnn.loss_and_grads(
        cnn.CNN_ZOO[name][1], p, nchw(x.astype(dtype)), torch.from_numpy(y))
    p, opt, metrics = adamw_update(grads, opt, p, cfg)
    assert abs(float(loss) - jloss) <= TOL * abs(jloss)
    assert float(metrics["lr"]) == pytest.approx(lr, rel=1e-6)
    assert int(opt["count"]) == int(jopt["count"]) == 1

    def port(tree_):                      # JAX's tree as the port lays it
        return dict(flat(bridge.cnn_params_from_numpy(name, tree_, "cpu")))

    for key in ("mu", "nu"):
        want = port(jopt[key])
        for k, g in flat(opt[key]):
            w = as_np(want[k])
            if not np.any(w):
                assert not torch.any(g), (key, k)
            else:
                assert rel(g, w) <= TOL, (key, k)
    jmu, tmu = port(jopt["mu"]), dict(flat(opt["mu"]))
    b1 = cfg.b1
    for k, want in port(jnew).items():
        got, want = as_np(dict(flat(p))[k]), as_np(want)
        dg = np.abs(as_np(tmu[k]) - as_np(jmu[k])) / (1 - b1)
        allowed = TOL * np.max(np.abs(want)) + lr / cfg.eps * dg
        assert np.all(np.abs(got - want) <= allowed), k
