"""The CNN zoo of the PyTorch port (``repro_torch.models.cnn``) held
against the JAX package's (``repro.models.cnn``) on the CPU, two cases a
model on the same weights (a numpy tree filled from a seed in the shapes
of ``jax.eval_shape(init, key)``):

  * the float32 forward at batch 4 of ``CifarBatches(seed=0)``, the
    precision that the card trains in: ``cnn_loss`` within 1e-5 and the
    logits within 1e-4 of their largest magnitude, JAX's from one jitted
    forward.  Where JAX's own float32 logits lie further than 0.5e-4 from
    its float64 ones, the logits are held within twice that distance
    instead: that is float32's rounding through the net, which no float32
    implementation can undo (DPN92: JAX's float32 1.2e-4 from its
    float64 at batch 4);
  * the float64 forward and backward at batch 2: the logits within 1e-4,
    ``cnn_loss`` within 1e-5 and every gradient leaf within 1e-3 of its
    own largest magnitude, JAX's from one jitted ``value_and_grad(...,
    has_aux=True)``.

The cases are split over four files by their cost on one worker (JAX's
compiles, and its float64 grouped and depthwise convolutions): seven
models here, the depthwise nets in ``test_torch_cnn_zoo_depthwise.py``,
DenseNet121 and GoogLeNet in ``test_torch_cnn_zoo_heavy.py``, the
grouped-conv nets in ``test_torch_cnn_zoo_grouped.py``.

The gradients are held in float64.  In float32 these deep nets at a
small batch are ill-conditioned: rounding flips ReLUs near zero and cancels in
batch norms over 2x2 maps, so JAX's own float32 gradients lie up to 0.3
of a leaf's scale from its float64 ones (DPN92 at batch 4), and a
batch-norm shift that feeds a 1x1 conv and another batch norm has a
gradient that is zero but for rounding.  A leaf whose JAX gradient lies
below 1e-10 of the model's largest is such a zero: the port's must lie
below it too.  The batch of that case is 2, not 4: JAX's float64
convolutions are slow on the CPU, and the whole tier-1 run must keep
inside its limit (float32 gradients are held op by op in
``test_torch_cnn.py``, and in LeNet's train step there)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.data import CifarBatches
from repro.models import cnn as jcnn
from repro_torch import bridge
from repro_torch.models import cnn

BATCH, BATCH32 = 2, 4
LOSS_TOL, LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4, 1e-3
ZERO = 1e-10
# the other files' cases (see the module's docstring)
DEPTHWISE = ("MobileNet", "MobileNetV2", "ShuffleNetV2", "EfficientNetB0")
HEAVY = ("DenseNet121", "GoogLeNet")
GROUPED = ("ResNeXt29_2x64d", "RegNetX_200MF", "DPN92")
HERE = tuple(n for n in jcnn.CNN_ZOO if n not in DEPTHWISE + HEAVY + GROUPED)


def numpy_params(name, seed=0):
    """JAX's param tree of ``name`` as float32 numpy leaves from ``seed``:
    conv weights N(0, 2 / fan_in), fc weights N(0, 1 / cin), bn scales
    1 + N(0, 0.01), every shift and bias N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jcnn.CNN_ZOO[name][0], jax.random.PRNGKey(0))

    def leaf(path, s):
        key = path[-1].key
        if key == "w":
            fan_in = np.prod(s.shape[:-1])
            std = np.sqrt((2.0 if len(s.shape) == 4 else 1.0) / fan_in)
        else:
            std = 0.1
        x = rng.standard_normal(s.shape) * std + (key == "scale")
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flat(tree, pre=""):
    """(path, leaf) pairs of a nested dict / list tree, keys sorted, the
    ``None`` slots skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat(tree[k], f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from flat(t, f"{pre}/[{i}]")
    elif tree is not None:
        yield pre, tree


def as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rel(a, b) -> float:
    """max |a - b| / max |b|."""
    a, b = as_np(a), as_np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def jax_loss_logits(name, tree, images, labels, dtype):
    """JAX's (loss, logits) of ``name`` in ``dtype`` from one jitted
    forward, as numpy."""
    apply = jcnn.CNN_ZOO[name][1]

    def fwd(p, x, y):
        logits = apply(p, x)
        return jcnn.cnn_loss(lambda _p, _x: logits, p, x, y), logits

    with jax.enable_x64(dtype == np.float64):
        loss, logits = jax.jit(fwd)(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), tree),
            jnp.asarray(images, dtype), jnp.asarray(labels))
        return float(loss), np.asarray(logits)


def jax_loss_logits_grads(name, tree, images, labels):
    """JAX's float64 (loss, logits, grads) of ``name`` from one jitted
    ``value_and_grad(..., has_aux=True)``, as numpy."""
    apply = jcnn.CNN_ZOO[name][1]

    def loss_fn(p, x, y):
        logits = apply(p, x)
        return jcnn.cnn_loss(lambda _p, _x: logits, p, x, y), logits

    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(p64, jnp.asarray(images, jnp.float64),
                                    jnp.asarray(labels))
        return (float(loss), np.asarray(logits),
                jax.tree.map(np.asarray, grads))


def close_grads(got, want, what=""):
    """Every leaf of ``got`` (the port's tree) within ``GRAD_TOL`` of its
    own scale in ``want`` (JAX's, carried across), a zero leaf (below
    ``ZERO`` of the largest) zero in both."""
    got, want = dict(flat(got)), dict(flat(want))
    assert sorted(got) == sorted(want), what
    scale = max(np.max(np.abs(as_np(w))) for w in want.values())
    for key, w in want.items():
        g, w = as_np(got[key]), as_np(w)
        if np.max(np.abs(w)) <= ZERO * scale:
            assert np.max(np.abs(g)) <= ZERO * scale, (what, key)
        else:
            assert rel(g, w) <= GRAD_TOL, (what, key, rel(g, w))


def check_zoo_member_fp32(name):
    images, labels = CifarBatches(seed=0, batch=BATCH32).batch_at(0)
    tree = numpy_params(name)
    jloss, jlogits = jax_loss_logits(name, tree, images, labels, np.float32)
    _, jlogits64 = jax_loss_logits(name, tree, images, labels, np.float64)
    apply = cnn.CNN_ZOO[name][1]
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    with torch.no_grad():
        logits = apply(bridge.cnn_params_from_numpy(name, tree, "cpu"), x)
    loss = cnn.cnn_loss(lambda _p, _x: logits, None, None,
                        torch.from_numpy(labels))
    assert logits.dtype == torch.float32
    assert abs(float(loss) - jloss) <= LOSS_TOL * abs(jloss)
    tol = max(LOGIT_TOL, 2 * rel(jlogits, jlogits64))
    assert rel(logits, jlogits) <= tol, (name, rel(logits, jlogits), tol)


def check_zoo_member(name):
    images, labels = CifarBatches(seed=0, batch=BATCH).batch_at(0)
    tree = numpy_params(name)
    jloss, jlogits, jgrads = jax_loss_logits_grads(name, tree, images,
                                                   labels)
    apply = cnn.CNN_ZOO[name][1]
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    y = torch.from_numpy(labels)
    p64 = bridge.cnn_params_from_numpy(
        name, jax.tree.map(lambda a: a.astype(np.float64), tree), "cpu")
    (loss, logits), grads = cnn.loss_and_grads(apply, p64, x.double(), y)
    assert abs(float(loss) - jloss) <= LOSS_TOL * abs(jloss)
    assert rel(logits, jlogits) <= LOGIT_TOL
    close_grads(grads, bridge.cnn_params_from_numpy(name, jgrads, "cpu"),
                name)


def test_the_four_files_cover_the_zoo():
    cases = HERE + DEPTHWISE + HEAVY + GROUPED
    assert sorted(cases) == sorted(jcnn.CNN_ZOO) == sorted(cnn.CNN_ZOO)
    assert list(cnn.CNN_ZOO) == list(jcnn.CNN_ZOO)


@pytest.mark.parametrize("name", HERE)
def test_zoo_member_matches_jax(name):
    check_zoo_member(name)


@pytest.mark.parametrize("name", HERE)
def test_zoo_member_fp32_forward_matches_jax(name):
    check_zoo_member_fp32(name)
