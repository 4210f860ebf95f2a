"""The port's checkpoint store (``repro_torch.checkpoint``) held against the
JAX package's: the same step layout, bit-exact round trips of every leaf
dtype the port stores (bf16 as 2-byte void records), atomic commits,
garbage collection, and steps that either package writes and the other
reads."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lm_parity import one_torch_thread  # noqa: F401 (autouse)
from repro import checkpoint as jckpt
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)

DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.uint8,
          torch.int32]


def _leaf(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2 ** 20), min(info.max, 2 ** 20),
                         shape, generator=g, dtype=torch.int64).to(dtype)


def _tree(seed=0):
    """Nested dicts and lists (a tuple too) of every stored dtype, a numpy
    leaf and a scalar."""
    return {"pools": {"k": _leaf(torch.bfloat16, (2, 3, 4), seed),
                      "k_scale": _leaf(torch.float32, (2, 3, 1), seed + 1),
                      "q": _leaf(torch.int8, (2, 3, 4), seed + 2)},
            "layers": [{"w": _leaf(torch.float32, (4, 5), seed + 3)},
                       {"w": _leaf(torch.bfloat16, (4, 5), seed + 4)}],
            "pair": (_leaf(torch.uint8, (7,), seed + 5),
                     _leaf(torch.int32, (3, 2), seed + 6)),
            "meta": np.arange(5, dtype=np.uint8),
            "step": 7}


def _bits(x):
    """A leaf's raw bytes, so that bf16 compares bit for bit."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().tobytes()
    a = np.asarray(x)
    return a.view(np.uint8).tobytes() if a.ndim else a.tobytes()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]/"))
        return out
    return {prefix[:-1]: tree}


def _like(tree):
    """``tree``'s structure with zeroed leaves of the same dtypes."""
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, np.ndarray):
        return np.zeros((0,), tree.dtype)
    return 0


def test_round_trip_is_bit_exact(tmp_path):
    tree = _tree()
    path = save_pytree(tree, tmp_path, 3)
    assert path.name == "step_00000003"
    assert sorted(p.name for p in path.iterdir()) == [
        "_COMMITTED", "arrays.npz", "manifest.json"]
    got = restore_pytree(_like(tree), tmp_path)
    want, have = _flat(tree), _flat(got)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        if isinstance(leaf, torch.Tensor):
            assert have[key].dtype == leaf.dtype, key
            assert have[key].device == leaf.device, key
            assert tuple(have[key].shape) == tuple(leaf.shape), key
        assert _bits(have[key]) == _bits(leaf), key
    assert isinstance(got["pair"], tuple)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[1])
def test_each_dtype_round_trips_in_the_manifest_layout(tmp_path, dtype):
    """The manifest records the tensor's dtype by name; a bf16 leaf is
    stored as 2-byte void records, every other one as itself."""
    leaf = _leaf(dtype, (3, 4, 5), 11)
    save_pytree({"a": [leaf]}, tmp_path, 0)
    step = tmp_path / "step_00000000"
    manifest = json.loads((step / "manifest.json").read_text())
    name = str(dtype).split(".")[1]
    assert manifest == {"a/[0]": {"shape": [3, 4, 5], "dtype": name}}
    with np.load(step / "arrays.npz") as data:
        stored = data["a/[0]"]
    assert stored.dtype == (np.dtype("V2") if dtype == torch.bfloat16
                            else np.dtype(name))
    back = restore_pytree({"a": [torch.ones(1, dtype=dtype)]}, tmp_path)
    assert back["a"][0].dtype == dtype
    assert _bits(back["a"][0]) == _bits(leaf)


def test_uncommitted_step_is_ignored(tmp_path):
    save_pytree({"x": torch.ones(3)}, tmp_path, 1)
    torn = tmp_path / "step_00000002"          # a save that died mid-write
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError, match="not committed"):
        restore_pytree({"x": torch.zeros(3)}, tmp_path, 2)
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError, match="no committed"):
        restore_pytree({"x": torch.zeros(3)}, tmp_path / "empty")


@pytest.mark.parametrize("save_async", [False, True])
def test_manager_keeps_the_last_two(tmp_path, save_async):
    mgr = CheckpointManager(tmp_path, keep=2, save_async=save_async)
    for step in range(4):
        mgr.save({"x": torch.full((2,), float(step))}, step)
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    assert mgr.restore({"x": torch.zeros(2)})["x"].tolist() == [3.0, 3.0]
    assert mgr.restore({"x": torch.zeros(2)}, 2)["x"].tolist() == [2.0, 2.0]


def test_async_save_copies_before_returning(tmp_path):
    """The writer thread gets a host copy: a tensor changed right after
    ``save`` returns is written as it was."""
    x = torch.zeros(1000)
    mgr = CheckpointManager(tmp_path, save_async=True)
    mgr.save({"x": x}, 0)
    x.fill_(5.0)
    assert float(mgr.restore({"x": torch.ones(1000)})["x"].abs().max()) == 0


def test_restore_never_casts_values(tmp_path):
    save_pytree({"x": torch.arange(4, dtype=torch.int32)}, tmp_path, 0)
    with pytest.raises(ValueError, match="int32"):
        restore_pytree({"x": torch.zeros(4)}, tmp_path)
    with pytest.raises(TypeError):               # no mesh: no shardings
        restore_pytree({"x": torch.zeros(4, dtype=torch.int32)}, tmp_path,
                       None, shardings=None)


# --------------------------------------------------------------------------
# across the two packages
# --------------------------------------------------------------------------
def _jax_like(tree):
    if isinstance(tree, dict):
        return {k: _jax_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_like(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        dt = jnp.bfloat16 if tree.dtype == torch.bfloat16 else \
            np.dtype(str(tree.dtype).split(".")[1])
        return jnp.zeros(tuple(tree.shape), dt)
    return jnp.zeros((0,), np.asarray(tree).dtype) \
        if isinstance(tree, np.ndarray) else jnp.zeros((), jnp.int32)


def _from_jax(x):
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port",
                                       "port-to-bridge"])
def test_steps_cross_between_packages(tmp_path, direction):
    tree = _tree(seed=5)
    tree.pop("step")
    if direction == "jax-to-port":
        jtree = jax.tree.map(
            lambda v: jnp.asarray(np.asarray(v.view(torch.int16)).view(
                ml_dtypes.bfloat16)) if isinstance(v, torch.Tensor)
            and v.dtype == torch.bfloat16 else jnp.asarray(np.asarray(v)),
            tree, is_leaf=lambda v: isinstance(v, torch.Tensor))
        jckpt.save_pytree(jtree, tmp_path, 4)
        got = restore_pytree(_like(tree), tmp_path)
    else:
        save_pytree(tree, tmp_path, 4)
        if direction == "port-to-jax":
            got = jax.tree.map(_from_jax,
                               jckpt.restore_pytree(_jax_like(tree), tmp_path))
        else:
            got = bridge.load_step_dir(tmp_path / "step_00000004")
            got["pair"] = tuple(got["pair"])
    want, have = _flat(tree), _flat(got)
    assert sorted(have) == sorted(want)
    for key, leaf in want.items():
        if isinstance(leaf, torch.Tensor):
            assert have[key].dtype == leaf.dtype, key
        assert _bits(have[key]) == _bits(leaf), key
