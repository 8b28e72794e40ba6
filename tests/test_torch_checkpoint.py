"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
JAX package's, both ways, on the CPU: the same format on disk, so that a
checkpoint written by either package restores in the other.

Contracts: every restored leaf equals the saved one bit for bit (bf16
compared through its 16-bit pattern); the ``.npz`` key sets and the
manifests' ``keys`` of the same tree are equal, and so are the stored
bytes; ``_gc``, ``all_steps``, ``latest_step`` and the async writer act as
the reference's.  The reference cannot restore a bf16 leaf (its
``jax.device_put`` rejects the void records that ``np.savez`` writes for
them, ROADMAP.md section 3), so the port-to-reference direction holds
f32 and int32 leaves, and the test pins that fault."""
import json
import os
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import detection as JD
from repro.train import checkpoint as JCKPT
from repro_torch.models import detection as D
from repro_torch.models.weights import (detector_params_from_jax,
                                        detector_params_to_jax)
from repro_torch.train import checkpoint as CKPT


def _values(rng):
    """Numpy values of one tree: nested dicts, a list, f32, int32, bf16
    (as f32 values exactly representable in bf16) and 0-d leaves."""
    bf = rng.normal(0, 3, (3, 5)).astype(np.float32)
    bf = np.asarray(jnp.asarray(bf, jnp.bfloat16), np.float32)
    return {"params": {"w": rng.normal(0, 1, (4, 6)).astype(np.float32),
                       "layers": [rng.normal(0, 1, (2,)).astype(np.float32),
                                  {"b": bf}]},
            "opt": {"step": np.int32(7),
                    "count": rng.integers(-5, 5, (3,)).astype(np.int32)},
            "scale": np.float32(0.25)}


def _jax_tree(v, bf16=True):
    return {"params": {"w": jnp.asarray(v["params"]["w"]),
                       "layers": [jnp.asarray(v["params"]["layers"][0]),
                                  {"b": jnp.asarray(
                                      v["params"]["layers"][1]["b"],
                                      jnp.bfloat16 if bf16 else jnp.float32)}]},
            "opt": {"step": jnp.asarray(v["opt"]["step"]),
                    "count": jnp.asarray(v["opt"]["count"])},
            "scale": jnp.asarray(v["scale"])}


def _port_tree(v, bf16=True):
    def t(a, dtype=None):
        return torch.from_numpy(np.array(a)).to(dtype)
    return {"params": {"w": t(v["params"]["w"]),
                       "layers": [t(v["params"]["layers"][0]),
                                  {"b": t(v["params"]["layers"][1]["b"],
                                          torch.bfloat16 if bf16
                                          else torch.float32)}]},
            "opt": {"step": t(v["opt"]["step"]),
                    "count": t(v["opt"]["count"])},
            "scale": t(v["scale"])}


def _bits(x) -> np.ndarray:
    """A leaf's dtype name and bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy()
        return x.numpy().dtype.name, x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return "bfloat16", a.view(np.int16)
    return a.dtype.name, a


def _leaves(tree):
    return [leaf for _, leaf in CKPT._flatten(tree)]


def _assert_same_leaves(ours, ref):
    a, b = _leaves(ours), _leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        (dx, bx), (dy, by) = _bits(x), _bits(y)
        assert dx == dy and bx.shape == by.shape
        np.testing.assert_array_equal(bx, by)


def test_reference_checkpoint_restores_in_port(tmp_path):
    v = _values(np.random.default_rng(0))
    JCKPT.save(str(tmp_path), 3, _jax_tree(v))
    like = jax.tree.map(torch.zeros_like, _port_tree(v))
    back = CKPT.restore(str(tmp_path), 3, like)
    assert isinstance(back["params"]["layers"], list)
    assert back["params"]["layers"][1]["b"].dtype == torch.bfloat16
    _assert_same_leaves(back, _jax_tree(v))


def test_port_checkpoint_restores_in_reference(tmp_path):
    v = _values(np.random.default_rng(1))
    CKPT.save(str(tmp_path), 5, _port_tree(v, bf16=False))
    back = JCKPT.restore(str(tmp_path), 5, _jax_tree(v, bf16=False))
    _assert_same_leaves(_port_tree(v, bf16=False), back)
    # bf16: the port writes the reference's void records; the reference
    # cannot read them back, the port can
    CKPT.save(str(tmp_path), 6, _port_tree(v))
    with pytest.raises(TypeError):
        JCKPT.restore(str(tmp_path), 6, _jax_tree(v))
    _assert_same_leaves(CKPT.restore(str(tmp_path), 6, _port_tree(v)),
                        _port_tree(v))


def test_keys_manifest_and_bytes_equal_the_reference(tmp_path):
    v = _values(np.random.default_rng(2))
    ours = CKPT.save(str(tmp_path / "port"), 4, _port_tree(v),
                     extra={"note": "x"})
    ref = JCKPT.save(str(tmp_path / "ref"), 4, _jax_tree(v),
                     extra={"note": "x"})
    assert os.path.basename(ours) == os.path.basename(ref) == "step_4"
    manifests = []
    for d in (ours, ref):
        with open(os.path.join(d, "manifest.json")) as f:
            manifests.append(json.load(f))
    m_ours, m_ref = manifests
    assert m_ours.keys() == m_ref.keys()
    assert m_ours["keys"] == m_ref["keys"]
    assert (m_ours["step"], m_ours["extra"]) == (m_ref["step"],
                                                 m_ref["extra"])
    assert "params/layers/1/b" in m_ours["keys"] and "opt/step" in \
        m_ours["keys"]
    a = np.load(os.path.join(ours, "arrays.npz"))
    b = np.load(os.path.join(ref, "arrays.npz"))
    assert set(a.files) == set(b.files) == set(m_ref["keys"])
    for k in a.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert a[k].tobytes() == b[k].tobytes(), k
    with zipfile.ZipFile(os.path.join(ours, "arrays.npz")) as z:
        assert sorted(z.namelist()) == sorted(f"{k}.npy" for k in a.files)


def test_gc_steps_and_async_writer_act_as_the_reference(tmp_path):
    for pkg, tree in ((CKPT, {"x": torch.zeros(2)}),
                      (JCKPT, {"x": jnp.zeros(2)})):
        d = str(tmp_path / pkg.__name__)
        assert pkg.all_steps(d) == [] and pkg.latest_step(d) is None
        for s in (1, 2, 3, 4, 5):
            pkg.save(d, s, tree, keep=2)
        os.makedirs(os.path.join(d, "step_notanumber"))
        assert pkg.all_steps(d) == [4, 5] and pkg.latest_step(d) == 5
        handle = pkg.save(d, 9, tree, keep=2, blocking=False)
        assert isinstance(handle, threading.Thread)
        handle.join(timeout=60)
        assert not handle.is_alive()
        assert pkg.all_steps(d) == [5, 9]
        # saving a step again replaces it
        assert pkg.save(d, 9, tree, keep=2).endswith("step_9")
        assert sorted(os.listdir(d)) == ["step_5", "step_9",
                                         "step_notanumber"]


def test_async_save_holds_the_values_of_the_call(tmp_path):
    """The leaves reach the host before save returns: an in-place update
    afterwards does not reach the checkpoint."""
    t = torch.arange(6, dtype=torch.float32)
    handle = CKPT.save(str(tmp_path), 1, {"t": t}, blocking=False)
    t.add_(100.0)
    handle.join(timeout=60)
    back = CKPT.restore(str(tmp_path), 1, {"t": torch.zeros(6)})
    np.testing.assert_array_equal(back["t"].numpy(), np.arange(6))


def test_restore_takes_like_dtype_and_raises_as_the_reference(tmp_path):
    v = _values(np.random.default_rng(3))
    JCKPT.save(str(tmp_path), 2, _jax_tree(v))
    # a numpy like-tree gives numpy arrays of its dtypes; a bf16 record
    # into an f32 leaf gives its exact value
    like = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32),
                        _jax_tree(v))
    back = CKPT.restore(str(tmp_path), 2, like)
    b = back["params"]["layers"][1]["b"]
    assert isinstance(b, np.ndarray) and b.dtype == np.float32
    np.testing.assert_array_equal(b, v["params"]["layers"][1]["b"])
    assert back["opt"]["step"].dtype == np.float32
    wrong = _port_tree(v)
    wrong["params"]["w"] = torch.zeros(6, 4)
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(str(tmp_path), 2, wrong)
    extra = _port_tree(v)
    extra["params"]["missing"] = torch.zeros(1)
    with pytest.raises(KeyError, match="missing"):
        CKPT.restore(str(tmp_path), 2, extra)
    with pytest.raises(KeyError, match="missing"):
        JCKPT.restore(str(tmp_path), 2, {"missing": jnp.zeros(1)})
    # a sharding tree of another size raises (tests/test_torch_moe.py
    # holds the restore onto shardings against the reference's)
    with pytest.raises(ValueError, match="0 shardings for 6 leaves"):
        CKPT.restore(str(tmp_path), 2, _port_tree(v), shardings={})


def test_detector_checkpoint_crosses_both_ways(tmp_path):
    """The detector in the reference's layout (HWIO, f32): the reference's
    params saved by ``repro`` restore in the port as exactly
    ``detector_params_from_jax`` of them, and the port's saved through
    ``detector_params_to_jax`` restore in ``repro`` bit for bit."""
    cfg = JD.TinyDetectorConfig()
    jparams = {k: np.asarray(v) for k, v in
               JD.init(jax.random.PRNGKey(4), cfg).items()}
    JCKPT.save(str(tmp_path / "ref"), 1, jparams)
    ours = D.init(torch.Generator().manual_seed(5), D.TinyDetectorConfig(),
                  device="cpu")
    like = detector_params_to_jax(ours)
    assert {k: a.shape for k, a in like.items()} == \
        {k: a.shape for k, a in jparams.items()}
    back = detector_params_from_jax(
        CKPT.restore(str(tmp_path / "ref"), 1, like), "cpu")
    for k, want in detector_params_from_jax(jparams, "cpu").items():
        assert torch.equal(back[k], want), k
    CKPT.save(str(tmp_path / "port"), 2, detector_params_to_jax(ours))
    ref_back = JCKPT.restore(str(tmp_path / "port"), 2, jparams)
    for k, a in detector_params_to_jax(ours).items():
        np.testing.assert_array_equal(np.asarray(ref_back[k]), a)
    # to the reference's layout and back is exact
    for k, t in detector_params_from_jax(detector_params_to_jax(ours),
                                         "cpu").items():
        assert torch.equal(t, ours[k]), k
