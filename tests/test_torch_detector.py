"""The port's TinyDetector, box decoding and F1 on the CPU, against the JAX
package with the same weights carried across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import detection as JD
from repro_torch.models import detection as D
from repro_torch.models.weights import detector_params_from_jax


@pytest.fixture(scope="module")
def jparams():
    params = JD.init(jax.random.PRNGKey(1), JD.TinyDetectorConfig())
    # nonzero biases, so the bias layout is checked too
    rng = np.random.default_rng(0)
    return {k: np.asarray(v) + (rng.normal(0, 0.1, v.shape).astype(np.float32)
                                if v.ndim == 1 else 0.0)
            for k, v in params.items()}


def test_weights_convert_hwio_to_oihw(jparams):
    params = detector_params_from_jax(jparams, device="cpu")
    assert params["conv0"].shape == (16, 1, 3, 3)
    assert params["conv2"].shape == (64, 32, 3, 3)
    assert params["head"].shape == (5, 64, 1, 1)
    np.testing.assert_array_equal(params["conv1"][7, 3].numpy(),
                                  jparams["conv1"][:, :, 3, 7])
    np.testing.assert_array_equal(params["bias1"].numpy(), jparams["bias1"])
    with pytest.raises(ValueError):
        detector_params_from_jax({"x": np.zeros((2, 2))}, device="cpu")


@pytest.mark.parametrize("H,W,stride", [(64, 96, 8), (48, 80, 8),
                                        (37, 53, 8), (30, 42, 4)])
def test_forward_matches(jparams, H, W, stride):
    # odd sizes pad (1, 1) under "SAME" with stride 2, even sizes (0, 1)
    cfg = D.TinyDetectorConfig(stride=stride)
    jcfg = JD.TinyDetectorConfig(stride=stride)
    frames = np.random.default_rng(1).uniform(0, 255, (2, H, W)) \
        .astype(np.float32)
    ref = np.asarray(JD.forward(jparams, jcfg, jnp.asarray(frames)))
    ours = D.forward(detector_params_from_jax(jparams, device="cpu"), cfg,
                     torch.from_numpy(frames))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)


def test_decode_boxes_matches():
    raw = np.random.default_rng(2).normal(0, 2, (3, 8, 12, 5)) \
        .astype(np.float32)
    cfg = D.TinyDetectorConfig()
    boxes, scores = D.decode_boxes(torch.from_numpy(raw), cfg)
    jb, js = JD.decode_boxes(jnp.asarray(raw), JD.TinyDetectorConfig())
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=1e-4)


def _boxes(seed, B, P, G):
    rng = np.random.default_rng(seed)
    gt = np.concatenate([rng.uniform(10, 90, (B, G, 2)),
                         rng.uniform(8, 30, (B, G, 2))], -1)
    pred = gt[:, rng.integers(0, G, P)] + rng.normal(0, 3, (B, P, 4))
    scores = rng.uniform(0, 1, (B, P))
    valid = rng.uniform(0, 1, (B, G)) < 0.8
    return (pred.astype(np.float32), scores.astype(np.float32),
            gt.astype(np.float32), valid)


@pytest.mark.parametrize("P,G", [(20, 5), (3, 6)])
def test_f1_score_exact(P, G):
    pred, scores, gt, valid = _boxes(P * 10 + G, 6, P, G)
    valid[0] = False                       # a frame with no ground truth
    scores[1] = 0.0                        # a frame with no prediction
    ours = D.f1_score(torch.from_numpy(pred), torch.from_numpy(scores),
                      torch.from_numpy(gt), torch.from_numpy(valid))
    ref = jax.vmap(JD.f1_score)(jnp.asarray(pred), jnp.asarray(scores),
                                jnp.asarray(gt), jnp.asarray(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert 0.0 < float(ours.mean()) < 1.0
    np.testing.assert_allclose(
        D.iou_cxcywh(torch.from_numpy(pred[:, :, None]),
                     torch.from_numpy(gt[:, None])).numpy(),
        np.asarray(JD.iou_cxcywh(pred[:, :, None], gt[:, None])), atol=1e-6)


def test_init_follows_fan_in_rule():
    cfg = D.TinyDetectorConfig()
    params = D.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    jparams = JD.init(jax.random.PRNGKey(0), JD.TinyDetectorConfig())
    assert list(params) == list(JD.param_specs(JD.TinyDetectorConfig()))
    for name, value in params.items():
        jv = np.asarray(jparams[name])
        if jv.ndim == 4:
            assert value.shape == jv.transpose(3, 2, 0, 1).shape
            # weights ~ N(0, 1/cin): the sample std within 15% of 1/sqrt(cin)
            std = 1 / np.sqrt(jv.shape[2])
            assert abs(float(value.std()) / std - 1) < 0.15, name
        else:
            assert torch.equal(value, torch.zeros(jv.shape))
    again = D.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)
