"""The port's main path on the CPU: ``repro_torch.core.roundtrip`` and the
decode-side pieces against the JAX package, the port's oracle against
its round trip, CUDA-by-default entry points, and the port's isolation
from JAX and the JAX package."""
import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid_decoder as JH
from repro.core import quality_transfer as JQ
from repro.core import reuse as JU
from repro.core import roundtrip as JRT
from repro.models import detection as JD
from repro.sim.video_source import StreamConfig as JStreamConfig
from repro.sim.video_source import generate_chunk as j_generate_chunk
from repro_torch import device as port_device
from repro_torch.codec.video_codec import VideoCodecConfig, encode_chunk
from repro_torch.core import hybrid_decoder as H
from repro_torch.core import quality_transfer as Q
from repro_torch.core import reuse as U
from repro_torch.core.roundtrip import (RoundtripConfig, anchor_budget_bits,
                                        roundtrip_chunk, roundtrip_oracle)
from repro_torch.models import detection as D
from repro_torch.models.weights import detector_params_from_jax
from repro_torch.sim.video_source import StreamConfig, generate_chunk

ROOT = pathlib.Path(__file__).resolve().parents[1]
HH, WW, T = 64, 96, 4
# (0.05, 0.1) leaves pipeline ② idle on these frames; (0.5, 0.02) drives it
THRESHOLDS = [(0.05, 0.1), (0.5, 0.02)]


@pytest.fixture(scope="module")
def stream():
    raw, gtb, gtv = j_generate_chunk(None, JStreamConfig(
        height=HH, width=WW, n_objects=3, seed=0), 0, T)
    params = JD.init(jax.random.PRNGKey(1), JD.TinyDetectorConfig())
    return ((np.array(raw), np.array(gtb), np.array(gtv)),
            {k: np.asarray(v) for k, v in params.items()})


def _run_port(fn, stream, level, tr1, tr2):
    (raw, gtb, gtv), jparams = stream
    return fn(raw, gtb, gtv, detector_params_from_jax(jparams, "cpu"),
              tr1=tr1, tr2=tr2, bw_kbps=6000.0,
              cfg=RoundtripConfig(level=level), device="cpu")


@pytest.mark.parametrize("tr1,tr2", THRESHOLDS)
@pytest.mark.parametrize("level", [2, 3])
def test_roundtrip_chunk_matches_jax(stream, level, tr1, tr2):
    (raw, gtb, gtv), jparams = stream
    ref = JRT.roundtrip_chunk(raw, gtb, gtv, jparams, tr1=tr1, tr2=tr2,
                              bw_kbps=6000.0,
                              cfg=JRT.RoundtripConfig(level=level))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    ours = {k: v.numpy() for k, v in
            _run_port(roundtrip_chunk, stream, level, tr1, tr2).items()}
    assert set(ours) == set(ref)
    np.testing.assert_array_equal(ours["types"], ref["types"])
    np.testing.assert_array_equal(ours["anchor_q"], ref["anchor_q"])
    # f32 sums in other orders: bits, detector outputs, latency
    for k in ("video_bits", "anchor_bits", "total_bits"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(ours["scores"], ref["scores"], atol=1e-4)
    np.testing.assert_allclose(ours["boxes"], ref["boxes"], atol=1e-2)
    for k in ("f1", "mean_f1"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, err_msg=k)
    for k in ("latency", "t_trans", "t_comp", "t_queue"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("tr1,tr2", THRESHOLDS)
def test_roundtrip_oracle_agrees_with_roundtrip_chunk(stream, tr1, tr2):
    fused = _run_port(roundtrip_chunk, stream, 3, tr1, tr2)
    oracle = _run_port(roundtrip_oracle, stream, 3, tr1, tr2)
    assert set(fused) == set(oracle)
    for k in fused:
        # one batched JPEG launch vs one per anchor: the same arithmetic
        # per block; anchor bits add up in another order
        torch.testing.assert_close(fused[k], oracle[k], rtol=1e-6, atol=0,
                                   msg=k)


def test_roundtrip_rejects_unported_options(stream):
    # the anchor budget search, the one option this test once found
    # rejected, is ported: roundtrip_chunk and roundtrip_oracle with
    # anchor_search=True hold against the reference's (rungs exact, bits
    # rtol 1e-4 as above) and against each other bit for bit
    (raw, gtb, gtv), jparams = stream
    params = detector_params_from_jax(jparams, "cpu")
    kw = dict(tr1=0.05, tr2=0.1, bw_kbps=900.0)
    cfg = RoundtripConfig(level=3, anchor_search=True)
    jcfg = JRT.RoundtripConfig(level=3, anchor_search=True)
    outs = []
    for fn, jfn in ((roundtrip_chunk, JRT.roundtrip_chunk),
                    (roundtrip_oracle, JRT.roundtrip_oracle)):
        ours = fn(raw, gtb, gtv, params, cfg=cfg, device="cpu", **kw)
        ref = jfn(raw, gtb, gtv, jparams, cfg=jcfg, **kw)
        np.testing.assert_array_equal(ours["types"].numpy(),
                                      np.asarray(ref["types"]))
        np.testing.assert_array_equal(ours["anchor_q"].numpy(),
                                      np.asarray(ref["anchor_q"]))
        assert float(ours["anchor_q"].max()) not in (0.0, 70.0)
        for k in ("anchor_bits", "total_bits"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]),
                                       rtol=1e-4, err_msg=k)
        outs.append(ours)
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k


# ------------------------------------------------ decode-side pieces, exact
def test_anchor_index_upscale_mvs_and_costs_exact():
    types = np.array([1, 3, 2, 1, 3, 3, 2, 1, 2], np.int32)
    np.testing.assert_array_equal(
        H.anchor_index(torch.from_numpy(types)).numpy(),
        np.asarray(JH.anchor_index(jnp.asarray(types))))
    mv = np.random.default_rng(0).integers(-8, 9, (3, 3, 4, 2)) \
        .astype(np.int32)
    for hw in ((96, 144), (720, 1280)):
        np.testing.assert_array_equal(
            H._upscale_mvs(torch.from_numpy(mv), hw).numpy(),
            np.asarray(JH._upscale_mvs(jnp.asarray(mv), hw)))
    np.testing.assert_allclose(
        float(H.pipeline_cost(torch.tensor(3.0), torch.tensor(5.0),
                              torch.tensor(7.0))),
        float(JH.pipeline_cost(jnp.float32(3), jnp.float32(5),
                               jnp.float32(7))), rtol=1e-7)
    np.testing.assert_allclose(
        float(anchor_budget_bits(6000.0, torch.tensor(12345.0), 3, 30,
                                 30.0)),
        float(JRT.anchor_budget_bits(6000.0, 12345.0, 3, 30, 30.0)),
        rtol=1e-7)


def test_reuse_chunk_matches():
    rng = np.random.default_rng(1)
    types = np.array([1, 3, 3, 2, 3], np.int32)
    mvs = rng.integers(-6, 7, (5, 4, 6, 2)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0, 64, (5, 10, 2)),
                            rng.uniform(4, 40, (5, 10, 2))], -1) \
        .astype(np.float32)
    scores = rng.uniform(0, 1, (5, 10)).astype(np.float32)
    ob, os_ = U.reuse_chunk(torch.from_numpy(types), torch.from_numpy(mvs),
                            torch.from_numpy(boxes), torch.from_numpy(scores))
    jb, js = JU.reuse_chunk(jnp.asarray(types), jnp.asarray(mvs),
                            jnp.asarray(boxes), jnp.asarray(scores))
    # integer MVs: the masked sums are exact in either form
    np.testing.assert_array_equal(ob.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(os_.numpy(), np.asarray(js))


def test_quality_transfer_matches():
    rng = np.random.default_rng(2)
    qtab = np.array(JRT.B.quant_table(50.0))
    residual_q = rng.integers(-6, 7, (3, 96, 8, 8)).astype(np.float32)
    px = Q.residual_to_pixels(torch.from_numpy(residual_q),
                              torch.from_numpy(qtab), 64, 96)
    for t in range(3):
        np.testing.assert_allclose(
            px[t].numpy(), np.asarray(JQ.residual_to_pixels(
                jnp.asarray(residual_q[t]), qtab, 64, 96)), atol=1e-3)
    anchor = rng.uniform(0, 255, (3, 64, 96)).astype(np.float32)
    mv = rng.integers(-30, 31, (3, 4, 6, 2)).astype(np.int32)
    out = Q.transfer_frame(torch.from_numpy(anchor), torch.from_numpy(mv),
                           px)
    for t in range(3):
        np.testing.assert_array_equal(
            out[t].numpy(), np.asarray(JQ.transfer_frame(
                jnp.asarray(anchor[t]), jnp.asarray(mv[t]),
                jnp.asarray(px[t].numpy()))))


# ------------------------------------------------------------ video source
def test_generate_chunk_is_continuous_and_in_range():
    cfg = StreamConfig(height=48, width=80, n_objects=3, seed=5)
    frames, boxes, valid = generate_chunk(cfg, 0, 6, device="cpu")
    tail, tail_boxes, _ = generate_chunk(cfg, 4, 2, device="cpu")
    assert frames.shape == (6, 48, 80) and boxes.shape == (6, 3, 4)
    assert bool(valid.all())
    assert float(frames.min()) >= 0.0 and float(frames.max()) <= 255.0
    torch.testing.assert_close(frames[4:], tail)
    torch.testing.assert_close(boxes[4:], tail_boxes)
    # box centres stay inside the frame, sizes inside [min, max]
    assert bool((boxes[..., 2:] >= cfg.min_size).all())
    assert bool((boxes[..., 2:] <= cfg.max_size).all())
    assert bool((boxes[..., 0] <= cfg.height).all())


# ------------------------------------------------- CUDA unless told the CPU
def test_entry_points_default_to_cuda_and_raise_without_it(stream,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (raw, gtb, gtv), jparams = stream
    params = detector_params_from_jax(jparams, "cpu")
    enc = encode_chunk(raw, VideoCodecConfig(), device="cpu")
    types = torch.ones(T, dtype=torch.int32)
    kw = dict(tr1=0.05, tr2=0.1, bw_kbps=6000.0)
    calls = [
        lambda: port_device.resolve_device(),
        lambda: port_device.resolve_device("cuda"),
        lambda: roundtrip_chunk(raw, gtb, gtv, params, **kw),
        lambda: roundtrip_oracle(raw, gtb, gtv, params, **kw),
        lambda: encode_chunk(raw, VideoCodecConfig()),
        lambda: H.decode_execute_chunk(
            enc, types, raw, gtb, gtv, params, D.TinyDetectorConfig(),
            bw_kbps=6000.0),
        lambda: generate_chunk(StreamConfig(), 0, 2),
        lambda: D.init(torch.Generator(), D.TinyDetectorConfig()),
        lambda: detector_params_from_jax(jparams),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


# -------------------------------------------- isolation from JAX and repro
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|$|\.|,)"
    r"|from\s+repro(\.|\s+import\b))", re.M)


def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
    # the pattern itself catches the forms it is meant to
    for bad in ("import jax", "from jax import numpy", "import repro",
                "from repro.codec import motion", "from repro import core",
                "  import jax.numpy as jnp"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.codec import x",
               "import jaxlib_free"):
        assert not _FORBIDDEN.search(ok), ok


def test_importing_every_port_module_loads_no_jax_or_repro():
    src = ROOT / "src"
    modules = [".".join(p.relative_to(src).with_suffix("").parts)
               .removesuffix(".__init__")
               for p in sorted((src / "repro_torch").rglob("*.py"))]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(src))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_configs_mirror_the_reference():
    ours = {f.name for f in dataclasses.fields(RoundtripConfig)}
    ref = {f.name for f in dataclasses.fields(JRT.RoundtripConfig)}
    assert ours == ref
    assert dataclasses.asdict(H.PipelineCosts()) == \
        dataclasses.asdict(JH.PipelineCosts())
    assert D.TinyDetectorConfig() == D.TinyDetectorConfig(
        **dataclasses.asdict(JD.TinyDetectorConfig()))
