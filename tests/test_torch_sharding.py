"""The port's stream sharding on the CPU: the rule tables and spec helpers
against the JAX package's; ``pad_stream_axis`` against the reference's;
``shard_encode``, ``shard_streams`` and ``shard_roundtrip`` on logical
CPU meshes of 1, 2 and 4 shards and a (2, 2) mesh under the DP rules,
bit for bit the port's unsharded batched forms, and on a one-device mesh
against the reference's ``shard_*`` under the contracts of
``test_torch_batched.py``; ``remesh``; the runtime's mesh mode against
its logical shards (and the reference's runtime), evictions included;
and the kernel launch's device guard.

A logical mesh names the same device several times: each shard's body
runs on its own slice of the stream axis exactly as on a mesh of distinct
devices, so these tests hold the split, the padding, the replication and
the gather, which is all that stream sharding adds to the batched forms.
"""
import ast
import dataclasses
import importlib
import math
import pathlib
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.codec import video_codec as JV
from repro.core import hybrid_encoder as JE
from repro.distributed import sharding as JSH
from repro.serving import runtime as JR
from repro.serving import faults as JF
from repro.serving import scheduler as JSCH
from repro.sim import video_source as JS
from repro_torch.codec import video_codec as V
from repro_torch.core import hybrid_decoder as H
from repro_torch.core import roundtrip as RT
from repro_torch.core.roi import RoiConfig
from repro_torch.distributed import shard_map_compat as SMC
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import current_ctx, shard_ctx
from repro_torch.distributed.mesh import Mesh, NamedSharding, make_mesh
from repro_torch.kernels import build
from repro_torch.serving import faults as F
from repro_torch.serving import runtime as R
from repro_torch.serving import scheduler as SCH
from repro_torch.serving.elastic import ElasticPool, remesh

from test_torch_batched import (ENC_FIELDS, _frames, _hold_encode,
                                _hold_outputs, _jcfg)
from test_torch_serving import (DET, JDET, _hold_poll, _hold_stats,
                                port_packet)
from test_torch_serving import weights  # noqa: F401  (a fixture)

# the packages export a function named as this module: take the modules
JSS = importlib.import_module("repro.distributed.stream_sharding")
SS = importlib.import_module("repro_torch.distributed.stream_sharding")

HH, WW, T = 64, 96, 4
SIZES = (1, 3, 4, 8)
MIXED = (4, 3, 2, 1, 0, 4, 3, 2)       # a rung a stream, S <= 8
MESHES = {"1": ((1,), ("data",), SH.SINGLE_POD_RULES),
          "2": ((2,), ("data",), SH.SINGLE_POD_RULES),
          "4": ((4,), ("data",), SH.SINGLE_POD_RULES),
          "2x2": ((2, 2), ("data", "model"), SH.SINGLE_POD_RULES_DP)}
RULE_TABLES = ("SINGLE_POD_RULES", "MULTI_POD_RULES", "SINGLE_POD_RULES_EP",
               "MULTI_POD_RULES_EP", "MULTI_POD_RULES_FSDP_POD",
               "SINGLE_POD_RULES_KVREP", "MULTI_POD_RULES_KVREP",
               "SINGLE_POD_RULES_DP", "MULTI_POD_RULES_DP")
SHAPES = ({"data": 1}, {"data": 4}, {"data": 2, "model": 2},
          {"pod": 2, "data": 2, "model": 2}, {"model": 4})


def _mesh(name):
    shape, names, rules = MESHES[name]
    return make_mesh(shape, names, devices=["cpu"] * math.prod(shape)), rules


def _equal(ours, ref, label=""):
    """Every output bit for bit (dicts of tensors or EncodedChunks)."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), label
        pairs = [(k, ours[k], ref[k]) for k in ref]
    else:
        pairs = [(k, getattr(ours, k), getattr(ref, k)) for k in ENC_FIELDS]
    for k, a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype, (label, k)
        assert torch.equal(a, b), f"{label}: {k} differs"


def _chunk(seed, t=0):
    """Chunk t of the reference's stream ``seed`` at HH x WW."""
    raw, gtb, gtv = JS.generate_chunk(None, JS.StreamConfig(
        height=HH, width=WW, n_objects=3, seed=seed), t * T, T)
    return np.array(raw), np.array(gtb), np.array(gtv)


@pytest.fixture(scope="module")
def streams():
    data = [_chunk(s) for s in range(max(SIZES))]
    return tuple(np.stack([d[i] for d in data]) for i in range(3))


def _scalars(n):
    return dict(tr1=np.full(n, 0.5, np.float32),
                tr2=np.full(n, 0.02, np.float32),
                bw_kbps=np.linspace(1500.0, 8000.0, n).astype(np.float32),
                queue_delay=np.linspace(0.0, 0.03, n).astype(np.float32))


# ------------------------------------------------------- rules and specs
@pytest.mark.parametrize("name", RULE_TABLES)
def test_rule_tables_and_specs_match_reference(name):
    ours, ref = getattr(SH, name), getattr(JSH, name)
    assert dict(ours.table) == dict(ref.table)
    logical = [("batch", None, "tensor"), ("fsdp", "tensor"),
               ("stream", None), ("expert", "seq_kv", None), (None,),
               ("missing", "batch")]
    for axes in logical:
        spec, jspec = SH.logical_to_spec(axes, ours), \
            JSH.logical_to_spec(axes, ref)
        assert tuple(spec) == tuple(jspec), axes
        for shape in SHAPES:
            mesh = SimpleNamespace(shape=shape)
            if not all(a in shape for e in spec if e is not None
                       for a in (e if isinstance(e, tuple) else (e,))):
                continue
            for dims in ((8, 6, 4), (3, 5, 7), (4, 4)):
                assert tuple(SH.validated_spec(spec, dims, mesh)) == \
                    tuple(JSH.validated_spec(jspec, dims, mesh)), \
                    (axes, shape, dims)
        for shape in SHAPES:
            mesh = SimpleNamespace(shape=shape)
            assert SS.stream_axis_names(mesh, ours) == \
                JSS.stream_axis_names(mesh, ref)
            assert SS.stream_shard_count(mesh, ours) == \
                JSS.stream_shard_count(mesh, ref)
            assert tuple(SS.stream_partition_spec(mesh, ours)) == \
                tuple(JSS.stream_partition_spec(mesh, ref))


def test_named_rules_and_stream_extents_match_reference():
    assert set(SH._NAMED_RULES) == set(JSH._NAMED_RULES)
    for (pods, variant), rules in JSH._NAMED_RULES.items():
        ours = SH.make_axis_rules(pods == "multi", variant)
        assert dict(ours.table) == dict(rules.table)
    dp = SimpleNamespace(shape={"data": 2, "model": 2})
    assert SS.stream_shard_count(dp, SH.SINGLE_POD_RULES_DP) == 4 == \
        JSS.stream_shard_count(dp, JSH.SINGLE_POD_RULES_DP)
    assert SH.SINGLE_POD_RULES.mesh_axes("stream") == ("data",)
    assert SH.MULTI_POD_RULES.mesh_axes("stream") == ("pod", "data")
    assert SH.SINGLE_POD_RULES.mesh_axes(None) == ()
    assert repr(SH.P("data", None)) == "P('data', None)"


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 3, 4, 8, 9])
def test_pad_stream_axis_matches_reference(S, n):
    rng = np.random.default_rng([S, n])
    tree = {"a": rng.standard_normal((S, 3)).astype(np.float32),
            "b": rng.integers(-5, 5, (S,)).astype(np.int32),
            "c": rng.random((S, 2, 2)) > 0.5}
    ours = SS.pad_stream_axis(tree, n)
    ref = JSS.pad_stream_axis(tree, n)
    for k in tree:
        assert ours[k].shape[0] == -(-S // n) * n
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))
        assert ours[k].numpy().dtype == np.asarray(ref[k]).dtype


# ------------------------------------------------------------------ mesh
def test_mesh_make_mesh_and_context():
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert list(mesh.shape.items()) == [("data", 2), ("model", 2)]
    assert mesh.size == 4 and mesh.devices.shape == (2, 2)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert isinstance(SS.stream_sharding(mesh, SH.SINGLE_POD_RULES_DP),
                      NamedSharding)
    # no CUDA here: make_mesh never falls back to the CPU or repeats
    with pytest.raises(RuntimeError, match="needs 1 CUDA devices"):
        make_mesh((1,), ("data",))
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((4,), ("data",), devices=["cpu"] * 3)
    with pytest.raises(ValueError):
        Mesh(np.array(["cpu", "cpu"], dtype=object), ("data", "model"))
    assert current_ctx() is None
    with shard_ctx(mesh, SH.SINGLE_POD_RULES_DP) as ctx:
        assert current_ctx() is ctx
        assert ctx.stream_axes == ("data", "model")
        assert ctx.stream_shards == 4 and ctx.batch_axes == ("data", "model")
        with shard_ctx(mesh, SH.SINGLE_POD_RULES) as inner:
            assert inner.stream_shards == 2 and inner.tensor_axes == ("model",)
        assert current_ctx() is ctx
    assert current_ctx() is None


def test_shard_map_places_slices_row_major_and_replicates_once():
    devs = [torch.device("cpu", i) for i in range(4)]
    mesh = make_mesh((2, 2), ("data", "model"), devices=devs)
    # slice i of a split over some axes goes to the mesh positions whose
    # coordinates on those axes, row-major in the spec's order, are i
    grid = [{"data": d, "model": m} for d in (0, 1) for m in (0, 1)]
    assert [SMC._block(mesh, ("data", "model"), c) for c in grid] == \
        [0, 1, 2, 3]
    assert [SMC._block(mesh, ("model", "data"), c) for c in grid] == \
        [0, 2, 1, 3]
    assert [SMC._block(mesh, ("data",), c) for c in grid] == [0, 0, 1, 1]
    seen = []

    def body(x, w):
        seen.append(w["a"])
        return {"y": x * w["a"]}

    run = SMC.shard_map_compat(body, mesh, (SH.P(("data", "model")),
                                            SH.P()), SH.P(("data", "model")))
    w = {"a": torch.tensor(2.0)}
    torch.testing.assert_close(run(torch.arange(8.0), w)["y"],
                               torch.arange(8.0) * 2, rtol=0, atol=0)
    first = list(seen)
    assert len({id(a) for a in first}) == 4     # one copy a device
    run(torch.arange(8.0), w)
    assert all(a is b for a, b in zip(seen[4:], first))   # kept
    w["a"].add_(1.0)                                       # changed in place
    assert torch.equal(run(torch.arange(8.0), w)["y"], torch.arange(8.0) * 3)
    assert not any(a is b for a, b in zip(seen[8:], first))
    with pytest.raises(ValueError, match="does not split 4 ways"):
        run(torch.arange(6.0), w)
    # a split of a later dimension, and of two dimensions, gathers back to
    # the operand (the MoE slice's specs; tests/test_torch_moe.py holds
    # them and the reductions in full)
    m = torch.arange(32.0).reshape(4, 8)
    for spec in (SH.P(None, "data"), SH.P("data", "model")):
        same = SMC.shard_map_compat(lambda x: x.clone(), mesh, (spec,), spec)
        assert torch.equal(same(m), m)
    with pytest.raises(NotImplementedError, match="no operand is split"):
        SMC.shard_map_compat(body, mesh, (SH.P("data"), SH.P()),
                             SH.P("model"))
    with pytest.raises(ValueError, match="not in the mesh"):
        SMC.shard_map_compat(body, mesh, (SH.P("pod"), SH.P()), SH.P())


# ---------------------------------------------------- the sharded forms
_batched_cache = {}


def _batched(form, S, streams, params):
    """The port's unsharded batched form on the first S streams."""
    key = (form, S)
    if key not in _batched_cache:
        raw, gtb, gtv = (x[:S] for x in streams)
        sc = _scalars(S)
        if form == "roundtrip":
            out = RT.roundtrip_batched(raw, gtb, gtv, params,
                                       cfg=RT.RoundtripConfig(level=3),
                                       device="cpu", **sc)
        elif form == "encode":
            out = V.encode_chunk_batched(_lr(raw), V.VideoCodecConfig(),
                                         device="cpu")
        else:
            out = H.decode_execute_batched(*_execute_inputs(raw, gtb, gtv),
                                           params, DET, device="cpu",
                                           **_execute_scalars(S))
        _batched_cache[key] = out
    return _batched_cache[key]


def _lr(raw):
    return np.stack([_frames(48, 64, s) for s in range(raw.shape[0])])


def _execute_inputs(raw, gtb, gtv):
    enc = V.encode_chunk_batched(_lr(raw), V.VideoCodecConfig(),
                                 device="cpu")
    S = raw.shape[0]
    types = np.tile(np.array([1, 3, 2, 2], np.int32), (S, 1))
    types[1::2, 2] = 1
    anchor = np.where(types[..., None, None] == 1, raw, 0.0) \
        .astype(np.float32)
    return enc, types, anchor, gtb, gtv


def _execute_scalars(S):
    return dict(bw_kbps=np.linspace(900.0, 6000.0, S).astype(np.float32),
                queue_delay=np.linspace(0.0, 0.05, S).astype(np.float32),
                total_bits=np.linspace(1e4, 3e4, S).astype(np.float32))


@pytest.fixture(scope="module")
def params(weights):   # noqa: F811
    return weights[1]


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_roundtrip_equals_batched(streams, params, mesh_name, S):
    mesh, rules = _mesh(mesh_name)
    raw, gtb, gtv = (x[:S] for x in streams)
    out = SS.shard_roundtrip(mesh, rules, cfg=RT.RoundtripConfig(level=3))(
        raw, gtb, gtv, params, **_scalars(S))
    _equal(out, _batched("roundtrip", S, streams, params),
           f"mesh {mesh_name} S={S}")


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_encode_equals_batched(streams, params, mesh_name, S):
    mesh, rules = _mesh(mesh_name)
    lr = _lr(streams[0][:S])
    out = SS.shard_encode(mesh, rules, cfg=V.VideoCodecConfig())(lr)
    _equal(out, _batched("encode", S, streams, params),
           f"mesh {mesh_name} S={S}")


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_shard_streams_equals_batched(streams, params, mesh_name, S):
    mesh, rules = _mesh(mesh_name)
    raw, gtb, gtv = (x[:S] for x in streams)
    out = SS.shard_streams(mesh, rules, det_cfg=DET)(
        *_execute_inputs(raw, gtb, gtv), params, **_execute_scalars(S))
    _equal(out, _batched("execute", S, streams, params),
           f"mesh {mesh_name} S={S}")


ROUNDTRIP_VARIANTS = {
    "mixed_ladder": (RT.RoundtripConfig(), dict(levels=True)),
    "anchor_search": (RT.RoundtripConfig(level=3, anchor_search=True), {}),
    "roi_padded_canvas": (
        RT.RoundtripConfig(roi=RoiConfig(capacity=3),
                           codec=V.VideoCodecConfig(search="diamond",
                                                    dtype="bfloat16")),
        dict(levels=True, canvas=True)),
}


@pytest.mark.parametrize("S", [3, 8])
@pytest.mark.parametrize("mesh_name", ["2", "4", "2x2"])
@pytest.mark.parametrize("variant", list(ROUNDTRIP_VARIANTS))
def test_shard_roundtrip_variants_equal_batched(streams, params, variant,
                                                mesh_name, S):
    """The mixed ladder (S=3 on 2 and 4 shards: non-divisible), the budget
    search and the ROI gate on the full LR canvas, each bit for bit its
    unsharded form."""
    cfg, kw = ROUNDTRIP_VARIANTS[variant]
    mesh, rules = _mesh(mesh_name)
    raw, gtb, gtv = (x[:S] for x in streams)
    sc = _scalars(S)
    levels = MIXED[:S] if kw.get("levels") else None
    canvas = RT.full_lr_canvas(HH, WW) if kw.get("canvas") else None
    out = SS.shard_roundtrip(mesh, rules, cfg=cfg)(
        raw, gtb, gtv, params, levels=levels, canvas=canvas, **sc)
    if canvas is not None:
        lr_pad = RT._downscale_pad(torch.from_numpy(raw), levels, canvas)
        ext, qual = RT.ladder_batch_arrays(levels, HH, WW, device="cpu")
        ref = RT.roundtrip_padded_batched(raw, lr_pad, ext, qual, gtb, gtv,
                                          params, cfg=cfg, device="cpu",
                                          **sc)
    elif levels is not None:
        ref = RT.roundtrip_ladder_batched(raw, gtb, gtv, params,
                                          levels=levels, cfg=cfg,
                                          device="cpu", **sc)
    else:
        ref = RT.roundtrip_batched(raw, gtb, gtv, params, cfg=cfg,
                                   device="cpu", **sc)
    _equal(out, ref, f"{variant} mesh {mesh_name} S={S}")


def test_zero_lanes_stay_finite(params):
    """The padded lanes of a non-divisible mesh are all zeros (constant
    frames, bandwidth 0, no boxes): the batched forms on such lanes give
    finite values in every output, so no NaN can reach a reduction."""
    zeros = np.zeros((3, T, HH, WW), np.float32)
    gtb = np.zeros((3, T, 3, 4), np.float32)
    gtv = np.zeros((3, T, 3), bool)
    hp, wp = RT.full_lr_canvas(HH, WW)
    outs = [RT.roundtrip_padded_batched(
        zeros, np.zeros((3, T, hp, wp), np.float32),
        np.tile(np.array([hp, wp], np.int32), (3, 1)),
        np.full(3, 50.0, np.float32), gtb, gtv, params, tr1=0.0, tr2=0.0,
        bw_kbps=0.0, cfg=cfg, device="cpu")
        for cfg in (RT.RoundtripConfig(), RT.RoundtripConfig(
            anchor_search=True, roi=RoiConfig(capacity=3)))]
    enc = V.encode_chunk_batched(zeros[:, :, :48, :64], device="cpu")
    outs.append(dataclasses.asdict(enc))
    outs.append(H.decode_execute_batched(
        enc, np.zeros((3, T), np.int32), zeros, gtb, gtv, params, DET,
        bw_kbps=0.0, queue_delay=0.0, total_bits=0.0, device="cpu"))
    for out in outs:
        for k, v in out.items():
            if v.is_floating_point():
                assert bool(torch.isfinite(v).all()), k


# ------------------------------------- one device: against the reference
@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1,), ("data",))


@pytest.mark.parametrize("variant", ["uniform", *ROUNDTRIP_VARIANTS])
def test_shard_roundtrip_single_device_matches_reference(
        streams, weights, jmesh, variant):   # noqa: F811
    jparams, params = weights
    cfg, kw = ROUNDTRIP_VARIANTS.get(variant,
                                     (RT.RoundtripConfig(level=3), {}))
    S = 3
    raw, gtb, gtv = (x[:S] for x in streams)
    sc = _scalars(S)
    levels = MIXED[:S] if kw.get("levels") else None
    mesh, rules = _mesh("1")
    out = SS.shard_roundtrip(mesh, rules, cfg=cfg)(
        raw, gtb, gtv, params, levels=levels, **sc)
    ref = JSS.shard_roundtrip(jmesh, JSH.SINGLE_POD_RULES, cfg=_jcfg(cfg))(
        raw, gtb, gtv, jparams, levels=levels, **sc)
    _hold_outputs(out, ref, f"{variant}: ")


def test_shard_encode_and_streams_single_device_match_reference(
        streams, weights, jmesh):   # noqa: F811
    jparams, params = weights
    mesh, rules = _mesh("1")
    raw, gtb, gtv = (x[:3] for x in streams)
    lr = _lr(raw)
    ours = SS.shard_encode(mesh, rules, cfg=V.VideoCodecConfig())(lr)
    ref = JSS.shard_encode(jmesh, JSH.SINGLE_POD_RULES,
                           cfg=JV.VideoCodecConfig())(jnp.asarray(lr))
    _hold_encode(ours, ref)
    enc, types, anchor, gtb, gtv = _execute_inputs(raw, gtb, gtv)
    jenc = JV.EncodedChunk(**{k: jnp.asarray(getattr(enc, k).numpy())
                              for k in ENC_FIELDS})
    sc = _execute_scalars(3)
    ours = SS.shard_streams(mesh, rules, det_cfg=DET)(
        enc, types, anchor, gtb, gtv, params, **sc)
    ref = JSS.shard_streams(jmesh, JSH.SINGLE_POD_RULES, det_cfg=JDET)(
        jenc, jnp.asarray(types), jnp.asarray(anchor), jnp.asarray(gtb),
        jnp.asarray(gtv), jparams, **sc)
    _hold_outputs(ours, ref)


# ---------------------------------------------------------------- remesh
def test_remesh_respects_power_of_two_and_raises_when_empty():
    devs = [torch.device("cpu", i) for i in range(4)]
    pool = ElasticPool(4)
    mesh4 = remesh(pool, devices=devs)
    assert mesh4.shape == {"data": 4, "model": 1}
    pool.fail(0)
    assert pool.usable_power_of_two() == 2
    m = remesh(pool, devices=devs)
    assert m.shape["data"] == 2
    assert devs[0] not in list(m.devices.flat)     # failed group left
    assert set(m.devices.flat) < set(mesh4.devices.flat)
    two = remesh(ElasticPool(4), n_model=2, devices=devs)
    assert two.shape == {"data": 2, "model": 2}
    # groups that do not divide the devices are logical: the data axis
    # shrinks over the leading devices
    logical = ElasticPool(3, healthy=np.array([True, False, True]))
    assert list(remesh(logical, devices=devs).devices.flat) == devs[:2]
    with pytest.raises(ValueError, match="n_model"):
        remesh(pool, n_model=0, devices=devs)
    with pytest.raises(RuntimeError, match="cannot host n_model=8"):
        remesh(pool, n_model=8, devices=devs)
    for g in (1, 2, 3):
        pool.fail(g)
    with pytest.raises(RuntimeError, match="0 of 4 groups healthy"):
        remesh(pool, devices=devs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        remesh(ElasticPool(1))


def test_eviction_remesh_roundtrip_bit_exact(streams, params):
    """Kill a device group, rebuild the mesh from the survivors and run
    the same streams again: every stream bit for bit the batched form."""
    raw, gtb, gtv = (x[:4] for x in streams)
    cfg = RT.RoundtripConfig(level=3)
    ref = _batched("roundtrip", 4, streams, params)
    devs = [torch.device("cpu", i) for i in range(4)]
    pool = ElasticPool(4)
    mesh4 = remesh(pool, devices=devs)
    out4 = SS.shard_roundtrip(mesh4, SH.SINGLE_POD_RULES, cfg=cfg)(
        raw, gtb, gtv, params, **_scalars(4))
    pool.fail(3)
    mesh2 = remesh(pool, devices=devs)
    assert mesh2.size == 2
    assert set(mesh2.devices.flat) < set(mesh4.devices.flat)
    out2 = SS.shard_roundtrip(mesh2, SH.SINGLE_POD_RULES, cfg=cfg)(
        raw, gtb, gtv, params, **_scalars(4))
    _equal(out4, ref, "pre-fault mesh")
    _equal(out2, ref, "post-eviction mesh")


# ------------------------------------------------------ runtime, mesh mode
def _rt(params, mesh_name=None, **kw):
    """A runtime on a logical CPU mesh, or with logical shards."""
    cfg = SCH.ServingConfig(n_streams=kw.pop("n_streams", 4), **kw)
    if mesh_name is None:
        return R.EdgeRuntime(cfg, params, DET, device="cpu")
    mesh, rules = _mesh(mesh_name)
    return R.EdgeRuntime(cfg, params, DET, mesh=mesh, rules=rules)


def _equal_poll(a, b, where=""):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=where)


def test_runtime_defers_on_per_shard_not_global_depth(params):
    """Two mesh shards, shard 0 saturated: the stream on shard 0 defers
    while the stream on shard 1, at the same global backlog, still
    admits; the depths and decisions are the reference's."""
    rt = _rt(params, "2", n_streams=2, gpu_capacity_fps=40.0,
             latency_budget=1.0)
    assert rt.n_shards == 2 and rt.cfg.n_shards == 2
    jcfg = JSCH.ServingConfig(n_streams=2, n_shards=2, gpu_capacity_fps=40.0,
                              latency_budget=1.0)
    jq, jadm = JSCH.PipelineQueues(jcfg, lambda f: []), \
        JSCH.AdmissionController(jcfg)
    frame = np.zeros((8, 8), np.float32)
    for i in range(18):
        rt.queues.submit(SCH.InferRequest(0, 0, i, 1, frame, shard=0))
        jq.submit(JSCH.InferRequest(0, 0, i, 1, frame, shard=0))
    depths = rt.queues.shard_depths
    np.testing.assert_array_equal(depths, jq.shard_depths)
    assert depths[0, 0] == 18 and depths[1].sum() == 0
    assert not rt.admission.admit_shard(depths, 0, 4)
    assert rt.admission.admit_shard(depths, 1, 4)
    assert rt.admission.admit(rt.queues.depths, 4)
    for s, n in ((0, 4), (1, 4)):
        assert rt.admission.admit_shard(depths, s, n) == \
            jadm.admit_shard(jq.shard_depths, s, n)


def test_edge_runtime_hot_shard_defers_stream_to_reuse(weights,
                                                       packets_mesh):
    """Shard 0's queue saturated: its stream's type-2 frames defer to
    reuse, shard 1's stream is admitted; mesh mode == logical shards bit
    for bit, and the reference's runtime within its contract."""
    jparams, params = weights
    kw = dict(n_streams=2, gpu_capacity_fps=16.0, latency_budget=1.0)
    rts = [_rt(params, "2", **kw), _rt(params, n_shards=2, **kw)]
    jrt = JR.EdgeRuntime(JSCH.ServingConfig(n_shards=2, **kw), jparams,
                         JDET)
    frame = np.zeros((HH, WW), np.float32)
    jp = packets_mesh[0, 0]
    outs = []
    for r in (*rts, jrt):
        assert r.stream_shard(0) == 0 and r.stream_shard(1) == 1
        req = SCH.InferRequest if r is not jrt else JSCH.InferRequest
        for i in range(12):
            r.queues.submit(req(9, 9, i, 1, frame, shard=0))
        pk = port_packet(jp) if r is not jrt else jp
        outs.append([r.process_chunk(s, 0, pk) for s in range(2)])
        assert list(r.deferred_by_shard) == [1, 0]
    (t0, t1) = (o[2] for o in outs[0])
    assert (t0 == np.where(jp.types == 2, 3, jp.types)).all()
    assert (t1 == jp.types).all()
    for s in range(2):
        _equal_poll(outs[0][s], outs[1][s], f"stream {s}")
        _hold_poll(outs[0][s], outs[2][s], f"stream {s}")


@pytest.fixture(scope="module")
def packets_mesh():
    """Reference packets of 4 streams x 2 chunks, with pipeline ② frames
    (tr1=0.5, tr2=0.02 drive it)."""
    return {(s, t): JE.encode_hybrid(_chunk(s, t)[0], 6000.0, 0.5, 0.02)
            for s in range(4) for t in range(2)}


def _serve(rt, packets, rounds=2, batch=True):
    """Rounds of every stream: batch-submit (submit all, one flush, poll
    all) or chunk-sequential ``process_chunk``."""
    polls = []
    for t in range(rounds):
        pks = [port_packet(packets[s, t]) for s in range(4)]
        if batch:
            tks = [rt.submit_chunk(s, t, pk) for s, pk in enumerate(pks)]
            rt.flush()
            polls += [rt.poll(tk) for tk in tks]
        else:
            polls += [rt.process_chunk(s, t, pk) for s, pk in enumerate(pks)]
    return polls


@pytest.mark.parametrize("roi", [None, RoiConfig(capacity=3)],
                         ids=["full", "roi"])
@pytest.mark.parametrize("mesh_name", ["4", "2x2"])
def test_runtime_mesh_mode_equals_logical_shards(params, packets_mesh,
                                                 mesh_name, roi):
    """Four streams, two rounds, batch-submit then chunk-sequential: the
    mesh-mode runtime (four shards of a logical CPU mesh) gives the
    logical-shard runtime's detections and stats bit for bit."""
    kw = dict(roi=roi) if roi is not None else {}
    ours = _rt(params, mesh_name, **kw)
    ref = _rt(params, n_shards=4, **kw)
    assert ours.n_shards == 4 and len(ours._shard_infer) == 4
    # one distinct device: one detector shared by the four shards
    assert len({id(f) for f in ours._shard_infer}) == 1
    for batch in (True, False):
        for a, b in zip(_serve(ours, packets_mesh, batch=batch),
                        _serve(ref, packets_mesh, batch=batch)):
            _equal_poll(a, b)
    assert ours.deferred_by_shard.tolist() == ref.deferred_by_shard.tolist()
    assert {c: s.as_dict() for c, s in ours.stats.items()} == \
        {c: s.as_dict() for c, s in ref.stats.items()}
    ours.close()
    ref.close()


def test_runtime_mesh_mode_detectors_per_device_and_hedge(params):
    devs = [torch.device("cpu", i) for i in (1, 2, 1, 2)]
    mesh = make_mesh((4,), ("data",), devices=devs)
    sched = F.FaultSchedule([F.FaultEvent("shard_slow", 1, 6, target=1,
                                          magnitude=8.0)], seed=0)
    rt = R.EdgeRuntime(SCH.ServingConfig(n_streams=4), params, DET,
                       mesh=mesh, rules=SH.SINGLE_POD_RULES, faults=sched)
    assert rt.device == torch.device("cpu", 1)        # the first device
    f = rt._shard_infer
    assert f[0] is f[2] and f[1] is f[3] and f[0] is not f[1]
    assert rt._hedge.replicas == f
    assert rt.evict_shard(1, 0)
    assert rt._hedge.replicas == [f[0], f[2], f[3]]
    rt.close()


def test_runtime_eviction_serves_all_streams(params, packets_mesh):
    """Mesh mode on four logical shards, shard 2 evicted: every stream,
    the evicted shard's included, is served on a survivor with the
    no-fault runtime's frame types and detections."""
    rt = _rt(params, "4", gpu_capacity_fps=480.0)
    oracle = _rt(params, gpu_capacity_fps=480.0)
    assert rt.evict_shard(2, t=0)
    assert rt.active_shards == [0, 1, 3]
    for s in range(4):
        assert rt.stream_shard(s) in rt.active_shards
        _equal_poll(rt.process_chunk(s, 0, port_packet(packets_mesh[s, 0])),
                    oracle.process_chunk(s, 0,
                                         port_packet(packets_mesh[s, 0])),
                    f"stream {s}")
    assert int(rt.deferred) == 0
    for st in rt.stats.values():
        assert st.frames_in == st.frames_inferred + st.frames_reused \
            + st.frames_skipped


def test_eviction_remesh_runtime_rebuilt_serves_survivors(params,
                                                          packets_mesh):
    """The runtime on remesh(pool) of four logical devices, then shard 3
    failed and the runtime rebuilt on the remeshed two: the same streams
    are all served, each with the no-fault runtime's detections."""
    pool = ElasticPool(4)
    rules = SH.SINGLE_POD_RULES
    cfg = SCH.ServingConfig(n_streams=4, gpu_capacity_fps=480.0)
    before = R.EdgeRuntime(cfg, params, DET, mesh=remesh(
        pool, devices=["cpu"] * 4), rules=rules)
    polls = _serve(before, packets_mesh)
    pool.fail(3)
    after = R.EdgeRuntime(cfg, params, DET, mesh=remesh(
        pool, devices=["cpu"] * 4), rules=rules)
    assert after.n_shards == 2
    for a, b in zip(_serve(after, packets_mesh), polls):
        _equal_poll(a, b)
    for st in after.stats.values():
        assert st.frames_in == st.frames_inferred + st.frames_reused \
            + st.frames_skipped


def test_eviction_while_in_flight_bit_exact(params, packets_mesh):
    """Evict a shard between submit and flush, another shard's batch
    already dispatched: the pending ticket re-homes to a survivor and
    every stream polls bit for bit the no-fault runtime's."""
    rt = _rt(params, "4", gpu_capacity_fps=480.0)
    oracle = _rt(params, gpu_capacity_fps=480.0)
    pks = [port_packet(packets_mesh[s, 0]) for s in range(4)]
    tks = [rt.submit_chunk(s, 0, pks[s]) for s in range(4)]
    rt.flush(shard=rt.stream_shard(0))
    assert tks[0].done
    victim = rt.stream_shard(2)
    assert rt.evict_shard(victim, t=0)
    assert tks[2].shard in rt.active_shards
    for s, out in enumerate(rt.poll_all(tks)):
        _equal_poll(out, oracle.process_chunk(s, 0, pks[s]), f"stream {s}")
    for st in rt.stats.values():
        assert st.frames_in == st.frames_inferred + st.frames_reused \
            + st.frames_skipped


def test_runtime_mesh_mode_straggler_eviction_matches_logical(weights,
                                                              packets_mesh):
    """Two mesh shards, shard 1 eight times slower over chunks 1-5: the
    eviction, recovery, hedges and fault log are the logical-shard
    runtime's and the reference's."""
    jparams, params = weights
    sched = F.FaultSchedule([F.FaultEvent("shard_slow", 1, 6, target=1,
                                          magnitude=8.0)], seed=0)
    jsched = JF.FaultSchedule([JF.FaultEvent("shard_slow", 1, 6, target=1,
                                             magnitude=8.0)], seed=0)
    mesh, rules = _mesh("2")
    cfg = SCH.ServingConfig(n_streams=3)
    rts = [R.EdgeRuntime(cfg, params, DET, mesh=mesh, rules=rules,
                         faults=sched),
           R.EdgeRuntime(dataclasses.replace(cfg, n_shards=2), params, DET,
                         faults=sched, device="cpu"),
           JR.EdgeRuntime(JSCH.ServingConfig(n_streams=3, n_shards=2),
                          jparams, JDET, faults=jsched)]
    for r in rts:
        r.straggler.cfg.patience, r.straggler.cfg.window = 2, 4
    for t in range(8):
        polls = []
        for r in rts:
            pk = [packets_mesh[s, t % 2] for s in range(3)]
            polls.append([r.process_chunk(s, t, p if r is rts[2]
                                          else port_packet(p))
                          for s, p in enumerate(pk)])
            r.poll_faults(t)
        for a, b, c in zip(*polls):
            _equal_poll(a, b)
            _hold_poll(a, c)
        assert rts[0].active_shards == rts[1].active_shards \
            == rts[2].active_shards
    assert rts[0].fault_log == rts[1].fault_log == rts[2].fault_log
    assert [a for _, a, _ in rts[0].fault_log] == ["evict", "recover"]
    assert rts[0].hedged_dispatches == rts[2].hedged_dispatches
    _hold_stats(rts[0], rts[2])
    for r in rts:
        r.close()


# ------------------------------------------------------ the device guard
def test_launch_runs_the_entry_under_the_tensors_device(monkeypatch):
    """``build.launch`` calls the C entry inside ``torch.cuda.device(d)``
    for the device the wrapper passes, with that device's stream last."""
    state = {"inside": None, "calls": []}

    class FakeDevice:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            state["inside"] = self.device

        def __exit__(self, *exc):
            state["inside"] = None
            return False

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(build, "stream_ptr",
                        lambda d: ("stream of", d, state["inside"]))

    def entry(*args):
        state["calls"].append((state["inside"], args))
        return state.get("code", 0)

    entry.error_string = lambda code: b"an error"
    dev = torch.device("cuda", 1)
    before = build.LAUNCHES["fake"]
    build.launch("fake", entry, dev, 7, 8)
    assert state["calls"] == [(dev, (7, 8, ("stream of", dev, dev)))]
    assert state["inside"] is None and build.LAUNCHES["fake"] == before + 1
    state["code"] = 700
    with pytest.raises(RuntimeError, match="fake kernel launch failed: "
                                           "CUDA error 700 .an error."):
        build.launch("fake", entry, dev)
    assert build.LAUNCHES["fake"] == before + 1
    del build.LAUNCHES["fake"]


def test_every_wrapper_launches_on_its_checked_tensors_device():
    """Each ``build.launch`` call of a kernel wrapper passes the device of
    the first tensor it hands the kernel, the device its checks hold every
    operand to."""
    root = pathlib.Path(build.__file__).parent
    calls = 0
    for path in sorted(root.glob("*/ops.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and \
                    ast.unparse(node.func) == "build.launch":
                calls += 1
                dev, first = node.args[2], node.args[3]
                assert isinstance(dev, ast.Attribute) and dev.attr == \
                    "device", (path, ast.unparse(node))
                assert ast.unparse(first) == \
                    f"build.ptr({ast.unparse(dev.value)})", \
                    (path, ast.unparse(node))
    assert calls == 7       # blockdct 2, motion_sad, qtransfer,
    # roi_gather, seq_sum, flash_attention
