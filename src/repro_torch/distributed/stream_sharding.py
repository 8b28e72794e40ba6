"""Shard the batched stream forms over a mesh of devices (port of
``repro.distributed.stream_sharding``).

The batched chunk forms treat their leading axis as independent video
streams (there are no cross-stream collectives anywhere in the chunk
computation), so data-parallel placement over the mesh's "stream" axes
is exact: each device runs the same batched body over its slice of
streams and the results concatenate back bit for bit.

* the stream axis is zero-padded up to a multiple of the mesh's stream
  extent (3 streams on 4 devices stay legal; padded lanes are computed
  and dropped on exit);
* stream-leading operands are split over the rule table's "stream" axes;
  detector params are replicated, one copy a distinct device;
* outputs are gathered on the mesh's first device and unpadded back to
  the caller's stream count.

``shard_streams`` is the twin of ``decode_execute_batched``,
``shard_encode`` of ``encode_chunk_batched`` and ``shard_roundtrip`` of
``roundtrip_batched`` / ``roundtrip_ladder_batched`` (and, given a
``canvas``, ``roundtrip_padded_batched``).  Their bodies are the batched
forms' own (``_encode_batch``, ``_execute_batch`` and
``_roundtrip_ladder_body`` below), so the unsharded batched forms are the
oracle: every mesh, logical or not, must give their outputs bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.codec.video_codec import EncodedChunk
from repro_torch.codec.video_codec import _encode_chunk as _encode_batch
from repro_torch.core.hybrid_decoder import PipelineCosts
from repro_torch.core.hybrid_decoder import _execute_chunk as _execute_batch
from repro_torch.core.roundtrip import (_downscale_pad, _lanes,
                                        _roundtrip_ladder_body,
                                        ladder_batch_arrays)
from repro_torch.distributed.mesh import Mesh, NamedSharding
from repro_torch.distributed.shard_map_compat import (shard_map_compat,
                                                      tree_map)
from repro_torch.distributed.sharding import P, AxisRules

f32 = torch.float32


def stream_axis_names(mesh: Mesh, rules: AxisRules) -> tuple[str, ...]:
    """The rule table's "stream" axes that actually exist in ``mesh``."""
    return tuple(a for a in rules.mesh_axes("stream") if a in mesh.shape)


def stream_shard_count(mesh: Mesh, rules: AxisRules) -> int:
    """How many ways the stream axis splits on this mesh."""
    n = 1
    for a in stream_axis_names(mesh, rules):
        n *= mesh.shape[a]
    return n


def stream_partition_spec(mesh: Mesh, rules: AxisRules) -> P:
    axes = stream_axis_names(mesh, rules)
    if not axes:
        return P()
    return P(axes[0] if len(axes) == 1 else axes)


def stream_sharding(mesh: Mesh, rules: AxisRules) -> NamedSharding:
    return NamedSharding(mesh, stream_partition_spec(mesh, rules))


def pad_stream_axis(tree, n_shards: int):
    """Zero-pad every leaf's leading (stream) axis to a multiple of
    ``n_shards`` (leaves become tensors).  Zero lanes are safe: each
    stream's chunk computation is independent and total on degenerate
    inputs (constant frames, bandwidth 0 floored at 1e-6, no boxes), and
    the wrappers drop them on exit."""
    def one(x):
        x = torch.as_tensor(x)
        s = x.shape[0]
        s_pad = -(-s // n_shards) * n_shards
        if s_pad == s:
            return x
        return torch.cat([x, x.new_zeros((s_pad - s, *x.shape[1:]))])

    return tree_map(one, tree)


def _home(mesh: Mesh) -> torch.device:
    """Where the operands gather before the split and the outputs after."""
    return mesh.devices.flat[0]


def _unpad(out, s: int):
    return tree_map(lambda x: x[:s], out)


def shard_encode(mesh: Mesh, rules: AxisRules, *, cfg):
    """The mesh-sharded twin of ``encode_chunk_batched``.

    Returns ``run(frames)``, frames (S, T, H, W): the stream axis is
    zero-padded to the mesh's stream extent, each device encodes its
    slice of streams through the batched codec body, and the fields
    unpad back to S.  Zero-frame lanes are safe: the codec is total on
    constant frames (the all-ties motion search resolves first-wins).
    ``cfg`` (``VideoCodecConfig``) is bound at build time."""
    spec = stream_partition_spec(mesh, rules)
    n_shards = stream_shard_count(mesh, rules)
    sharded = shard_map_compat(lambda f: _encode_batch(f, cfg), mesh,
                               in_specs=(spec,), out_specs=spec)

    def run(frames) -> EncodedChunk:
        frames = torch.as_tensor(frames, dtype=f32, device=_home(mesh))
        (padded,) = pad_stream_axis((frames,), n_shards)
        return _unpad(sharded(padded), frames.shape[0])

    return run


def shard_roundtrip(mesh: Mesh, rules: AxisRules, *, cfg):
    """The mesh-sharded twin of ``roundtrip_batched`` /
    ``roundtrip_ladder_batched``.

    Returns ``run(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2,
    bw_kbps, queue_delay=0.0, levels=None, canvas=None)``, raw (S, T, H,
    W) source frames, the keyword scalars one for all or (S,).
    ``levels`` (one ladder rung a stream) defaults to ``cfg.level`` for
    all; each stream downscales to its rung on the mesh's first device,
    outside the sharded region, onto ``canvas`` ((hp, wp); by default the
    batch's largest LR shape, ``full_lr_canvas`` for the padded form's),
    and the sharded body is the mixed-ladder one, extents and qualities
    as data.  Padded lanes get the full canvas extent and quality 50 (a
    zero extent would make the masked means 0/0) and are dropped on exit.
    ``cfg.anchor_search`` rides through.  ``cfg`` (``RoundtripConfig``)
    is bound at build time."""
    spec = stream_partition_spec(mesh, rules)
    n_shards = stream_shard_count(mesh, rules)

    def body(raw, lr_pad, extents, qualities, gb, gv, params, lanes):
        return _roundtrip_ladder_body(raw, lr_pad, extents, qualities, gb,
                                      gv, params, lanes, cfg)

    sharded = shard_map_compat(
        body, mesh, in_specs=(spec, spec, spec, spec, spec, spec, P(), spec),
        out_specs=spec)

    def run(raw, gt_boxes, gt_valid, detector_params, *, tr1, tr2, bw_kbps,
            queue_delay=0.0, levels=None, canvas=None) -> dict:
        home = _home(mesh)
        raw = torch.as_tensor(raw, dtype=f32, device=home)
        s = raw.shape[0]
        levels = tuple(levels) if levels is not None else (cfg.level,) * s
        # the host data first: a host copy queued after the downscale
        # would wait for it
        extents, qualities = ladder_batch_arrays(levels, *raw.shape[2:],
                                                 device=home)
        streamed = (torch.as_tensor(gt_boxes, dtype=f32, device=home),
                    torch.as_tensor(gt_valid, device=home),
                    _lanes(home, s, tr1=tr1, tr2=tr2, bw_kbps=bw_kbps,
                           queue_delay=queue_delay),
                    raw, _downscale_pad(raw, levels, canvas))
        gb, gv, lanes, r, lp = pad_stream_axis(streamed, n_shards)
        pad = r.shape[0] - s
        if pad:
            # padded lanes: the full canvas extent (filled on the device,
            # for the same reason), nominal quality
            extents = torch.cat([extents, torch.stack([torch.full(
                (pad,), n, dtype=torch.int32, device=home)
                for n in lp.shape[2:]], 1)])
            qualities = torch.cat([qualities, torch.full(
                (pad,), 50.0, dtype=f32, device=home)])
        params = {k: torch.as_tensor(v) for k, v in detector_params.items()}
        out = sharded(r, lp, extents, qualities, gb, gv, params, lanes)
        return _unpad(out, s)

    return run


def shard_streams(mesh: Mesh, rules: AxisRules, *, det_cfg, costs=None):
    """The mesh-sharded twin of ``decode_execute_batched``.

    Returns ``run(enc, types, anchor_hd, gt_boxes, gt_valid,
    detector_params, *, bw_kbps, queue_delay, total_bits)``: every
    positional operand but the params has a leading stream axis of the
    same extent S, and the three keyword scalars are (S,) or one for all.
    S need not divide the mesh's stream extent.  ``det_cfg``/``costs``
    are bound at build time."""
    costs = costs or PipelineCosts()
    spec = stream_partition_spec(mesh, rules)
    n_shards = stream_shard_count(mesh, rules)

    def body(e, ty, ah, gb, gv, params, bw, qd, tb):
        return _execute_batch(e, ty, ah, gb, gv, params, det_cfg, bw, qd, tb,
                              costs)

    sharded = shard_map_compat(
        body, mesh, in_specs=(spec, spec, spec, spec, spec, P(), spec, spec,
                              spec),
        out_specs=spec)

    def run(enc, types, anchor_hd, gt_boxes, gt_valid, detector_params, *,
            bw_kbps, queue_delay, total_bits) -> dict:
        home = _home(mesh)
        types = torch.as_tensor(types, dtype=torch.int32, device=home)
        s = types.shape[0]
        enc = tree_map(lambda x: torch.as_tensor(x, device=home), enc)
        streamed = (enc, types,
                    torch.as_tensor(anchor_hd, dtype=f32, device=home),
                    torch.as_tensor(gt_boxes, dtype=f32, device=home),
                    torch.as_tensor(gt_valid, device=home),
                    *_lanes(home, s, bw=bw_kbps, qd=queue_delay,
                            tb=total_bits).values())
        e, ty, ah, gb, gv, bw, qd, tb = pad_stream_axis(streamed, n_shards)
        params = {k: torch.as_tensor(v) for k, v in detector_params.items()}
        out = sharded(e, ty, ah, gb, gv, params, bw, qd, tb)
        return _unpad(out, s)

    return run
