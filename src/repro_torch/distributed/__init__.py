"""Sharding over a mesh of devices (port of ``repro.distributed``): the
rule tables and placement by logical axes, a one-process mesh,
``shard_map`` (the stream specs, the MoE block's parameter specs and its
reductions), and the stream-sharded encode, execute and round trip."""
from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    SINGLE_POD_RULES,
    MULTI_POD_RULES,
    logical_to_spec,
    make_axis_rules,
)
from repro_torch.distributed.stream_sharding import (  # noqa: F401
    pad_stream_axis,
    shard_streams,
    stream_shard_count,
    stream_sharding,
)
