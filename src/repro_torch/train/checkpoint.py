"""Checkpointing: atomic, versioned, async-capable (port of
``repro.train.checkpoint``), in the reference's format, so that a
checkpoint written by either package restores in the other.

Save: every leaf goes to the host in one pass (each CUDA tensor copied
into a pinned buffer without waiting, then one synchronisation a device)
and is written as one ``.npz`` plus a JSON manifest (``{"step", "time",
"keys", "extra"}``).  Keys are the reference's path strings, dict keys
and list indices joined by ``/`` (``params/blocks/wq``, ``opt/step``);
bf16 leaves are written as the 2-byte void records the reference writes.
Writes go to ``.tmp_step_{n}``, renamed into place; the writer may run on
a background thread (``blocking=False`` returns it) while the loop steps
on.

Restore: into the structure of a like-tree, each leaf taking the
like-leaf's dtype, shape and device (a numpy like-leaf gives a numpy
array).  A void record restores as bfloat16, where the reference's
``jax.device_put`` rejects it (ROADMAP.md section 3).  With
``shardings`` (a matching tree of ``NamedSharding``, e.g. from
``distributed.sharding.tree_shardings``) each leaf is laid out across its
mesh instead (``distributed.mesh.device_put``): a cross-mesh elastic
restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SEP = "/"
_BF16_RECORD = np.dtype("V2")


def _flatten(tree, prefix=()):
    """(key, leaf) pairs in the reference's order: dict keys sorted, list
    and tuple items in turn; None is an empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    elif tree is not None:
        yield _SEP.join(prefix), tree


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`_flatten`'s order."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return None if like is None else next(leaves)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _host_arrays(leaves) -> list:
    """Each leaf as a host numpy array of its own, in one pass."""
    host, devices = [], set()
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            host.append(np.array(leaf))
            continue
        t = leaf.detach()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            devices.add(t.device)
        else:
            buf = t.clone()   # a later in-place update must not reach it
        host.append(buf)
    for dev in devices:
        torch.cuda.synchronize(dev)
    return [_numpy(h) if isinstance(h, torch.Tensor) else h for h in host]


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3,
         blocking: bool = True, extra: dict | None = None):
    """Returns the final checkpoint path (or the writer thread if
    ``blocking`` is false).  The leaves are on the host before it
    returns either way."""
    pairs = list(_flatten(tree))
    flat = dict(zip((k for k, _ in pairs),
                    _host_arrays(leaf for _, leaf in pairs)))
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")

    def _write():
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(flat.keys()), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return final
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            try:
                out.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _bf16_bits_to_f32(arr: np.ndarray) -> np.ndarray:
    return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def _restore_leaf(arr: np.ndarray, like, key: str):
    """The stored array as ``like``: its dtype, shape and device."""
    shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
    if arr.shape != shape:
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}, "
                         f"the like-tree {shape}")
    record = arr.dtype == _BF16_RECORD
    if isinstance(like, torch.Tensor):
        if record:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    return (_bf16_bits_to_f32(arr) if record else arr).astype(
        np.asarray(like).dtype)


def restore(ckpt_dir: str, step: int, like_tree, *, shardings=None):
    """Restore step ``step`` into the structure of ``like_tree``.

    ``shardings``: None, or a tree of ``NamedSharding`` with one a leaf of
    the like-tree (in its structure); each leaf then comes back laid out by
    its sharding, a ``Placed`` of the like-leaf's dtype.  Raises
    ``KeyError`` when the checkpoint lacks a key of the like-tree and
    ``ValueError`` on a shape mismatch or a sharding tree of another
    size."""
    from repro_torch.distributed.mesh import device_put
    path = os.path.join(ckpt_dir, f"step_{step}")
    flat = list(_flatten(like_tree))
    placements = [None] * len(flat) if shardings is None \
        else [s for _, s in _flatten(shardings)]
    if len(placements) != len(flat):
        raise ValueError(f"{len(placements)} shardings for {len(flat)} "
                         f"leaves")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        missing = [k for k, _ in flat if k not in data.files]
        if missing:
            raise KeyError(f"checkpoint {path} missing keys: {missing[:5]}")
        leaves = [_restore_leaf(data[k], like, k) for k, like in flat]
    leaves = [leaf if sh is None else device_put(leaf, sh)
              for leaf, sh in zip(leaves, placements)]
    return _unflatten(like_tree, iter(leaves))
