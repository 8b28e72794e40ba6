"""The zoo's registry and cells in the port against the JAX package, with
nothing allocated: ``ARCH_IDS``, ``ALIASES`` and ``all_cells`` (the 40
(arch, shape, skip) triples); the six vision and diffusion configs, full
and reduced, field by field with their shapes, sources, parameter specs
and counts; ``build_cell`` on the ``meta`` device for every zoo cell,
its arguments' paths, shapes and dtypes the reference's; the training
launcher on a zoo arch; and the TinyDetector's bf16 ``dtype`` (``init``
by the reference's rule, ``forward`` raising ``TypeError`` in both
packages).  Everything here is exact."""
import dataclasses
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.launch import steps as JS
from repro.models import detection as JD
from repro.models.params import is_spec
from repro_torch import configs as CFG
from repro_torch.launch import steps as S
from repro_torch.launch import train as LT
from repro_torch.models import detection as D
from repro_torch.models import params as PM
from repro_torch.models.weights import detector_params_from_jax
from repro_torch.train import checkpoint as CKPT

ZOO = ("dit_xl2", "dit_b2", "resnet_152", "resnet_50", "convnext_b",
       "vit_b16")
# the published parameter counts (the reference's, from its specs)
PARAMS = {"resnet_50": 25_557_032, "resnet_152": 60_192_808,
          "convnext_b": 88_571_496, "vit_b16": 86_859_496,
          "dit_b2": 133_413_136, "dit_xl2": 679_406_992}


def _jax_specs(tree) -> list:
    """(path, shape, axes, init, scale, dtype name) of every reference
    spec, in sorted-key order."""
    leaves = jax.tree.flatten_with_path(tree, is_leaf=is_spec)[0]
    return [(tuple(k.key for k in path), s.shape, s.axes, s.init, s.scale,
             str(np.dtype(s.dtype))) for path, s in leaves]


def _port_specs(tree, prefix=()) -> list:
    if isinstance(tree, PM.ParamSpec):
        return [(prefix, tree.shape, tree.axes, tree.init, tree.scale,
                 str(tree.dtype).removeprefix("torch."))]
    return [leaf for k in sorted(tree)
            for leaf in _port_specs(tree[k], prefix + (k,))]


def _spec_list(tree):
    """(path, shape, dtype name) of every leaf, in sorted-key order."""
    return [(k, tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
            for k, leaf in CKPT._flatten(tree)]


def test_registry_equals_the_reference():
    assert CFG.ARCH_IDS == JCFG.ARCH_IDS
    assert CFG.ALIASES == JCFG.ALIASES
    cells = list(CFG.all_cells())
    assert cells == list(JCFG.all_cells())
    assert len(cells) == 40
    for alias in CFG.ALIASES:
        assert CFG.get_arch(alias).arch_id == JCFG.get_arch(alias).arch_id
    assert [dataclasses.asdict(c) for c in
            CFG.vision_shapes().values()] == \
        [dataclasses.asdict(c) for c in JCFG.vision_shapes().values()]
    assert [dataclasses.asdict(c) for c in
            CFG.diffusion_shapes().values()] == \
        [dataclasses.asdict(c) for c in JCFG.diffusion_shapes().values()]


@pytest.mark.parametrize("arch_id", ZOO)
@pytest.mark.parametrize("reduced", [False, True])
def test_zoo_configs_equal_the_reference(arch_id, reduced):
    ours, ref = CFG.get_arch(arch_id, reduced), JCFG.get_arch(arch_id,
                                                              reduced)
    assert (ours.arch_id, ours.family, ours.source) == \
        (ref.arch_id, ref.family, ref.source)
    assert type(ours.cfg).__name__ == type(ref.cfg).__name__
    assert dataclasses.asdict(ours.cfg) == dataclasses.asdict(ref.cfg)
    assert {k: dataclasses.asdict(v) for k, v in ours.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.shapes.items()}
    # counted from the specs: nothing is allocated
    assert ours.cfg.param_count() == ref.cfg.param_count()
    if not reduced:
        assert ours.cfg.param_count() == PARAMS[arch_id]
    specs = S._model(ours).param_specs(ours.cfg)
    jspecs = JS._specs_tree(ref)
    assert _port_specs(specs) == _jax_specs(jspecs)
    assert PM.param_bytes(specs) == sum(
        int(np.prod(s.shape)) * np.dtype(s.dtype).itemsize
        for s in jax.tree.leaves(jspecs, is_leaf=is_spec))


@pytest.mark.parametrize("arch_id", ZOO)
def test_build_cell_on_meta_equals_the_reference(arch_id):
    """Every shape of the arch at full size: the arguments on ``meta``,
    with the reference's paths, shapes and dtypes."""
    arch, jarch = CFG.get_arch(arch_id), JCFG.get_arch(arch_id)
    for name, case in arch.shapes.items():
        cell = S.build_cell(arch, case)
        jcell = JS.build_cell(jarch, jarch.shapes[name])
        assert (cell.name, cell.kind, cell.donate) == \
            (jcell.name, jcell.kind, jcell.donate)
        assert len(cell.args) == len(jcell.args)
        for a, b in zip(cell.args, jcell.args):
            assert all(leaf.device.type == "meta"
                       for _, leaf in CKPT._flatten(a))
            assert _spec_list(a) == _spec_list(b), (arch_id, name)
        assert callable(cell.fn)


def test_train_launcher_on_resnet_50():
    """``python -m repro_torch.launch.train --arch resnet_50`` (reduced, as
    the reference), 2 steps on the CPU with a checkpoint: the state holds
    the batch stats, which the loop saves and the steps move."""
    with tempfile.TemporaryDirectory() as d:
        hist = LT.main(["--arch", "resnet_50", "--steps", "2",
                        "--log-every", "1", "--ckpt-dir", d], device="cpu")
        assert CKPT.all_steps(d) == [1, 2]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_detector_bf16_init_and_forward():
    """bf16 parameters by the reference's rule (the f32 draw rounded to
    nearest even), the port's and the reference's each their f32 init's
    bits rounded; ``forward`` raises ``TypeError`` in both, as the
    reference's convolution does on f32 frames and bf16 weights."""
    cfg, jcfg = D.TinyDetectorConfig(dtype="bfloat16"), \
        JD.TinyDetectorConfig(dtype="bfloat16")
    ours = D.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    f32 = D.init(torch.Generator().manual_seed(0), D.TinyDetectorConfig(),
                 device="cpu")
    assert list(ours) == list(f32)
    for k, v in ours.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, f32[k].to(torch.bfloat16)), k
    key = jax.random.PRNGKey(0)
    ref = JD.init(key, jcfg)
    ref32 = detector_params_from_jax(
        {k: np.asarray(v) for k, v in JD.init(
            key, JD.TinyDetectorConfig()).items()}, "cpu")
    # the reference's bf16 bits are its f32 draws rounded as the port
    # rounds them
    for k, v in ref.items():
        a = np.asarray(v)
        assert str(a.dtype) == "bfloat16"
        got = torch.from_numpy(a.astype(np.float32))
        if got.dim() == 4:
            got = got.permute(3, 2, 0, 1)
        assert torch.equal(got, ref32[k].to(torch.bfloat16).float()), k
    frames = np.random.default_rng(0).integers(
        0, 256, (1, 16, 24)).astype(np.float32)
    with pytest.raises(TypeError, match="same dtypes"):
        JD.forward(ref, jcfg, frames)
    with pytest.raises(TypeError, match="same dtypes, got float32, "
                                        "bfloat16"):
        D.forward(ours, cfg, torch.from_numpy(frames))
