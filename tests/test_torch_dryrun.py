"""The port's dry-run tooling against the JAX package, all on the CPU:
``launch/mesh``, ``models/params.abstract_params``/``is_spec``,
``train/optimizer.abstract_state``, ``launch/steps.batch_specs`` and
``build_cell`` under a mesh, ``models/layers.constrain`` and
``launch/dryrun``.

(a) every non-skipped cell on the three production meshes under the
baseline and kvint8 variants: the port's ``ShapeDtypeStruct`` leaves have
the reference's paths, shapes, dtypes and per-device shard shapes, and
its per-device argument bytes the reference's sum (the reference's
layouts come from one child process with 512 forced CPU devices, built
without a compile); (b) the FLOPs counted on ``meta`` equal those counted
over real CPU tensors for a reduced config of each family; (c) the probes
at 2 and 4 layers give a 6-layer model's full-walk counts exactly; (d)
``constrain`` is the identity and raises where the reference's
``named_sharding`` does; (e) ``abstract_state`` and ``is_spec``; (f) ``main --list``, the skip record and the error
record; (g) every decode cell walks on ``meta``; (h) the kernel path
raises on ``meta``.  Everything is exact."""
import dataclasses
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import conftest
from repro import configs as JCFG
from repro.distributed import sharding as JSH
from repro.launch import steps as JS
from repro.models import params as JPM
from repro.train import optimizer as JOPT
from repro_torch import configs as CFG
from repro_torch.configs import ShapeCase
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.context import shard_ctx
from repro_torch.distributed.mesh import ShapeDtypeStruct, make_mesh
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import params as PM
from repro_torch.train import optimizer as OPT

MESHES = ("single", "multi", "degraded")
VARIANTS = ("baseline", "kvint8")
# per-device argument bytes of the reference on the single mesh, baseline
REFERENCE_BYTES = {("llama3_2_1b", "train_4k"): 223_039_492,
                   ("mixtral_8x22b", "decode_32k"): 1_674_752_036,
                   ("resnet_50", "cls_224"): 21_616_204,
                   ("dit_xl2", "gen_fast"): 15_052_812}

_CHILD = r"""
import json, sys
from repro.configs import all_cells, get_arch
from repro.distributed.sharding import make_axis_rules
from repro.launch import dryrun as D
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


out = {}
for mk in ("single", "multi", "degraded"):
    mesh = make_production_mesh(multi_pod=mk == "multi",
                                degraded=mk == "degraded")
    for variant in ("baseline", "kvint8"):
        rules = make_axis_rules(mk == "multi", variant)
        for a, s, skip in all_cells():
            if skip:
                continue
            arch = D._apply_variant_overrides(get_arch(a), variant)
            cell = build_cell(arch, arch.shapes[s], mesh, rules)
            out["|".join((a, s, mk, variant))] = [
                (p, list(x.shape), str(x.dtype),
                 list(x.sharding.shard_shape(x.shape)
                      if x.sharding is not None else x.shape))
                for p, x in leaves(cell.args)]
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference_layouts(tmp_path_factory):
    """The reference's layout of every cell x mesh x variant, built in a
    child process with 512 forced CPU devices."""
    path = tmp_path_factory.mktemp("dryrun") / "layouts.json"
    res = subprocess.run([sys.executable, "-c", _CHILD, str(path)],
                         env=conftest.forced_multidevice_env(512),
                         cwd=conftest.REPO_ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def _port_leaves(tree) -> list:
    """(path, shape, dtype, shard shape) of every leaf, sorted-key order."""
    out = []
    for path, s in DR.path_leaves(tree):
        out.append(("/".join(map(str, path)), list(s.shape),
                    str(s.dtype).removeprefix("torch."),
                    list(s.shard_shape())))
    return sorted(out)


def _bytes(leaves) -> int:
    return sum(math.prod(shard) * np.dtype(dt).itemsize
               for _, _, dt, shard in leaves)


@pytest.mark.parametrize("mesh_kind", MESHES)
@pytest.mark.parametrize("arch_id", CFG.ARCH_IDS)
def test_layouts_equal_the_reference(reference_layouts, arch_id, mesh_kind):
    """(a) Each non-skipped cell of the arch on ``mesh_kind`` under both
    variants: leaf for leaf the reference's path, shape, dtype and shard
    shape, and the per-device argument bytes ``layout`` reports the sum
    of the reference's."""
    mesh = DR.meta_mesh(mesh_kind)
    n = 0
    for variant in VARIANTS:
        rules = SH.make_axis_rules(mesh_kind == "multi", variant)
        arch0 = CFG.get_arch(arch_id)
        arch = DR._apply_variant_overrides(arch0, variant)
        for name, case in arch.shapes.items():
            if case.skip:
                continue
            want = sorted(tuple(leaf) for leaf in reference_layouts[
                "|".join((arch_id, name, mesh_kind, variant))])
            cell = S.build_cell(arch, case, mesh, rules)
            got = [tuple(leaf) for leaf in _port_leaves(cell.abstract)]
            assert got == want, (arch_id, name, mesh_kind, variant)
            arg = sum(DR._shard_bytes(s)
                      for _, s in DR.path_leaves(cell.abstract))
            assert arg == _bytes(want)
            key = (arch_id, name)
            if mesh_kind == "single" and variant == "baseline" \
                    and key in REFERENCE_BYTES:
                assert arg == REFERENCE_BYTES[key]
            n += 1
    assert n > 0
    S.set_grad_accum_dtype(torch.float32)


def _reduced_cases():
    lm = CFG.get_arch("llama3_2_1b", True)
    lm_remat = dataclasses.replace(lm, cfg=dataclasses.replace(
        lm.cfg, remat=True))
    moe = CFG.get_arch("qwen2_moe_a2_7b", True)
    vit = CFG.get_arch("vit_b16", True)
    dit = CFG.get_arch("dit_xl2", True)
    return {
        "lm_train": (lm_remat, ShapeCase("t", "train", batch=4, seq_len=64,
                                         grad_accum=2)),
        "lm_prefill": (lm, ShapeCase("p", "prefill", batch=2, seq_len=64)),
        "lm_decode": (lm, ShapeCase("d", "decode", batch=2, seq_len=40)),
        "moe_train": (moe, ShapeCase("t", "train", batch=2, seq_len=32)),
        "resnet_train": (CFG.get_arch("resnet_50", True),
                         ShapeCase("t", "train", batch=2, img_res=32)),
        "convnext_infer": (CFG.get_arch("convnext_b", True),
                           ShapeCase("i", "infer", batch=2, img_res=32)),
        "vit_train": (vit, ShapeCase("t", "train", batch=2,
                                     img_res=vit.cfg.img_res)),
        "dit_sample": (dit, ShapeCase("s", "sample", batch=2,
                                      img_res=dit.cfg.img_res)),
    }


@pytest.mark.parametrize("name", list(_reduced_cases()))
def test_meta_flops_equal_the_cpu_count(name):
    """(b) The FLOPs of one step counted on meta (the dry run's walk on a
    1x1 mesh) equal those counted over the same step on real CPU tensors,
    operator by operator (but ConvNeXt's layout, below), and so do the
    transcendentals and the bytes (but decode's 4)."""
    arch, case = _reduced_cases()[name]
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("meta")])
    rules = SH.make_axis_rules(False)
    meta = DR.walk(S.build_cell(arch, case, mesh, rules), mesh, rules)
    args = S.materialize(torch.Generator().manual_seed(0), arch, case,
                         "cpu")
    cell = S.build_cell(arch, case)
    traffic = DR._Traffic()
    with DR.flop_counter() as fc, traffic:
        cell.fn(*args)
    by_op = {str(op): n for op, n in
             fc.get_flop_counts()["Global"].items()}
    assert meta["flops"] == fc.get_total_flops() > 0
    assert meta["transcendentals"] == traffic.transcendentals
    if name == "convnext_infer":
        # a meta convolution returns NCHW-contiguous output (it has no
        # device to pick a layout by), the CPU's and cuDNN's channels-last:
        # the pointwise products on that layout fold into bmm on meta, mm
        # here, the same FLOPs, and the folds' copies add bytes on meta
        assert meta["flops_by_op"]["aten.bmm"] > 0 and "aten.bmm" not in by_op
        assert meta["flops_by_op"]["aten.convolution"] == \
            by_op["aten.convolution"]
        assert meta["bytes accessed"] > traffic.bytes
        return
    assert meta["flops_by_op"] == by_op
    # decode writes the position, a Python int, into the cache's slot
    # positions: a 0-d tensor of 4 bytes on meta, a fill on the CPU
    assert meta["bytes accessed"] - traffic.bytes == \
        (4 if name == "lm_decode" else 0)


@pytest.mark.parametrize("arch_id", ["llama3_2_1b", "qwen2_moe_a2_7b",
                                     "dit_b2", "vit_b16"])
def test_probes_extrapolate_exactly(arch_id):
    """(c) A reduced homogeneous model at 6 layers: the probes at 2 and 4
    layers give the full walk's every count exactly."""
    arch = DR._with_layers(CFG.get_arch(arch_id, True), 6)
    if arch.family == "lm":
        case = ShapeCase("t", "train", batch=2, seq_len=32, grad_accum=2)
    else:
        case = ShapeCase("t", "train", batch=2, img_res=arch.cfg.img_res)
    mesh = DR.meta_mesh("single")
    rules = SH.make_axis_rules(False)
    full = DR.walk(S.build_cell(arch, case, mesh, rules), mesh, rules)
    assert DR.probe_walk(arch, case, mesh, rules) == full


def _raises(fn):
    """None, "KeyError", or "raises" for another exception (the
    reference's ``DuplicateSpecError``, the port's ``ValueError``)."""
    try:
        fn()
    except KeyError:
        return "KeyError"
    except Exception:  # noqa: BLE001 - the kind is compared, not handled
        return "raises"
    return None


def test_constrain_identity_and_raises_as_the_reference():
    """(d) ``constrain`` returns its tensor itself, with no context and
    under one; under one it raises where the reference's
    ``named_sharding`` raises (a rule naming an axis the mesh lacks, one
    mesh axis for two dimensions) and nowhere else."""
    x = torch.zeros(4, 8, 16)
    assert L.constrain(x, "batch", None, "tensor") is x
    mesh = make_mesh((2, 4), ("data", "model"),
                     devices=[torch.device("meta")] * 8)
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    single, multi = SH.make_axis_rules(False), SH.make_axis_rules(True)
    jsingle, jmulti = JSH.make_axis_rules(False), JSH.make_axis_rules(True)
    bad = SH.AxisRules({"batch": ("nope",)})
    jbad = JSH.AxisRules({"batch": ("nope",)})
    cases = [(("batch", None, "tensor"), single, jsingle),
             (("unknown", None, None), single, jsingle),
             (("batch", None, None), multi, jmulti),
             (("batch", None, None, "tensor"), single, jsingle),
             (("batch",), single, jsingle),
             (("batch", "batch", None), single, jsingle),
             (("batch", "fsdp", None), single, jsingle),
             (("batch", None, None), bad, jbad)]
    seen = set()
    for axes, rules, jrules in cases:
        want = _raises(lambda: JSH.named_sharding(jmesh, axes, jrules,
                                                  x.shape))
        with shard_ctx(mesh, rules):
            got = _raises(lambda: L.constrain(x, *axes))
            if got is None:
                assert L.constrain(x, *axes) is x
        assert got == want, axes
        seen.add(got)
    assert seen == {None, "KeyError", "raises"}
    # not divisible: replicated, as the reference
    with shard_ctx(mesh, single):
        y = torch.zeros(3, 8, 6)
        assert L.constrain(y, "batch", None, "tensor") is y


def test_abstract_state_and_is_spec():
    """(e) ``abstract_params``/``abstract_state`` of the reduced llama3.2
    -1B's specs on a (16, 16) mesh: the reference's shapes, dtypes and
    shard shapes leaf for leaf (an ``AbstractMesh`` there), f32 moments
    placed as their parameters, an unplaced int32 step; ``is_spec``."""
    arch, jarch = CFG.get_arch("llama3_2_1b", True), \
        JCFG.get_arch("llama3_2_1b", True)
    specs, jspecs = S._specs_tree(arch), JS._specs_tree(jarch)
    mesh = DR.meta_mesh("single")
    jmesh = AbstractMesh((16, 16), ("data", "model"))
    rules, jrules = SH.make_axis_rules(False), JSH.make_axis_rules(False)
    params = PM.abstract_params(specs, mesh, rules)
    jparams = JPM.abstract_params(jspecs, jmesh, jrules)
    state = OPT.abstract_state(params)
    jstate = JOPT.abstract_state(jparams)

    def jleaves(tree):
        return sorted(
            ("/".join(str(k.key) for k in path), list(x.shape),
             str(x.dtype), list(x.sharding.shard_shape(x.shape)
                                if x.sharding is not None else x.shape))
            for path, x in jax.tree.flatten_with_path(tree)[0])

    assert [tuple(v) for v in _port_leaves(params)] == \
        [tuple(v) for v in jleaves(jparams)]
    assert [tuple(v) for v in _port_leaves(state)] == \
        [tuple(v) for v in jleaves(jstate)]
    assert state["step"] == ShapeDtypeStruct((), torch.int32)
    for (_, p), (_, m) in zip(DR.path_leaves(params),
                              DR.path_leaves(state["mu"])):
        assert m.dtype == torch.float32 and m.sharding == p.sharding
    assert PM.abstract_params(specs)["embed"].sharding is None
    leaf = params["embed"]
    assert leaf.nbytes == math.prod(leaf.shape) * 2
    assert leaf.meta().device.type == "meta" and \
        tuple(leaf.meta().shape) == leaf.shape
    assert PM.is_spec(specs["embed"]) and JPM.is_spec(jspecs["embed"])
    assert not PM.is_spec(params["embed"]) and not PM.is_spec({})


def _reference_dryrun():
    """The reference's dryrun module; its import sets XLA_FLAGS, restored
    here (jax is already up in this process)."""
    saved = os.environ.get("XLA_FLAGS")
    mod = importlib.import_module("repro.launch.dryrun")
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


def test_main_list_skip_and_error_records(tmp_path, capsys, monkeypatch):
    """(f) ``--list`` prints the reference's lines; each of the three
    skipped cells gives the reference's record and file; a bad arch the
    error record, its file and exit 1, as the reference's."""
    JD = _reference_dryrun()
    DR.main(["--list"])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    JD.main()
    assert ours == capsys.readouterr().out
    assert len(ours.splitlines()) == 40

    a, b = tmp_path / "port", tmp_path / "ref"
    skipped = [(arch, shape) for arch, shape, skip in CFG.all_cells()
               if skip]
    assert len(skipped) == 3
    for arch, shape in skipped:
        rec = DR.run_cell(arch, shape, "single", "baseline", str(a))
        jrec = JD.run_cell(arch, shape, "single", "baseline", str(b))
        assert rec == jrec and rec["status"] == "skipped"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == sorted(
        f"{arch}__{shape}__single__baseline.json"
        for arch, shape in skipped)

    argv = ["--arch", "no_such_arch", "--shape", "train_4k", "--out"]
    with pytest.raises(SystemExit) as e:
        DR.main(argv + [str(a)])
    assert e.value.code == 1
    out = json.loads(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["dryrun"] + argv + [str(b)])
    with pytest.raises(SystemExit) as je:
        JD.main()
    assert je.value.code == 1
    jout = json.loads(capsys.readouterr().out)
    assert out["status"] == jout["status"] == "error"
    assert {k: v for k, v in out.items() if k != "error"} == \
        {k: v for k, v in jout.items() if k != "error"}
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


DECODE_CELLS = [(a, s) for a, s, skip in CFG.all_cells()
                if not skip and CFG.get_arch(a).shapes[s].kind == "decode"]


@pytest.mark.parametrize("arch_id,shape", DECODE_CELLS)
def test_decode_cells_walk_on_meta(arch_id, shape):
    """(g) Every decode cell walks on meta (the step takes materialize's
    position for a meta ``pos``, which keeps its 4 bytes in the layout)."""
    rec = DR.run_cell(arch_id, shape, "single", "baseline", None)
    assert rec["status"] == "ok"
    assert rec["cost_global"]["flops"] > 0
    cell = S.build_cell(CFG.get_arch(arch_id), CFG.get_arch(
        arch_id).shapes[shape])
    assert cell.abstract[2]["pos"] == ShapeDtypeStruct((), torch.int32)
    assert cell.args[2]["pos"].device.type == "meta"


def test_pallas_attention_raises_on_meta():
    """(h) An LM cell on the kernel path raises on meta, naming the
    kernel: the plain path is never counted in its place."""
    arch = CFG.get_arch("llama3_2_1b")
    pallas = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, attention_impl="pallas"))
    mesh = DR.meta_mesh("single")
    rules = SH.make_axis_rules(False)
    for shape, err in (("prefill_32k", ValueError),
                       ("train_4k", RuntimeError)):
        with pytest.raises(err, match="flash_attention"):
            DR.layout(pallas, pallas.shapes[shape], mesh, rules)


def test_flop_counter_counts_the_f32_result_bmm():
    """The dry run's counter takes ``bmm(a, b, out_dtype)``, the card's
    f32-result product, at the library's plain-bmm count (the dtype
    overload runs on CUDA only; its arguments here are shapes)."""
    a, b = torch.zeros(3, 4, 5), torch.zeros(3, 5, 6)
    with DR.flop_counter() as fc:
        torch.bmm(a, b)
    assert fc.get_total_flops() == 2 * 3 * 4 * 5 * 6
    assert DR._bmm_flop((3, 4, 5), (3, 5, 6), torch.float32,
                        out_shape=(3, 4, 6)) == 2 * 3 * 4 * 5 * 6


def test_production_meshes_and_constants():
    """The production shapes and axis names; a mesh over CUDA cards
    raises without them; the card's constants."""
    for kw, shape, names in (({}, (16, 16), ("data", "model")),
                             ({"multi_pod": True}, (2, 16, 16),
                              ("pod", "data", "model")),
                             ({"degraded": True}, (8, 16),
                              ("data", "model"))):
        assert LM.production_shape(**kw) == (shape, names)
        mesh = LM.make_production_mesh(
            **kw, devices=[torch.device("meta")] * math.prod(shape))
        assert tuple(mesh.shape.values()) == shape
        assert mesh.axis_names == names
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            LM.make_production_mesh()
    assert (LM.PEAK_FLOPS_BF16, LM.HBM_BW) == (989e12, 3.35e12)


def test_meta_mesh_runs_no_shard():
    """A mesh of meta devices runs no shard: a MoE cell that would take
    ``moe_block``'s expert-parallel branch on a mesh of devices (batch
    and tensor axes that divide, B * S >= 4096) walks its local branch on
    meta, and the dry run counts that."""
    meta = make_mesh((2, 4), ("data", "model"),
                     devices=[torch.device("meta")] * 8)
    cpu = make_mesh((2, 4), ("data", "model"),
                    devices=[torch.device("cpu")] * 8)
    rules = SH.make_axis_rules(False)
    with shard_ctx(cpu, rules) as ctx:
        assert ctx.runs_shards
    with shard_ctx(meta, rules) as ctx:
        assert not ctx.runs_shards
    arch = CFG.get_arch("qwen2_moe_a2_7b", True)
    case = ShapeCase("p", "prefill", batch=8, seq_len=512)
    before = L.MOE_BRANCHES.copy()
    rec = DR.walk(S.build_cell(arch, case, meta, rules), meta, rules)
    assert rec["flops"] > 0
    ran = L.MOE_BRANCHES - before
    assert ran["expert_parallel"] == 0
    assert ran["sorted"] + ran["gathered"] == arch.cfg.n_layers
