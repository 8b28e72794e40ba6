"""The port's blockdct, qtransfer and seq_sum forms, or llama3.2-1B's
decode step, from two trees, timed in turns on one card.

    python3 tools/transform_ab.py OTHER_ROOT [--decode] [--pairs N]
        (from the repo root)

OTHER_ROOT is the root of another checkout of the repo, for instance the
parent commit unpacked with ``git archive`` into a git-ignored directory.
The two trees' ports run in turns, each in a process of its own, since
two packages of one name cannot share one: N pairs (default 2), the
first (other, this), the next (this, other), and so on.  Prints, for each
form and measure, each tree's median over its runs with their spread and
every run's value.

The kernel forms (the default): each process builds its tree's kernels
and times every form below at the round trip's shapes on the same seeded
inputs, three ways, in microseconds: the device time a call, from a CUDA
graph of 20 calls (or one a copy, where there are more) replayed 10
times (median), so that the host does not pace the launches; CUDA events
over 5 back-to-back calls (median of 20), which the host may pace; and
the host's time a call without waiting for the card (median of 200).
"kernel" forms time the kernel's wrapper alone, on the layout that
tree's kernel takes (tiles in block order before the raster entries
existed); "codec" forms time the codec entry the round trip calls, with
whatever block-order copies that tree makes around the kernel.  The
seq_sum forms sum the paths' grids of 8x8-block bits, one copy (read from
the L2 after the first call) and, "cold", copies over 128 MiB read in
turns, each call's from HBM.

``--decode``: each process draws llama3.2-1B at full width and depth
from a seed (``launch.steps.materialize``) with a cache of 4128 slots for
2 requests, as ``chip_smoke.py``'s [lm] decodes, and runs 3 + 32 greedy
decode steps through ``make_infer_fn``, in milliseconds the median of
the last 32: CUDA events around the step, the next token's argmax after
it, as [lm] times it (the decode is host-bound, so this is the host's
time a step), and the host's clock to a synchronise.  In a tree whose
``models/layers`` has ``constrain``, each of those steps is followed by
one with an identity in its place, timed alike: the activation marks'
cost, free of the spread between processes.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HD, LR = 30, (720, 1280), (352, 640)
# seq_sum's grids (lanes, rows, cols): the LR codec's bits of 9 streams,
# the anchors' of one stream and of nine
SEQ_SUM_GRIDS = ((270, 44, 80), (30, 90, 160), (270, 90, 160))
COLD_BYTES = 128 << 20
# the decode form: [lm]'s requests, cache slots and first position
DECODE_BATCH, DECODE_SLOTS, DECODE_POS = 2, 4128, 4096
DECODE_WARMUP, DECODE_STEPS = 3, 32


def graph_us(fn, n: int = 20, reps: int = 10) -> float:
    """Device time a call of ``fn`` in microseconds: a CUDA graph of ``n``
    back-to-back calls, replayed ``reps`` times (median), as
    ``chip_smoke.graph_ms`` takes it; a copy, since importing
    ``chip_smoke`` puts this tree's ``src`` first on the path."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    return statistics.median(times)


def events_us(fn, reps: int = 20, inner: int = 5) -> float:
    """The mean time a call of ``inner`` back-to-back calls by CUDA events,
    median of ``reps``, in microseconds, as ``chip_smoke.cuda_ms``."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / inner)
    return statistics.median(times)


def host_us(fn, n: int = 200) -> float:
    """The host's time a call, without waiting for the card, median of
    ``n`` after one more, in microseconds, as ``chip_smoke.host_ms`` takes
    it from 10."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def seq_sum_forms(g) -> dict:
    """seq_sum at SEQ_SUM_GRIDS, warm and cold: form -> (call, calls a
    graph)."""
    import torch
    from repro_torch.kernels.seq_sum.ops import seq_sum
    out = {}
    for shape in SEQ_SUM_GRIDS:
        scale = 10.0 ** (torch.rand(shape, generator=g, device="cuda") * 7
                         - 3)
        x = torch.randn(shape, generator=g, device="cuda") * scale
        n = -(-COLD_BYTES // (x.numel() * 4))
        turns = itertools.cycle([x] + [x.clone() for _ in range(n - 1)])
        name = "seq_sum " + "x".join(map(str, shape))
        out[name] = (lambda x=x: seq_sum(x), 20)
        out[name + " cold"] = (lambda t=turns: seq_sum(next(t)), max(20, n))
    return out


def forms() -> dict:
    """form -> (a call of it on this process's port, calls a graph),
    inputs drawn from seed 0 in a fixed order."""
    import torch
    from repro_torch.codec import blockdct as B
    from repro_torch.core.quality_transfer import residual_to_pixels
    from repro_torch.kernels.blockdct import ops as dct
    from repro_torch.kernels.qtransfer.ops import qtransfer
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D = B.dct_matrix(8, dev)
    q50, q70 = B.quant_table(50.0, dev), B.quant_table(70.0, dev)
    hd = torch.rand((T, *HD), generator=g, device=dev) * 255 - 128
    lr = torch.rand((1, *LR), generator=g, device=dev) * 255 - 128
    lr_t = torch.rand((T, *LR), generator=g, device=dev) * 255 - 128
    raster = hasattr(dct, "forward_quant_raster")

    def kernel_forward(frames, qt):
        if raster:
            return lambda: dct.forward_quant_raster(frames, D, qt)
        blocks = B.blockify(frames).reshape(-1, 8, 8).contiguous()
        return lambda: dct.forward_quant(blocks, D, qt)

    def codec_forward(frames, qt):
        if raster:
            return lambda: B.dct_quantize_raster(frames, qt)
        H, W = frames.shape[-2:]
        return lambda: B.unblockify(B.dct_quantize(B.blockify(frames),
                                                   qt)[1], H, W)

    q_lr = dct.forward_quant_plain(B.blockify(lr_t).reshape(-1, 8, 8), D,
                                   q50)[0].reshape(T, -1, 8, 8)
    if raster:
        kernel_inverse = lambda: dct.inverse_raster(q_lr, D, q50, *LR)
    else:
        q_blocks = q_lr.reshape(-1, 8, 8)
        kernel_inverse = lambda: dct.inverse(q_blocks, D, q50)

    anchor = torch.rand((T, *HD), generator=g, device=dev) * 255
    resid = torch.randn((T, *HD), generator=g, device=dev) * 8
    mv = torch.randint(-24, 25, (T, HD[0] // 16, HD[1] // 16, 2), generator=g,
                       device=dev, dtype=torch.int32)
    a_lr = torch.rand((1, *LR), generator=g, device=dev) * 255
    mv_lr = torch.randint(-8, 9, (1, LR[0] // 16, LR[1] // 16, 2),
                          generator=g, device=dev, dtype=torch.int32)
    bf = torch.bfloat16
    a16, r16 = anchor.to(bf), resid.to(bf)
    calls = {
        "blockdct forward kernel 30x720x1280": kernel_forward(hd, q70),
        "blockdct forward codec 30x720x1280": codec_forward(hd, q70),
        "blockdct forward kernel 1x352x640": kernel_forward(lr, q50),
        "blockdct forward codec 1x352x640": codec_forward(lr, q50),
        "blockdct inverse kernel 30x352x640": kernel_inverse,
        "blockdct inverse codec 30x352x640":
            lambda: residual_to_pixels(q_lr, q50, *LR),
        "qtransfer f32 pixel+resid 30x720x1280":
            lambda: qtransfer(anchor, mv, resid, edge="pixel"),
        "qtransfer f32 pixel bare 1x352x640":
            lambda: qtransfer(a_lr, mv_lr, edge="pixel"),
        "qtransfer bf16 block+resid 30x720x1280":
            lambda: qtransfer(a16, mv, r16, edge="block", dtype=bf),
    }
    return {**{name: (fn, 20) for name, fn in calls.items()},
            **seq_sum_forms(g)}


def decode_ms() -> dict:
    """llama3.2-1B's decode step (the module docstring), in ms."""
    import torch
    from repro_torch.configs import ShapeCase, get_arch
    from repro_torch.launch import steps as S
    arch = get_arch("llama3_2_1b")
    case = ShapeCase("decode", "decode", batch=DECODE_BATCH,
                     seq_len=DECODE_SLOTS)
    g = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.models import layers
    params, cache, batch = S.materialize(g, arch, case)
    decode = S.make_infer_fn(arch, case)
    tok = batch["tokens"]
    # a tree with layers.constrain also takes, in alternate steps, the
    # step with an identity in its place: the two in one process
    constrain = getattr(layers, "constrain", None)
    forms = ("",) if constrain is None else ("", ", constrain an identity")
    times = {f: ([], []) for f in forms}
    pos = DECODE_POS
    with torch.no_grad():
        for i in range(DECODE_WARMUP + DECODE_STEPS):
            for form in forms:
                layers.constrain = constrain if not form else \
                    (lambda x, *axes: x)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                logits, cache = decode(params, cache,
                                       {"tokens": tok, "pos": pos})
                end.record()
                tok = logits[:, -1].argmax(-1, keepdim=True).int()
                torch.cuda.synchronize()
                pos += 1
                if i >= DECODE_WARMUP:
                    times[form][0].append(start.elapsed_time(end))
                    times[form][1].append((time.perf_counter() - t0) * 1e3)
    layers.constrain = constrain
    name = (f"llama3.2-1B decode {DECODE_BATCH}x{DECODE_SLOTS}, median of "
            f"{DECODE_STEPS}")
    out = {}
    for form, (events, walls) in times.items():
        out[f"events ms{form}"] = statistics.median(events)
        out[f"host to a synchronise ms{form}"] = statistics.median(walls)
    return {name: out}


def child(decode: bool) -> None:
    if decode:
        print(json.dumps(decode_ms()))
        return
    from repro_torch.kernels import build
    build.build(("blockdct", "qtransfer", "seq_sum"))
    print(json.dumps({name: {"device (CUDA graph) us": graph_us(fn, n),
                             "events us": events_us(fn),
                             "host us": host_us(fn)}
                      for name, (fn, n) in forms().items()}))


def run(root: str, decode: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, os.path.abspath(__file__), "--child"]
    res = subprocess.run(cmd + (["--decode"] if decode else []), cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: {res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if args.child:
        child(args.decode)
        return 0
    other = os.path.abspath(args.other)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    order = [("other", other), ("this", ROOT)]
    turns = [t for i in range(args.pairs) for t in order[::1 - 2 * (i % 2)]]
    print(f"{card}; {args.pairs} pairs in turns "
          f"{', '.join(label for label, _ in turns)} (other = {args.other})",
          flush=True)
    runs = {"other": [], "this": []}
    for label, root in turns:
        runs[label].append(run(root, args.decode))
    for name in runs["this"][0]:
        if name not in runs["other"][0]:
            print(f"{name}: not in the other tree")
            continue
        for what in runs["this"][0][name]:
            cols = []
            for label in ("other", "this"):
                if what not in runs[label][0][name]:
                    continue
                v = [r[name][what] for r in runs[label]]
                cols.append(f"{label} median {statistics.median(v):.2f} "
                            f"({min(v):.2f}-{max(v):.2f}: "
                            f"{' '.join(f'{x:.2f}' for x in v)})")
            print(f"{name} {what}: {'; '.join(cols)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
