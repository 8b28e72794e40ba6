"""The port's blockdct, qtransfer and seq_sum forms from two trees, timed
in turns on one card.

    python3 tools/transform_ab.py OTHER_ROOT     (from the repo root)

OTHER_ROOT is the root of another checkout of the repo, for instance the
parent commit unpacked with ``git archive`` into a git-ignored directory.
The two trees' ports run in turns (other, this, this, other), each in a
process of its own, since two packages of one name cannot share one.
Each process builds its tree's kernels and times every form below at the
round trip's shapes on the same seeded inputs, three ways: the device
time a call, from a CUDA graph of 20 calls (or one a copy, where there
are more) replayed 10 times (median), so that the host does not pace the
launches; CUDA events over 5 back-to-back calls (median of 20), which
the host may pace; and the host's time a call without waiting for the
card (median of 200).  "kernel" forms time the kernel's wrapper alone, on
the layout that tree's kernel takes (tiles in block order before the
raster entries existed); "codec" forms time the codec entry the round
trip calls, with whatever block-order copies that tree makes around the
kernel.  The seq_sum forms sum the paths' grids of 8x8-block bits, one
copy (read from the L2 after the first call) and, "cold", copies over
128 MiB read in turns, each call's from HBM.  Prints one line a form, in
microseconds.
"""
from __future__ import annotations

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


def child() -> None:
    from repro_torch.kernels import build
    build.build(("blockdct", "qtransfer", "seq_sum"))
    print(json.dumps({name: [graph_us(fn, n), events_us(fn), host_us(fn)]
                      for name, (fn, n) in forms().items()}))


def run(root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--child"], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"{root}: {res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv) -> int:
    if argv == ["--child"]:
        child()
        return 0
    other = os.path.abspath(argv[0])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; us a call, turns: other, this, this, other (other = "
          f"{argv[0]})")
    runs = [run(other), run(ROOT), run(ROOT), run(other)]
    for name in runs[1]:
        if name not in runs[0]:
            print(f"{name}: not in the other tree")
            continue
        for i, what in enumerate(("device (CUDA graph)", "events", "host")):
            o = [runs[0][name][i], runs[3][name][i]]
            t = [runs[1][name][i], runs[2][name][i]]
            print(f"{name} {what}: other {o[0]:.2f} / {o[1]:.2f}, this "
                  f"{t[0]:.2f} / {t[1]:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
