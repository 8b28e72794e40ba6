"""The port's blockdct and qtransfer forms from two trees, timed in turns
on one card.

    python3 tools/transform_ab.py OTHER_ROOT     (from the repo root)

OTHER_ROOT is the root of another checkout of the repo, for instance the
parent commit unpacked with ``git archive`` into a git-ignored directory.
The two trees' ports run in turns (other, this, this, other), each in a
process of its own, since two packages of one name cannot share one.
Each process builds its tree's kernels and times every form below at the
round trip's shapes on the same seeded inputs: the device time a call,
from a CUDA graph of 20 calls replayed 10 times (median), so that the
host does not pace the launches.  "kernel" forms time the kernel's
wrapper alone, on the layout that tree's kernel takes (tiles in block
order before the raster entries existed); "codec" forms time the codec
entry the round trip calls, with whatever block-order copies that tree
makes around the kernel.  Prints one line a form, in microseconds.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HD, LR = 30, (720, 1280), (352, 640)


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


def forms() -> dict:
    """form -> a call of it on this process's port, inputs drawn from seed
    0 in a fixed order."""
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
    return {
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


def child() -> None:
    from repro_torch.kernels import build
    build.build(("blockdct", "qtransfer"))
    print(json.dumps({name: graph_us(fn) for name, fn in forms().items()}))


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
    print(f"{card}; device us a call (CUDA graph), turns: other, this, "
          f"this, other (other = {argv[0]})")
    runs = [run(other), run(ROOT), run(ROOT), run(other)]
    for name in runs[1]:
        o = [runs[0][name], runs[3][name]]
        t = [runs[1][name], runs[2][name]]
        print(f"{name}: other {o[0]:.2f} / {o[1]:.2f}, this {t[0]:.2f} / "
              f"{t[1]:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
