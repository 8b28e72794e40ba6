"""Where the port's bf16 flash_attention kernel's time goes, on one card.

    PYTHONPATH=src python3 tools/flash_ablation.py   (from the repo root)

Builds copies of ``kernels/csrc`` whose ``flash_attention.cu`` leaves one
part out of the consumers' loop, and times each beside the kernel as it
is, in turns, at the llama3.2-1B and chatglm3-6B head shapes:

- ``products only``: no softmax (p is the raw score): the TMA ring and
  the two wgmma products;
- ``softmax only``: no wgmma: the softmax on whatever the registers hold;
- ``__expf``: the fast exponential (ex2.approx of a scaled argument) in
  place of expf.

The copies compute wrong results on purpose; only their times mean
anything.  The port never runs them.  A variant whose text is no longer
in the source is skipped with a message.  Last, the kernel as it is runs for
two seconds at the llama3.2-1B shape while ``nvidia-smi`` samples the
card's SM clock and power draw.
"""
from __future__ import annotations

import shutil
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import flash_attention

_SOFTMAX_START = ("#pragma unroll\n"
                  "      for (int i = 0; i < kBlockN / 2; ++i) s[i] *= scale;")
_SOFTMAX_END = "      // acc += bf16(p) v over 16 keys a step"

# (text, replacement, occurrences) applied to flash_attention.cu
VARIANTS = {
    "kernel": [],
    "products only": [(None, None, 1)],  # _SOFTMAX_START.._SOFTMAX_END cut
    "softmax only": [("wgmma_ss_n128(s, qd[kk],",
                      "if (0) wgmma_ss_n128(s, qd[kk],", 1),
                     ("wgmma_rs(acc, pa[kk],", "if (0) wgmma_rs(acc, pa[kk],",
                      1)],
    "__expf": [("= expf(s[4 * c", "= __expf(s[4 * c", 4)],
}
# (label, B, H, Hk, S, D), causal bf16
SHAPES = [("llama3.2-1b heads", 1, 32, 8, 4096, 64),
          ("chatglm3-6b heads", 1, 32, 2, 2048, 128)]


def variant_source(src: str, edits) -> str | None:
    """``src`` with the edits made, or None if a text to edit is not
    there as often as stated."""
    for old, new, count in edits:
        if old is None:
            if _SOFTMAX_START not in src or _SOFTMAX_END not in src:
                return None
            i, j = src.index(_SOFTMAX_START), src.index(_SOFTMAX_END)
            src = src[:i] + src[j:]
        elif src.count(old) != count:
            return None
        else:
            src = src.replace(old, new)
    return src


def time_ms(fn, reps: int = 20, inner: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``inner`` calls (CUDA
    events), after three warm-up calls."""
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
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("ablation: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True, timeout=60)
    print(card.stdout.strip().splitlines()[0])
    csrc = build.CSRC
    root = build.BUILD_DIR.parent / "ablation"
    kernel_src = (csrc / "flash_attention.cu").read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        src = variant_source(kernel_src, edits)
        if src is None:
            print(f"[ablation] {name}: its text is not in "
                  f"flash_attention.cu, skipped", file=sys.stderr)
            continue
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        (d / "flash_attention.cu").write_text(src)
        dirs[name] = d
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {label: [torch.randn(shape, generator=g, device="cuda")
                      .to(torch.bfloat16)
                      for shape in ((B, S, H, D), (B, S, Hk, D),
                                    (B, S, Hk, D))]
              for label, B, H, Hk, S, D in SHAPES}
    times = {(name, label): [] for name in dirs for label, *_ in SHAPES}
    try:
        for _ in range(2):  # in turns: every variant, then again
            for name, d in dirs.items():
                build.CSRC = d
                build._functions.clear()
                for label, *_ in SHAPES:
                    q, k, v = inputs[label]
                    times[name, label].append(time_ms(
                        lambda: flash_attention(q, k, v, causal=True)))
    finally:
        build.CSRC = csrc
        build._functions.clear()
    for (name, label), ts in times.items():
        print(f"[ablation] {label:18s} {name:14s} "
              f"{', '.join(f'{t * 1e3:.1f}' for t in ts)} us")

    q, k, v = inputs[SHAPES[0][0]]
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "200"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.monotonic() + 2.0
        while time.monotonic() < end:
            for _ in range(20):
                flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        samples = smi.communicate(timeout=60)[0].split("\n")
    # the first samples may predate the load
    under_load = [tuple(float(x) for x in line.split(","))
                  for line in samples[3:] if line.strip()]
    if under_load:
        mhz, watts = zip(*under_load)
        print(f"[ablation] under load ({len(under_load)} samples): SM clock "
              f"{min(mhz):.0f}-{max(mhz):.0f} MHz, power "
              f"{min(watts):.1f}-{max(watts):.1f} W")
    return 0


if __name__ == "__main__":
    sys.exit(main())
