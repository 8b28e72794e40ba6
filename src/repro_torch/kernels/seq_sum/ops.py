"""Order-stable sum of a grid of partials: the CUDA kernel's wrapper, its
launch plan and its plain PyTorch version.

The reference (``repro.codec.blockdct.seq_sum``) sums with ``lax.scan``:
each row strictly left to right in f32, then the row totals in row order.
That order makes zeroed padding (a column suffix within each row, a suffix
of all-zero rows) an exact no-op, which the mixed-ladder encode needs.
The kernel is ``kernels/csrc/seq_sum.cu``; ``seq_sum_plain`` is the same
add sequence in PyTorch, taken for CPU tensors and used as the kernel's
reference on the card.

Every launch takes :func:`plan`'s layout (lanes a block, the tiles a block
stages in shared memory), and :func:`schedule` spells out which rows and
columns each block of that plan sums, in which order: the kernel's own
index arithmetic, which the CPU tests hold to the reference's order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

f32 = torch.float32
# the kernel keeps a lane's row totals in 48 KB of shared memory
MAX_ROWS = 48 * 1024 // 4

# the kernel's limits (seq_sum.cu): threads a block, bytes of one staging
# buffer, shared memory a block
WARP = 32
MAX_THREADS = 256
STAGE_BYTES = 64 * 1024
MAX_SMEM = 227 * 1024
# a block's threads issue about this many 4-byte copies each
COPIES_PER_THREAD = 8
H100_SMS = 132


def stride_of(cols: int) -> int:
    """A staged row's stride in floats: the row rounded up to 16 bytes,
    so that a tile of whole rows lies in shared memory as in x (one bulk
    copy) where C is a multiple of 4."""
    return -(-cols // 4) * 4


def total_stride(R: int) -> int:
    """Floats between two lanes' row totals in shared memory: R rounded up
    to 16 bytes, so that a lane's totals are scanned 16 bytes a read as
    its rows are."""
    return -(-R // 4) * 4


class Plan(NamedTuple):
    """How one launch covers an (L, R, C) grid: block b sums the
    ``lanes_per_cta`` whole lanes from ``b * lanes_per_cta``, staging their
    rows in tiles of ``tile_rows`` x ``tile_cols`` (``buffers`` 2: the next
    tile loads while this one is scanned), ``threads`` threads, one a row
    of a tile."""
    lanes_per_cta: int
    tile_rows: int
    tile_cols: int
    buffers: int
    threads: int

    @property
    def stride(self) -> int:
        return stride_of(self.tile_cols)

    def grid(self, L: int) -> int:
        return -(-L // self.lanes_per_cta)

    def smem_bytes(self, R: int) -> int:
        return 4 * (self.buffers * self.tile_rows * self.stride
                    + self.lanes_per_cta * total_stride(R))

    def launch_args(self) -> tuple:
        return (self.lanes_per_cta, self.tile_rows, self.tile_cols,
                self.threads, self.buffers)


def plan(L: int, R: int, C: int, n_sms: int = H100_SMS) -> Plan:
    """The kernel's layout for an (L, R, C) grid on a card of ``n_sms``
    SMs.

    - A row wider than a staging buffer is staged in column tiles of a
      multiple of 4 floats, one row a tile.
    - Several whole lanes go to a block when they fit one tile: enough to
      fill a warp's threads, or fewer blocks than lanes where there are
      more lanes than SMs.
    - A block with more rows than a tile holds streams them in row tiles
      through two buffers.
    - A block has a thread a row of its tile, and, where C is not a
      multiple of 4 (4-byte copies), more where that leaves more than
      ``COPIES_PER_THREAD`` copies a thread to issue."""
    if min(L, R, C) < 1 or R > MAX_ROWS:
        raise ValueError(f"no plan for an ({L}, {R}, {C}) grid: each axis "
                         f"at least 1 and at most {MAX_ROWS} rows")
    tile_cols = C
    if 4 * stride_of(C) > STAGE_BYTES:
        # a part of one row that fills one buffer
        tile_cols = STAGE_BYTES // 4
    rows_fit = STAGE_BYTES // (4 * stride_of(tile_cols))
    lanes_per_cta = 1
    if tile_cols == C and R <= min(MAX_THREADS, rows_fit):
        want = max(L // n_sms, WARP // R)
        lanes_per_cta = max(1, min(want, MAX_THREADS // R, rows_fit // R, L))
    block_rows = lanes_per_cta * R
    tile_rows = min(block_rows, MAX_THREADS, rows_fit)
    tiles = -(-block_rows // tile_rows) * -(-C // tile_cols)
    # one thread a row of a tile; where C is not a multiple of 4 the block
    # copies a tile 4 bytes at a time, and then enough to issue those at
    # about COPIES_PER_THREAD a thread
    copies = 0 if C % 4 == 0 else tile_rows * tile_cols
    threads = min(MAX_THREADS, max(tile_rows, lanes_per_cta,
                                   -(-copies // COPIES_PER_THREAD)))
    return Plan(lanes_per_cta, tile_rows, tile_cols, 1 if tiles == 1 else 2,
                WARP * -(-threads // WARP))


class BlockWork(NamedTuple):
    """What block ``block`` of a plan sums: lanes ``lane0`` up to
    ``lane0 + n_lanes``, its global rows ``rows`` (a range of
    ``lane * R + r``), and its tiles in the order it stages them, each
    ((first row, n rows), (first col, n cols))."""
    block: int
    lane0: int
    n_lanes: int
    rows: range
    tiles: tuple


def schedule(p: Plan, L: int, R: int, C: int) -> list[BlockWork]:
    """Every block's work under plan ``p``, with the kernel's arithmetic
    (``seq_sum_kernel`` in seq_sum.cu): row r of lane ``lane0 + j`` goes
    to slot ``j * total_stride(R) + r`` of its block's totals, and the
    block scans lane j's slots from r = 0 to R - 1 in order."""
    out = []
    n_ct = -(-C // p.tile_cols)
    for block in range(p.grid(L)):
        lane0 = block * p.lanes_per_cta
        n_lanes = min(p.lanes_per_cta, L - lane0)
        g0, g1 = lane0 * R, (lane0 + n_lanes) * R
        tiles = []
        for row0 in range(g0, g1, p.tile_rows):
            for ct in range(n_ct):
                col0 = ct * p.tile_cols
                tiles.append(((row0, min(p.tile_rows, g1 - row0)),
                              (col0, min(p.tile_cols, C - col0))))
        out.append(BlockWork(block, lane0, n_lanes, range(g0, g1),
                             tuple(tiles)))
    return out


def seq_sum_plain(x):
    """x (L, R, C) f32 -> (L,): for every lane, each row scanned left to
    right, then the row totals scanned in row order.  One vectorised f32
    add a column across all rows and lanes, then one a row: the add
    sequence of the reference's vmapped ``lax.scan``."""
    L, R, C = x.shape
    rows = torch.zeros((L, R), dtype=f32, device=x.device)
    for c in range(C):
        rows = rows + x[:, :, c]
    total = torch.zeros((L,), dtype=f32, device=x.device)
    for r in range(R):
        total = total + rows[:, r]
    return total


_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, ctypes.c_long, _I, _I, _I, _I, _I, _I, _I, _P, _P]


@functools.lru_cache(maxsize=256)
def _launch_args(L: int, R: int, C: int, device: torch.device) -> tuple:
    """:func:`plan`'s layout of an (L, R, C) grid on ``device``, as the C
    entry takes it."""
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan(L, R, C, n_sms).launch_args()


def seq_sum(x):
    """x (L, R, C) f32 -> (L,) as :func:`seq_sum_plain`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (counted as
    ``seq_sum``) with :func:`plan`'s layout, which takes R <= MAX_ROWS.
    Raises under autograd."""
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"x must be a non-empty (L, R, C) grid, got "
                         f"{tuple(x.shape)}")
    if x.dtype != f32:
        raise TypeError(f"x has dtype {x.dtype}, expected {f32}")
    build.refuse_grad("seq_sum", x)
    if x.device.type == "cpu":
        return seq_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"seq_sum runs on cpu or cuda, not {x.device}")
    L, R, C = x.shape
    if R > MAX_ROWS:
        raise ValueError(f"seq_sum takes at most {MAX_ROWS} rows on CUDA, "
                         f"got {R}")
    x = x.contiguous()
    build.check_cuda_tensor("x", x, f32, x.device)
    out = torch.empty((L,), dtype=f32, device=x.device)
    fn = build.kernel_function("seq_sum", "seq_sum_launch", _ARGTYPES)
    build.launch("seq_sum", fn, x.device, build.ptr(x), L, R, C,
                 *_launch_args(L, R, C, x.device), build.ptr(out))
    return out
