"""K1: the sorted-flat CSR SpMV kernel (``schedule='sorted_flat'``, and
``'auto'`` for all but extreme-skew matrices).

Replaces ``loops_tpu/ops/kernels/spmv_sorted.py`` (``sorted_spmv_plan``,
``sorted_spmv_bind``, ``sorted_spmv_pallas``). What crosses over is the
host plan's block cuts and the per-row f32 sums inside each block:

1.  **Merge-path blocks** of at most ``block_atoms`` atoms, split further
    so no block spans more than ``ROW_SPAN`` rows or crosses a
    ``STRIPE_ROWS`` row stripe — the same cuts as the reference plan.
2.  **Per-row sums inside a block**, in f32 (``csrc/spmv.cu``
    ``sorted_spmv_kernel``): the block's products ``vals * x[cols]`` go
    to shared memory first, then a group of lanes sums each row; a row
    cut by block seams is the sum of its blocks' partials in block order.

What does not cross over: the column sort and chunking, the Benes
unpermute, the touch-loop gathers and ``bucketed=`` all exist because the
TPU has no general gather and compiles per static shape; Hopper gathers
``x[col]`` natively and launches at any shape. Nor do the refusals that
bounded VMEM or the Mosaic compile (degenerate shape, ``x_sublanes_cap``,
``span_cap``, ``pad_cap``). A block's products once had to fit one CTA's
shared memory (``MAX_BLOCK_ATOMS``, kept as the plan's bound); the kernel
now takes a block in pieces of at most ``PIECE_MAX`` atoms.
Whether a column sort helps L2 locality on the H100 is open (ROADMAP).

What bounds K1 on an H100 is the stream of values and columns and the
row sums (local gathers) or the ``x[col]`` gather (random ones): the
kernel is one persistent launch of ``min(nb, CTAS_PER_SM * SMs)`` CTAs,
each walking a contiguous range of blocks, whose producer warp keeps the
coming pieces' values, columns and row offsets in flight by bulk copies
into a ring of shared-memory stages while the consumer warps gather,
multiply and sum rows; the partials of rows cut by blocks are carried
inside a CTA, and the last CTA adds the few cut by CTA ranges. It writes
every row of y (the empty rows between blocks too), so y is allocated
with ``torch.empty``. Where the plan's blocks gather x at random
(``x_lines_per_atom``) and a share of the atoms lie in rows longer than
a piece (``long_row_share``), the consumers copy x into the ring by
``cp.async`` ``GATHER_DEPTH`` pieces ahead of the piece they sum (the
deep path, ``gather_depth``); elsewhere they load the next piece's x
into registers (the register path). Both give the same y, bit for bit.

The plan/bind split mirrors the reference's preprocess-vs-kernel
separation (merge_path_flat.cuh:97-138): ``sorted_spmv_plan`` is pure
host numpy and reports its cost as ``plan_ms``; ``sorted_spmv_bind``
stages it on a device and, on a card, checks the staged buffers once and
packs their addresses and the plan's sizes into one ``_SortedPlan``
(``SortedLaunch``), so an apply checks only ``x``, allocates y, and makes
one C call with four pointers and the stream.
"""
from __future__ import annotations

import ctypes
import time
import weakref

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
ROW_WINDOW = 1024             # the reference's output row window
ROW_SPAN = ROW_WINDOW - LANES   # max block row span, as in the reference
STRIPE_ROWS = 32768           # no block crosses a stripe, as in the reference
# the plan's bound on a block, from when a block's products had to fit one
# CTA's shared memory (227 KB on an H100); the kernel now takes a block in
# pieces (PIECE_MAX), and the bound stays so that plans stay as they were
MAX_BLOCK_ATOMS = 49152
# K1's two paths (csrc/spmv.cu): each consumer thread loads the next
# piece's x into registers while the current piece is summed (the
# register path, depth 0), or x is copied by cp.async into shared memory
# GATHER_DEPTH pieces ahead of the piece summed (the deep path; the
# kernel's kK1Depth). The deep path is taken where a block's atoms gather
# x at random, at least DEEP_LINES lines of x an atom (x_lines_per_atom,
# read from LOCALITY_BLOCKS evenly spaced blocks), and at least
# DEEP_LONG_SHARE of the atoms lie in rows longer than a piece
# (long_row_share), whose pieces are one row each: on an H100 it ran 3%
# faster than the register path on soc-LiveJournal1's matrix (3.6% of its
# atoms in such rows), and 1.5-6% slower on random matrices of short
# rows (PERF.md section 6).
GATHER_DEPTH = 2
DEEP_LINES = 0.25
DEEP_LONG_SHARE = 0.01
LOCALITY_BLOCKS = 512
# the block K1 builds by default: on an H100, 1024 atoms ran faster than
# 2048 up to 16384 on both bench_32768 and big_2097152 (a smaller
# products buffer leaves more of the SM's 256 KB to L1, which holds the
# bench matrix's 128 KB x; PERF.md section 6)
BLOCK_ATOMS = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lanes_for(mean: float) -> int:
    """The lanes that sum one row (K1) or row run (K3) from shared memory:
    the power of two at or above ``mean``, the mean length of the
    nonempty rows or runs, at most a warp."""
    return int(min(32, 1 << max(int(np.ceil(np.log2(max(mean, 1.0)))), 0)))


# the arrays of a K1 plan that the plan derives (cached by io/plan_cache);
# the rest are the matrix's own (matrix_arrays)
PLAN_ARRAYS = ("cuts", "row_first", "row_last")
# what they derive from, besides the shape: the key of a cached K1 plan
PLAN_KEY_ARRAYS = ("offsets",)


def matrix_arrays(csr) -> dict:
    """The CSR's arrays as K1 stages them: int32 offsets and columns,
    f32 values."""
    return dict(offsets=csr.offsets.astype(np.int32),
                cols=csr.indices.astype(np.int32),
                vals=csr.vals.astype(np.float32))


def sorted_spmv_plan(csr, *, block_atoms: int = BLOCK_ATOMS):
    """Host planning: returns ``(arrays, params)`` — pure numpy."""
    t0 = time.perf_counter()
    if not 1 <= block_atoms <= MAX_BLOCK_ATOMS:
        raise ValueError(f"block_atoms={block_atoms}: K1 holds a block's "
                         f"products in shared memory, 1 to "
                         f"{MAX_BLOCK_ATOMS} atoms")
    rows, cols_n = csr.shape
    N = int(csr.nnz)
    if N == 0:
        return {}, dict(empty=True, rows=rows, cols_n=cols_n, num_blocks=0,
                        plan_ms=(time.perf_counter() - t0) * 1e3)
    K = int(block_atoms)
    offsets = csr.offsets.astype(np.int64)
    rid = np.repeat(np.arange(rows, dtype=np.int64), np.diff(offsets))

    # ---- block cuts: merge-path atoms, K-cap, row-span + stripe ----
    ST = max(ROW_WINDOW, min(STRIPE_ROWS, _round_up(rows, ROW_WINDOW)))
    ST = _round_up(ST, ROW_WINDOW)
    cuts = np.arange(0, N + K, K, dtype=np.int64)
    st_bounds = np.arange(ST, rows, ST, dtype=np.int64)
    cuts = np.unique(np.concatenate([cuts, offsets[st_bounds], [0, N]]))
    cuts = cuts[cuts <= N]
    extra = [np.arange(a, b, K, dtype=np.int64)
             for a, b in zip(cuts[:-1], cuts[1:]) if b - a > K]
    if extra:
        cuts = np.unique(np.concatenate([cuts, *extra]))
    for _ in range(64):  # split row spans > ROW_SPAN (terminates: each
        r0 = rid[cuts[:-1]]                  # new cut strictly interior
        r1 = rid[cuts[1:] - 1]
        bad = np.nonzero(r1 - r0 > ROW_SPAN)[0]
        if not len(bad):
            break
        cuts = np.unique(np.concatenate(
            [cuts, offsets[r0[bad] + ROW_SPAN]]))

    row_len = np.diff(offsets)
    lanes = lanes_for(N / max(int(np.count_nonzero(row_len)), 1))
    arrays = dict(
        **matrix_arrays(csr),
        cuts=cuts.astype(np.int32),
        row_first=rid[cuts[:-1]].astype(np.int32),
        row_last=rid[cuts[1:] - 1].astype(np.int32),
    )
    params = dict(empty=False, rows=rows, cols_n=cols_n,
                  num_blocks=len(cuts) - 1, block_atoms=K, ST=ST,
                  lanes_per_row=lanes, max_atoms=int(np.diff(cuts).max()))
    params.update(gather_reading(row_len, arrays["cols"], arrays["cuts"]))
    params["plan_ms"] = (time.perf_counter() - t0) * 1e3
    return arrays, params


def x_lines_per_atom(cols, cuts, blocks: int = LOCALITY_BLOCKS) -> float:
    """The distinct 128-byte lines of x (32 columns each) that a block's
    atoms touch, per atom, over ``blocks`` of the plan's blocks (cut at
    ``cuts``) evenly spaced, or all where it has fewer: about 1 where the
    columns lie at random, a small fraction where a block's columns lie
    near each other. The same sample on every call, and no pass over
    the other blocks' columns."""
    nb = len(cuts) - 1
    pick = np.unique(np.linspace(0, nb - 1, min(nb, blocks)).astype(np.int64))
    a0 = cuts[pick].astype(np.int64)
    n = cuts[pick + 1].astype(np.int64) - a0
    atoms = int(n.sum())
    if atoms == 0:
        return 0.0
    # the sampled atoms' indices, block after block
    at = np.repeat(a0 - (np.cumsum(n) - n), n) + np.arange(atoms)
    key = np.sort(np.repeat(np.arange(len(pick), dtype=np.int64), n) << 32
                  | cols[at].astype(np.int64) >> 5)
    # the distinct keys, counted on the sorted keys (np.unique took 50
    # times a sort's time on random columns with numpy 2.3)
    return (1 + int(np.count_nonzero(key[1:] != key[:-1]))) / atoms


def long_row_share(row_len, atoms: int) -> float:
    """The share of the ``atoms`` that lie in rows longer than a piece
    (``PIECE_MAX``), from the row lengths alone."""
    long_rows = np.flatnonzero(row_len > PIECE_MAX)
    return float(row_len[long_rows].sum(dtype=np.int64) / max(atoms, 1))


def gather_reading(row_len, cols, cuts) -> dict:
    """The plan's readings from its row lengths, columns and block cuts
    (``x_lines_per_atom``, ``long_row_share``), the gather depth K1 takes,
    and what reading them cost (``reading_ms``).
    The depth is ``GATHER_DEPTH``, the deep path, where the gathers are
    spread (at least ``DEEP_LINES`` lines an atom) and at least
    ``DEEP_LONG_SHARE`` of the atoms lie in rows longer than a piece, else
    0, the register path. Where the gathers are local the long rows are
    not read (``long_row_share`` None): a pass over every row, 30-40 ms for
    road_usa's 23.9M on an H100's host, that would not change the path."""
    t0 = time.perf_counter()
    lines = x_lines_per_atom(cols, cuts)
    long_share = (long_row_share(row_len, int(cuts[-1]))
                  if lines >= DEEP_LINES else None)
    deep = long_share is not None and long_share >= DEEP_LONG_SHARE
    return dict(x_lines_per_atom=lines, long_row_share=long_share,
                gather_depth=GATHER_DEPTH if deep else 0,
                reading_ms=(time.perf_counter() - t0) * 1e3)


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K1
    reads: contiguous int32/float32 tensors on ``device`` of the plan's
    sizes."""
    nb = int(params["num_blocks"])
    _build.check(b["offsets"], "offsets", torch.int32, device,
                 int(params["rows"]) + 1)
    _build.check(b["cols"], "cols", torch.int32, device, b["vals"].numel())
    _build.check(b["vals"], "vals", torch.float32, device)
    _build.check(b["cuts"], "cuts", torch.int32, device, nb + 1)
    _build.check(b["row_first"], "row_first", torch.int32, device, nb)
    _build.check(b["row_last"], "row_last", torch.int32, device, nb)


# the guard of the staged buffers, shared with K2 and K3
staged_fingerprint = _build.staged_fingerprint
staged_unchanged = _build.staged_unchanged

# the kernel's launch shape (csrc/spmv.cu): CTAs an SM it is built for
# (__launch_bounds__), its ring's stages, a piece's atoms and a stage's
# row offsets at most
CTAS_PER_SM = 3
STAGES = 4
PIECE_MAX = 1024
WINDOW_MAX = 1024
# the staged buffers whose addresses the packed plan carries, in order
PLAN_POINTERS = ("offsets", "cols", "vals", "cuts", "row_first", "row_last")


class _SortedPlan(ctypes.Structure):
    """``csrc/spmv.cu`` ``SortedPlan``, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in PLAN_POINTERS]
                + [(k, ctypes.c_int) for k in ("rows", "nb", "lanes_per_row",
                                               "grid", "piece", "window",
                                               "deep")])


def launch_shape(params: dict, max_rows: int, sms: int) -> dict:
    """K1's grid (at most ``CTAS_PER_SM`` CTAs on each of ``sms`` SMs, one
    block each at least), its piece (the atoms a stage holds: the longest
    block's, rounded up to a quad, at most ``PIECE_MAX``), its window (the
    row offsets a stage holds: ``max_rows``, the most rows of a block, and
    one, rounded up to a quad, at most ``WINDOW_MAX``; a block with more
    reads its offsets from device memory) and its path (``deep``: 1 where
    the plan's ``gather_depth`` is above 0, else 0)."""
    return dict(grid=min(int(params["num_blocks"]), CTAS_PER_SM * sms),
                piece=min(_round_up(int(params["max_atoms"]), 4), PIECE_MAX),
                window=min(_round_up(int(max_rows) + 1, 4), WINDOW_MAX),
                deep=int(int(params["gather_depth"]) > 0))


def max_block_rows(row_first, row_last) -> int:
    """The most rows one block of the plan spans."""
    return int((row_last - row_first).max()) + 1


class SortedLaunch:
    """K1's launch on one card: the staged buffers' addresses and the
    plan's sizes packed once into a ``_SortedPlan`` (one pointer to the C
    entry point), and one scratch buffer for each CUDA stream K1 runs on,
    keyed by the stream's raw handle and made at its first launch there:
    the ticket that finds the last CTA, which resets it, and the seams
    between CTA ranges. ``launch(x, out=None)`` checks ``x`` only, and
    makes one C call. Any grid up to nb and any piece up to
    ``PIECE_MAX`` give the same y, bit for bit."""

    def __init__(self, b: dict, params: dict, device, max_rows: int):
        self.device = device
        self.index = (torch.cuda.current_device() if device.index is None
                      else device.index)
        self.rows, self.cols_n = int(params["rows"]), int(params["cols_n"])
        self.shape = launch_shape(params, max_rows, _build.sm_count(device))
        nb = int(params["num_blocks"])
        self.plan = _SortedPlan(
            *(b[k].data_ptr() for k in PLAN_POINTERS), self.rows, nb,
            int(params["lanes_per_row"]), self.shape["grid"],
            self.shape["piece"], self.shape["window"], self.shape["deep"])
        self.plan_ptr = ctypes.addressof(self.plan)
        # the tensors whose addresses the plan holds
        self.staged = tuple(b[k] for k in PLAN_POINTERS)
        self.scratch_words = 4 + self.shape["grid"] + nb
        self.scratch = {}  # raw stream handle -> (tensor, its address)
        self.fn = None
        if self.shape["deep"]:
            GATHERS.launches.add(self)

    def _new_scratch(self, stream: int) -> tuple:
        """``stream``'s scratch, zeroed on that stream (the current one) at
        its first launch there, and its address."""
        t = torch.zeros(self.scratch_words, dtype=torch.int32,
                        device=self.device)
        got = self.scratch[stream] = (t, t.data_ptr())
        return got

    def __call__(self, x: torch.Tensor, out=None) -> torch.Tensor:
        _build.check(x, "x", torch.float32, self.device, self.cols_n)
        y = _build.output(out, self.rows, self.device)
        stream = _build._raw_stream(self.index)
        scratch = (self.scratch.get(stream) or self._new_scratch(stream))[1]
        if self.fn is None:
            self.fn = _build._function("loops_sorted_spmv_f32")
        _build.call(self.fn, "loops_sorted_spmv_f32", "sorted_spmv",
                    self.index, (self.plan_ptr, x.data_ptr(), y.data_ptr(),
                                 scratch), stream)
        return y


class GatherCounter:
    """What K1's deep path counts on the card, for a ``utils/trace.profile``
    window (``GATHERS``, registered with ``_build.window_counter``). Each
    deep launch adds, into words 1 to 3 of its scratch buffer, the pieces
    its CTAs summed, those whose gathers had all landed when a CTA first
    tested their barrier, and one launch; the register path counts
    nothing. ``start`` zeroes those words of every live deep
    ``SortedLaunch`` and notes K1's launches so far (``_build.LAUNCHES``);
    ``read`` copies each buffer once after the window:
    ``k1.gathers_ready_share``, the pieces found gathered over the pieces
    (None where no deep launch ran), and ``k1.gather_depth``, the depth of
    the launches that ran: ``GATHER_DEPTH`` for the deep ones, 0 for the
    window's other K1 launches (a list where both ran, None where none
    did). A deep launch made for one call (``sorted_spmv_cuda`` on
    buffers no bind packed) takes its counts with it. The untraced path
    reads nothing."""

    def __init__(self):
        self.launches = weakref.WeakSet()  # the live deep launches
        self.before = 0

    def _buffers(self) -> list:
        bufs = [t for launch in list(self.launches)
                for t, _ in list(launch.scratch.values())]
        # every launch that wrote them has finished, on each card
        for dev in {t.device for t in bufs if t.is_cuda}:
            torch.cuda.synchronize(dev)
        return bufs

    def start(self) -> None:
        for t in self._buffers():
            t[1:4].zero_()
        self._buffers()
        self.before = _build.LAUNCHES["sorted_spmv"]

    def read(self) -> dict:
        counts = np.zeros(3, np.int64)
        for t in self._buffers():
            counts += t[1:4].cpu().numpy().view(np.uint32)
        pieces, ready, deep = (int(c) for c in counts)
        depths = ([0] if _build.LAUNCHES["sorted_spmv"] - self.before > deep
                  else []) + ([GATHER_DEPTH] if deep else [])
        return {"k1.gathers_ready_share": ready / pieces if pieces else None,
                "k1.gather_depth": (depths[0] if len(depths) == 1
                                    else depths or None)}


GATHERS = _build.window_counter(GatherCounter())


def sorted_spmv_cuda(b: dict, x: torch.Tensor, params: dict,
                     staged_on=None, out=None) -> torch.Tensor:
    """Launch K1 (``csrc/spmv.cu`` ``sorted_spmv_kernel``, one launch) on
    buffers that no bind packed (a bound function's ``fn.launch`` does
    so once). ``staged_on``: the device on which ``check_staged`` has
    accepted ``b`` (at bind); the buffers are then not checked again, and
    ``x`` must lie there too. ``out``: a float32 tensor of ``rows`` to
    write y into instead of a new ``torch.empty`` (the kernel writes every
    row, which a NaN-filled ``out`` shows)."""
    if not x.is_cuda:
        raise ValueError(f"sorted_spmv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    dev = x.device if staged_on is None else staged_on
    _build.check(x, "x", torch.float32, dev, params["cols_n"])
    if staged_on is None:
        check_staged(b, params, dev)
    launch = SortedLaunch(b, params, dev,
                          max_block_rows(b["row_first"], b["row_last"]))
    return launch(x, out)


def sorted_spmv_plain(b: dict, x: torch.Tensor, params: dict) -> torch.Tensor:
    """K1's plain PyTorch version over the same staged buffers: per-row
    f32 segment sums of ``vals * x[cols]`` over the CSR offsets."""
    prod = b["vals"] * x.to(torch.float32)[b["cols"]]
    return torch.segment_reduce(prod, "sum", offsets=b["offsets"].long(),
                                unsafe=True)


def sorted_spmv_mirror(a: dict, params: dict, x, grid: int,
                       piece: int) -> np.ndarray:
    """K1's numpy mirror: ``sorted_spmv_kernel``'s walk and its order of
    f32 additions, element for element, on the plan's arrays ``a`` (those
    of ``sorted_spmv_plan``) and a float32 ``x``. CTA k walks blocks
    [k nb / grid, (k + 1) nb / grid) in order, each block in pieces of at
    most ``piece`` atoms. A row of a block is summed by ``lanes_per_row``
    lanes, lane-strided, then the xor tree; a lane's partial of a row cut
    by a piece goes on to the next piece. The fold of a row cut by blocks
    is carried from block to block; a row cut by a CTA range leaves its
    first range's prefix in ``tail`` and each later block's partial in
    ``part``, and the last CTA adds them in block order. CTAs run here
    last to first, and y and the seams start at NaN, so a row or seam
    left unwritten shows."""
    rows, nb = params["rows"], params["num_blocks"]
    g = params["lanes_per_row"]
    off, cuts = a["offsets"], a["cuts"]
    rf_, rl_ = a["row_first"], a["row_last"]
    y = np.full(rows, np.nan, np.float32)
    tail = np.full(grid, np.nan, np.float32)
    part = np.full(nb, np.nan, np.float32)
    start = [k * nb // grid for k in range(grid + 1)]
    for k in reversed(range(grid)):
        B0, B1 = start[k], start[k + 1]
        assert B1 > B0
        hc = rf_[B0] if B0 > 0 and rl_[B0 - 1] == rf_[B0] else -1
        carry_row = np.full(2, np.nan, np.float32)
        carry_lanes = np.full((2, 32), np.nan, np.float32)
        par = 0
        for b in range(B0, B1):
            a0, a1 = int(cuts[b]), int(cuts[b + 1])
            r0, r1 = int(rf_[b]), int(rl_[b])
            nxt = rf_[b + 1] if b + 1 < nb else rows
            cin = b > 0 and rl_[b - 1] == r0
            cout = nxt == r1
            nrows = r1 - r0 + 1
            ro = off[r0:r1 + 2].astype(np.int64)

            def lower_bound(key):  # first m in [1, nrows], ro[m] >= key
                return 1 + int(np.searchsorted(ro[1:nrows + 1], key))
            for p0 in range(a0, a1, piece):
                p1 = min(a1, p0 + piece)
                prod = a["vals"][p0:p1] * x[a["cols"][p0:p1]]
                assert prod.dtype == np.float32
                if p0 == a0:
                    y[r1 + 1:nxt] = 0
                    if b == 0:
                        y[:r0] = 0
                jf, jl = 0, nrows - 1
                if p0 > a0:
                    lb = lower_bound(p0)
                    jf = lb if ro[lb] == p0 else lb - 1
                if p1 < a1:
                    jl = lower_bound(p1) - 1
                for j in range(jf, jl + 1):
                    s0, e0 = max(ro[j], a0), min(ro[j + 1], a1)
                    lo, hi = max(s0, p0), min(e0, p1)
                    lanes = (carry_lanes[par, :g].copy() if s0 < p0
                             else np.zeros(g, np.float32))
                    for lane in range(g):
                        i = s0 + lane
                        if i < lo:
                            i += -(-(lo - i) // g) * g
                        for i in range(i, hi, g):
                            lanes[lane] = np.float32(lanes[lane]
                                                     + prod[i - p0])
                    if e0 > p1:
                        carry_lanes[par ^ 1, :g] = lanes
                        continue
                    o = g // 2
                    while o:
                        lanes = lanes + lanes[np.arange(g) ^ o]
                        o //= 2
                    v, r = lanes[0], r0 + j
                    if r == hc:
                        part[b] = v
                        continue
                    if j == 0 and cin:
                        v = np.float32(carry_row[b & 1] + v)
                    if j == nrows - 1 and cout:
                        if b + 1 < B1:
                            carry_row[(b + 1) & 1] = v
                        else:
                            tail[k] = v
                    else:
                        y[r] = v
                par ^= 1
    # the last CTA: each row a range ends inside of and began in
    for k in range(grid):
        c0, c1 = start[k], start[k + 1]
        if c1 >= nb or rf_[c1] != rl_[c1 - 1]:
            continue
        t = rl_[c1 - 1]
        if rf_[c0] == t and c0 > 0 and rl_[c0 - 1] == t:
            continue
        s, c = tail[k], c1
        while c < nb and rf_[c] == t:
            s = np.float32(s + part[c])
            if rl_[c] != t:
                break
            c += 1
        y[t] = s
    return y


def sorted_spmv_bind(arrays, params, device):
    """Turn a plan into ``(bufs, fn)`` on ``device``; ``fn(bufs, x)``.
    On a card ``fn.launch`` is the ``SortedLaunch`` made here."""
    rows = int(params["rows"])
    launch = None
    if params.get("empty"):
        def fn(b, x):
            return torch.zeros(rows, dtype=torch.float32, device=x.device)
        bufs = {}
    else:
        bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        staged_on = _build.staged_guard(bufs, params, check_staged)
        if bufs["vals"].is_cuda:
            launch = SortedLaunch(bufs, params, bufs["vals"].device,
                                  max_block_rows(arrays["row_first"],
                                                 arrays["row_last"]))

        def fn(b, x):
            if x.is_cpu:
                return sorted_spmv_plain(b, x, params)
            if launch is not None and staged_on(b) is not None:
                return launch(x)
            return sorted_spmv_cuda(b, x, params, staged_on(b))
    fn.launch = launch
    # the plan's parameters, for a caller of sorted_spmv_cuda on these
    # buffers
    fn.params = params
    fn.meta = dict(num_blocks=params["num_blocks"],
                   block_atoms=params.get("block_atoms"),
                   lanes_per_row=params.get("lanes_per_row"),
                   # K1's path: the plan's readings, the depth they gave
                   # and what reading them cost (in plan_ms)
                   x_lines_per_atom=params.get("x_lines_per_atom"),
                   long_row_share=params.get("long_row_share"),
                   gather_depth=params.get("gather_depth"),
                   reading_ms=params.get("reading_ms"),
                   # host planning cost, excluding the device upload —
                   # the reference's preprocess-vs-kernel separation
                   # (merge_path_flat.cuh:97-138); for a plan from the
                   # cache, the load time, with the build's beside it
                   plan_ms=params["plan_ms"],
                   plan_source=params.get("plan_source", "built"),
                   built_plan_ms=params.get("built_plan_ms",
                                            params["plan_ms"]),
                   # hashing the shape and offsets into the cache's key
                   key_ms=params.get("key_ms"))
    return bufs, fn


def sorted_spmv(csr, *, block_atoms: int = BLOCK_ATOMS, device="cuda",
                cache_dir=None):
    """Build ``(bufs, fn)`` for CSR @ vector through K1.

    ``cache_dir``: a directory of the plan cache (``io/plan_cache.py``),
    keyed by the matrix's shape and row offsets, from which the plan
    derives, and ``block_atoms``. On a hit the host plan is loaded, not
    built, and ``fn.meta`` has ``plan_source`` 'cache' and ``plan_ms``
    the load time and the path's readings (``reading_ms``), taken anew
    from the caller's columns; on a miss the plan is built and saved
    (``plan_source`` 'built'). The cache holds the arrays the plan derives
    (``PLAN_ARRAYS``) and its parameters; the matrix's own arrays are the
    caller's CSR at every bind."""
    device = ensure_platform(device)
    if cache_dir is None:
        arrays, params = sorted_spmv_plan(csr, block_atoms=block_atoms)
        return sorted_spmv_bind(arrays, params, device)
    from loops_tpu_torch.io.plan_cache import plan_cache_get_or_build

    built = {}

    def build():
        arrays, params = sorted_spmv_plan(csr, block_atoms=block_atoms)
        built.update(arrays)
        return {k: arrays[k] for k in PLAN_ARRAYS if k in arrays}, params
    arrays, params = plan_cache_get_or_build(
        cache_dir, csr, dict(block_atoms=int(block_atoms)), build,
        arrays=PLAN_KEY_ARRAYS)
    if built:
        arrays = built
    elif not params.get("empty"):
        arrays = {**matrix_arrays(csr), **arrays}
        # the key holds the offsets, not the columns the reading reads,
        # and a plan cached before the reading has none: read anew, its
        # cost counted in the load's plan_ms
        t0 = time.perf_counter()
        params = {**params, **gather_reading(
            np.diff(arrays["offsets"]), arrays["cols"], arrays["cuts"])}
        params["reading_ms"] = (time.perf_counter() - t0) * 1e3
        params["plan_ms"] += params["reading_ms"]
    return sorted_spmv_bind(arrays, params, device)
