"""Host microseconds per call of each part of a kernel's launch path.

    python -m loops_tpu_torch.utils.launch_cost [--calls 100]

At small sizes a kernel apply costs its host launch path, not its device
time (K12 on [8, 8192]; K1 on the 32768^2 bench matrix). This module takes
that path apart: each part is timed alone by the host clock over ``calls``
calls in a row (``utils/bench.host_us``: the median of ``repeats`` runs,
each queued behind a sleep kernel so that the card never holds the host
back), less the cost of an empty call. The parts are the operations the
wrappers run now:

* ``SpMVOperator.__call__``: ``stage(x)`` of a staged ``x`` and the
  launch-counter bookkeeping;
* K1's wrapper: the test that its buffers are those checked at bind, the
  check of ``x``, the ``torch.empty`` of y and of the seam buffer;
* ``_build.launch``: the counter lookup, the function resolved at load,
  the arguments as plain ints, ``current_device()``, the raw stream query
  and the C call itself;
* K12: its checks, ``torch.empty_like``, the cached SM count, its C call
  and, in ``saxpy()``, the device asked once and the test that the
  operands are staged (beside ``ensure_platform``, which it asked on
  every call before).

The whole calls (``op(x)``, ``saxpy_cuda``, ``saxpy``, ``torch.add``) are
timed the same way beside the parts. Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json

import torch

from loops_tpu_torch.ops.kernels import _build, saxpy, spmv_sorted
from loops_tpu_torch.utils import generate
from loops_tpu_torch.utils.bench import host_us
from loops_tpu_torch.utils.platform import ensure_platform


def launch_path_parts(device, calls: int = 100, repeats: int = 5) -> dict:
    """``{"parts": {label: us}, "calls": {label: us}, "empty_us": us}``:
    each part's and each whole call's host microseconds per call, less
    ``empty_us``, the cost of calling an empty function."""
    from loops_tpu_torch.ops.spmv import SpMVOperator

    if device.index is None:  # as a tensor's device reads
        device = torch.device(device.type, torch.cuda.current_device())
    csr = generate.random_csr(4096, 4096, 16 / 4096, seed=3)
    op = SpMVOperator(csr, "sorted_flat", device=device)
    b, params = op._bufs, op._raw.params
    xd = torch.from_numpy(generate.make_input_vector(csr.shape[1])).to(device)
    nb, rows = params["num_blocks"], params["rows"]
    y = torch.empty(rows, device=device)
    seam = torch.empty(2 * nb, device=device)
    k1_name = "loops_sorted_spmv_f32"
    k1_fn = _build._function(k1_name)
    k1_args = [b["offsets"], b["cols"], b["vals"], b["cuts"], b["row_first"],
               b["row_last"], xd, y, seam, rows, nb, params["lanes_per_row"],
               params["max_atoms"]]
    k1_ints = [a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in k1_args]
    idx = device.index
    stream = _build._raw_stream(idx)
    staged = tuple(b.values())
    fingerprint = spmv_sorted.staged_fingerprint(b)
    sx, sy = (torch.randn(8, 8192, device=device) for _ in range(2))
    sout = torch.empty_like(sx)
    sax_fn = _build._function("loops_saxpy_f32")
    sax_blocks = min(-(-sx.numel() // (4 * saxpy.BLOCK)),
                     saxpy.CTAS_PER_SM * _build.sm_count(device))
    f32 = torch.float32
    counter = {"n": 0}

    def bookkeeping():
        before = _build.LAUNCHES["sorted_spmv"]
        counter["n"] += _build.LAUNCHES["sorted_spmv"] - before

    def saxpy_checks():
        _build.check(sx, "x", f32, device)
        _build.check(sy, "y", f32, device, sx.numel())
        if sy.shape != sx.shape:
            raise AssertionError

    parts = {
        "SpMVOperator.stage(x), x staged": lambda: op.stage(xd),
        "SpMVOperator counter bookkeeping": bookkeeping,
        "K1 staged buffers unchanged (identity, fingerprint)":
            lambda: spmv_sorted.staged_unchanged(b, staged, fingerprint),
        "K1 check of x": lambda: _build.check(xd, "x", f32, device,
                                              params["cols_n"]),
        "K1 torch.empty(rows) (y)": lambda: torch.empty(rows, device=device),
        "K1 torch.empty(2 nb) (seam)":
            lambda: torch.empty(2 * nb, device=device),
        "launch: counter lookup": lambda: "sorted_spmv" in _build.LAUNCHES,
        "launch: _build._function (resolved at load)":
            lambda: _build._function(k1_name),
        "launch: plain int arguments (K1)": lambda: [
            a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in k1_args],
        "launch: torch.cuda.current_device()": torch.cuda.current_device,
        "launch: raw stream query": lambda: _build._raw_stream(idx),
        "launch: C call, K1 (kernel + seam pass)":
            lambda: k1_fn(*k1_ints, stream),
        "K12 two checks and the shape": saxpy_checks,
        "K12 torch.empty_like (out)": lambda: torch.empty_like(sx),
        "K12 _build.sm_count (cached)": lambda: _build.sm_count(device),
        "launch: C call, K12": lambda: sax_fn(2.5, sx.data_ptr(),
                                              sy.data_ptr(),
                                              sout.data_ptr(), sx.numel(),
                                              sax_blocks, stream),
        "K12 saxpy(): the device asked once, operands staged":
            lambda: saxpy._staged(sx, sy, saxpy._device("cuda")),
        "ensure_platform('cuda') (saxpy() before)":
            lambda: ensure_platform("cuda"),
    }
    whole = {
        "K1 apply, SpMVOperator op(x)": lambda: op(xd),
        "K1 wrapper through the bound function": lambda: op._raw(b, xd),
        "K12 saxpy_cuda": lambda: saxpy.saxpy_cuda(2.5, sx, sy),
        "K12 saxpy(..., device)": lambda: saxpy.saxpy(2.5, sx, sy, device),
        "torch.add(y, x, alpha=2.5)": lambda: torch.add(sy, sx, alpha=2.5),
    }
    empty = host_us(lambda: None, calls, repeats)
    res = {"empty_us": empty, "parts": {}, "calls": {}}
    for key, group in (("parts", parts), ("calls", whole)):
        for label, fn in group.items():
            res[key][label] = max(0.0, host_us(fn, calls, repeats) - empty)
    torch.cuda.synchronize(device)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args(argv)
    device = ensure_platform("cuda")
    res = launch_path_parts(device, args.calls)
    for key in ("parts", "calls"):
        for label, us in res[key].items():
            print(f"{label}: {us:.2f} us")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
