"""Micro-autotune for the launch box, run on request.

The port of ``loops_tpu/tuning/autotune.py``. The reference measures its
per-arch launch table once per GPU generation and bakes the result into
a header (reference: algorithms/spmv/launch_box.hxx:63-90, the sweep
rationale at :33-59). ``autotune()`` measures the two load-bearing knobs
of ``tuning/launch_box.py`` on the card it runs on:

* ``spmv_block``: atoms (plus rows) per merge-path block of K2
  (``flat_spmv_v2``) and K3 (``flat_spmv``), over 1024-16384; the block
  with the least geomean of the two kernels' card times wins;
* ``spmm_block_f``: K4's (``flat_spmm``) widest feature tile, over the
  widths it takes (multiples of 32, up to 32 x ``MAX_FPL``),

each on a ~1M-nonzero random matrix, timed by the card's own time per
apply (``utils/bench.device_ms``: at this size the host's launch path
would set ``apply_ms``). It caches the winners in a JSON file keyed by
the card's name (``torch.cuda.get_device_name()``; ``$LOOPS_TUNE_CACHE``,
else ``$XDG_CACHE_HOME/loops_tpu_torch/autotune.json``, else
``~/.cache/...``), and ``launch_params()`` takes a cached row first
(provenance ``"autotuned"``). It never runs implicitly: call
``autotune()`` or ``python -m loops_tpu_torch.tuning.autotune``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib

_CACHE_ENV = "LOOPS_TUNE_CACHE"
SPMV_BLOCKS = (1024, 2048, 4096, 8192, 16384)
SPMV_IMPLS = {"pallas2": "flat_spmv_v2", "pallas": "flat_spmv"}
SPMM_BLOCK_FS = (32, 64, 128, 256)
SPMM_F = 512


def cache_path() -> pathlib.Path:
    override = os.environ.get(_CACHE_ENV)
    if override:
        return pathlib.Path(override)
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return pathlib.Path(base) / "loops_tpu_torch" / "autotune.json"


def _rows() -> dict:
    try:
        rows = json.loads(cache_path().read_text())
    except (OSError, ValueError):
        return {}
    return rows if isinstance(rows, dict) else {}


def cached_autotune_row(kind: str) -> dict | None:
    """The cached ``{spmv_block, spmm_block_f}`` for a card name."""
    row = _rows().get(kind)
    if not isinstance(row, dict):
        return None
    keep = {k: int(row[k]) for k in ("spmv_block", "spmm_block_f")
            if k in row}
    return keep or None


def _store(kind: str, row: dict) -> None:
    p = cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    rows = _rows()
    rows[kind] = row
    p.write_text(json.dumps(rows, indent=1, sort_keys=True))


def device_name(device) -> str:
    """The launch box's key for ``device``: the card's name, or "cpu"."""
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def autotune(device="cuda", *, n: int = 16384, density: float = 4e-3,
             verbose: bool = True) -> dict:
    """Sweep ``spmv_block`` (K2, K3) and ``spmm_block_f`` (K4) on
    ``device``; cache and return the winners with every time measured."""
    import numpy as np
    import torch

    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils.bench import apply_ms, device_ms
    from loops_tpu_torch.utils.generate import random_csr
    from loops_tpu_torch.utils.platform import ensure_platform
    from loops_tpu_torch.utils.reference import (
        rigorously_validate_spmv,
        validate_sampled_rows,
    )

    dev = ensure_platform(device)
    timer = device_ms if dev.type == "cuda" else apply_ms
    kind = device_name(dev)
    csr = random_csr(n, n, density, seed=7)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         .astype(np.float32)).to(dev)

    spmv = {}
    for impl in SPMV_IMPLS:
        for block in SPMV_BLOCKS:
            op = SpMVOperator(csr, "merge_path", block=block, impl=impl,
                              device=dev)
            rep = rigorously_validate_spmv(csr, x.cpu().numpy(),
                                           op(x).cpu().numpy())
            if rep.verdict != "NOT_A_BUG":
                raise RuntimeError(f"{op.impl_used} at block {block}: {rep}")
            spmv[impl, block] = timer(op, x)
            if verbose:
                print(f"  spmv_block {block:6d} {SPMV_IMPLS[impl]:13s}: "
                      f"{spmv[impl, block]:8.4f} ms")
    best_block = min(SPMV_BLOCKS, key=lambda b: float(np.prod(
        [spmv[i, b] for i in SPMV_IMPLS])))

    B = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (n, SPMM_F)).astype(np.float32)).to(dev)
    spmm = {}
    for bf in SPMM_BLOCK_FS:
        op = SpMMOperator(csr, "merge_path", "pallas", block_f=bf,
                          device=dev)
        rep = validate_sampled_rows(csr, B.cpu().numpy(), op(B))
        if rep.overruns:
            raise RuntimeError(f"{op.impl_used} at block_f {bf}: {rep}")
        spmm[bf] = timer(op, B)
        if verbose:
            print(f"  spmm_block_f {bf:4d}: {spmm[bf]:8.4f} ms")
    best_f = min(SPMM_BLOCK_FS, key=spmm.get)

    row = {"spmv_block": int(best_block), "spmm_block_f": int(best_f),
           "timing": timer.__name__, "nnz": int(csr.nnz),
           "spmv_ms": {f"{SPMV_IMPLS[i]}@{b}": round(ms, 5)
                       for (i, b), ms in spmv.items()},
           "spmm_ms": {f"flat_spmm@{bf}": round(ms, 5)
                       for bf, ms in spmm.items()}}
    _store(kind, row)
    if verbose:
        print(f"autotuned {kind!r}: spmv_block {best_block}, spmm_block_f "
              f"{best_f} -> {cache_path()}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Sweep the launch box's "
                                 "spmv_block and spmm_block_f; cache them.")
    ap.add_argument("--device", default="cuda")
    autotune(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
