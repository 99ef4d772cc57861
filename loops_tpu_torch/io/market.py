"""Matrix Market (.mtx) loader and writer.

Functional parity with the reference loader (reference:
include/loops/container/market.hxx:100-289 + detail/mtx_parser.hxx):
banner/typecode parsing, comment tolerance, 1-indexed coordinate records,
symmetric expansion, index/offset overflow guards, and fail-fast
rejection of complex/hermitian/skew-symmetric/dense-array files.

A file is mapped (``mmap``) and its body handed without a copy to the
native tokenizer (``native/src/mtx_parser.cpp``, ``std::from_chars``
over the buffer), as ``loops_tpu/io/market.py`` does; without the
library, or where it refuses the body, numpy tokenizes it
(``bytes.split`` + one float64 conversion).
"""
from __future__ import annotations

import mmap
import os

import numpy as np

from loops_tpu_torch.formats import COO
from loops_tpu_torch.formats.base import INDEX_DTYPE

_FIELDS = {"real", "integer", "pattern", "complex"}
_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


class MatrixMarketError(ValueError):
    pass


def _parse_banner(line: bytes):
    """Parse ``%%MatrixMarket object format field symmetry`` (reference:
    mtx_parser.hxx:152-211)."""
    parts = line.decode("ascii", "replace").strip().split()
    if len(parts) != 5 or parts[0].lower() != "%%matrixmarket":
        raise MatrixMarketError(f"malformed banner: {line!r}")
    _, obj, fmt, field, sym = (p.lower() for p in parts)
    if obj != "matrix":
        raise MatrixMarketError(f"unsupported object {obj!r}")
    if fmt != "coordinate":
        raise MatrixMarketError(
            "dense 'array' format is not supported (reference parity: "
            "market.hxx:114-129 rejects it too)")
    if field not in _FIELDS or field == "complex":
        raise MatrixMarketError(f"unsupported field {field!r}")
    if sym not in _SYMMETRIES or sym in ("skew-symmetric", "hermitian"):
        raise MatrixMarketError(f"unsupported symmetry {sym!r}")
    return field, sym


def _parse_body(body, nnz: int, has_values: bool):
    """Parse whitespace-separated records from bytes or a memoryview.
    Returns (r, c, v) 0-indexed."""
    from loops_tpu_torch.native import mtx_parse

    arr = mtx_parse(body, nnz, 3 if has_values else 2)
    if arr is None:
        data = body.tobytes() if isinstance(body, memoryview) else body
        flat = np.array(data.split(), dtype=np.float64)
        per = flat.size // nnz if nnz else (3 if has_values else 2)
        if nnz and per < 2:
            raise MatrixMarketError(
                f"expected {nnz} records, found {flat.size} numbers")
        arr = flat[: nnz * per].reshape(nnz, per)
    r = arr[:, 0].astype(np.int64) - 1
    c = arr[:, 1].astype(np.int64) - 1
    if has_values and arr.shape[1] >= 3:
        v = arr[:, 2]
    else:
        v = np.ones(nnz, dtype=np.float64)
    if nnz and (r.min(initial=0) < 0 or c.min(initial=0) < 0):
        raise MatrixMarketError(
            "0-indexed entry found; Matrix Market is 1-indexed "
            "(reference parity: loader fails fast on this)")
    return r, c, v


def load(path_or_bytes, dtype=np.float32) -> COO:
    """Load a Matrix Market file into a host :class:`COO`.

    Matches the reference flow (market.hxx:100-177): banner -> comments ->
    dims -> overflow guard -> body parse -> symmetric mirror.
    """
    mm = None
    if isinstance(path_or_bytes, (str, os.PathLike)):
        # the mapped file (the reference's mapped_file_t,
        # detail/mapped_file.hxx:78-192): its body below is a view
        with open(path_or_bytes, "rb") as f:
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                data = mm
            except ValueError:  # an empty file cannot be mapped
                data = f.read()
    else:
        data = bytes(path_or_bytes)
    try:
        return _load(data, mm, dtype)
    finally:
        if mm is not None:
            mm.close()


def _load(data, mm, dtype) -> COO:
    nl = data.find(b"\n")
    if nl < 0:
        raise MatrixMarketError("empty file")
    field, sym = _parse_banner(data[:nl])

    # Skip comment lines ('%...') and blank lines to the dims line.
    pos = nl + 1
    while pos < len(data):
        eol = data.find(b"\n", pos)
        eol = len(data) if eol < 0 else eol
        line = data[pos:eol].strip()
        if line and not line.startswith(b"%"):
            break
        pos = eol + 1
    else:
        raise MatrixMarketError("missing size line")
    try:
        rows, cols, nnz = (int(x) for x in line.split())
    except Exception as e:
        raise MatrixMarketError(f"malformed size line {line!r}") from e
    if max(rows, cols) > np.iinfo(INDEX_DTYPE).max:
        raise OverflowError(
            f"dimensions {rows}x{cols} exceed int32 index range "
            "(reference parity: market.hxx:143-149)")

    body = memoryview(data)[eol + 1:] if mm is not None else data[eol + 1:]
    try:
        r, c, v = _parse_body(body, nnz, has_values=(field != "pattern"))
    finally:
        if mm is not None:
            body.release()  # the map closes only with no view left
    if nnz and (r.max(initial=0) >= rows or c.max(initial=0) >= cols):
        raise MatrixMarketError("coordinate out of declared bounds")

    if sym == "symmetric":
        off = r != c
        total = nnz + int(off.sum())
        if total > np.iinfo(INDEX_DTYPE).max:
            raise OverflowError("expanded nnz exceeds int32 offset range")
        r, c, v = (np.concatenate([r, c[off]]), np.concatenate([c, r[off]]),
                   np.concatenate([v, v[off]]))

    return COO((rows, cols), r, c, v.astype(dtype))


def load_csr(path, dtype=np.float32):
    return load(path, dtype=dtype).to_csr()


def save(path, mat, comment: str | None = None) -> None:
    """Write ``mat`` (any container with ``to_coo``, or a COO) as a
    1-indexed ``coordinate real general`` Matrix Market file, byte for
    byte what ``loops_tpu.io.market.save`` writes for the same COO.

    The reference is loader-only (market.hxx writes nothing); the writer
    exists so sweeps and tests can stage synthetic matrices in the
    interchange format the loader consumes. Output is vectorized (one
    formatted block, not a per-record Python loop).
    """
    coo = mat.to_coo() if hasattr(mat, "to_coo") else mat
    rows, cols = coo.shape
    r = np.asarray(coo.rows, dtype=np.int64) + 1
    c = np.asarray(coo.cols, dtype=np.int64) + 1
    v = np.asarray(coo.vals)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{rows} {cols} {len(v)}\n")
        np.savetxt(f, np.column_stack([r, c, v.astype(np.float64)]),
                   fmt="%d %d %.9g")
