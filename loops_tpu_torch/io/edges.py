"""Edge-list loader (.tsv/.csv/.txt: ``src dst [weight]``), the format
most graph datasets ship in (``loops_tpu/io/edges.py``).

``loops_tpu`` parses with pandas' C engine and falls back to a Python
loop; the port parses with numpy's C tokenizer (``np.loadtxt``), which
reads the file in chunks with pandas' rules: a ``comment`` character
ends the line's data (a line that starts with it is skipped), blank
lines are skipped, fields are split at commas when the first 1000 bytes
hold one, else at whitespace. The errors are the reference's: fewer than
two columns, a negative id, more nodes than int32 indexes; rows of
unequal width raise too.
"""
from __future__ import annotations

import io
import os
import warnings

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.models.graph import Graph


def _records(source, sep: bool, comment: str) -> np.ndarray:
    """The numeric records of ``source`` (a path or a binary file) as
    float64 ``[n, fields]``."""
    with warnings.catch_warnings():
        # an input without records: the caller's column check raises
        warnings.simplefilter("ignore", UserWarning)
        try:
            return np.loadtxt(source, dtype=np.float64,
                              comments=comment or None,
                              delimiter="," if sep else None, ndmin=2)
        except ValueError as e:
            raise ValueError(f"edge list: {e}") from None


def load_edges(path_or_bytes, num_nodes: int | None = None,
               make_undirected: bool = False, comment: str = "#") -> Graph:
    """Load an edge list into a :class:`Graph`.

    Columns: src dst [weight]; whitespace or comma separated; text after
    ``comment`` is skipped; node ids are 0-indexed. ``num_nodes``
    defaults to max id + 1.
    """
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            sep = b"," in f.read(1000)
        arr = _records(path_or_bytes, sep, comment)
    else:
        data = bytes(path_or_bytes)
        arr = _records(io.BytesIO(data), b"," in data[:1000], comment)
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError("edge list needs at least src and dst columns")

    src = arr[:, 0].astype(np.int64)
    dst = arr[:, 1].astype(np.int64)
    if src.min(initial=0) < 0 or dst.min(initial=0) < 0:
        raise ValueError("negative node id in edge list")
    w = (arr[:, 2].astype(np.float32) if arr.shape[1] >= 3
         else np.ones(len(src), np.float32))
    n = int(num_nodes if num_nodes is not None
            else max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if n > np.iinfo(INDEX_DTYPE).max:
        raise OverflowError("node count exceeds int32 index range")
    return Graph.from_edges(src, dst, n, weights=w,
                            make_undirected=make_undirected)
