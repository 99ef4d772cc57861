"""Persistent plan-artifact cache (``loops_tpu/io/plan_cache.py``).

The reference separates preprocess from kernel time
(merge_path_flat.cuh:97-138) and *hints* at a binary cache so a sweep
never re-parses a matrix (util/filepath.hxx:33-35). ``io/binary.py``
caches matrices; this module caches **plans**: K1's host plan (its
merge-path cuts and seam rows, ``ops/kernels/spmv_sorted.py``), whose
construction costs hundreds of ms at tens of millions of nonzeros for a
kernel of a fraction of a ms. With the cache that plan is paid once per
matrix; a later bind is an ``.npz`` load plus the device upload any
plan pays.

Keying: BLAKE2b over the CSR's shape and the arrays the plan derives
from, plus a canonical encoding of every plan knob. By default those are
all three arrays, as in ``loops_tpu``, whose plans hold the matrix's
values. K1's plan, its cuts and seam rows, derives from the shape and
the row offsets alone, and the cache stores only that plan: every bind
takes the columns and values from the caller's CSR. So K1 keys the shape
and offsets (``arrays=("offsets",)``), a few MB to hash where the whole
matrix is hundreds, and two matrices of one row structure share one plan
without either taking the other's values.

Format: one ``.npz`` per (matrix, knobs) key holding the plan arrays and
a JSON params blob, tagged with the port's own version,
``loops-tpu-torch-plan-v1``. The port's K1 plan is not the TPU kernel's,
so a file the JAX package wrote (``loops-tpu-plan-v1``) is a miss.

Saving writes a temporary file named for its process and thread, then
renames it into place: two processes that save one key each publish a
whole file, and the later rename wins (a rename the system refuses
while the other file is in use is tolerated, as ``ops/kernels/_build.py``
tolerates a lost library rename). (``loops_tpu`` writes every save
through one fixed temporary name, ``.{key}.tmp.npz``, which two savers
overwrite under each other.)
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import threading
import time

import numpy as np

_VERSION = "loops-tpu-torch-plan-v1"


# the CSR arrays a plan is keyed on unless its builder names fewer
MATRIX_ARRAYS = ("offsets", "indices", "vals")


def matrix_content_key(csr, arrays=MATRIX_ARRAYS) -> str:
    """Content hash of a CSR matrix: its shape and the named arrays (by
    default all three, the bytes ``loops_tpu`` hashes)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(tuple(int(d) for d in csr.shape)).encode())
    for name in arrays:
        arr = np.ascontiguousarray(getattr(csr, name))
        h.update(str(arr.dtype).encode())
        h.update(memoryview(arr).cast("B"))
    return h.hexdigest()


def plan_key(csr, kind: str, knobs: dict, arrays=MATRIX_ARRAYS) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(_VERSION.encode())
    h.update(kind.encode())
    h.update(json.dumps(knobs, sort_keys=True, default=str).encode())
    h.update(repr(tuple(arrays)).encode())
    h.update(matrix_content_key(csr, arrays).encode())
    return h.hexdigest()


def save_plan(cache_dir, key: str, arrays: dict, params: dict) -> pathlib.Path:
    """Publish ``arrays`` and ``params`` under ``key``; returns the file."""
    d = pathlib.Path(cache_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{key}.npz"
    # np.savez appends .npz to a name without it: keep the suffix
    tmp = d / f".{key}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
    meta = dict(params)
    for k in ("plan_source", "key_ms"):
        meta.pop(k, None)
    try:
        np.savez(tmp, __version__=_VERSION,
                 __params__=json.dumps(meta, default=str), **arrays)
        try:
            os.replace(tmp, path)  # atomic: no reader sees half a file
        except OSError:
            # a rename lost to another saver of this key (where the
            # system refuses to replace a file in use) leaves its file
            if not path.exists():
                raise
    finally:
        if tmp.exists():
            tmp.unlink()
    return path


def load_plan(cache_dir, key: str):
    """``(arrays, params)``, or None on a miss, a file of another version
    or a damaged file."""
    path = pathlib.Path(cache_dir) / f"{key}.npz"
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["__version__"]) != _VERSION:
                return None
            params = json.loads(str(z["__params__"]))
            arrays = {k: z[k] for k in z.files if not k.startswith("__")}
        return arrays, params
    except (OSError, ValueError, KeyError, EOFError):
        return None


def plan_cache_get_or_build(cache_dir, csr, knobs: dict, build,
                            kind: str = "sorted_spmv",
                            arrays=MATRIX_ARRAYS):
    """Load the plan for ``(csr, knobs)``, or build and save it.
    ``arrays``: the CSR arrays the plan derives from, which the key
    hashes with the shape.

    ``build()`` returns ``(arrays, params)`` with numpy arrays. The
    returned params carry ``plan_source`` (``'cache'`` or ``'built'``);
    on a hit ``plan_ms`` is the load time and ``built_plan_ms`` the
    build's. ``key_ms``: the time of hashing those arrays into the key,
    paid on a hit and a miss alike.
    """
    t0 = time.perf_counter()
    key = plan_key(csr, kind, knobs, arrays)
    key_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hit = load_plan(cache_dir, key)
    if hit is not None:
        arrays, params = hit
        params = dict(params)
        params["plan_source"] = "cache"
        params["built_plan_ms"] = params.get("plan_ms")
        params["plan_ms"] = (time.perf_counter() - t0) * 1e3
    else:
        arrays, params = build()
        params = dict(params)
        params["plan_source"] = "built"
        save_plan(cache_dir, key, arrays, params)
    params["key_ms"] = key_ms
    return arrays, params
