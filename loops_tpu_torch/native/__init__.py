"""The native (C++) host tier: the Matrix Market tokenizer, the COO ->
CSR counting sort and the shard column remap (``src/``, copied from
``loops_tpu/native/src``). Built with g++ at first use into ``_build/``
and loaded with ctypes; every entry point returns None without a
compiler, and its call site then takes a numpy path."""
from __future__ import annotations

from loops_tpu_torch.native.build import load_library  # noqa: F401
from loops_tpu_torch.native.convert import coo_to_csr, unique_remap  # noqa: F401
from loops_tpu_torch.native.mtx import mtx_parse  # noqa: F401
