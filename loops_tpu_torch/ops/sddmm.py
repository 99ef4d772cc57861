"""SDDMM — sampled dense-dense matrix products, the second half of the GNN
primitive pair: ``out_nz = vals_nz * <A[row_nz, :], B[col_nz, :]>``.

The port of ``loops_tpu/ops/sddmm.py``. Format, impl -> execution:

* CSR or COO, ``xla`` — gathers of the A and B rows and a row dot in f32
  (in the values' type for float64); ``dtype="bfloat16"`` rounds A and B
  first, so ``vals * sum bf16(A) * bf16(B)``. Values in storage order.
* CSR, ``pallas`` with ``dtype="bfloat16"`` — kernel K5
  (``ops/kernels/sddmm_flat.py``), which folds vals into the B row before
  rounding it (the TPU kernel's rounding).
* BCSR, ``xla`` — per stored block ``vals * (A_i @ B_k^T)``, one batched
  product; ``pallas`` — kernel K10 (``ops/kernels/sddmm_bcsr.py``).
  Per-block payloads [NB, R, C].

Refusals (``loops_tpu`` warns and takes XLA, or ignores the request):
CSR ``pallas`` without ``dtype="bfloat16"`` warns and takes the torch path
on the CPU and raises ``ValueError`` on a CUDA device; COO takes
``impl="xla"`` only; BCSR ``dtype="bfloat16"`` raises (``loops_tpu``
computes f32 there without a word); float64 BCSR values with ``pallas``
raise on a CUDA device and warn and take the torch path on the CPU. K5
has no envelope on the card, so ``loops_tpu``'s fallback for rows too
sparse for its A windows is gone.

A kernel runs when the operator lives on a CUDA device; on the CPU its
wrapper takes the plain PyTorch version. ``impl_used`` names the path the
build took and ``launches`` counts this operator's kernel launches.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from loops_tpu_torch.formats import BCSR, COO, CSR
from loops_tpu_torch.ops.kernels import _build, sddmm_bcsr, sddmm_flat
from loops_tpu_torch.ops.spmv import op_cache
from loops_tpu_torch.utils import counters
from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["sddmm", "SDDMMOperator"]

BF16 = "bfloat16"
IMPLS = ("xla", "pallas")


class SDDMMOperator:
    """An SDDMM bound to one CSR, COO or BCSR pattern on one device:
    ``op(A, B) -> out``, with A [rows, F] and B [cols, F]."""

    def __init__(self, mat, impl: str = "xla", block_f: int = 512,
                 dtype=None, device="cuda"):
        if not isinstance(mat, (CSR, COO, BCSR)):
            raise TypeError(f"sddmm: unsupported format {type(mat).__name__}")
        if impl not in IMPLS:
            raise ValueError(f"SDDMM implements impl in {IMPLS}, got "
                             f"{impl!r}")
        if dtype not in (None, BF16):
            raise ValueError(f"SDDMM dtype={dtype!r}: expected None or "
                             f"{BF16!r}")
        self.device = ensure_platform(device)
        self.mat = mat
        self.rows, self.cols = mat.shape
        self.impl = impl
        self.block_f = block_f
        self.dtype = dtype
        self._vals_dtype = torch.from_numpy(mat.vals[:0]).dtype
        # "torch" for the torch-op executors, else the kernel's name
        self.impl_used = "torch"
        self.launches = 0
        t0 = time.perf_counter()
        if isinstance(mat, BCSR):
            self._bufs, self._raw = self._build_bcsr(mat, impl)
        else:
            self._bufs, self._raw = self._build_nz(mat, impl)
        self.meta = dict(getattr(self._raw, "meta", {}) or {},
                         build_ms=(time.perf_counter() - t0) * 1e3)
        self._kernel = (self.impl_used if self.impl_used in _build.LAUNCHES
                        else None)

    def _refuse(self, reason: str) -> str:
        """``'xla'`` with a warning on the CPU; ``ValueError`` on a CUDA
        device, so a kernel request never runs torch ops on the card."""
        if self.device.type == "cuda":
            raise ValueError(f"{reason}; pass impl='xla' for the torch path")
        warnings.warn(f"{reason}; falling back to the torch path",
                      stacklevel=4)
        return "xla"

    def _build_nz(self, mat, impl):
        if isinstance(mat, COO):
            if impl != "xla":
                raise ValueError(f"COO SDDMM implements impl='xla' only, got "
                                 f"{impl!r}")
            rid, cid = mat.rows, mat.cols
        else:
            if impl == "pallas" and self.dtype != BF16:
                impl = self._refuse(
                    "impl='pallas' SDDMM is the bf16-operand kernel K5 "
                    "(dtype='bfloat16')")
            if impl == "pallas":
                self.impl_used = "sddmm_flat"
                return sddmm_flat.sddmm_flat(mat, device=self.device)
            rid, cid = mat.row_ids(), mat.indices
        to = self.device
        bufs = dict(rid=torch.from_numpy(rid.astype(np.int64)).to(to),
                    cid=torch.from_numpy(cid.astype(np.int64)).to(to),
                    vals=torch.from_numpy(mat.vals).to(to))
        dtype = self.dtype

        def fn(b, A, B):
            if dtype == BF16:
                # products of bf16 values are exact in f32: sums in f32
                A = A.to(torch.bfloat16).float()
                B = B.to(torch.bfloat16).float()
            dots = (A[b["rid"]] * B[b["cid"]]).sum(dim=1)
            return b["vals"] * dots
        return bufs, fn

    def _build_bcsr(self, bcsr, impl):
        if self.dtype == BF16:
            raise ValueError("BCSR SDDMM computes in f32 (K10 and the torch "
                             "path); dtype='bfloat16' is not supported")
        if impl == "pallas" and np.dtype(bcsr.vals.dtype) != np.float32:
            impl = self._refuse("impl='pallas' stages float32 (K10), and the "
                                "values are float64")
        if impl == "pallas":
            self.impl_used = "sddmm_bcsr"
            return sddmm_bcsr.sddmm_bcsr(bcsr, block_f=self.block_f,
                                         device=self.device)
        shape = bcsr.shape

        def fn(b, A, B):
            return sddmm_bcsr.sddmm_bcsr_plain(b, A, B, shape)
        return sddmm_bcsr.stage_blocks(bcsr, self.device), fn

    def stage(self, A, B):
        """``A`` and ``B`` as contiguous [rows, F] and [cols, F] tensors on
        the operator's device: float32 for the kernels and the bf16 mode,
        else the values' type."""
        A, B = (t if isinstance(t, torch.Tensor)
                else torch.from_numpy(np.asarray(t)) for t in (A, B))
        sddmm_flat.check_operands(A, B, self.mat.shape)
        dt = (torch.float32 if self._kernel or self.dtype
              else self._vals_dtype)
        return (A.to(self.device, dt).contiguous(),
                B.to(self.device, dt).contiguous())

    def __call__(self, A, B):
        if counters.HOOK is not None:
            return counters.HOOK(self.work, self, A, B)
        A, B = self.stage(A, B)
        if self._kernel is None:
            return self._raw(self._bufs, A, B)
        before = _build.LAUNCHES[self._kernel]
        out = self._raw(self._bufs, A, B)
        self.launches += _build.LAUNCHES[self._kernel] - before
        return out

    def work(self, A, B) -> counters.Work:
        """One call's work on [rows, F] ``A`` (``utils/counters``): K10's
        formula for a BCSR, K5's for the nonzeros of any other format."""
        m, F = self.mat, int(A.shape[1])
        if isinstance(m, BCSR):
            return counters.sddmm_bcsr_work(self.rows, self.cols,
                                            m.num_blocks, m.nnz, F)
        return counters.sddmm_flat_work(self.rows, self.cols, m.nnz, F)


def sddmm(mat, A, B, impl: str = "xla", block_f: int = 512, dtype=None,
          device="cuda"):
    """Sampled products at the sparsity pattern of ``mat``, with the
    operator cached on the container: per-nonzero values in storage order
    (CSR, COO) or per-block payloads [NB, R, C] (BCSR)."""
    device = ensure_platform(device)
    key = (impl, block_f, str(dtype), str(device))
    cache = op_cache(mat, "_sddmm_ops")
    if key not in cache:
        cache[key] = SDDMMOperator(mat, impl, block_f, dtype, device)
    return cache[key](A, B)
