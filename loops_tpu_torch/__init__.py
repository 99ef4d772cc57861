"""loops-tpu-torch: the PyTorch + CUDA port of ``loops_tpu``.

Load-balanced irregular (sparse) computation on an NVIDIA H100, with the
capabilities of gunrock/loops (PPoPP 2023, "A Programming Model for GPU
Load Balancing") and the same split of *work layout* from *work
schedule* as the JAX package beside it. The module tree and names follow
``loops_tpu`` so that each part has its counterpart at the same relative
path:

- **formats**: host-side numpy sparse containers (COO, CSR, CSC, BCSR)
  with ``to_device`` staging into torch tensors.
- **io**: the Matrix Market loader and OGB-style node datasets.
- **layout**: the tile/atom layout contract and the merge-path partitioner.
- **schedule**: host planners: row_mapped, group_mapped, work_oriented,
  merge_path, and ``choose_schedule`` for ``auto``.
- **ops**: CSR and BCSR SpMV and SpMM, and SDDMM over CSR, COO and BCSR,
  on top of the planners; plain torch executors plus hand-written CUDA
  kernels (``ops/kernels``, sources in ``csrc/``).
- **models**: the GNN tier so far: graph container, message passing with
  its SpMM gradient, GCN, training, checkpoints.
- **tuning**: the launch box keyed by the card's name.
- **utils**: host reference engines, the Wilkinson validator, matrix
  generators, CUDA-event and slope timing, the measured read stream (K11).
- **probes**: the design probes of the TPU scripts as H100 probe kernels
  (K13-K15): K2's scan and constructs, the block dot on the CUDA cores
  and the tensor cores, the scatter accumulator, launch cost, and the
  element and row gathers.

The package imports torch and numpy only; it never imports JAX or
``loops_tpu``.
"""

__version__ = "0.1.0"

from loops_tpu_torch.formats import COO, CSR  # noqa: F401

_SUBMODULES = ("formats", "io", "layout", "schedule", "ops", "models",
               "tuning", "utils", "probes")


def __getattr__(name):
    # lazy submodule access (loops_tpu_torch.ops, ...) keeps
    # `import loops_tpu_torch` light — torch is only pulled in when
    # device code is actually requested
    if name in _SUBMODULES:
        import importlib

        mod = importlib.import_module(f"loops_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'loops_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
