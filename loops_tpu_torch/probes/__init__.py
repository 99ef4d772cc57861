"""H100 probes of the design questions the TPU probe scripts answered,
each probe kernel written by hand in CUDA C++ (``csrc/probes*.cu``), each
beside its plain PyTorch version:

- ``mosaic`` (K13): K2's segmented scan and its constructs in isolation
  (``scripts/tpu_mosaic_probe{,2}.py``);
- ``r2`` (K14): the read stream (K11), the per-chunk cost of the BCSR block
  product on the CUDA cores and the tensor cores, the shared-memory
  scatter accumulator, and the host cost of one launch
  (``scripts/tpu_r2_probe.py``);
- ``gather`` (K15): in-kernel element and row gathers from shared memory,
  L2 and device memory, and the one-hot tensor-core expand
  (``scripts/tpu_r3_gather_probe.py``, ``scripts/tpu_r4_gather_probe.py``).

``scripts/h100_probes.py`` runs them at the TPU scripts' sizes.
"""
