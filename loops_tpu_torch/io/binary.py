"""Binary CSR cache format (``loops_tpu/io/binary.py``).

The reference *hints* at a ``.csr`` binary cache (util/filepath.hxx:33-35
recognizes the extension) but ships no reader/writer. One ``.npz`` holds
the magic, the shape and the three CSR arrays; the magic is the JAX
package's, so a file written by either package reads in the other.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats import CSR

_MAGIC = "loops-tpu-csr-v1"


def save_csr(path, csr: CSR) -> None:
    np.savez(path, magic=_MAGIC, shape=np.asarray(csr.shape, np.int64),
             offsets=csr.offsets, indices=csr.indices, vals=csr.vals)


def load_csr(path) -> CSR:
    with np.load(path, allow_pickle=False) as z:
        if str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path}: not a loops-tpu binary CSR file")
        return CSR(tuple(int(d) for d in z["shape"]), z["offsets"],
                   z["indices"], z["vals"])
