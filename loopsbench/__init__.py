"""The benchmark of ``loops_tpu_torch`` on an H100: cells found by name
from ``BENCHMARK.json`` (see ``README.md``). It imports neither JAX nor
the JAX package."""
