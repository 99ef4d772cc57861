"""Utilities: generators, reference engines, validation, timing."""
from loops_tpu_torch.utils import generate  # noqa: F401
