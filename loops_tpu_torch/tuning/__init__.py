"""Per-card kernel tuning tables."""
from loops_tpu_torch.tuning.launch_box import LaunchParams, launch_params  # noqa: F401
