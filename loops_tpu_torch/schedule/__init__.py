"""Schedules: host planners mapping layouts onto the kernels' blocks
(reference: include/loops/schedule.hxx + schedule/*.hxx)."""
from loops_tpu_torch.schedule.plans import (  # noqa: F401
    SCHEDULES,
    FlatBlockPlan,
    GroupMappedPlan,
    RowMappedPlan,
    choose_schedule,
    make_plan,
)
