"""The ops of the model in plain PyTorch: no kernel, no compiled library."""

from portbench.reference.spacap.ops.ball_query import ball_query_plain as ball_query  # noqa: F401
from portbench.reference.spacap.ops.boxes import get_3d_box_batch  # noqa: F401
from portbench.reference.spacap.ops.fps import (  # noqa: F401
    furthest_point_sample_plain as furthest_point_sample,
)
from portbench.reference.spacap.ops.grouping import (  # noqa: F401
    gather_points,
    group_and_localize,
    group_points,
)
from portbench.reference.spacap.ops.interpolate import three_interpolate, three_nn  # noqa: F401
from portbench.reference.spacap.ops.nn_distance import nn_distance  # noqa: F401
