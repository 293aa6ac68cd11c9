"""Ops of the eval forward. FPS, ball query and the fused decode kernels
(generator argmax, FFN and its tensor-parallel partial sum) have CUDA
kernels (``csrc/``); the rest is plain PyTorch."""

from spacap3d_tpu_torch.ops.ball_query import (  # noqa: F401
    BQ_TILE_POINTS,
    BQ_WARP_CENTRES,
    BQ_WARPS,
    ball_query,
    ball_query_blocks,
    ball_query_default_warp_centres,
    ball_query_launch_info,
    ball_query_plain,
    ball_query_warp_centres,
)
from spacap3d_tpu_torch.ops.boxes import get_3d_box_batch  # noqa: F401
from spacap3d_tpu_torch.ops.decode import (  # noqa: F401
    ffn,
    ffn_default_cluster,
    ffn_launch_info,
    ffn_partial,
    ffn_partial_plain,
    ffn_plain,
    generator_argmax,
    generator_argmax_plain,
    generator_default_cluster,
    generator_launch_info,
    one_wave_cluster,
    pack_ffn,
    pack_generator,
)
from spacap3d_tpu_torch.ops.fps import (  # noqa: F401
    fps_cluster,
    fps_default_cluster,
    fps_launch_info,
    furthest_point_sample,
    furthest_point_sample_plain,
)
from spacap3d_tpu_torch.ops.grouping import (  # noqa: F401
    gather_points,
    group_and_localize,
    group_points,
)
from spacap3d_tpu_torch.ops.interpolate import three_interpolate, three_nn  # noqa: F401
from spacap3d_tpu_torch.ops.nn_distance import nn_distance  # noqa: F401
