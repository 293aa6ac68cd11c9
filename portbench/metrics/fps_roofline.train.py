"""FPS's share of its roofline in the traced steps: the bound of the
forward's two FPS calls (portbench/counts.py: 9 operations a point and
step over the float32 peak, or the bytes read and written over the
bandwidth, the larger) times the steps, over the device time of the
kernels matched by name."""
from portbench.trace import kernel_seconds

LAYER = "trunk kernels (ops/fps.py + csrc/fps.cu, ops/ball_query.py + csrc/ball_query.cu)"
UNIT = "%"
MOVES = "train_scenes_per_s"
KERNELS = ("fps_kernel",)


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record["traced_steps"]:
        return None
    spent = kernel_seconds(trace, KERNELS)
    if spent <= 0:
        return None
    return record["traced_steps"] * record["fps_bound_s"] / spent * 100
