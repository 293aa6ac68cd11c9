"""Ball query's share of its roofline in the traced steps: the bound of
the forward's five calls (portbench/counts.py: their points and centres
read once and their indices written once, over the bandwidth) times the
steps, over the device time of the kernels matched by name."""
from portbench.trace import kernel_seconds

LAYER = "trunk kernels (ops/fps.py + csrc/fps.cu, ops/ball_query.py + csrc/ball_query.cu)"
UNIT = "%"
MOVES = "train_scenes_per_s"
KERNELS = ("ball_query_kernel",)


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record["traced_steps"]:
        return None
    spent = kernel_seconds(trace, KERNELS)
    if spent <= 0:
        return None
    return record["traced_steps"] * record["bq_bound_s"] / spent * 100
