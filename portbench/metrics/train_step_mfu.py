"""The traced train steps' model FLOPs (forward, and a backward of twice
the forward), over the peak of the configuration's precision
(portbench/counts.py), as a share of the traced window's time."""
LAYER = "train step and captured train graph (train/step.py::make_train_step)"
UNIT = "%"
MOVES = "train_scenes_per_s"
KERNELS = ()


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record["traced_steps"]:
        return None
    return record["traced_steps"] * record["ideal_step_s"] / trace["window_s"] * 100
