"""Device busy milliseconds a traced train step (the union of its kernel,
copy and memset spans, over the steps in the profile)."""
LAYER = "train step and captured train graph (train/step.py::make_train_step)"
UNIT = "ms"
MOVES = "train_scenes_per_s"
KERNELS = ()


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record["traced_steps"]:
        return None
    return trace["busy_s"] / record["traced_steps"] * 1e3
