"""The traced forwards' model FLOPs, each part over the peak of the
precision the configuration states (portbench/counts.py), as a share of
the traced window's time."""
LAYER = "eval step and captured program (train/step.py::make_eval_step, train/capture.py)"
UNIT = "%"
MOVES = "eval_scenes_per_s"
KERNELS = ()


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "grid" or not trace or not record["traced_forwards"]:
        return None
    return record["traced_forwards"] * record["ideal_forward_s"] / trace["window_s"] * 100
