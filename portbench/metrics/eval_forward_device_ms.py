"""Device busy milliseconds a traced forward of the grid (the union of its
kernel, copy and memset spans, over the forwards in the profile)."""
LAYER = "eval step and captured program (train/step.py::make_eval_step, train/capture.py)"
UNIT = "ms"
MOVES = "eval_scenes_per_s"
KERNELS = ()


def read(record):
    if record.get("kind") != "grid" or not record.get("trace") or not record["traced_forwards"]:
        return None
    return record["trace"]["busy_s"] / record["traced_forwards"] * 1e3
