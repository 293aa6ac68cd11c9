"""Device milliseconds of host-to-device copies a traced train step."""
LAYER = "upload (train/step.py::to_device_batch)"
UNIT = "ms"
MOVES = "train_scenes_per_s"
KERNELS = ("Memcpy HtoD",)


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not record["traced_steps"]:
        return None
    return trace["htod_s"] / record["traced_steps"] * 1e3
