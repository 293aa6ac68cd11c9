"""The share of the traced window in which no kernel, copy or memset ran
on the device."""
LAYER = "device"
UNIT = "%"
MOVES = "eval_scenes_per_s"
KERNELS = ()


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "grid" or not trace or trace["window_s"] <= 0:
        return None
    return (1 - trace["busy_s"] / trace["window_s"]) * 100
