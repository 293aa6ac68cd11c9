"""Seconds a grid call spends building and uploading its point tables
(``timing_out["table_s"]``), the mean over the window's calls."""
LAYER = "mul_eval grid (eval/mul_eval.py::mul_eval_grid)"
UNIT = "s"
MOVES = "eval_scenes_per_s"
KERNELS = ()


def read(record):
    if record.get("kind") != "grid" or not record["timing"]:
        return None
    return sum(t["table_s"] for t in record["timing"]) / len(record["timing"])
