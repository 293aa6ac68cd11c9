"""Host milliseconds the train loop waits in ``next(loader)`` a step, the
mean over the window's steps (the loop's fetch time)."""
LAYER = "train input (data/loader.py::DataLoader, data/dataset.py::ScanReferDataset)"
UNIT = "ms"
MOVES = "train_scenes_per_s"
KERNELS = ()


def read(record):
    waits = record.get("loader_wait_s")
    if record.get("kind") != "train" or not waits:
        return None
    return sum(waits) / len(waits) * 1e3
