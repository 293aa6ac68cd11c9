"""The benchmark of ``spacap3d_tpu_torch`` on one H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell. Everything that belongs to one configuration, cell, traffic
kind or per-layer metric sits in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``, ``traffic/<kind>.py``,
``metrics/<metric>.py``. ``reference/`` holds the plain PyTorch and numpy
reference that decides ``correct``; it imports nothing of the program.
"""
