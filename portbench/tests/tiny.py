"""A cell cut to a size that a CPU test run holds: the program's tiny
architecture, 1,024 points, 16 proposals, a 64-word vocabulary, B = 2."""
from __future__ import annotations

import copy

TINY_MODEL = dict(
    num_points=1024, num_proposals=16, vocab_size=64,
    num_layers=2, num_heads=4, d_model=32, d_ff=64, max_des_len=7,
    sa_npoints=[128, 64, 32, 16], sa_nsamples=[16, 8, 8, 4],
    sa_widths=[[16, 16, 32], [32, 32, 64], [32, 32, 64], [32, 32, 64]],
    fp_width=64, seed_feature_dim=64, proposal_feature_dim=32,
)
TINY_SCENE = {"num_objects": 4, "points_per_object": 300, "background_points": 1200}


def overrides(workload, config):
    """(workload, config) at the tiny size."""
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config["model"].update(TINY_MODEL)
    if config["data"]["use_multiview"]:
        config["model"]["input_feature_dim"] = 132
    config["data"].update(num_points=1024, max_des_len=7, num_workers=2)
    config["train"]["batch_size"] = 2
    p = workload["params"]
    p.update(scenes=4, anns_per_object=2, scene=dict(TINY_SCENE))
    if workload["traffic"] == "grid":
        p.update(seeds_per_call=2, check_forwards=1)
    else:
        p.update(held_batches=3)
    return workload, config
