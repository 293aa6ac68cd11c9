"""The FLOP and byte counts at a small shape, against numbers worked by hand."""
import pytest

from portbench import counts
from portbench.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS

SMALL = dict(
    input_feature_dim=1, num_points=64, num_proposals=2, num_heading_bin=1,
    num_size_cluster=2, num_class=2, vote_factor=1,
    sa_npoints=[8, 4, 2, 1], sa_radii=[0.2, 0.4, 0.8, 1.2], sa_nsamples=[2, 2, 1, 1],
    sa_widths=[[2, 2, 4], [4, 4, 4], [4, 4, 4], [4, 4, 4]], fp_width=4,
    seed_feature_dim=4, agg_radius=0.3, agg_nsample=2, proposal_feature_dim=4,
    vocab_size=10, num_layers=1, num_heads=2, d_model=4, d_ff=8, max_des_len=2,
    src_pos_type="xyz", check_relation=True, eval_decode_dtype="bfloat16", use_bf16=False,
)


def test_mlp_counts_each_multiply_add_twice():
    assert counts.mlp(3, [2, 5, 7]) == 2 * 3 * (2 * 5 + 5 * 7)


def test_trunk_flops_by_hand():
    # SA1: 16 rows, 4->2->2->4; SA2: 8 rows 7->4->4->4; SA3: 2 rows; SA4: 1 row
    sa = 2 * 16 * (4 * 2 + 2 * 2 + 2 * 4) + 2 * 8 * (7 * 4 + 16 + 16) \
        + 2 * 2 * (7 * 4 + 16 + 16) + 2 * 1 * (7 * 4 + 16 + 16)
    fp = 2 * 2 * (8 * 4 + 16) + 2 * 4 * (8 * 4 + 16)
    vote = 2 * 4 * (16 + 16) + 2 * 4 * 4 * 7
    agg = 2 * 4 * (7 * 4 + 16 + 16)
    head = 2 * 2 * (16 + 16 + 4 * counts.head_out_dim(SMALL))
    assert counts.head_out_dim(SMALL) == 2 + 3 + 2 + 8 + 2
    assert counts.trunk_flops(SMALL) == sa + fp + vote + agg + head


def test_decode_and_teacher_forced_flops_by_hand():
    d, dff, v, k = 4, 8, 10, 2
    per_pos = [4 * 2 * d * d + 2 * 2 * keys * d + 2 * 2 * d * dff for keys in (1, 2, 3, 4)]
    assert counts.decode_flops(SMALL) == k * (sum(per_pos) + 3 * 2 * d * v)
    t = 4
    layer = 4 * 2 * 5 * d * d + 2 * 2 * 5 * 5 * d + 2 * 2 * 5 * d * dff
    rel = 2 * k * d * d + 2 * 2 * k * k * d + 2 * k * k * d * d + 2 * k * k * d * 9
    assert counts.teacher_forced_flops(SMALL) == layer + 2 * t * d * v + rel


def test_ideal_seconds_divides_each_part_by_its_peak():
    parts = counts.eval_forward_parts(SMALL, 3)
    want = sum(f / PEAK_FLOPS[p] for _, f, p in parts)
    assert counts.ideal_seconds(parts) == pytest.approx(want)
    assert [p for _, _, p in parts] == ["float32", "float32", "bfloat16"]
    fwd, bwd = counts.train_step_parts(SMALL, 3)
    assert bwd[1] == 2 * fwd[1]


def test_fps_bound_by_hand():
    b = 2
    fps = [max(9.0 * 7 * b * 64 / PEAK_FLOPS["float32"], (b * 64 * 12 + b * 8 * 4) / PEAK_BYTES_PER_S),
           max(9.0 * 1 * b * 4 / PEAK_FLOPS["float32"], (b * 4 * 12 + b * 2 * 4) / PEAK_BYTES_PER_S)]
    assert counts.fps_bound_seconds(SMALL, b) == pytest.approx(sum(fps))


def test_ball_query_bound_is_its_bytes_by_hand():
    b = 2
    assert counts.ball_query_sites(SMALL) == [(64, 8, 0.2, 2), (8, 4, 0.4, 2), (4, 2, 0.8, 1),
                                              (2, 1, 1.2, 1), (4, 2, 0.3, 2)]
    nbytes = b * ((64 * 12 + 8 * 12 + 8 * 2 * 4) + (8 * 12 + 4 * 12 + 4 * 2 * 4)
                  + (4 * 12 + 2 * 12 + 2 * 1 * 4) + (2 * 12 + 1 * 12 + 1 * 1 * 4)
                  + (4 * 12 + 2 * 12 + 2 * 2 * 4))
    assert counts.ball_query_bound_seconds(SMALL, b) == pytest.approx(nbytes / PEAK_BYTES_PER_S)
