"""Operations and bytes of the model and of its trunk kernels, from the
configuration's shapes alone, so that they count the same work whatever
implements it. A multiply-add is 2 operations.

Model FLOPs cover every 1x1 convolution, linear layer and attention
product of the trunk (SA, FP, voting, aggregation, proposal head) and of
the captioner (position head, encoder, decoder, generator, relation
head). Elementwise work, norms, softmax and the kernels' own distance
arithmetic are not counted. The backward of the train step is counted as
twice its forward.

Kernel bounds (the least time the chip could take): for FPS the larger of
its operations over the float32 peak (9 a point and step: every exact FPS
updates each point's distance at each step) and its bytes over the HBM
bandwidth, each input read once and each output written once; for ball
query its bytes alone, counted the same way. The pairs a ball query tests
depend on its algorithm (a scan in input order stops at a centre's
nsample-th hit, a kernel that bins the points tests fewer), so no count of
operations bounds every correct implementation."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from portbench.peaks import PEAK_BYTES_PER_S, PEAK_FLOPS


def mlp(rows: int, widths: Sequence[int]) -> float:
    """A stack of shared 1x1 convolutions over ``rows`` rows."""
    return sum(2.0 * rows * a * b for a, b in zip(widths[:-1], widths[1:]))


def head_out_dim(m) -> int:
    return 2 + 3 + m["num_heading_bin"] * 2 + m["num_size_cluster"] * 4 + m["num_class"]


def trunk_flops(m: Dict) -> float:
    """One scene through the detector trunk."""
    total, in_dim = 0.0, m["input_feature_dim"]
    for npoint, ns, widths in zip(m["sa_npoints"], m["sa_nsamples"], m["sa_widths"]):
        total += mlp(npoint * ns, [3 + in_dim, *widths])
        in_dim = widths[-1]
    w, sa = m["fp_width"], m["sa_widths"]
    total += mlp(m["sa_npoints"][2], [sa[2][-1] + sa[3][-1], w, w])
    total += mlp(m["sa_npoints"][1], [sa[1][-1] + w, w, w])
    seeds, d = m["sa_npoints"][1], m["seed_feature_dim"]
    total += mlp(seeds, [d, d, d]) + 2.0 * seeds * d * (3 + d) * m["vote_factor"]
    k, p = m["num_proposals"], m["proposal_feature_dim"]
    total += mlp(k * m["agg_nsample"], [3 + d, p, p, p])
    total += mlp(k, [p, p, p, head_out_dim(m)])
    return total


def layer_flops(tokens: int, keys: int, d: int, d_ff: int) -> float:
    """One pre-LN transformer layer over ``tokens`` queries attending to
    ``keys`` keys: four projections, two attention products, the FFN."""
    return 4 * 2.0 * tokens * d * d + 2 * 2.0 * tokens * keys * d + 2 * 2.0 * tokens * d * d_ff


def encoder_flops(m: Dict) -> float:
    """One scene's position head and encoder over its K proposals."""
    k, d = m["num_proposals"], m["d_model"]
    pos_in = 3 if m["src_pos_type"] in ("xyz", "center") else 6
    return mlp(k, [pos_in, d, d]) + m["num_layers"] * layer_flops(k, k, d, m["d_ff"])


def decode_flops(m: Dict) -> float:
    """One scene's greedy decode: K rows, the object token's pass and
    max_des_len + 1 steps, each step attending to the cache so far, and
    the generator at every step."""
    k, d, dff, vocab = m["num_proposals"], m["d_model"], m["d_ff"], m["vocab_size"]
    steps = m["max_des_len"] + 1
    per_row = 0.0
    for pos in range(steps + 1):          # position 0 is the object token
        keys = pos + 1
        per_row += m["num_layers"] * (4 * 2.0 * d * d + 2 * 2.0 * keys * d + 2 * 2.0 * d * dff)
    per_row += steps * 2.0 * d * vocab
    return k * per_row


def teacher_forced_flops(m: Dict) -> float:
    """One scene's teacher-forced caption (train): the object token and
    max_des_len + 2 tokens through the decoder, the generator over the
    tokens, and the relation head over every pair of proposals."""
    k, d, dff, vocab, h = (m["num_proposals"], m["d_model"], m["d_ff"], m["vocab_size"],
                           m["num_heads"])
    t = m["max_des_len"] + 2
    total = m["num_layers"] * layer_flops(t + 1, t + 1, d, dff) + 2.0 * t * d * vocab
    if m["check_relation"]:
        total += 2.0 * k * d * d                 # value heads through the first layer
        total += 2.0 * h * k * k * d             # attention-weighted sum over heads
        total += 2.0 * k * k * d * d + 2.0 * k * k * d * 9
    return total


def eval_forward_parts(m: Dict, batch: int) -> List[Tuple[str, float, str]]:
    """(part, FLOPs, precision) of one eval forward of ``batch`` scenes."""
    f32 = "bfloat16" if m.get("use_bf16") else "float32"
    return [("trunk", batch * trunk_flops(m), f32),
            ("encoder", batch * encoder_flops(m), f32),
            ("decode", batch * decode_flops(m), m["eval_decode_dtype"])]


def train_step_parts(m: Dict, batch: int) -> List[Tuple[str, float, str]]:
    """(part, FLOPs, precision) of one train step: forward and a backward
    of twice the forward."""
    f32 = "bfloat16" if m.get("use_bf16") else "float32"
    fwd = batch * (trunk_flops(m) + encoder_flops(m) + teacher_forced_flops(m))
    return [("forward", fwd, f32), ("backward", 2.0 * fwd, f32)]


def ideal_seconds(parts) -> float:
    """The parts' FLOPs, each over the peak of its precision."""
    return sum(flops / PEAK_FLOPS[precision] for _, flops, precision in parts)


def bound_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS["float32"], nbytes / PEAK_BYTES_PER_S)


def fps_sites(m: Dict) -> List[Tuple[int, int]]:
    """(N, npoint) of the FPS calls of one forward: SA1 over the input
    cloud, the aggregation over the votes (SA2-SA4 take the first points)."""
    return [(m["num_points"], m["sa_npoints"][0]),
            (m["sa_npoints"][1] * m["vote_factor"], m["num_proposals"])]


def fps_bound_seconds(m: Dict, batch: int) -> float:
    return sum(bound_seconds(9.0 * (npoint - 1) * batch * n, batch * n * 12 + batch * npoint * 4)
               for n, npoint in fps_sites(m))


def ball_query_sites(m: Dict) -> List[Tuple[int, int, float, int]]:
    """(N, m, radius, nsample) of the five ball-query calls of a forward."""
    n, sites = m["num_points"], []
    for npoint, r, ns in zip(m["sa_npoints"], m["sa_radii"], m["sa_nsamples"]):
        sites.append((n, npoint, r, ns))
        n = npoint
    sites.append((m["sa_npoints"][1] * m["vote_factor"], m["num_proposals"],
                  m["agg_radius"], m["agg_nsample"]))
    return sites


def ball_query_bound_seconds(m: Dict, batch: int) -> float:
    """The five calls' bound: their points and centres read once and their
    indices written once, over the bandwidth."""
    return sum(batch * (n * 12 + c * 12 + c * ns * 4) / PEAK_BYTES_PER_S
               for n, c, _, ns in ball_query_sites(m))
