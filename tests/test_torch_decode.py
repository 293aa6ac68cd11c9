"""The port's fused decode kernels (``ops/decode.py``) against the JAX
package's Pallas kernels (``ops/decode_pallas.py``) on the CPU, and the
captioner's fused path against its unfused path and against JAX. Under
tensor parallelism each rank's ``ffn_partial`` equals the unfused row
path's partial product bit for bit, and so do their sums over the ranks
with b2 and the one rounding.

On CPU tensors the wrappers take their plain versions, which repeat the
captioner's unfused op sequence. The Pallas kernels run in interpret mode,
as ``tests/test_decode_pallas.py`` runs them. Inputs come from numpy seeds.

Tolerances: argmax indices exactly equal (ties included). FFN outputs within
rtol = atol = 2^-7 (tests/test_decode_pallas.py allows 2e-2): both sides
sum the same exact bf16 products in f32 in other orders, so an output can
round to its neighbouring bf16 value (2^-8 relative), and a hidden value can
too, which moves an output by 2^-8 |h| |w2| <= 2^-8 at these scales."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from __graft_entry__ import _flagship_cfg
from spacap3d_tpu.ops import decode_pallas as dp
from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.config import ModelConfig
from spacap3d_tpu_torch.models import captioner as tcap
from spacap3d_tpu_torch.models.core import dense
from spacap3d_tpu_torch.ops import decode as dops
from test_torch_models import (
    _decode_both,
    _proposals,
    assert_tokens_match_or_tie,
    jax_model,
    port_model,
)

FFN_RTOL = FFN_ATOL = 2.0 ** -7


def _bf16(a):
    """numpy f32 -> (jax bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a.astype(np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("n,d,vocab", [(64, 32, 300), (128, 32, 1030), (256, 128, 4528)])
def test_generator_argmax_plain_matches_pallas_interpret(n, d, vocab):
    rng = np.random.RandomState(0)
    xj, xt = _bf16(rng.randn(n, d))
    wj, wt = _bf16(rng.randn(d, vocab) * 0.1)
    bj, bt = _bf16(rng.randn(vocab) * 0.1)
    wp, bp, v = dp.pad_generator({"kernel": wj, "bias": bj}, vocab, v_tile=512)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda x: dp.generator_argmax(x, wp, bp, v))(xj))
    got = ops.generator_argmax(xt, ops.pack_generator(wt.t().contiguous(), bt)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) < vocab


def test_generator_argmax_tie_across_tiles_takes_first():
    x = np.ones((8, 16), np.float32)
    w = np.zeros((16, 16), np.float32)
    w[:, 3] = 1.0
    w[:, 11] = 1.0
    xj, xt = _bf16(x)
    wj, wt = _bf16(w)
    bj, bt = _bf16(np.zeros(16))
    wp, bp, v = dp.pad_generator({"kernel": wj, "bias": bj}, 16, v_tile=8)  # two tiles
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(dp.generator_argmax(xj, wp, bp, v, v_tile=8))
    got = ops.generator_argmax(xt, ops.pack_generator(wt.t().contiguous(), bt)).numpy()
    assert want.tolist() == [3] * 8
    assert got.tolist() == [3] * 8


def test_padded_generator_columns_never_win():
    """Real logits all negative, padded rows zero: an unmasked pad would win."""
    rng = np.random.RandomState(1)
    _, xt = _bf16(rng.randn(20, 32))
    _, wt = _bf16(rng.randn(37, 32) * 0.01)
    _, bt = _bf16(np.full(37, -4.0))
    packed = ops.pack_generator(wt, bt)
    w, b = _read_generator(packed)
    assert w.shape == (128, 64) and b.shape == (128,) and not w[37:].any() and not b[37:].any()
    got = ops.generator_argmax(xt, packed)
    want = torch.argmax(xt.float() @ wt.float().t() + bt.float(), -1)
    assert torch.equal(got, want) and int(got.max()) < 37


@pytest.mark.parametrize("n", [32, 1024, 1000])   # single block, gridded, XLA composite
def test_ffn_plain_matches_pallas_interpret(n):
    rng = np.random.RandomState(1)
    xj, xt = _bf16(rng.randn(n, 32))
    w1j, w1t = _bf16(rng.randn(32, 64) * 0.2)
    b1j, b1t = _bf16(rng.randn(64) * 0.2)
    w2j, w2t = _bf16(rng.randn(64, 32) * 0.2)
    b2j, b2t = _bf16(rng.randn(32) * 0.2)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda x: dp.ffn(x, w1j, b1j, w2j, b2j))(xj)
    got = ops.ffn(xt, ops.pack_ffn(w1t.t().contiguous(), b1t, w2t.t().contiguous(), b2t))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 32)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=FFN_RTOL, atol=FFN_ATOL)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="multiple of 16"):     # d not a multiple of 16
        ops.pack_generator(torch.zeros(16, 24, dtype=torch.bfloat16),
                           torch.zeros(16, dtype=torch.bfloat16))
    bf = torch.bfloat16
    x = torch.zeros(4, 32)
    w1, b1, w2, b2 = (torch.zeros(s, dtype=bf) for s in ((64, 32), (64,), (32, 64), (32,)))
    packed = ops.pack_ffn(w1, b1, w2, b2)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.ffn(x, packed)
    with pytest.raises(ValueError, match="shape"):                # x of another width
        ops.ffn(torch.zeros(4, 48, dtype=bf), packed)
    with pytest.raises(ValueError, match="shape"):                # x of another width
        ops.generator_argmax(x.to(bf), ops.pack_generator(torch.zeros(20, 48, dtype=bf),
                                                          torch.zeros(20, dtype=bf)))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.generator_argmax(x, ops.pack_generator(torch.zeros(20, 32, dtype=bf),
                                                   torch.zeros(20, dtype=bf)))
    meta = torch.zeros(4, 32, dtype=bf, device="meta")
    with pytest.raises(ValueError, match="device"):
        ops.ffn(meta, ops.pack_ffn(*(t.to("meta") for t in (w1, b1, w2, b2))))
    with pytest.raises(ValueError, match="packed.w1 is on cpu"):  # weights on another device
        ops.ffn(meta, packed)


def _ffn_weights(rng, d, f):
    """bf16 (w1, b1, w2, b2) at the xavier / torch-default init ranges."""
    lim = np.sqrt(6 / (d + f))
    return tuple(_bf16(a)[1] for a in (rng.uniform(-lim, lim, (f, d)),
                                       rng.uniform(-1, 1, f) / np.sqrt(d),
                                       rng.uniform(-lim, lim, (d, f)),
                                       rng.uniform(-1, 1, d) / np.sqrt(f)))


def _read_image(packed, d, f):
    """Reads (w1, w2, b1) back from ``packed.image`` at d_pad and d_ff_pad, by
    the layout pack_ffn documents: in a (rows, K) matrix, element (n, k) is
    bf16 number 64 ((n // 8) K / 8 + k // 8) + 8 (n % 8) + k % 8."""
    dp, fp = -(-d // 64) * 64, -(-f // 64) * 64
    img = packed.image
    assert img.dtype == torch.uint8 and img.shape == (fp // 64, 2 * 64 * dp * 2 + 64 * 4)

    def read(flat, rows, k):
        n, kk = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
        idx = 64 * ((n // 8) * (k // 8) + kk // 8) + 8 * (n % 8) + kk % 8
        return flat[torch.from_numpy(idx)]

    w1 = torch.zeros(fp, dp, dtype=torch.bfloat16)
    w2 = torch.zeros(dp, fp, dtype=torch.bfloat16)
    b1 = torch.zeros(fp)
    wb = 64 * dp * 2
    for c in range(fp // 64):
        w1[64 * c:64 * c + 64] = read(img[c, :wb].view(torch.bfloat16), 64, dp)
        w2[:, 64 * c:64 * c + 64] = read(img[c, wb:2 * wb].view(torch.bfloat16), dp, 64)
        b1[64 * c:64 * c + 64] = img[c, 2 * wb:].view(torch.float32)
    return w1, w2, b1


@pytest.mark.parametrize("d,f", [(128, 2048), (32, 64), (144, 1040)])
def test_pack_ffn_round_trips_and_pads_with_zeros(d, f):
    w1, b1, w2, b2 = _ffn_weights(np.random.RandomState(d + f), d, f)
    packed = ops.pack_ffn(w1, b1, w2, b2)
    assert (packed.d, packed.d_ff) == (d, f)
    got_w1, got_w2, got_b1 = _read_image(packed, d, f)
    assert torch.equal(got_w1[:f, :d], w1) and torch.equal(got_w2[:d, :f], w2)
    assert torch.equal(got_b1[:f], b1.float()) and torch.equal(packed.b2_pad[:d], b2.float())
    assert packed.b2_pad.dtype == torch.float32 and packed.b2_pad.shape == (got_w2.shape[0],)
    for pad in (got_w1[f:], got_w1[:, d:], got_w2[d:], got_w2[:, f:], got_b1[f:],
                packed.b2_pad[d:]):
        assert not pad.float().abs().sum()


@pytest.mark.parametrize("r,d,f", [(200, 128, 2048), (64, 32, 64), (100, 144, 1040)])
def test_ffn_on_packed_weights_equals_ffn_plain_bit_for_bit(r, d, f):
    rng = np.random.RandomState(r)
    weights = _ffn_weights(rng, d, f)
    _, x = _bf16(rng.randn(r, d))
    got = ops.ffn(x, ops.pack_ffn(*weights))
    assert got.dtype == torch.bfloat16 and torch.equal(got, ops.ffn_plain(x, *weights))


def _rank_sum(parts):
    """The ranks' partials summed in rank order: each rank's all-reduce."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@pytest.mark.parametrize("tp,f", [(1, 128), (2, 256), (4, 256),
                                  (2, 96)])   # 48 a rank: a multiple of 16, not of 64
def test_ffn_partial_sums_equal_the_row_path_bit_for_bit(monkeypatch, tp, f):
    """Each rank packs its d_ff slice (w1 rows, b1, w2 columns, the whole b2).
    Its ``ffn_partial`` equals the unfused decode's row-parallel partial
    product, the f32 product of the bf16-rounded relu hidden with the w2
    slice, bit for bit; the ranks' partials summed, plus b2, rounded once
    equal what ``_DecodeWeights.row`` gives from the row path's partials
    (the group's all-reduce stood in for by a sum in rank order). At tp 1
    that is ``ffn_plain``."""
    d, r = 32, 100
    rng = np.random.RandomState(tp * f)
    w1, b1, w2, b2 = _ffn_weights(rng, d, f)
    _, x = _bf16(rng.randn(r, d))
    n = f // tp
    got, want, hids = [], [], []
    for k in range(tp):
        cols = slice(k * n, (k + 1) * n)
        packed = ops.pack_ffn(w1[cols], b1[cols], w2[:, cols].contiguous(), b2)
        got.append(ops.ffn_partial(x, packed))
        assert got[-1].dtype == torch.float32 and got[-1].shape == (r, d)
        hid = torch.relu(dense(x.float(), w1[cols].float(), b1[cols].float())).bfloat16()
        want.append(dense(hid.float(), w2[:, cols].float()))
        hids.append(hid)
        assert torch.equal(got[-1], want[-1])
    fused = (_rank_sum(got) + b2.float()).bfloat16()
    # rank 0's row path, its partial summed with the other ranks'
    monkeypatch.setattr(tcap, "reduce_from_group",
                        lambda part, others: _rank_sum([part, *others]))
    row = tcap._DecodeWeights.row(types.SimpleNamespace(group=want[1:]), hids[0].float(),
                                  w2[:, :n].float(), b2.float()).bfloat16()
    assert torch.equal(fused, row)
    if tp == 1:
        assert torch.equal(fused, ops.ffn_plain(x, w1, b1, w2, b2))
    np.testing.assert_allclose(fused.float().numpy(),
                               ops.ffn_plain(x, w1, b1, w2, b2).float().numpy(),
                               rtol=FFN_RTOL, atol=FFN_ATOL)


def _ffn_partial_case(case):
    """(x, packed) that ``ffn_partial`` must refuse, by case."""
    bf = torch.bfloat16
    w1, b1, w2, b2 = (torch.zeros(s, dtype=bf) for s in ((64, 32), (64,), (32, 64), (32,)))
    packed = ops.pack_ffn(w1, b1, w2, b2)
    if case == "x not (R, d)":
        return torch.zeros(4, 1, 32, dtype=bf), packed
    if case == "x of another width":
        return torch.zeros(4, 48, dtype=bf), packed
    if case == "x in f32":
        return torch.zeros(4, 32), packed
    if case == "d above 256":   # packed by hand: pack_ffn refuses it too
        w = torch.zeros(64, 272, dtype=bf)
        wide = ops.decode.PackedFFN(packed.image, torch.zeros(320), w, b1,
                                    torch.zeros(272, 64, dtype=bf), torch.zeros(272, dtype=bf))
        return torch.zeros(4, 272, dtype=bf), wide
    # every tensor on the meta device (pack_ffn refuses it, so by hand)
    meta = [t.to("meta") for t in (packed.image, packed.b2_pad, w1, b1, w2, b2)]
    return torch.zeros(4, 32, dtype=bf, device="meta"), ops.decode.PackedFFN(*meta)


@pytest.mark.parametrize("case,match", [
    ("x not (R, d)", "must be \\(R, d\\)"), ("x of another width", "shape"),
    ("x in f32", "bfloat16"), ("d above 256", "at most 256"),
    ("neither CUDA nor CPU", "unsupported device"),
])
def test_ffn_partial_refuses_what_the_kernel_does_not_take(case, match):
    x, packed = _ffn_partial_case(case)
    before = ops.ffn_partial.launches
    with pytest.raises(ValueError, match=match):
        ops.ffn_partial(x, packed)
    assert ops.ffn_partial.launches == before


@pytest.mark.parametrize("shapes,dtype,match", [
    (((64, 24), (64,), (24, 64), (24,)), torch.bfloat16, "multiple of 16"),   # d
    (((64, 272), (64,), (272, 64), (272,)), torch.bfloat16, "at most 256"),   # d
    (((40, 32), (40,), (32, 40), (32,)), torch.bfloat16, "d_ff = 40"),        # d_ff
    (((64, 32), (64,), (64, 32), (32,)), torch.bfloat16, "w2 has shape"),     # w2 not (d, d_ff)
    (((64, 32), (32,), (32, 64), (32,)), torch.bfloat16, "b1 has shape"),
    (((64, 32), (64,), (32, 64), (32,)), torch.float32, "bfloat16"),
])
def test_pack_ffn_refuses_what_the_kernel_does_not_take(shapes, dtype, match):
    with pytest.raises(ValueError, match=match):
        ops.pack_ffn(*(torch.zeros(s, dtype=dtype) for s in shapes))


@pytest.mark.parametrize("r,chunks,want", [
    (2048, 32, 3), (2000, 32, 3),          # 32 row tiles: 30 clusters of 4 resident, 44 of 3
    (132 * 64, 32, 1), (10 ** 5, 32, 1),   # the row tiles alone fill the card
    (64, 32, 8), (64, 2, 2), (1, 1, 1),    # at most 8, at most a chunk a block
])
def test_ffn_cluster_is_the_largest_that_runs_in_one_wave(r, chunks, want):
    def resident(s):   # an H100's co-resident 64-row clusters at d 128 by size
        return {1: 132, 2: 66, 3: 44, 4: 30, 5: 22, 6: 16, 7: 14, 8: 14}[s]
    assert ops.one_wave_cluster(r, chunks, resident) == want


def _read_generator(packed):
    """Reads (w, b) back from ``packed.image`` at d_pad and the padded
    vocab, by the layout pack_generator documents: in the (128, d_pad) matrix
    of a chunk, element (n, k) is bf16 number
    64 ((n // 8) d_pad / 8 + k // 8) + 8 (n % 8) + k % 8."""
    img = packed.image
    dp, n = -(-packed.d // 64) * 64, dops.GEN_CHUNK
    assert img.dtype == torch.uint8 and img.shape == (-(-packed.vocab // n), n * dp * 2 + n * 4)
    rows, k = np.meshgrid(np.arange(n), np.arange(dp), indexing="ij")
    order = torch.from_numpy(64 * ((rows // 8) * (dp // 8) + k // 8) + 8 * (rows % 8) + k % 8)
    w = torch.cat([c[:n * dp * 2].view(torch.bfloat16)[order] for c in img])
    b = torch.cat([c[n * dp * 2:].view(torch.float32) for c in img])
    return w, b


@pytest.mark.parametrize("vocab,d", [(4528, 128), (37, 32), (300, 144), (128, 256)])
def test_pack_generator_round_trips_and_pads_with_zeros(vocab, d):
    rng = np.random.RandomState(vocab + d)
    _, w = _bf16(rng.uniform(-0.1, 0.1, (vocab, d)))
    _, b = _bf16(rng.uniform(-0.1, 0.1, vocab))
    packed = ops.pack_generator(w, b)
    assert (packed.vocab, packed.d, packed.chunks) == (vocab, d, -(-vocab // 128))
    got_w, got_b = _read_generator(packed)
    assert got_w.shape == (packed.chunks * 128, -(-d // 64) * 64) and got_b.dtype == torch.float32
    assert torch.equal(got_w[:vocab, :d], w) and torch.equal(got_b[:vocab], b.float())
    assert torch.equal(packed.w, w) and torch.equal(packed.b, b)
    for pad in (got_w[vocab:], got_w[:, d:], got_b[vocab:]):
        assert not pad.float().abs().sum()


@pytest.mark.parametrize("shapes,dtype,match", [
    (((16, 24), (16,)), torch.bfloat16, "multiple of 16"),      # d
    (((16, 272), (16,)), torch.bfloat16, "at most 256"),        # d
    (((16, 32), (15,)), torch.bfloat16, "b has shape"),
    (((16, 32), (16,)), torch.float32, "bfloat16"),
    (((0, 32), (0,)), torch.bfloat16, "vocab is empty"),
    (((16,), (16,)), torch.bfloat16, "must be \\(vocab, d\\)"),
])
def test_pack_generator_refuses_what_the_kernel_does_not_take(shapes, dtype, match):
    with pytest.raises(ValueError, match=match):
        ops.pack_generator(*(torch.zeros(s, dtype=dtype) for s in shapes))


@pytest.mark.parametrize("r,chunks,want", [
    (2048, 36, 3), (2000, 36, 3),          # 32 row tiles: 30 clusters of 4 resident, 39 of 3
    (132 * 64, 36, 1),                     # the row tiles alone fill the card
    (64, 36, 8), (64, 2, 2), (64, 1, 1),   # at most 8, and never more ranks than chunks
])
def test_generator_cluster_is_the_largest_that_runs_in_one_wave(r, chunks, want):
    def resident(s):   # an H100's co-resident generator clusters at d 128 by size
        return {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}[s]
    s = ops.one_wave_cluster(r, chunks, resident)
    assert s == want and s <= chunks


@pytest.mark.parametrize("r,d,vocab", [(200, 128, 4528), (64, 32, 300), (100, 144, 1000)])
def test_generator_argmax_on_packed_weights_equals_plain_bit_for_bit(r, d, vocab):
    rng = np.random.RandomState(r + vocab)
    _, x = _bf16(rng.randn(r, d))
    _, w = _bf16(rng.uniform(-0.2, 0.2, (vocab, d)))
    _, b = _bf16(rng.uniform(-0.1, 0.1, vocab))
    got = ops.generator_argmax(x, ops.pack_generator(w, b))
    assert got.dtype == torch.long and torch.equal(got, ops.generator_argmax_plain(x, w, b, vocab))


def test_generator_chunk_matches_the_kernel_source():
    """pack_generator lays the vocab out in the kernel's chunk width."""
    src = (dops._build.CSRC / "decode.cu").read_text()
    assert f"constexpr int kChunk = {dops.GEN_CHUNK};   // vocab columns a chunk" in src


def _tiny(**kw):
    return dataclasses.replace(_flagship_cfg(tiny=True), eval_decode_dtype="bfloat16", **kw)


def _count_calls(monkeypatch):
    """Counts calls of the two wrappers from the captioner (CPU calls are
    not launches, so the wrappers' own counters stay put)."""
    calls = {"ffn": 0, "generator_argmax": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("early_guide", [True, False])
@pytest.mark.parametrize("stages", [1, 4])
def test_fused_decode_tokens_equal_unfused_on_cpu(monkeypatch, early_guide, stages):
    """The fused branch, forced on for CPU tensors, runs the wrappers' plain
    versions and gives the unfused decode's tokens bit for bit."""
    cfg = _tiny(eval_decode_stages=stages, early_guide=early_guide)
    model = port_model(cfg, jax_model(cfg, 1)[2])
    ep = {k: torch.from_numpy(v) for k, v in _proposals(cfg, np.random.RandomState(0)).items()}
    with torch.no_grad():
        unfused = model.caption(ep)
        calls = _count_calls(monkeypatch)
        monkeypatch.setattr(tcap, "decode_fused",
                            lambda c, dd, dev: c.eval_decode_fused and dd == torch.bfloat16)
        model.caption.cfg = ModelConfig(**dataclasses.asdict(
            dataclasses.replace(cfg, eval_decode_fused=True)))
        fused = model.caption(ep)
    steps = cfg.max_des_len + 1
    assert calls == {"generator_argmax": steps,
                     "ffn": cfg.num_layers * (steps + int(early_guide))}
    assert torch.equal(fused, unfused)


def test_fused_flag_tokens_match_jax_or_tie():
    """eval_decode_fused=True on both sides: JAX keeps its composites off the
    TPU and the port keeps its unfused path on the CPU; the tokens agree as
    the unfused bf16 decodes do (tests/test_torch_models.py)."""
    cfg = _tiny(eval_decode_fused=True)
    got, want, model, ep = _decode_both(cfg, np.random.RandomState(0))
    assert_tokens_match_or_tie(got, want, model, ep)


def test_gate_engages_only_for_bf16_on_cuda():
    on = ModelConfig(eval_decode_fused=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tcap.decode_fused(on, torch.bfloat16, cuda)
    assert not tcap.decode_fused(on, torch.float32, cuda)
    assert not tcap.decode_fused(on, torch.bfloat16, cpu)
    assert not tcap.decode_fused(ModelConfig(), torch.bfloat16, cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_flag_on_cpu_launches_nothing(monkeypatch, dtype):
    cfg = dataclasses.replace(_tiny(eval_decode_fused=True), eval_decode_dtype=dtype)
    model = port_model(cfg, jax_model(cfg, 2)[2])
    ep = {k: torch.from_numpy(v) for k, v in _proposals(cfg, np.random.RandomState(3)).items()}
    before = (dops.generator_argmax.launches, dops.ffn.launches)
    calls = _count_calls(monkeypatch)
    with torch.no_grad():
        model.caption(ep)
    assert calls == {"ffn": 0, "generator_argmax": 0}
    assert (dops.generator_argmax.launches, dops.ffn.launches) == before
