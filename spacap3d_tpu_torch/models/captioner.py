"""Spatiality-guided transformer captioner (as
``spacap3d_tpu/models/captioner.py``): the teacher-forced train forward with
its relation head, and the eval path's greedy decode.

* Pre-LN blocks with the reference LayerNorm (unbiased std, eps on std)
  and a final LayerNorm after each stack; attention masks with -1e9.
* The object token is the raw proposal feature plus its encoded feature.
* Early guide: the object token is decoder position 0 and decoder layers
  have no cross-attention; late guide cross-attends to the object token.
* Train (``train_forward``): teacher forcing in f32 over one caption a
  scene, the object token of the proposal nearest the annotated object;
  dropout (from an explicit ``torch.Generator``) on attention
  probabilities, sublayer outputs, FFN hiddens and embeddings; the
  relation head reads the last encoder layer's (dropped-out) attention
  probabilities and value heads.
* The attention dump (``attention_dump``): the same teacher-forced
  encoder and decoder without dropout over generated tokens, returning
  every layer's attention probabilities.
* Greedy decode over all B*K proposals with a per-layer KV cache, in
  ``eval_decode_dtype``: the residual stream, caches and weights are
  rounded to that dtype, LayerNorm and softmax run in f32, every matmul
  accumulates in f32 before its cast, and the argmax runs on f32 logits.
  Each step attends over the valid cache prefix, which gives the softmax
  of the JAX package's masked full-length (or staged) caches.
* ``eval_decode_fused`` with a bf16 decode on CUDA tensors runs each FFN
  and the generator's argmax as one fused kernel (``ops/decode.py``), as
  the JAX package runs its Pallas kernels for a bf16 decode on a TPU.
* Under tensor parallelism (``parallel/tp.py::shard_model``, which sets
  ``tp_group``) the attention and FFN layers hold this rank's heads and
  columns; the relation head and the attention dump gather every head,
  and the decode sums its row-parallel products over the group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from spacap3d_tpu_torch import ops
from spacap3d_tpu_torch.config import EOS_ID, SOS_ID, ModelConfig
from spacap3d_tpu_torch.models.core import (
    BatchNorm,
    Dense,
    Momentum,
    RefLayerNorm,
    dense,
    dropout,
    gather_from_group,
    reduce_from_group,
    ref_layer_norm,
    run_layers,
)
from spacap3d_tpu_torch.ops.nn_distance import nn_distance
from spacap3d_tpu_torch.utils.segments import Segments, run_eager

NEG_INF = -1e9


def sinusoid_pe(max_len: int, d_model: int, device=None) -> torch.Tensor:
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def attention(q, k, v, mask, rate: float = 0.0, gen=None):
    """q, k, v (B, h, T, dk); mask broadcastable bool (.., T, S) or None.
    Returns the output and the (dropped-out) probabilities. The heads are
    this rank's under tensor parallelism, so their masks come from the
    rank's own generator."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = dropout(torch.softmax(scores, dim=-1), rate, gen, local=True)
    return torch.matmul(p, v), p


class MultiHeadedAttention(nn.Module):
    def __init__(self, h: int, d_model: int):
        super().__init__()
        self.h = h
        self.linears = nn.ModuleList(
            [Dense(d_model, d_model, init="xavier") for _ in range(4)])

    def forward(self, query, key, value, mask=None, rate: float = 0.0, gen=None,
                return_aux: bool = False):
        """With ``return_aux`` also the probabilities and value heads."""
        q = split_heads(self.linears[0](query), self.h)
        k = split_heads(self.linears[1](key), self.h)
        v = split_heads(self.linears[2](value), self.h)
        if mask is not None and mask.dim() == 3:
            mask = mask[:, None]                     # broadcast over heads
        x, p = attention(q, k, v, mask, rate, gen)
        out = self.linears[3](merge_heads(x))
        return (out, p, v) if return_aux else out


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int):
        super().__init__()
        self.w_1 = Dense(d_model, d_ff, init="xavier")
        self.w_2 = Dense(d_ff, d_model, init="xavier")

    def forward(self, x, rate: float = 0.0, gen=None):
        return self.w_2(dropout(torch.relu(self.w_1(x)), rate, gen, local=True))


class SublayerConnection(nn.Module):
    """Pre-LN residual x + dropout(fn(norm(x)))."""

    def __init__(self, d_model: int):
        super().__init__()
        self.norm = RefLayerNorm(d_model)

    def forward(self, x, fn, rate: float = 0.0, gen=None):
        return x + dropout(fn(self.norm(x)), rate, gen)


class EncoderLayer(nn.Module):
    def __init__(self, h: int, d_model: int, d_ff: int):
        super().__init__()
        self.self_attn = MultiHeadedAttention(h, d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff)
        self.sublayer = nn.ModuleList([SublayerConnection(d_model) for _ in range(2)])

    def forward(self, x, mask, rate: float = 0.0, gen=None):
        """-> (x, (attention probabilities, value heads))."""
        aux = []

        def self_attn(xn):
            out, p, v = self.self_attn(xn, xn, xn, mask, rate, gen, return_aux=True)
            aux.append((p, v))
            return out

        x = self.sublayer[0](x, self_attn, rate, gen)
        x = self.sublayer[1](x, lambda xn: self.feed_forward(xn, rate, gen), rate, gen)
        return x, aux[0]


class DecoderLayer(nn.Module):
    """Self-attention, cross-attention (late guide only) and FFN; the
    sublayers keep the reference indices 0, 1, 2."""

    def __init__(self, h: int, d_model: int, d_ff: int, early_guide: bool):
        super().__init__()
        self.self_attn = MultiHeadedAttention(h, d_model)
        if not early_guide:
            self.src_attn = MultiHeadedAttention(h, d_model)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff)
        self.early_guide = early_guide
        idx = ["0", "2"] if early_guide else ["0", "1", "2"]
        self.sublayer = nn.ModuleDict({i: SublayerConnection(d_model) for i in idx})

    def forward(self, x, memory, src_mask, tgt_mask, rate: float = 0.0, gen=None,
                attn_out: Optional[list] = None):
        """Full-sequence (teacher-forced) layer; ``attn_out`` receives the
        self-attention probabilities."""
        def self_attn(xn):
            out, p, _ = self.self_attn(xn, xn, xn, tgt_mask, rate, gen, return_aux=True)
            if attn_out is not None:
                attn_out.append(p)
            return out

        x = self.sublayer["0"](x, self_attn, rate, gen)
        if not self.early_guide:
            x = self.sublayer["1"](
                x, lambda xn: self.src_attn(xn, memory, memory, src_mask, rate, gen), rate, gen)
        return self.sublayer["2"](x, lambda xn: self.feed_forward(xn, rate, gen), rate, gen)


class Stack(nn.Module):
    def __init__(self, layers: List[nn.Module], d_model: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = RefLayerNorm(d_model)


class Embeddings(nn.Module):
    def __init__(self, vocab_size: int, d_model: int):
        super().__init__()
        self.lut = nn.Embedding(vocab_size, d_model)


class Generator(nn.Module):
    def __init__(self, d_model: int, vocab_size: int):
        super().__init__()
        self.proj = Dense(d_model, vocab_size, init="xavier")


class TransformerModel(nn.Module):
    """The reference's ``caption.model`` subtree."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, h, dff, n = cfg.d_model, cfg.num_heads, cfg.d_ff, cfg.num_layers
        if cfg.use_transformer_encoder:
            self.encoder = Stack([EncoderLayer(h, d, dff) for _ in range(n)], d)
            if cfg.src_pos_type is not None:
                in_ch = 3 if cfg.src_pos_type in ("xyz", "center") else 6
                self.src_embed = nn.Module()
                self.src_embed.position_embedding_head = nn.Sequential(
                    Dense(in_ch, d, kernel_dims=(1,), init="xavier"), BatchNorm(d),
                    nn.ReLU(), Dense(d, d, kernel_dims=(1,), init="xavier"))
        self.decoder = Stack(
            [DecoderLayer(h, d, dff, cfg.early_guide) for _ in range(n)], d)
        self.tgt_embed = nn.ModuleList([Embeddings(cfg.vocab_size, d)])
        self.generator = Generator(d, cfg.vocab_size)


def decode_fused(cfg: ModelConfig, dd: torch.dtype, device: torch.device) -> bool:
    """The JAX gate (flag, bf16 decode, TPU backend), with CUDA for the TPU."""
    return bool(cfg.eval_decode_fused) and dd == torch.bfloat16 and device.type == "cuda"


def decode_plan(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """The greedy decode's stages as (first step, end step): the
    ``eval_decode_stages`` cut of the JAX package's ``captioner_eval``
    (its ``bounds``). Both the eager decode and a captured eval step run
    them, one graph a stage where the early exit tests between them."""
    n_steps = cfg.max_des_len + 1
    n_stages = min(max(1, int(cfg.eval_decode_stages)), n_steps)
    ends = [round(n_steps * (s + 1) / n_stages) for s in range(n_stages)]
    return list(zip([0] + ends[:-1], ends))


class _DecodeWeights:
    """The decoder's weights rounded to the decode dtype once per call and
    held in f32, so every matmul multiplies the rounded operands with f32
    accumulation (the products of bf16 values are exact in f32). A fused
    decode also keeps bf16 copies of the FFN and generator weights in the
    kernels' layout, built here, outside the step loop. Under tensor
    parallelism (``group``) the weights are this rank's slices, ``h`` its
    heads, and ``row`` sums a row-parallel product over the group; a fused
    decode packs the rank's d_ff slice of each FFN for ``ops.ffn_partial``."""

    def __init__(self, model: TransformerModel, cfg: ModelConfig, dd: torch.dtype,
                 group=None):
        def rnd(t):
            return t.detach().to(dd).float()

        def bf16(t):
            return t.detach().to(torch.bfloat16).contiguous()

        self.layers = []
        for layer in model.decoder.layers:
            lin = layer.self_attn.linears
            w = {
                "qkv_w": rnd(torch.cat([lin[i].matrix() for i in range(3)], 0)),
                "qkv_b": rnd(torch.cat([lin[i].bias for i in range(3)], 0)),
                "o_w": rnd(lin[3].matrix()), "o_b": rnd(lin[3].bias),
                "w1": rnd(layer.feed_forward.w_1.matrix()),
                "b1": rnd(layer.feed_forward.w_1.bias),
                "w2": rnd(layer.feed_forward.w_2.matrix()),
                "b2": rnd(layer.feed_forward.w_2.bias),
            }
            for i, sub in layer.sublayer.items():
                w[f"ln{i}"] = (rnd(sub.norm.a_2), rnd(sub.norm.b_2))
            if not cfg.early_guide:
                src = layer.src_attn.linears
                w.update({f"src{i}_w": rnd(src[i].matrix()) for i in range(4)})
                w.update({f"src{i}_b": rnd(src[i].bias) for i in range(4)})
            self.layers.append(w)
        lut = model.tgt_embed[0].lut.weight
        self.dd, self.group = dd, group
        self.h = model.decoder.layers[0].self_attn.h
        self.fused = decode_fused(cfg, dd, lut.device)
        if self.fused:
            for w, layer in zip(self.layers, model.decoder.layers):
                ff = layer.feed_forward
                w["ffn"] = ops.pack_ffn(bf16(ff.w_1.matrix()), bf16(ff.w_1.bias),
                                        bf16(ff.w_2.matrix()), bf16(ff.w_2.bias))
            proj = model.generator.proj
            self.gen = ops.pack_generator(bf16(proj.matrix()), bf16(proj.bias))
        self.final_ln = (rnd(model.decoder.norm.a_2), rnd(model.decoder.norm.b_2))
        self.gen_w = rnd(model.generator.proj.matrix())
        self.gen_b = rnd(model.generator.proj.bias)
        self.lut = rnd(lut)
        self.pe = rnd(sinusoid_pe(cfg.max_des_len + 4, cfg.d_model, lut.device))
        # a fill, not a host-to-device copy: a captured step builds this too
        self.sqrt_d = rnd(torch.full((), math.sqrt(cfg.d_model), device=lut.device))

    def row(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """x @ w^T + b for a row-parallel layer: the partial products summed
        over the group before the bias."""
        if self.group is None:
            return dense(x, w, b)
        return reduce_from_group(dense(x, w), self.group) + b


@dataclasses.dataclass
class DecodeState:
    """A greedy decode between stages (``Captioner.begin_decode``)."""

    w: _DecodeWeights
    caches: list                     # per layer (k, v), each (R, h, Lmax, dk)
    cross_kv: Optional[list]         # late guide: per layer (k, v) of the object token
    offset: int                      # cache position of the first caption token
    token: torch.Tensor              # (R,) int64: the last step's tokens
    tokens: torch.Tensor             # (R, max_des_len + 1) int64, filled step by step


class Captioner(nn.Module):
    # the model group and this rank's place in it under tensor parallelism
    # (parallel/tp.py), else None and 0
    tp_group, tp_rank = None, 0

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.model = TransformerModel(cfg)
        if cfg.check_relation:
            d = cfg.d_model
            # relation head: the train forward only
            self.relation_proposal = nn.Sequential(
                Dense(d, d), nn.ReLU(), Dense(d, d), nn.ReLU(), Dense(d, 9))

    def all_heads(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, heads, ...) of this rank's heads -> every head's."""
        return x if self.tp_group is None else gather_from_group(x, self.tp_group, 1)

    # ------------------------------------------------------------ encoder
    def src_pos(self, ep: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
        return {
            "xyz": lambda: ep["aggregated_vote_xyz"],
            "center": lambda: ep["center"],
            "loc": lambda: torch.cat([ep["center"], ep["pred_size"]], dim=-1),
            None: lambda: None,
        }[self.cfg.src_pos_type]()

    def src_embed(self, src: torch.Tensor, src_pos: Optional[torch.Tensor],
                  rate: float = 0.0, gen=None, momentum: Optional[Momentum] = None
                  ) -> torch.Tensor:
        """Learned position head (conv-BN-ReLU-conv; ``momentum`` moves its
        BN's running stats in train mode) or sinusoidal PE (with dropout)."""
        if self.cfg.src_pos_type is not None:
            return src + run_layers(self.model.src_embed.position_embedding_head, src_pos,
                                    momentum)
        return dropout(src + sinusoid_pe(src.shape[1], self.cfg.d_model, src.device), rate, gen)

    def encode(self, x: torch.Tensor, src_mask: torch.Tensor, rate: float = 0.0, gen=None,
               attn_out: Optional[list] = None):
        """-> (memory, the last layer's (attention probabilities, value
        heads)); ``attn_out`` receives every layer's probabilities."""
        for layer in self.model.encoder.layers:
            x, aux = layer(x, src_mask, rate, gen)
            if attn_out is not None:
                attn_out.append(aux[0])
        return self.model.encoder.norm(x), aux

    def object_tokens(self, ep: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B*K, 1, d) object tokens: raw proposal feature (+ encoded memory)."""
        cfg = self.cfg
        feats = ep["aggregated_vote_features"]
        b, k, c = feats.shape
        if not cfg.use_transformer_encoder:
            return feats.reshape(b * k, 1, c)
        src_mask = (ep["bbox_mask"] != 0)[:, None, :]
        memory, _ = self.encode(self.src_embed(feats, self.src_pos(ep)), src_mask)
        return feats.reshape(b * k, 1, c) + memory.reshape(b * k, 1, c)

    # -------------------------------------------------------------- train
    def decode_full(self, x, memory, src_mask, tgt_mask, rate: float = 0.0, gen=None,
                    attn_out: Optional[list] = None):
        """The decoder over whole sequences (teacher forcing); ``attn_out``
        receives every layer's self-attention probabilities."""
        for layer in self.model.decoder.layers:
            x = layer(x, memory, src_mask, tgt_mask, rate, gen, attn_out)
        return self.model.decoder.norm(x)

    @torch.no_grad()
    def attention_dump(self, ep: Dict[str, torch.Tensor], tokens: torch.Tensor):
        """Attention weights for analysis, as the JAX package's
        ``captioner_attention_dump`` (the reference's --save_encoder_attn /
        --save_decoder_attn, lib/eval_helper.py:99-121). ``tokens`` (B, K,
        T) are generated ids; returns (enc_attn (L, B, h, K, K), dec_attn
        (L, B*K, h, T', T')), T' counting the object token under early
        guide (an empty tensor for an absent encoder). The decoder's weights
        come from a teacher-forced rerun over the tokens, without dropout,
        which equals the last step of the reference's recompute-everything
        loop."""
        cfg = self.cfg
        feats = ep["aggregated_vote_features"]
        b, k, c = feats.shape
        r = b * k
        src_mask = (ep["bbox_mask"] != 0)[:, None, :]
        enc_attn, dec_attn = [], []
        if cfg.use_transformer_encoder:
            memory, _ = self.encode(self.src_embed(feats, self.src_pos(ep)), src_mask,
                                    attn_out=enc_attn)
            obj = feats.reshape(r, 1, c) + memory.reshape(r, 1, c)
        else:
            memory, obj = feats, feats.reshape(r, 1, c)
        t = tokens.shape[-1]
        pe = sinusoid_pe(cfg.max_des_len + 4, cfg.d_model, feats.device)
        emb = (self.model.tgt_embed[0].lut(tokens.reshape(r, t).long()) * math.sqrt(cfg.d_model)
               + pe[:t])
        if cfg.early_guide:
            causal = torch.ones((1, t + 1, t + 1), dtype=torch.bool, device=feats.device).tril()
            self.decode_full(torch.cat([obj, emb], 1), memory, src_mask, causal,
                             attn_out=dec_attn)
        else:
            causal = torch.ones((1, t, t), dtype=torch.bool, device=feats.device).tril()
            self.decode_full(emb, obj, None, causal, attn_out=dec_attn)
        empty = feats.new_zeros((0,))
        return (torch.stack([self.all_heads(a) for a in enc_attn]) if enc_attn else empty,
                torch.stack([self.all_heads(a) for a in dec_attn]) if dec_attn else empty)

    def relation_head(self, attn: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """attn (B, h, K, K), value (B, h, K, dk) -> (B, K, K, 9). The
        reference feeds rel[b, i, j] = concat_h(attn[b, h, i, j] value[b, h,
        j]) to its first linear layer; that layer is folded through the
        outer product instead, sum_h attn[b, h, i, j] (value[b, h, j] @
        W0_h), so the (B, K, K, h dk) tensor never exists."""
        b, h, k, dk = value.shape
        l0, l2, l4 = (self.relation_proposal[i] for i in (0, 2, 4))
        vw = torch.einsum("bhjd,hdc->bhjc", value, l0.matrix().t().reshape(h, dk, -1))
        h1 = torch.relu(torch.einsum("bhij,bhjc->bijc", attn, vw) + l0.bias)
        return l4(torch.relu(l2(h1)))

    def train_forward(self, ep: Dict[str, torch.Tensor],
                      gen: Optional[torch.Generator] = None,
                      bn_momentum: Momentum = 0.1) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward over the detector endpoints and the batch's
        ``lang_label`` / ``ref_center_label``: ``lang_cap`` (B, T, vocab)
        log-probs, ``match_idx``, ``good_bbox_masks``, ``pred_ious`` and,
        with the relation head, ``relation_pred`` (B, K, K, 9). Dropout at
        ``transformer_dropout`` in train mode, drawn from ``gen`` (under
        tensor parallelism the rank's heads and FFN columns draw from a
        generator of their own: ``gen`` is then the ``SplitGenerators`` that
        the train step split, ``train/step.py::dropout_generators``); the
        source embedding's BN moves its running stats at ``bn_momentum``."""
        cfg = self.cfg
        rate = cfg.transformer_dropout if self.training else 0.0
        src = ep["aggregated_vote_features"]                    # (B, K, C)
        c = src.shape[-1]
        # the proposal nearest the annotated object
        _, _, target_d2, idx = nn_distance(ep["aggregated_vote_xyz"],
                                           ep["ref_center_label"][:, None, :])
        index = idx.long()[..., None].expand(-1, -1, c)         # (B, 1, C)

        lang_label = ep["lang_label"]                           # (B, L + 3)
        seq_full = lang_label[:, :-1] if cfg.early_guide else lang_label[:, 1:-1]
        t = seq_full.shape[1]
        causal = torch.ones((t, t), dtype=torch.bool, device=src.device).tril()
        tgt_mask = (seq_full > 0)[:, None, :] & causal
        tgt_tokens = seq_full[:, 1:] if cfg.early_guide else seq_full
        src_mask = (ep["bbox_mask"] != 0)[:, None, :]

        relation = None
        if cfg.use_transformer_encoder:
            x = self.src_embed(src, self.src_pos(ep), rate, gen, bn_momentum)
            memory, relation = self.encode(x, src_mask, rate, gen)
            obj = torch.gather(src, 1, index) + torch.gather(memory, 1, index)
        else:
            memory, obj = src, torch.gather(src, 1, index)

        pe = sinusoid_pe(cfg.max_des_len + 4, cfg.d_model, src.device)
        emb = self.model.tgt_embed[0].lut(tgt_tokens) * math.sqrt(cfg.d_model)
        emb = dropout(emb + pe[:tgt_tokens.shape[1]], rate, gen)
        if cfg.early_guide:
            out = self.decode_full(torch.cat([obj, emb], 1), memory, src_mask, tgt_mask,
                                   rate, gen)[:, 1:]
        else:
            out = self.decode_full(emb, obj, None, tgt_mask, rate, gen)

        # good_bbox_masks: target_d2 is a squared distance, always > -1
        good = target_d2[:, 0] > -1
        new = {
            "lang_cap": torch.log_softmax(self.model.generator.proj(out), dim=-1),
            "match_idx": idx[:, 0],
            "good_bbox_masks": good,
            "pred_ious": torch.where(good.sum() > 0,
                                     torch.where(good, target_d2[:, 0], 0.0).mean(), 0.0),
        }
        if cfg.check_relation and relation is not None:
            new["relation_pred"] = self.relation_head(*map(self.all_heads, relation))
        return new

    # ------------------------------------------------------------- decode
    def _decode_step(self, w: _DecodeWeights, x, caches, pos: int, cross_kv):
        """One decoder step for the newest token. x (R, 1, d) in dd; caches
        per layer (k, v) of shape (R, h, Lmax, dk) in dd, slot ``pos``
        written here. Returns the final-norm hidden (R, d) f32."""
        cfg, dd, h = self.cfg, w.dd, w.h
        scale = math.sqrt(cfg.d_model // cfg.num_heads)

        def norm(ln, x):
            return ref_layer_norm(x.float(), *ln).to(dd)

        for li, lw in enumerate(w.layers):
            k_cache, v_cache = caches[li]
            qkv = dense(norm(lw["ln0"], x).float(), lw["qkv_w"], lw["qkv_b"])
            d = qkv.shape[-1] // 3                  # this rank's heads' width
            q = split_heads(qkv[..., :d], h)
            k_cache[:, :, pos:pos + 1] = split_heads(qkv[..., d:2 * d], h).to(dd)
            v_cache[:, :, pos:pos + 1] = split_heads(qkv[..., 2 * d:], h).to(dd)
            keys = k_cache[:, :, :pos + 1].float()
            vals = v_cache[:, :, :pos + 1].float()
            scores = torch.matmul(q.to(dd).float(), keys.transpose(-1, -2)) / scale
            probs = torch.softmax(scores, dim=-1)
            att = torch.matmul(probs.to(dd).float(), vals)
            x = x + w.row(merge_heads(att).to(dd).float(), lw["o_w"], lw["o_b"]).to(dd)
            if not cfg.early_guide:
                ck, cv = cross_kv[li]
                q = split_heads(dense(norm(lw["ln1"], x).float(), lw["src0_w"], lw["src0_b"]), h)
                scores = torch.matmul(q.to(dd).float(), ck.float().transpose(-1, -2)) / scale
                att = torch.matmul(torch.softmax(scores, dim=-1).to(dd).float(), cv.float())
                x = x + w.row(merge_heads(att).to(dd).float(), lw["src3_w"],
                              lw["src3_b"]).to(dd)
            xn = norm(lw["ln2"], x)
            if w.fused and w.group is None:
                x = x + ops.ffn(xn[:, 0], lw["ffn"])[:, None]
            elif w.fused:   # this rank's d_ff slice, summed over the group as ``row``
                part = ops.ffn_partial(xn[:, 0], lw["ffn"])
                x = x + (reduce_from_group(part, w.group) + lw["b2"]).to(dd)[:, None]
            else:
                hid = torch.relu(dense(xn.float(), lw["w1"], lw["b1"])).to(dd)
                x = x + w.row(hid.float(), lw["w2"], lw["b2"]).to(dd)
        return ref_layer_norm(x.float(), *w.final_ln)[:, 0]

    def start_decode(self, obj_token: torch.Tensor):
        """Decode state for obj_token (R, 1, d): rounded weights, empty KV
        caches (early guide: the object token already at position 0), the
        late-guide cross K/V, and the position of the first caption token."""
        cfg = self.cfg
        w = _DecodeWeights(self.model, cfg, getattr(torch, cfg.eval_decode_dtype),
                           self.tp_group)
        dd, r, dev = w.dd, obj_token.shape[0], obj_token.device
        h, dk = w.h, cfg.d_model // cfg.num_heads
        offset = 1 if cfg.early_guide else 0
        lmax = cfg.max_des_len + 2 + offset
        caches = [(torch.zeros((r, h, lmax, dk), dtype=dd, device=dev),
                   torch.zeros((r, h, lmax, dk), dtype=dd, device=dev))
                  for _ in range(cfg.num_layers)]
        cross_kv = None
        if not cfg.early_guide:
            obj = obj_token.to(dd).float()
            cross_kv = [(split_heads(dense(obj, lw["src1_w"], lw["src1_b"]), h).to(dd),
                         split_heads(dense(obj, lw["src2_w"], lw["src2_b"]), h).to(dd))
                        for lw in w.layers]
        else:
            self._decode_step(w, obj_token.to(dd), caches, 0, cross_kv)
        return w, caches, cross_kv, offset

    def _step_hidden(self, w: _DecodeWeights, token, i: int, caches, offset: int, cross_kv):
        """Final-norm hidden (R, d) f32 of step i, fed the previous tokens (R,)."""
        # embedding * sqrt(d) + PE: both ops are in dd, so each rounds
        emb = ((w.lut[token][:, None] * w.sqrt_d).to(w.dd).float() + w.pe[i]).to(w.dd)
        return self._decode_step(w, emb, caches, i + offset, cross_kv)

    def next_logits(self, w: _DecodeWeights, token, i: int, caches, offset: int, cross_kv):
        """f32 logits (R, vocab) of step i, fed the previous tokens (R,)."""
        hid = self._step_hidden(w, token, i, caches, offset, cross_kv)
        return dense(hid.to(w.dd).float(), w.gen_w, w.gen_b)

    def next_token(self, w: _DecodeWeights, token, i: int, caches, offset: int, cross_kv):
        """Greedy token (R,) int64 of step i: the first maximum of the f32
        logits, which the fused generator kernel never writes."""
        if not w.fused:
            return torch.argmax(self.next_logits(w, token, i, caches, offset, cross_kv), dim=-1)
        hid = self._step_hidden(w, token, i, caches, offset, cross_kv)
        return ops.generator_argmax(hid.to(w.dd), w.gen)

    def begin_decode(self, obj_token: torch.Tensor) -> "DecodeState":
        """``start_decode`` plus the SOS tokens and an empty (R, max_des_len
        + 1) token buffer."""
        w, caches, cross_kv, offset = self.start_decode(obj_token)
        r, dev = obj_token.shape[0], obj_token.device
        return DecodeState(w, caches, cross_kv, offset,
                           torch.full((r,), SOS_ID, dtype=torch.long, device=dev),
                           torch.empty((r, self.cfg.max_des_len + 1), dtype=torch.long,
                                       device=dev))

    def decode_stage(self, state: "DecodeState", start: int, end: int) -> None:
        """Greedy steps start..end - 1, each token written to its slot."""
        for i in range(start, end):
            state.token = self.next_token(state.w, state.token, i, state.caches, state.offset,
                                          state.cross_kv)
            state.tokens[:, i] = state.token

    @staticmethod
    def decode_done(state: "DecodeState", end: int) -> torch.Tensor:
        """The early exit's test at a stage end, a 0-dim bool on the device:
        every row has emitted EOS in its first ``end`` steps."""
        return state.tokens[:, :end].eq(EOS_ID).any(1).all()

    @staticmethod
    def skip_stages(state: "DecodeState", start: int) -> None:
        """The skipped stages' slots from step ``start`` on are EOS (the
        harness truncates at the first EOS), as the JAX package's
        ``skip_stage`` fills them."""
        state.tokens[:, start:].fill_(EOS_ID)

    def decode_segments(self, begin: Callable[[Dict], torch.Tensor],
                        end: Callable[[Dict, torch.Tensor], Any]) -> Segments:
        """The greedy decode as ``Segments`` (``utils/segments.py``) in the
        stages of ``decode_plan``: ``begin(carry)`` gives the object tokens
        (R, 1, d) f32, and ``end(carry, tokens)`` the result from the (R,
        max_des_len + 1) int32 tokens. With ``eval_decode_early_exit`` and
        more than one stage it is a part a stage, each but the last ending
        in the all-EOS test where the JAX package runs ``lax.cond``, whose
        ``skip`` fills the later slots with EOS, and then ``end``; else one
        part. ``greedy_decode`` runs it eagerly; the eval step puts its
        trunk in ``begin`` and its tail in ``end``, eager or captured."""
        plan = decode_plan(self.cfg)

        def stage(carry, s):
            self.decode_stage(carry["dec"], *plan[s])
            return self.decode_done(carry["dec"], plan[s][1]) if s + 1 < len(plan) else None

        def first(carry):
            carry["dec"] = self.begin_decode(begin(carry))
            return stage(carry, 0)

        def finish(carry):
            return end(carry, carry["dec"].tokens.to(torch.int32))

        if not (self.cfg.eval_decode_early_exit and len(plan) > 1):
            def whole(carry):            # no stage end is tested
                carry["dec"] = self.begin_decode(begin(carry))
                for start, stop in plan:
                    self.decode_stage(carry["dec"], start, stop)
                return finish(carry)
            return Segments([whole])
        return Segments([first, *(lambda carry, s=s: stage(carry, s) for s in range(1, len(plan))),
                         finish],
                        lambda carry, k: self.skip_stages(carry["dec"], plan[k][1]))

    def greedy_decode(self, obj_token: torch.Tensor) -> torch.Tensor:
        """obj_token (R, 1, d) f32 -> tokens (R, max_des_len + 1) int32:
        ``decode_segments`` run eagerly. With ``eval_decode_early_exit`` the
        host tests each stage end but the last, and once every row has
        emitted EOS skips the rest."""
        return run_eager(self.decode_segments(lambda carry: carry["inputs"]["obj"],
                                              lambda carry, tokens: tokens),
                         {"obj": obj_token})

    def forward(self, ep: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Greedy captions for every proposal: (B, K, max_des_len + 1) int32."""
        b, k, _ = ep["aggregated_vote_features"].shape
        return self.greedy_decode(self.object_tokens(ep)).reshape(b, k, -1)
