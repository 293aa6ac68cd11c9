"""Model and train configuration and token ids for the PyTorch port.

Copies of the JAX package's ``ModelConfig`` and ``TrainConfig`` (same field
names, same defaults), so that a config serialised by either package builds
the same architecture and schedule in the other. The port imports nothing
of ``spacap3d_tpu``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Special vocabulary tokens (reference lib/dataset.py:134-144).
PAD_ID = 0
UNK_ID = 1
SOS_ID = 2
EOS_ID = 3

MAX_DES_LEN = 30          # max caption tokens (excluding sos/eos)
MAX_NUM_OBJ = 128         # max GT objects per scene
GT_VOTE_FACTOR = 3        # replicated GT votes per point
DEFAULT_SEED = 42


@dataclass(frozen=True)
class ModelConfig:
    """Static architecture hyper-parameters."""

    # Detector trunk (reference models/backbone_module.py:28-66).
    num_points: int = 40000
    input_feature_dim: int = 1          # height only by default
    num_proposals: int = 256
    num_heading_bin: int = 1
    num_size_cluster: int = 18
    num_class: int = 18
    vote_factor: int = 1

    sa_npoints: Tuple[int, ...] = (2048, 1024, 512, 256)
    sa_radii: Tuple[float, ...] = (0.2, 0.4, 0.8, 1.2)
    sa_nsamples: Tuple[int, ...] = (64, 32, 16, 16)
    sa_widths: Tuple[Tuple[int, ...], ...] = (
        (64, 64, 128), (128, 128, 256), (128, 128, 256), (128, 128, 256)
    )
    fp_width: int = 256
    seed_feature_dim: int = 256
    agg_radius: float = 0.3
    agg_nsample: int = 16
    proposal_feature_dim: int = 128

    # Captioner (reference scripts/train.py:387-391 defaults).
    vocab_size: int = 4528
    num_layers: int = 6
    num_heads: int = 8
    d_model: int = 128
    d_ff: int = 2048
    transformer_dropout: float = 0.1
    # 'xyz' | 'center' | 'loc' | None (sinusoidal source PE)
    src_pos_type: Optional[str] = "xyz"
    use_transformer_encoder: bool = True
    early_guide: bool = True
    check_relation: bool = True
    no_caption: bool = False

    max_des_len: int = MAX_DES_LEN
    max_num_obj: int = MAX_NUM_OBJ

    use_bf16: bool = False
    # Greedy-decode activation/KV-cache dtype; matmuls accumulate in f32
    # and the argmax runs on f32 logits either way.
    eval_decode_dtype: str = "bfloat16"
    # Stage count of the JAX package's staged KV caches. The port attends
    # over the valid cache prefix at every step, which computes the same
    # softmax, so the value changes nothing here except where
    # ``eval_decode_early_exit`` checks for an all-EOS batch.
    eval_decode_stages: int = 4
    # Skip the remaining stages once every row has emitted EOS, filling
    # their token slots with EOS.
    eval_decode_early_exit: bool = False
    # Fused decode kernels (ops/decode.py, csrc/decode.cu): each FFN and the
    # generator's argmax run as one kernel, the hidden layer and the logits
    # kept on chip. They engage only for a bf16 decode on CUDA tensors (the
    # JAX package: bf16 on a TPU); otherwise the flag changes nothing. Off
    # by default, as in the JAX package, until a measurement says otherwise.
    eval_decode_fused: bool = False

    @property
    def size_decoded(self) -> bool:
        return self.src_pos_type == "loc"


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    epoch: int = 50
    lr: float = 1e-3
    transformer_lr: float = 1e-3
    wd: float = 1e-5
    seed: int = DEFAULT_SEED
    val_step: int = 2000
    verbose: int = 1000
    criterion: str = "cider"
    no_detection: bool = False   # freeze the detector trunk
    no_caption: bool = False     # detection-only pretraining
    use_relation: bool = True
    # detection-only pretraining schedules (reference scripts/train.py:260-263)
    lr_decay_step: Tuple[int, ...] = (80, 120, 160)
    lr_decay_rate: float = 0.1
    bn_decay_step: int = 20
    bn_decay_rate: float = 0.5
    ckpt_every: int = 1
