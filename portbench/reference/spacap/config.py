"""Model, train, data and run configuration and token ids for the PyTorch
port.

Copies of the JAX package's ``ModelConfig``, ``TrainConfig``,
``DataConfig`` and ``RunConfig`` (same field names, same defaults), so that
a ``config.json`` written by either package builds the same architecture,
schedule and input pipeline in the other. The port imports nothing of
``spacap3d_tpu``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Special vocabulary tokens (reference lib/dataset.py:134-144).
PAD_ID = 0
UNK_ID = 1
SOS_ID = 2
EOS_ID = 3
SPECIAL_TOKENS = ("pad_", "unk", "sos", "eos")

MAX_DES_LEN = 30          # max caption tokens (excluding sos/eos)
MAX_NUM_OBJ = 128         # max GT objects per scene
GT_VOTE_FACTOR = 3        # replicated GT votes per point
DEFAULT_SEED = 42
EVAL_MIN_IOU = 0.5        # caption-to-GT box IoU a proposal needs in eval
MEAN_COLOR_RGB = (109.8, 97.2, 83.8)


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


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "ScanRefer"     # or "ReferIt3D"
    data_root: str = os.environ.get("SPACAP_DATA_ROOT", "data")
    num_points: int = 40000
    use_height: bool = True
    use_color: bool = False
    use_normal: bool = False
    use_multiview: bool = False
    augment: bool = True
    use_relation: bool = True
    num_workers: int = 4
    max_des_len: int = MAX_DES_LEN

    @property
    def scannet_data(self) -> str:
        return os.path.join(self.data_root, "scannet", "scannet_data")

    @property
    def input_feature_dim(self) -> int:
        return (
            128 * int(self.use_multiview)
            + 3 * int(self.use_normal)
            + 3 * int(self.use_color)
            + int(self.use_height)
        )


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    output_dir: str = "outputs"
    tag: str = ""

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @staticmethod
    def load(path: str) -> "RunConfig":
        """JSON lists become tuples where the dataclass holds tuples."""
        with open(path) as f:
            raw = json.load(f)

        def build(cls, values):
            return cls(**{k: _tuples(v) for k, v in values.items()})

        return RunConfig(model=build(ModelConfig, raw["model"]),
                         train=build(TrainConfig, raw["train"]),
                         data=build(DataConfig, raw["data"]),
                         output_dir=raw.get("output_dir", "outputs"),
                         tag=raw.get("tag", ""))


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v
