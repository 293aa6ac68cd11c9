"""The plain reference of the eval grid: for a sample of the forwards the
window ran, it builds each row's input again from the raw scene (the
frozen copy of the dataset's cached val item and of the grid's (seed,
index) RNG schedule), runs the frozen copy of the detector trunk and the
captioner's encoder in float32 with TF32 off, and judges the program's
outputs: its detection outputs against the reference's, and each served
token by the gap between the reference's best logit and the token's, the
reference run over the served tokens teacher-forced. It imports nothing
of the program."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import synthetic
from portbench.reference.spacap.config import EOS_ID, SOS_ID, DataConfig, ModelConfig
from portbench.reference.spacap.data.dataset import ScanReferDataset, Scene
from portbench.reference.spacap.data.scannet_config import ScannetDatasetConfig
from portbench.reference.spacap.models.captioner import sinusoid_pe
from portbench.reference.spacap.models.spacap import SpaCapNet
from portbench.reference.train_check import tf32

DET_KEYS = ("objectness_scores", "sem_cls_scores", "bbox_lo", "bbox_hi")
ROW_CHUNK = 256


def grid_pairs(seeds: Sequence[int], n: int, batch: int) -> np.ndarray:
    """The grid's (seed, item) rows in stream order, the last batch
    padded by cycling, as (rows, 2)."""
    grid = np.array([(s, i) for s in seeds for i in range(n)], dtype=np.int64)
    if len(grid) % batch:
        grid = np.concatenate([grid, np.resize(grid, (batch - len(grid) % batch, 2))])
    return grid


def dataset(scenes: Dict, eval_list: List[dict], vocab_size: int, data: Dict) -> ScanReferDataset:
    return ScanReferDataset(eval_list, synthetic.store(Scene, scenes),
                            synthetic.reference_vocabulary(vocab_size), ScannetDatasetConfig(),
                            DataConfig(**data), split="val")


def inputs(ds: ScanReferDataset, rows: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The clouds and GT centres of ``rows`` (seed, item): each item's
    subsample drawn with the grid's RNG key."""
    items = [ds.getitem_cached(int(i), np.random.RandomState(
        (int(s) * 2654435761 + int(i)) % (2 ** 31))) for s, i in rows]
    return {k: torch.from_numpy(np.stack([it[k] for it in items])).to(device)
            for k in ("point_clouds", "center_label")}


def detect(model: SpaCapNet, pc: torch.Tensor) -> Dict[str, torch.Tensor]:
    ep = model.detect(pc)
    ep["bbox_lo"] = ep["bbox_corner"].amin(dim=2)
    ep["bbox_hi"] = ep["bbox_corner"].amax(dim=2)
    return ep


def served_logit_gaps(model: SpaCapNet, ep: Dict, tokens: torch.Tensor) -> torch.Tensor:
    """Per served token up to each row's first EOS, the reference's best
    logit minus the token's: the captioner run teacher-forced over the
    served tokens, fed SOS first, in float32. tokens (B, K, T); returns a
    1-D tensor of gaps."""
    cfg = model.cfg
    cap = model.caption
    obj = cap.object_tokens(ep)                                   # (R, 1, d)
    r, t = obj.shape[0], tokens.shape[-1]
    served = tokens.reshape(r, t).long()
    fed = torch.cat([torch.full((r, 1), SOS_ID, device=served.device), served[:, :-1]], 1)
    pe = sinusoid_pe(cfg.max_des_len + 4, cfg.d_model, obj.device)
    is_eos = served == EOS_ID
    first_eos = torch.where(is_eos.any(1), is_eos.float().argmax(1), t - 1)
    keep = torch.arange(t, device=served.device)[None] <= first_eos[:, None]
    causal = torch.ones((1, t + 1, t + 1), dtype=torch.bool, device=obj.device).tril()
    gaps = []
    for s in range(0, r, ROW_CHUNK):
        e = min(r, s + ROW_CHUNK)
        emb = cap.model.tgt_embed[0].lut(fed[s:e]) * math.sqrt(cfg.d_model) + pe[:t]
        out = cap.decode_full(torch.cat([obj[s:e], emb], 1), None, None, causal)[:, 1:]
        logits = cap.model.generator.proj(out)                     # (rows, T, vocab)
        best = logits.max(-1).values
        mine = torch.gather(logits, 2, served[s:e, :, None])[..., 0]
        gaps.append((best - mine)[keep[s:e]])
    return torch.cat(gaps)


def fp8_rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale (its largest
    magnitude at the format's largest finite value, 448), back in f32."""
    scale = t.abs().max().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def control_outputs(model: SpaCapNet, pc: torch.Tensor) -> Dict:
    """The control: the reference's own eval forward in place of the
    program's, a step below each precision the configuration states: its
    float32 parts in TF32, and its bf16 decode with fp8 weights (the
    decoder's, the embedding's and the generator's, each rounded through
    float8 e4m3 with a per-tensor scale)."""
    cap = model.caption
    saved = {n: p.detach().clone() for n, p in cap.model.named_parameters()
             if not n.startswith("encoder.") and not n.startswith("src_embed.")}
    with torch.no_grad():
        for n, p in cap.model.named_parameters():
            if n in saved:
                p.copy_(fp8_rounded(p))
    try:
        with tf32(True):
            ep = detect(model, pc)
            ep["lang_cap"] = cap(ep)
    finally:
        with torch.no_grad():
            for n, p in cap.model.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
    return {k: ep[k] for k in (*DET_KEYS, "lang_cap")}


def judge(model_fields: Dict, data: Dict, scenes: Dict, eval_list: List[dict],
          state0: Dict[str, torch.Tensor], samples: List, device,
          control: bool = False) -> Dict[str, float]:
    """``samples``: (rows (B, 2) of (seed, item), the program's outputs).
    Returns ``det_gap`` (the widest gap of a detection output, over the
    reference's largest magnitude of that output) and ``cap_gap`` (the
    widest logit gap of a served token). ``control`` judges the control's
    outputs in place of the program's."""
    cfg = ModelConfig(**model_fields)
    ds = dataset(scenes, eval_list, cfg.vocab_size, data)
    model = SpaCapNet(cfg).to(device).eval()
    model.load_state_dict(state0)
    det_gap, cap_gap = 0.0, 0.0
    with torch.no_grad():
        for rows, out in samples:
            x = inputs(ds, rows, device)
            got = (control_outputs(model, x["point_clouds"]) if control
                   else {k: (v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)))
                         .to(device) for k, v in out.items()})
            with tf32(False):
                ep = detect(model, x["point_clouds"])
                for k in DET_KEYS:
                    ref = ep[k].float()
                    gap = (got[k].float() - ref).abs().max() / ref.abs().max().clamp_min(1e-12)
                    det_gap = max(det_gap, float(gap))
                tokens = got["lang_cap"].long()
                gaps = served_logit_gaps(model, ep, tokens)
                cap_gap = max(cap_gap, float(gaps.max()))
    return {"det_gap": det_gap, "cap_gap": cap_gap}
