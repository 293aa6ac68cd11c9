"""Vocabulary construction and caption tokenization, as
``spacap3d_tpu/data/vocabulary.py`` (reference lib/dataset.py:78-181):
  * vocabulary = train-split tokens (truncated to MAX_DES_LEN), filtered
    to words present in the GloVe table, sorted by descending frequency;
  * special ids: pad_=0, unk=1, sos=2, eos=3 (note "pad_" to distinguish
    from the real word "pad");
  * per-annotation id sequence: [sos] + tokens + [eos] padded with 0 to
    MAX_DES_LEN + 2; unknown words -> unk;
  * vocabulary cached as {dataset}_vocabulary.json; token weights all 1.

GloVe is used ONLY as a vocabulary filter (the reference loads 300-d
embeddings per token into ``lang_feat`` but the model never consumes
them — the captioner trains its own embedding table, SURVEY.md §2.2).
When no GloVe pickle is available, pass ``glove_vocab=None`` to skip the
filter (flagged in the saved json).
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from spacap3d_tpu_torch.config import MAX_DES_LEN, SPECIAL_TOKENS, UNK_ID


class Vocabulary:
    def __init__(self, word2idx: Dict[str, int], idx2word: Dict[str, str],
                 glove_filtered: bool = True):
        self.word2idx = word2idx
        self.idx2word = idx2word  # str(idx) -> word, reference json layout
        self.glove_filtered = glove_filtered

    def __len__(self):
        return len(self.word2idx)

    @staticmethod
    def build(
        annotations: Sequence[dict],
        glove_vocab: Optional[Iterable[str]] = None,
        max_len: int = MAX_DES_LEN,
    ) -> "Vocabulary":
        counter: Counter = Counter()
        for ann in annotations:
            counter.update(ann["token"][:max_len])
        if glove_vocab is not None:
            gset = set(glove_vocab)
            items = [(w, c) for w, c in counter.items() if w in gset]
        else:
            items = list(counter.items())
        items.sort(key=lambda kv: kv[1], reverse=True)

        word2idx, idx2word = {}, {}
        for i, w in enumerate(SPECIAL_TOKENS):
            word2idx[w] = i
            idx2word[str(i)] = w
        for i, (w, _) in enumerate(items):
            j = i + len(SPECIAL_TOKENS)
            word2idx[w] = j
            idx2word[str(j)] = w
        return Vocabulary(word2idx, idx2word, glove_filtered=glove_vocab is not None)

    def encode(self, tokens: List[str], max_len: int = MAX_DES_LEN) -> np.ndarray:
        """[sos] + tokens[:max_len] + [eos], 0-padded to max_len + 2."""
        ids = np.zeros(max_len + 2, np.int64)
        seq = ["sos"] + list(tokens[:max_len]) + ["eos"]
        for i, tok in enumerate(seq):
            ids[i] = self.word2idx.get(tok, UNK_ID)
        return ids

    def decode(self, token_ids: Iterable[int]) -> str:
        """reference lib/eval_helper.py:46-57 (decode_caption): 'sos' +
        tokens until/including 'eos'; appends 'eos' if never produced."""
        out = ["sos"]
        for tid in token_ids:
            tok = self.idx2word[str(int(tid))]
            out.append(tok)
            if tok == "eos":
                break
        if "eos" not in out:
            out.append("eos")
        return " ".join(out)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"word2idx": self.word2idx, "idx2word": self.idx2word,
                 "glove_filtered": self.glove_filtered},
                f, indent=4,
            )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        with open(path) as f:
            raw = json.load(f)
        return Vocabulary(raw["word2idx"], raw["idx2word"],
                          raw.get("glove_filtered", True))

