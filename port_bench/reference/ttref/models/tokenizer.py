"""CLIP BPE tokenizer (host-side, pure Python).

The port's own copy of ``triplaneturbo_tpu/models/tokenizer.py`` (the port
imports nothing of the JAX package): the same ids for the same text,
including the hashed fallback.

From-scratch implementation of the byte-level BPE scheme CLIP uses. Loads
``vocab.json``/``merges.txt`` when a local tokenizer directory is supplied
(zero-egress environments ship no HF cache); without merge data it falls back
to a deterministic hashed-token scheme so the full pipeline stays runnable —
embeddings are then meaningless but shape/latency-accurate, which is what the
benchmarks need before real checkpoints are converted.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False
    else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1)
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """Minimal CLIP tokenizer: encode(text) -> fixed-length id array."""

    def __init__(
        self,
        vocab_path: Optional[str] = None,
        merges_path: Optional[str] = None,
        max_length: int = 77,
        vocab_size: int = 49408,
    ):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.bos_id = vocab_size - 2  # 49406
        self.eos_id = vocab_size - 1  # 49407
        self.vocab: Optional[Dict[str, int]] = None
        self.bpe_ranks: Optional[Dict[Tuple[str, str], int]] = None
        if vocab_path and os.path.exists(vocab_path):
            with open(vocab_path) as f:
                self.vocab = json.load(f)
            if merges_path and os.path.exists(merges_path):
                with open(merges_path, encoding="utf-8") as f:
                    merges = f.read().split("\n")
                merges = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
                self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self._byte_encoder = _bytes_to_unicode()

    @classmethod
    def from_pretrained(cls, path: str, **kw) -> "CLIPTokenizer":
        return cls(
            vocab_path=os.path.join(path, "vocab.json"),
            merges_path=os.path.join(path, "merges.txt"),
            **kw,
        )

    # -- BPE ---------------------------------------------------------------

    def _bpe(self, token: str) -> List[str]:
        assert self.bpe_ranks is not None
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return list(word)
        while True:
            pairs = set(zip(word[:-1], word[1:]))
            ranked = [(self.bpe_ranks.get(p, 1 << 30), p) for p in pairs]
            best_rank, best = min(ranked)
            if best_rank == 1 << 30:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        return list(word)

    def _encode_word(self, word: str) -> List[int]:
        text = "".join(self._byte_encoder[b] for b in word.encode("utf-8"))
        if self.vocab is not None and self.bpe_ranks is not None:
            return [self.vocab.get(t, 0) for t in self._bpe(text)]
        # deterministic hash fallback (no merge data available)
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        return [h % (self.vocab_size - 3) + 1]

    def encode(self, text: str) -> np.ndarray:
        """Lowercased, whitespace-normalized -> [max_length] int32 ids."""
        text = re.sub(r"\s+", " ", text.lower().strip())
        ids: List[int] = [self.bos_id]
        for word in _PAT.findall(text):
            ids.extend(self._encode_word(word))
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - 1] + [self.eos_id]
        out = np.full((self.max_length,), self.eos_id, np.int32)
        out[: len(ids)] = np.asarray(ids, np.int32)
        return out

    def batch_encode(self, texts: List[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])
