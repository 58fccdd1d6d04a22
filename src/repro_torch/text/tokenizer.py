"""Hash tokenizer + stemmer-lite.

The paper's engine (Mitos) stems Greek text and maps words to integer
ids via a word table.  We provide (a) a real-text path — lowercase,
alnum-split, crude suffix stemming, FNV-1a hashing — and (b) a
synthetic path where term ids are mapped to uint32 hashes through a
*bijective* avalanche mix (no collisions by construction), which all
synthetic-corpus tests and benchmarks use.
"""
from __future__ import annotations

import re
from typing import Iterable

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+")
_SUFFIXES = ("ations", "ation", "ingly", "ities", "ing", "ions", "ies",
             "edly", "ed", "es", "ly", "s")


def stem(word: str) -> str:
    """Crude suffix stripper ('information' -> 'informat', as the paper)."""
    for suf in _SUFFIXES:
        if word.endswith(suf) and len(word) - len(suf) >= 3:
            return word[: len(word) - len(suf)]
    return word


def tokenize(text: str) -> list[str]:
    return [stem(w) for w in _WORD_RE.findall(text.lower())]


def fnv1a(word: str) -> np.uint32:
    h = np.uint32(2166136261)
    for b in word.encode("utf-8"):
        h = np.uint32(h ^ np.uint32(b))
        h = np.uint32(h * np.uint32(16777619))
    return np.uint32(max(int(h), 1))  # 0 is the "empty query slot" sentinel


def hash_terms(words: Iterable[str]) -> np.ndarray:
    return np.array([fnv1a(w) for w in words], dtype=np.uint32)


def mix32(x: np.ndarray) -> np.ndarray:
    """Bijective 32-bit finalizer (murmur3-style): term id -> unique hash."""
    x = x.astype(np.uint64)
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    x = np.maximum(x, 1)  # avoid the empty-slot sentinel 0
    return x.astype(np.uint32)
