"""MinHash / LSH near-duplicate detection — numpy, no external deps.

Replaces the reference's datasketch dependency (reference:
src/data_pipeline/deduplicate.py:10-154) with vectorised universal hashing:
word shingles -> 64-bit hashes -> ``num_permutations`` affine permutations
min-reduced in one numpy op. Banding LSH buckets candidate pairs; a
union-find (instead of the reference's driver-side recursive DFS) yields the
connected components, keeping the smallest id per component.

The port's copy of ``apertis_llm_tpu/data_pipeline/minhash.py``, whose package imports JAX;
the port imports nothing of it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

_MERSENNE = (1 << 61) - 1
_MAX_HASH = (1 << 32) - 1


def _shingle_hashes(text: str, shingle_size: int = 3) -> np.ndarray:
    """Stable 32-bit hashes of word shingles."""
    words = text.lower().split()
    if len(words) < shingle_size:
        shingles = [" ".join(words)] if words else [""]
    else:
        shingles = [" ".join(words[i:i + shingle_size])
                    for i in range(len(words) - shingle_size + 1)]
    out = np.empty(len(shingles), np.uint64)
    for i, s in enumerate(shingles):
        out[i] = int.from_bytes(
            hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")
    return out


class MinHasher:
    def __init__(self, num_permutations: int = 128, seed: int = 1,
                 shingle_size: int = 3):
        rng = np.random.RandomState(seed)
        self.a = rng.randint(1, _MERSENNE, size=num_permutations, dtype=np.uint64)
        self.b = rng.randint(0, _MERSENNE, size=num_permutations, dtype=np.uint64)
        self.num_permutations = num_permutations
        self.shingle_size = shingle_size

    def signature(self, text: str) -> np.ndarray:
        h = _shingle_hashes(text, self.shingle_size)  # (S,)
        # (S, P) affine permutations mod Mersenne prime, truncated to 32 bits.
        vals = (h[:, None] * self.a[None, :] + self.b[None, :]) % _MERSENNE
        return np.min(vals & _MAX_HASH, axis=0).astype(np.uint32)

    @staticmethod
    def jaccard_estimate(sig_a: np.ndarray, sig_b: np.ndarray) -> float:
        return float(np.mean(sig_a == sig_b))


def lsh_candidate_pairs(
    signatures: Sequence[np.ndarray],
    num_bands: int,
) -> Set[Tuple[int, int]]:
    """Band the signatures; items sharing any band bucket become candidates."""
    if not signatures:
        return set()
    perms = len(signatures[0])
    rows = perms // num_bands
    pairs: Set[Tuple[int, int]] = set()
    for band in range(num_bands):
        buckets: Dict[bytes, List[int]] = {}
        lo, hi = band * rows, (band + 1) * rows
        for idx, sig in enumerate(signatures):
            buckets.setdefault(sig[lo:hi].tobytes(), []).append(idx)
        for members in buckets.values():
            for i in range(len(members)):
                for j in range(i + 1, len(members)):
                    pairs.add((members[i], members[j]))
    return pairs


class UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:  # path compression
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # Attach the larger-id root to the smaller so representatives are
            # the minimum id of each component (matching the reference's
            # keep-min-id policy, deduplicate.py:53-83).
            if ra < rb:
                self.parent[rb] = ra
            else:
                self.parent[ra] = rb


def deduplicate_texts(
    texts: Sequence[str],
    threshold: float = 0.8,
    num_permutations: int = 128,
    num_bands: int = 16,
    seed: int = 1,
) -> List[int]:
    """Return the indices of texts to KEEP (component representatives)."""
    hasher = MinHasher(num_permutations, seed)
    signatures = [hasher.signature(t) for t in texts]
    uf = UnionFind(len(texts))
    for i, j in lsh_candidate_pairs(signatures, num_bands):
        if MinHasher.jaccard_estimate(signatures[i], signatures[j]) >= threshold:
            uf.union(i, j)
    return sorted({uf.find(i) for i in range(len(texts))})
