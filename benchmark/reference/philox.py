"""Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers:
as easy as 1, 2, 3", SC'11) on int64 tensors, and the counter layouts under
which the program's kernels draw from it.

The layouts are the kernels' documented contract (the head comments of
``csrc/ris.cu`` and ``csrc/spatial.cu``): a 64-bit key split into its low
and high words; a counter (c0, pixel, pixel >> 32, tag); a uniform is the
word's top 24 bits times 2^-24.

- RIS (kernel 3): candidate slot t of lane l takes counter
  (t·K + l, pixel, 0, 0); its four words are the light pick, u, v and the
  race's uniform. The MIS RIS (kernel 15) draws the same way for each
  iteration i under tag 0x4D49 << 16 | i.
- Neighbour selection (kernel 16): box offset o (dy-major, dx-minor,
  (0, 0) skipped) takes word o mod 4 of counter (o div 4, pixel, 0,
  0x4E53 << 16); its score is -log(-log u) of the word's uniform.
- A biased spatial pass (kernel 5): stream s (the R neighbours, then the
  receiver itself) takes counter (2s, pixel, 0, 0x5350 << 16 | pass); its
  words are the row offset, the column offset and the race noise of lanes
  0 and 1; lanes 2 and 3 take words 0 and 1 of counter 2s + 1.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
TAG_PASS_BIASED = 0x5350 << 16
TAG_MIS = 0x4D49 << 16
TAG_SELECT = 0x4E53 << 16


def _mulhilo(m: int, a: torch.Tensor):
    """(high, low) words of the 64-bit product m·a, a's words < 2^32, in
    int64 without overflow (16-bit halves of a)."""
    p_lo = m * (a & 0xFFFF)
    p_hi = m * (a >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK


def philox4x32_10(c0, c1, c2, c3, key: int):
    """Ten rounds on counters (int64 tensors of 32-bit words) under the
    64-bit ``key`` → four int64 tensors of 32-bit words."""
    k0, k1 = key & MASK, (key >> 32) & MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def uniform(word: torch.Tensor) -> torch.Tensor:
    """A word's top 24 bits as a float32 in [0, 1)."""
    return (word >> 8).to(torch.float32) * (1.0 / 16777216.0)


def gumbel(word: torch.Tensor) -> torch.Tensor:
    """-log(-log u) of a word's uniform, u kept above 1e-37."""
    return -torch.log(-torch.log(torch.clamp_min(uniform(word), 1e-37)))


def offset(word: torch.Tensor, radius: int) -> torch.Tensor:
    """A uniform integer in [-radius, radius] from a word."""
    span = 2 * radius + 1
    return torch.clamp_max((uniform(word) * float(span)).to(torch.int64),
                           2 * radius) - radius


def _block(key: int, c0: torch.Tensor, n: int, tag: int):
    """The words at counters (c0[i], pixel, pixel >> 32, tag) for every i
    and every pixel of n → four [len(c0), n] tensors."""
    pix = torch.arange(n, dtype=torch.int64, device=c0.device)[None]
    shape = (c0.shape[0], n)
    return philox4x32_10(c0[:, None].expand(shape), (pix & MASK).expand(shape),
                         (pix >> 32).expand(shape),
                         torch.full(shape, tag, dtype=torch.int64,
                                    device=c0.device), key)


def ris_slot(key: int, slot: int, k: int, n: int, dev, tag: int = 0):
    """The uniforms of candidate slot ``slot`` in every lane → (pick, u, v,
    race), each [K, N]."""
    c0 = torch.arange(slot * k, slot * k + k, dtype=torch.int64, device=dev)
    return tuple(uniform(w) for w in _block(key, c0, n, tag))


def selection_scores(key: int, n_off: int, n: int, dev, chunk: int = 16):
    """The selection's score of every box offset → [n_off, N] float32."""
    out = []
    n_ctr = -(-n_off // 4)
    for c0 in range(0, n_ctr, chunk):
        c = torch.arange(c0, min(c0 + chunk, n_ctr), dtype=torch.int64,
                         device=dev)
        words = torch.stack(_block(key, c, n, TAG_SELECT), dim=1)
        out.append(gumbel(words.reshape(-1, n)))
    return torch.cat(out)[:n_off]


def spatial_pass(key: int, pass_index: int, n_nbr: int, k: int, radius: int,
                 n: int, dev):
    """One biased pass's draws → (row offsets [R, N], column offsets
    [R, N], race noise [R+1, K, N])."""
    tag = TAG_PASS_BIASED | (pass_index & 0xFFFF)
    streams = torch.arange(n_nbr + 1, dtype=torch.int64, device=dev)
    x, y, z, w = _block(key, 2 * streams, n, tag)
    lanes = [gumbel(z), gumbel(w)]
    if k > 2:
        x2, y2, _, _ = _block(key, 2 * streams + 1, n, tag)
        lanes += [gumbel(x2), gumbel(y2)]
    return (offset(x[:n_nbr], radius), offset(y[:n_nbr], radius),
            torch.stack(lanes[:k], dim=1))
