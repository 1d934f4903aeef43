"""Text and reads from the seed.

The pattern of ``generate_reads`` (tpufm_torch/host/seqio.py), copied so that
the yardstick does not move with the program: a text of i.i.d. uniform 2-bit
codes, and reads that are substrings of it at uniform start positions, each base
of a read substituted (code + 1..3 mod 4) with a per-base error rate, as a read
simulator such as wgsim draws sequencing errors. Everything is drawn on the
device the run uses, with a ``torch.Generator`` seeded from ``--seed`` through
``numpy.random.SeedSequence`` (one stream per purpose), so the same seed gives
the same text and reads.
"""

from __future__ import annotations

import numpy as np
import torch

#: stream tags under one run's seed
TEXT, READS, KEEP = 1, 2, 3


def stream_seed(seed: int, tag: int) -> int:
    """A 64-bit seed for stream ``tag`` of run ``seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1, np.uint64)[0])


def generator(seed: int, tag: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, tag))
    return g


def make_text(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """uint8 [n] i.i.d. uniform codes 0..3 (A, C, G, T) on ``device``."""
    return torch.randint(0, 4, (n,), dtype=torch.uint8, device=device, generator=generator(seed, TEXT, device))


def make_reads(text: torch.Tensor, length: int, num: int, g: torch.Generator,
               substitution_rate: float = 0.0) -> torch.Tensor:
    """uint8 [num, length] reads of ``text`` (on its device) at uniform starts,
    each base substituted by one of the other three codes, uniformly, with
    probability ``substitution_rate`` (none by default), independently."""
    n = text.shape[0]
    if length > n:
        raise ValueError(f"read length {length} exceeds the text's {n} bases")
    if not 0.0 <= substitution_rate < 1.0:
        raise ValueError(f"substitution rate {substitution_rate} is not in [0, 1)")
    dev = text.device
    starts = torch.randint(0, n - length + 1, (num,), device=dev, generator=g)
    reads = text.unfold(0, length, 1)[starts]
    if substitution_rate > 0:
        hit = torch.rand((num, length), device=dev, generator=g) < substitution_rate
        off = torch.randint(1, 4, (num, length), dtype=torch.uint8, device=dev, generator=g)
        reads = torch.where(hit, (reads + off) & 3, reads)
    return reads


def make_pool(text: torch.Tensor, traffic: dict, seed: int) -> list[np.ndarray]:
    """The traffic's pool of distinct batches, host uint8 [batch_reads,
    read_len] each (pageable numpy, as a pipeline holds its reads)."""
    g = generator(seed, READS, text.device)
    return [
        make_reads(text, traffic["read_len"], traffic["batch_reads"], g,
                   traffic.get("substitution_rate", 0.0)).cpu().numpy()
        for _ in range(traffic["pool_batches"])
    ]
