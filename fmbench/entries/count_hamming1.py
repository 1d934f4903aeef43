"""Hamming <= 1 counts: ``SearchEngine.count(mismatches=1)``, host uint8
reads [B, L] to host uint32 counts [B] (each read and its 3L substitutions as
search lanes), on the index the program builds on the card."""

from __future__ import annotations

import numpy as np
import torch

from fmbench.entries.search import FULL, build, wrong_rows  # noqa: F401  (build: the same engine)


def call(engine, reads: np.ndarray):
    return engine.count(reads, mismatches=1)


def as_program(counts: torch.Tensor) -> np.ndarray:
    return (counts & FULL).cpu().numpy().astype(np.uint32)


def expected(ref, reads: torch.Tensor, config: dict, traffic: dict) -> np.ndarray:
    return as_program(ref.counts_hamming1(reads))


def control(ref, reads: torch.Tensor, config: dict, traffic: dict) -> np.ndarray:
    """The reference with the substitutions left out: exact counts."""
    return as_program(ref.counts(reads))


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """Reads whose count differs from the reference's."""
    return {"counts_wrong": wrong_rows(got, want)}
