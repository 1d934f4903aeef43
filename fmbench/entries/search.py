"""Exact search: ``SearchEngine.search``, host uint8 reads [B, L] to host
uint32 intervals [B, 2], on the index the program builds on the card."""

from __future__ import annotations

import time

import numpy as np
import torch

FULL = 0xFFFFFFFF


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_index(config: dict, text: np.ndarray, device: torch.device):
    """(the k-step index on the device, seconds of its build to a device barrier)."""
    from tpufm_torch.host.index import IndexConfig
    from tpufm_torch.index.builder_device import build_index_device

    t0 = time.perf_counter()
    index = build_index_device(text, IndexConfig(k=config["k"], d=config["d"]), return_host=False, device=device)
    sync(device)
    return index, time.perf_counter() - t0


def build(config: dict, traffic: dict, text: np.ndarray, device: torch.device):
    from tpufm_torch.engine.search import SearchEngine

    index, seconds = build_index(config, text, device)
    return SearchEngine(index, device, lut_m=config["lut_m"]), seconds


def call(engine, reads: np.ndarray):
    return engine.search(reads)


def as_program(iv: torch.Tensor) -> np.ndarray:
    return (iv & FULL).cpu().numpy().astype(np.uint32)


def expected(ref, reads: torch.Tensor, config: dict, traffic: dict) -> np.ndarray:
    return as_program(ref.intervals(reads))


def control(ref, reads: torch.Tensor, config: dict, traffic: dict) -> np.ndarray:
    """The reference with the read's last round (its first k bases) left out."""
    return as_program(ref.intervals(reads[:, config["k"]:]))


def wrong_rows(got, want: np.ndarray) -> int:
    """Reads whose answer in ``got`` differs from ``want`` (all of them
    where the shapes differ)."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return want.shape[0]
    return int((got != want).reshape(want.shape[0], -1).any(axis=1).sum())


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """Reads whose interval differs from the reference's."""
    return {"intervals_wrong": wrong_rows(got, want)}
