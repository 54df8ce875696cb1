"""The one traffic generator of the benchmark. It reads a traffic mix,
a data file ``benchmark/traffic/<mix>.json``, and makes the mix's inputs
and their truth from ``--seed`` with the frozen transmitter and channel
of ``benchmark/reference/``. It imports nothing of the port.

Two shapes of traffic, by the file's ``kind``:

- ``captures``: a pool of ``pool`` batches of ``captures`` captures, each
  one frame after a random lead within ``lead``, then ``tail`` samples;
  CFO uniform within ``cfo``, noise at ``snr_db``.
- ``streams``: ``streams`` looped streams of ``loop_samples`` samples,
  each a run of frames placed from ``first_start`` on, ``spacing`` apart
  start to start, as many as fit (or ``frames_per_loop``) with
  ``reserve`` samples from each start inside the loop (so the spacing
  across the loop's end is at least ``reserve``); stream i at CFO
  ``cfo_spread * (i - (S - 1) / 2) / (S / 2)``; noise at ``snr_db``. A
  stream is replayed end to end, so its truth repeats with the loop's
  period.

Frame rates come from ``rates``: ``"cycle"`` takes the eight rates in
turn, frame j of stream (or capture) i at rate ``(i + j) % 8``; a list
draws from the list. PSDU lengths (FCS included) are uniform over the
inclusive range ``psdu_bytes``. Distinct frames are encoded once, in
batches of one rate and length, and placed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference import channel, tx

@dataclass
class Frame:
    """One frame of the truth: where it starts (in its capture or its
    loop), its rate, its PSDU (FCS included) and its sample count."""
    start: int
    mbps: int
    psdu: np.ndarray

    @property
    def n_samples(self) -> int:
        return tx.frame_samples(self.psdu.size, self.mbps)

    @property
    def bits(self) -> np.ndarray:
        return tx.bits_of(self.psdu)


def _rate(mix, rng, i: int, j: int) -> int:
    rates = mix["rates"]
    if rates == "cycle":
        return tx.RATE_ORDER[(i + j) % 8]
    return int(rates[int(rng.integers(0, len(rates)))])


def _encode(plan: List[Tuple[int, int, np.ndarray]]) -> Dict[int, np.ndarray]:
    """plan: (key, mbps, psdu) -> {key: complex128 frame samples},
    encoded in batches of one rate and length."""
    groups: Dict[Tuple[int, int], List] = {}
    for key, mbps, psdu in plan:
        groups.setdefault((mbps, psdu.size), []).append((key, psdu))
    out = {}
    for (mbps, _n), items in groups.items():
        frames = tx.encode_frames(np.stack([p for _k, p in items]), mbps)
        for (key, _p), fr in zip(items, frames):
            out[key] = fr
    return out


def _psdu(mix, rng) -> np.ndarray:
    lo, hi = mix["psdu_bytes"]
    n = int(rng.integers(lo, hi + 1))
    return tx.with_fcs(rng.integers(0, 256, (1, n - 4)).astype(np.uint8))[0]


def _torch_gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_captures(mix: Dict, seed: int, device):
    """Returns (pool: list of batches, each a list of (n, 2) float32
    arrays; truth: the same shape of Frame lists)."""
    rng = np.random.default_rng(seed % (1 << 64))
    gen = _torch_gen(seed, device)
    n_cap = mix["captures"]
    plan, meta = [], []
    for b in range(mix["pool"]):
        for i in range(n_cap):
            mbps = _rate(mix, rng, i, 0)
            psdu = _psdu(mix, rng)
            lead = int(rng.integers(mix["lead"][0], mix["lead"][1]))
            eps = float(rng.uniform(mix["cfo"][0], mix["cfo"][1]))
            plan.append(((b, i), mbps, psdu))
            meta.append(((b, i), mbps, psdu, lead, eps))
    frames = _encode(plan)
    pool, truth = [], []
    for b in range(mix["pool"]):
        rows = meta[b * n_cap:(b + 1) * n_cap]
        lens = [lead + frames[k].size + mix["tail"]
                for k, _m, _p, lead, _e in rows]
        z = np.zeros((n_cap, max(lens)), np.complex128)
        for r, (k, _m, _p, lead, _e) in enumerate(rows):
            z[r, lead:lead + frames[k].size] = frames[k]
        eps = torch.tensor([e for *_x, e in rows], device=device)
        x = channel.impair(torch.as_tensor(z, device=device), eps,
                           mix["snr_db"], gen).cpu().numpy()
        pool.append([x[r, :lens[r]].copy() for r in range(n_cap)])
        truth.append([Frame(lead, m, p) for _k, m, p, lead, _e in rows])
    return pool, truth


def make_streams(mix: Dict, seed: int, device):
    """Returns (loops: list of (loop_samples, 2) float32 arrays; truth:
    per stream the list of Frames of one loop, by start)."""
    rng = np.random.default_rng(seed % (1 << 64))
    gen = _torch_gen(seed, device)
    n_s, loop = mix["streams"], mix["loop_samples"]
    plan, placed = [], []
    for i in range(n_s):
        pos = int(rng.integers(mix["first_start"][0],
                               mix["first_start"][1] + 1))
        frames: List[Frame] = []
        while len(frames) < mix.get("frames_per_loop", 1 << 30):
            mbps = _rate(mix, rng, i, len(frames))
            psdu = _psdu(mix, rng)
            fr = Frame(pos, mbps, psdu)
            if pos + max(fr.n_samples, mix["reserve"]) > loop:
                break
            plan.append(((i, len(frames)), mbps, psdu))
            frames.append(fr)
            pos += int(rng.integers(mix["spacing"][0], mix["spacing"][1] + 1))
        placed.append(frames)
    samples = _encode(plan)
    loops = []
    for i, frames in enumerate(placed):
        z = np.zeros((1, loop), np.complex128)
        for j, fr in enumerate(frames):
            z[0, fr.start:fr.start + fr.n_samples] = samples[(i, j)]
        eps = torch.tensor([mix["cfo_spread"] * (i - (n_s - 1) / 2)
                            / (n_s / 2)], device=device)
        loops.append(channel.impair(torch.as_tensor(z, device=device), eps,
                                    mix["snr_db"], gen)[0].cpu().numpy())
    return loops, placed
