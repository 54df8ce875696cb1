"""Soft-decision Viterbi decoder for the 802.11 K=7 code: the trellis
tables and the per-step-renormalized scan decoder (counterpart of
ziria_tpu/ops/viterbi.py).

State = the 6 most recent input bits, newest in the MSB. Soft input is
LLR-like, positive = bit more likely 1; punctured positions carry 0.
The scan decoder here is what the SIGNAL field decode runs (24 steps,
a Python loop over batched ops, as the reference's ``lax.scan`` is not
a kernel). The long DATA trellis goes through the CUDA kernels of
``ops/viterbi_cuda.py`` instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ziria_tpu_torch.ops.coding import G0, G1

N_STATES = 64


def _edge_tables():
    """For each next-state t and decision d in {0,1}: predecessor state
    and the two coded output bits on that edge (as +-1 floats)."""
    pred = np.zeros((N_STATES, 2), np.int32)
    out_a = np.zeros((N_STATES, 2), np.float32)
    out_b = np.zeros((N_STATES, 2), np.float32)
    for t in range(N_STATES):
        b = t >> 5                     # input bit of any edge into t
        for d in range(2):             # d = low bit of the predecessor
            s = ((t & 31) << 1) | d
            pred[t, d] = s
            window = [b] + [(s >> (5 - i)) & 1 for i in range(6)]
            a = sum(g * w for g, w in zip(G0, window)) % 2
            bb = sum(g * w for g, w in zip(G1, window)) % 2
            out_a[t, d] = 2.0 * a - 1.0
            out_b[t, d] = 2.0 * bb - 1.0
    return pred, out_a, out_b


_PRED, _OUT_A, _OUT_B = _edge_tables()
NEG = -1e30


def viterbi_decode(llrs: torch.Tensor, n_bits: int = None) -> torch.Tensor:
    """Decode a batch of soft streams: llrs (B, T, 2) or (B, 2T) float
    -> (B, T) uint8 bits (or the first `n_bits`).

    Same semantics as the reference's scan: state 0 starts at metric 0
    and the rest at -1e30, a decision picks predecessor-low-bit 1 only
    when its candidate is strictly larger, metrics are renormalized
    every step, and the traceback starts at the first argmax."""
    x = llrs.to(torch.float32)
    if x.dim() == 2:
        x = x.reshape(x.shape[0], -1, 2)
    B, T = x.shape[0], x.shape[1]
    dev = x.device
    pred = torch.from_numpy(_PRED.astype(np.int64)).to(dev)     # (64, 2)
    out_a = torch.from_numpy(_OUT_A).to(dev)
    out_b = torch.from_numpy(_OUT_B).to(dev)
    m = torch.full((B, N_STATES), NEG, dtype=torch.float32, device=dev)
    m[:, 0] = 0.0
    decisions = torch.empty((B, T, N_STATES), dtype=torch.int64,
                            device=dev)
    for t in range(T):
        la = x[:, t, 0][:, None, None]
        lb = x[:, t, 1][:, None, None]
        cand = m[:, pred] + out_a * la + out_b * lb              # (B, 64, 2)
        decisions[:, t] = torch.argmax(cand, dim=2)
        new = cand.amax(dim=2)
        m = new - new.amax(dim=1, keepdim=True)
    state = torch.argmax(m, dim=1)
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    for t in reversed(range(T)):
        bits[:, t] = (state >> 5).to(torch.uint8)
        d = decisions[:, t].gather(1, state[:, None])[:, 0]
        state = ((state & 31) << 1) | d
    return bits if n_bits is None else bits[:, :n_bits]
