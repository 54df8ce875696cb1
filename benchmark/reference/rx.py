"""The plain reference receiver of the benchmark: 802.11a captures in,
frames out, written in plain PyTorch at a dtype of the caller's choice.

It works out again, from the samples alone, what the port derives:
the frame's start (the long training symbols' cross-correlation peak),
the CFO (the phase between the two long symbols), the channel (their
mean FFT), the SIGNAL field (BPSK, rate 1/2), and the DATA field (FFT,
zero-forcing equalization, pilot phase tracking, max-log demapping,
deinterleaving, depuncturing, a 64-state Viterbi decoder ending in state
0, the descrambler seeded from the SERVICE bits) and the FCS. It shares
no code with the port: the tables come from the frozen transmitter
beside it (``reference/tx.py``), which was frozen from the port's
``phy/wifi/tx.py`` and ``ops/`` at commit 33779fc. Every floating
operation runs at ``dtype``: float32 is the reference, bfloat16 the
control that the comparison has to refuse.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.reference import tx

LTS_AT = 192          # the first long training symbol, from the start


def _pair(x: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.stack([x.real, x.imag], -1), device=device) \
        .to(dtype)


class Receiver:
    """The reference at one dtype and device; tables built once."""

    def __init__(self, dtype=torch.float32, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        lts = np.conj(tx.lts_time())
        w = np.zeros((2, 2, 64))
        # out0 = re(x * conj(l)), out1 = im(x * conj(l)), x = (re, im)
        w[0, 0], w[0, 1] = lts.real, -lts.imag
        w[1, 0], w[1, 1] = lts.imag, lts.real
        self.lts_w = torch.as_tensor(w, device=self.device).to(dtype)
        k = np.arange(64)
        dft = np.exp(-2j * np.pi * np.outer(k, k) / 64)      # Y = x @ dft
        self.dft = _pair(dft, dtype, self.device)            # (64, 64, 2)
        self.lts_sign = torch.as_tensor(
            np.fft.ifftshift(np.concatenate([[0] * 6, tx.LTS_FREQ,
                                             [0] * 5])),
            device=self.device).to(dtype)
        self.data_bins = torch.as_tensor(tx.DATA_BINS, device=self.device)
        self.pilot_bins = torch.as_tensor(tx.PILOT_BINS, device=self.device)
        self.pilot_vals = torch.as_tensor(tx.PILOT_VALS,
                                          device=self.device).to(dtype)
        self.polarity = torch.as_tensor(tx.PILOT_POLARITY,
                                        device=self.device).to(dtype)
        # trellis: state = last six inputs, newest in bit 0; the next
        # state s' has predecessors s' >> 1 and (s' >> 1) | 32, input s' & 1
        s = np.arange(64)
        self.prev = [torch.as_tensor((s >> 1) | (32 * m), device=self.device)
                     for m in (0, 1)]
        signs = []
        for m in (0, 1):
            reg = np.zeros((64, 7), np.int64)
            reg[:, 0] = s & 1                           # x[k]
            pred = (s >> 1) | (32 * m)
            for d in range(1, 7):
                reg[:, d] = (pred >> (d - 1)) & 1       # x[k - d]
            a = (reg * tx.G0).sum(1) % 2
            b = (reg * tx.G1).sum(1) % 2
            signs.append(torch.as_tensor(np.stack([2 * a - 1, 2 * b - 1], 1),
                                         device=self.device).to(dtype))
        self.signs = signs                              # (64, 2) each

    # ------------------------------------------------------------ front

    def _fft(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 64, 2) -> (..., 64, 2) DFT at the receiver's dtype."""
        wr, wi = self.dft[..., 0], self.dft[..., 1]
        xr, xi = x[..., 0], x[..., 1]
        return torch.stack([xr @ wr - xi @ wi, xr @ wi + xi @ wr], -1)

    @staticmethod
    def _mul(a, b):
        return torch.stack([a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1],
                            a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]],
                           -1)

    @staticmethod
    def _mulconj(a, b):
        return torch.stack([a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1],
                            a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]],
                           -1)

    def _derotated(self, x, p, eps, offs):
        """Samples x[f, p_f + offs] rotated by -eps_f * offs: (F, n, 2)."""
        idx = (p[:, None] + offs[None, :]).clamp(0, x.shape[1] - 1)
        seg = torch.gather(x, 1, idx[..., None].expand(-1, -1, 2))
        ph = -eps[:, None] * offs.to(self.dtype)[None, :]
        rot = torch.stack([torch.cos(ph), torch.sin(ph)], -1)
        return self._mul(seg, rot)

    def _symbols(self, x, p, eps, h, first, n_sym, index0):
        """Equalized, pilot-corrected data subcarriers of `n_sym` OFDM
        symbols from `first` (offset from p) and their gains: ((F, n_sym,
        48, 2), (F, 1, 48))."""
        offs = (first + 16 + torch.arange(n_sym * 80, device=self.device)
                .reshape(n_sym, 80)[:, :64]).reshape(-1)
        seg = self._derotated(x, p, eps, offs).reshape(
            x.shape[0], n_sym, 64, 2)
        y = self._fft(seg)
        g = h[..., 0] ** 2 + h[..., 1] ** 2                       # (F, 64)
        eq = self._mulconj(y, h[:, None]) / g[:, None, :, None]
        pol = self.polarity[(torch.arange(n_sym, device=self.device)
                             + index0) % 127]
        want = self.pilot_vals[None, :] * pol[:, None]            # (S, 4)
        c = (eq[:, :, self.pilot_bins] * want[None, :, :, None]).sum(2)
        mag = torch.sqrt(c[..., 0] ** 2 + c[..., 1] ** 2) + 1e-30
        rot = torch.stack([c[..., 0] / mag, -c[..., 1] / mag], -1)
        eq = self._mul(eq, rot[:, :, None])
        return eq[:, :, self.data_bins], g[:, None, self.data_bins]

    @staticmethod
    def _demap(z, gain, n_bpsc):
        """(F, S, 48, 2) symbols -> (F, S, 48 * n_bpsc) soft bits,
        positive for 1, the max-log distances on the integer grid."""
        a = z / float(tx.KMOD[n_bpsc])
        i, q = a[..., 0], a[..., 1]
        if n_bpsc == 1:
            soft = [i]
        elif n_bpsc == 2:
            soft = [i, q]
        elif n_bpsc == 4:
            soft = [i, 2 - i.abs(), q, 2 - q.abs()]
        else:
            soft = [i, 4 - i.abs(), 2 - (i.abs() - 4).abs(),
                    q, 4 - q.abs(), 2 - (q.abs() - 4).abs()]
        s = torch.stack(soft, -1) * gain[..., None]
        return s.reshape(s.shape[0], s.shape[1], -1)

    def _soft_bits(self, z, gain, mbps):
        """One rate's symbols -> depunctured soft pairs (F, n_bits, 2)."""
        n_bpsc, n_cbps, _n_dbps, coding, _ = tx.RATES[mbps]
        soft = self._demap(z, gain, n_bpsc)
        perm = torch.as_tensor(tx.interleave_perm(n_cbps, n_bpsc),
                               device=self.device)
        deint = torch.empty_like(soft)
        deint[..., perm] = soft
        keep = tx.PUNCTURE_KEEP[coding]
        f = soft.shape[0]
        kept = deint.reshape(f, -1, int(keep.sum()))
        full = torch.zeros((f, kept.shape[1], keep.size), dtype=self.dtype,
                           device=self.device)
        full[:, :, torch.as_tensor(np.flatnonzero(keep),
                                   device=self.device)] = kept
        return full.reshape(f, -1, 2)

    # ----------------------------------------------------------- viterbi

    def viterbi(self, soft: torch.Tensor, ends: torch.Tensor) -> np.ndarray:
        """Soft pairs (F, T, 2), positive for 1, each frame's bits ending
        in state 0 at step ends[f] -> decoded bits (F, T) uint8 (past a
        frame's end: 0)."""
        f, t_max, _ = soft.shape
        big = torch.tensor(-1e4, dtype=self.dtype, device=self.device)
        m = torch.full((f, 64), -1e4, dtype=self.dtype, device=self.device)
        m[:, 0] = 0
        dec = torch.empty((t_max, f, 64), dtype=torch.bool,
                          device=self.device)
        p0, p1 = self.prev
        s0, s1 = self.signs
        for t in range(t_max):
            llr = soft[:, t]                                  # (F, 2)
            c0 = m[:, p0] + llr @ s0.T
            c1 = m[:, p1] + llr @ s1.T
            d = c1 > c0
            dec[t] = d
            m = torch.where(d, c1, c0)
            m = torch.maximum(m - m.max(1, keepdim=True).values, big)
        state = torch.zeros(f, dtype=torch.long, device=self.device)
        bits = torch.zeros((f, t_max), dtype=torch.uint8, device=self.device)
        rows = torch.arange(f, device=self.device)
        for t in range(t_max - 1, -1, -1):
            live = t < ends
            b = dec[t, rows, state].long()
            bits[:, t] = torch.where(live, state & 1, 0).to(torch.uint8)
            state = torch.where(live, (state >> 1) | (b << 5), state)
        return bits.cpu().numpy()

    # ------------------------------------------------------------ frames

    def receive(self, captures: Sequence[np.ndarray]) -> List[Dict]:
        """Captures ((n, 2) float pairs, each holding one frame) -> one
        dict a capture: start, ok, rate_mbps, length_bytes, psdu_bits,
        crc_ok."""
        f = len(captures)
        n_max = max(c.shape[0] for c in captures)
        host = np.zeros((f, n_max + 64, 2), np.float32)
        for i, c in enumerate(captures):
            host[i, :c.shape[0]] = c
        x = torch.as_tensor(host, device=self.device).to(self.dtype)
        corr = torch.nn.functional.conv1d(x.transpose(1, 2), self.lts_w)
        mag = corr[:, 0] ** 2 + corr[:, 1] ** 2
        score = mag[:, :-64] + mag[:, 64:]
        p = score.argmax(1)
        lts = self._derotated(x, p, torch.zeros(f, dtype=self.dtype,
                                                device=self.device),
                              torch.arange(128, device=self.device))
        c = self._mulconj(lts[:, 64:], lts[:, :64]).sum(1)
        eps = torch.atan2(c[:, 1], c[:, 0]) / 64
        both = self._fft(self._derotated(
            x, p, eps, torch.arange(128, device=self.device)
        ).reshape(f, 2, 64, 2))
        h = (both[:, 0] + both[:, 1]) / 2 * self.lts_sign[None, :, None]
        sig, g = self._symbols(x, p, eps, h, 128, 1, 0)
        sig_soft = self._demap(sig, g, 1)[:, 0]
        perm = torch.as_tensor(tx.interleave_perm(48, 1), device=self.device)
        deint = torch.empty_like(sig_soft)
        deint[:, perm] = sig_soft
        sig_bits = self.viterbi(deint.reshape(f, 24, 2),
                                torch.full((f,), 24, device=self.device))
        starts = (p - LTS_AT).cpu().numpy()
        out = []
        for i in range(f):
            b = sig_bits[i]
            rate_code = int(b[0]) << 3 | int(b[1]) << 2 | int(b[2]) << 1 \
                | int(b[3])
            length = int(sum(int(b[5 + k]) << k for k in range(12)))
            mbps = tx.SIGNAL_TO_MBPS.get(rate_code, 0)
            ok = (mbps > 0 and int(b[:18].sum()) % 2 == 0 and length > 0
                  and starts[i] >= 0 and starts[i]
                  + tx.frame_samples(length, mbps) <= captures[i].shape[0])
            out.append({"start": int(starts[i]), "ok": bool(ok),
                        "rate_mbps": mbps if ok else 0,
                        "length_bytes": length if ok else 0,
                        "psdu_bits": np.zeros(0, np.uint8), "crc_ok": None})
        live = [i for i in range(f) if out[i]["ok"]]
        if not live:
            return out
        # DATA: every rate's front, then one Viterbi over all frames
        n_bits = {i: tx.n_symbols(out[i]["length_bytes"], out[i]["rate_mbps"])
                  * tx.RATES[out[i]["rate_mbps"]][2] for i in live}
        t_max = max(n_bits.values())
        soft = torch.zeros((len(live), t_max, 2), dtype=self.dtype,
                           device=self.device)
        row = {i: r for r, i in enumerate(live)}
        for mbps in tx.RATE_ORDER:
            grp = [i for i in live if out[i]["rate_mbps"] == mbps]
            if not grp:
                continue
            n_sym = max(tx.n_symbols(out[i]["length_bytes"], mbps)
                        for i in grp)
            sel = torch.as_tensor(grp, device=self.device)
            z, gain = self._symbols(x[sel], p[sel], eps[sel], h[sel], 208,
                                    n_sym, 1)
            pairs = self._soft_bits(z, gain, mbps)
            for j, i in enumerate(grp):
                soft[row[i], :n_bits[i]] = pairs[j, :n_bits[i]]
        # the encoder is back in state 0 after the tail bits (the pad
        # bits after them are scrambled)
        ends = torch.as_tensor([tx.N_SERVICE + 8 * out[i]["length_bytes"]
                                + tx.N_TAIL for i in live],
                               device=self.device)
        bits = self.viterbi(soft, ends)
        for r, i in enumerate(live):
            n = out[i]["length_bytes"]
            clear = descramble(bits[r, :tx.N_SERVICE + 8 * n])
            psdu = clear[tx.N_SERVICE:]
            out[i]["psdu_bits"] = psdu
            out[i]["crc_ok"] = fcs_ok(psdu)
        return out


def descramble(bits: np.ndarray) -> np.ndarray:
    """Undo the scrambler: its state is the first seven bits (the
    SERVICE field's first seven bits are zero before scrambling)."""
    seq = list(bits[:7].astype(np.int64))
    while len(seq) < 127:
        seq.append(seq[-7] ^ seq[-4])
    full = np.tile(np.array(seq, np.uint8), -(-bits.size // 127))[:bits.size]
    return bits ^ full


def fcs_ok(psdu_bits: np.ndarray) -> bool:
    """True iff the last 32 bits are the CRC-32 of the rest."""
    if psdu_bits.size < 40:
        return False
    data = np.packbits(psdu_bits, bitorder="little").tobytes()
    return zlib.crc32(data[:-4]).to_bytes(4, "little") == data[-4:]
