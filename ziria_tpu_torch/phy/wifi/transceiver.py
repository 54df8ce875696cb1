"""Transceiver + MAC-lite: the closed TX<->RX loop (counterpart of
ziria_tpu/phy/wifi/transceiver.py).

Counterpart of the reference's `code/WiFi/transceiver/` (SURVEY.md §2.3:
the real-time loop coupling TX+RX over SORA/BladeRF hardware, with a
minimal MAC). No radio hardware here, so the "air" is an explicit
channel function and time is sample counts at 20 Msps; everything else
mirrors the reference's split:

- PHY: `tx.encode_frame` / `rx.receive` on the station's device (the
  card by default), `rx.receive(fxp=True)` for a fixed-point station;
- MAC-lite: a 4-byte header [type, seq, dst, src] + CRC32 FCS inside
  the PSDU; DATA frames are ACKed after SIFS; the sender retransmits on
  ACK timeout up to a retry limit (stop-and-wait ARQ, the shape of the
  reference's transceiver demo, not the full 802.11 DCF).

`Station` is a host-side state machine (send queue, pending-ACK timer,
dedup by sequence number); `run_link` steps two stations over a shared
channel. The PHY work runs on the device; the MAC logic is control
flow over a handful of scalars per frame, on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ziria_tpu_torch.ops.crc import append_crc32, check_crc32
from ziria_tpu_torch.phy.wifi import rx, tx
from ziria_tpu_torch.utils.bits import np_bits_to_bytes, np_bytes_to_bits

# MAC-lite frame types (first header byte)
TYPE_DATA = 0x08
TYPE_ACK = 0xD4

HDR_BYTES = 4          # [type, seq, dst, src]
FCS_BYTES = 4

SIFS_SAMPLES = 320     # 16 us at 20 Msps
ACK_RATE_MBPS = 6      # control frames go at the base rate
ACK_TIMEOUT = 8192     # samples the sender waits before retransmitting


def mac_frame_psdu(ftype: int, seq: int, dst: int, src: int,
                   payload: bytes = b"") -> np.ndarray:
    """Build the PSDU bytes: header + payload + CRC32 FCS (host
    arithmetic; the FCS through ops/crc on a CPU tensor)."""
    hdr = np.array([ftype & 0xFF, seq & 0xFF, dst & 0xFF, src & 0xFF],
                   np.uint8)
    body = np.concatenate([hdr, np.frombuffer(payload, np.uint8)])
    bits = append_crc32(torch.from_numpy(np_bytes_to_bits(body)))
    return np_bits_to_bytes(bits.numpy())


@dataclass
class MacFrame:
    ftype: int
    seq: int
    dst: int
    src: int
    payload: bytes

    @staticmethod
    def parse(psdu_bytes: np.ndarray) -> Optional["MacFrame"]:
        b = np.asarray(psdu_bytes, np.uint8)
        if b.size < HDR_BYTES + FCS_BYTES:
            return None
        if not bool(check_crc32(torch.from_numpy(np_bytes_to_bits(b)))):
            return None
        return MacFrame(int(b[0]), int(b[1]), int(b[2]), int(b[3]),
                        bytes(b[HDR_BYTES:-FCS_BYTES].tobytes()))


@dataclass
class _Pending:
    psdu: np.ndarray
    rate: int
    seq: int
    dst: int
    deadline: int
    tries: int


@dataclass
class Station:
    """Half-duplex stop-and-wait station.

    fxp=True receives through the Q15 integer interior
    (rx.receive(fxp=True), phy/wifi/rx_fxp.py): the MAC loop on the
    reference's fixed-point discipline. The PHY runs on `device` (the
    card by default)."""

    addr: int
    rate_mbps: int = 24
    max_tries: int = 4
    fxp: bool = False
    device: str = "cuda"
    now: int = 0                      # local clock, in samples
    delivered: List[Tuple[int, bytes]] = field(default_factory=list)
    acked: List[int] = field(default_factory=list)
    failed: List[int] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=lambda: {
        "tx_data": 0, "rx_data": 0, "tx_ack": 0, "rx_ack": 0,
        "retries": 0, "drops": 0, "dups": 0})
    _next_seq: int = 0
    _pending: Optional[_Pending] = None
    _last_rx_seq: Dict[int, int] = field(default_factory=dict)

    # ------------------------------------------------------------- sending

    def send(self, payload: bytes, dst: int) -> np.ndarray:
        """Queue a DATA frame; returns the samples to put on the air."""
        if self._pending is not None:
            raise RuntimeError("stop-and-wait: previous frame not yet "
                               "ACKed or failed")
        seq = self._next_seq
        self._next_seq = (self._next_seq + 1) & 0xFF
        psdu = mac_frame_psdu(TYPE_DATA, seq, dst, self.addr, payload)
        self.counters["tx_data"] += 1
        samples = self._emit(psdu, self.rate_mbps)
        # the ACK timer starts when the frame has LEFT the air (_emit
        # advanced the clock by the frame duration): anchoring it before
        # would expire mid-transmission for frames longer than the timeout
        self._pending = _Pending(psdu, self.rate_mbps, seq, dst,
                                 self.now + ACK_TIMEOUT, 1)
        return samples

    def poll(self) -> Optional[np.ndarray]:
        """Clock tick: retransmit if the ACK timer expired; returns
        samples to transmit, or None."""
        p = self._pending
        if p is None or self.now < p.deadline:
            return None
        if p.tries >= self.max_tries:
            self.failed.append(p.seq)
            self.counters["drops"] += 1
            self._pending = None
            return None
        p.tries += 1
        self.counters["retries"] += 1
        self.counters["tx_data"] += 1
        samples = self._emit(p.psdu, p.rate)
        p.deadline = self.now + ACK_TIMEOUT   # timer from end of transmit
        return samples

    # ----------------------------------------------------------- receiving

    def on_air(self, samples: np.ndarray) -> Optional[np.ndarray]:
        """Process received samples; returns response samples (an ACK
        after a SIFS of silence) or None."""
        self.now += int(np.asarray(samples).shape[0])
        res = rx.receive(samples, check_fcs=False, fxp=self.fxp,
                         device=self.device)
        if not res.ok:
            return None
        fr = MacFrame.parse(np_bits_to_bytes(res.psdu_bits))
        if fr is None or fr.dst != self.addr:
            return None
        if fr.ftype == TYPE_ACK:
            p = self._pending
            if p is not None and fr.seq == p.seq and fr.src == p.dst:
                self.acked.append(p.seq)
                self.counters["rx_ack"] += 1
                self._pending = None
            return None
        if fr.ftype == TYPE_DATA:
            self.counters["rx_data"] += 1
            if self._last_rx_seq.get(fr.src) == fr.seq:
                self.counters["dups"] += 1     # retransmit of a frame we
            else:                              # ACKed: re-ACK, don't
                self._last_rx_seq[fr.src] = fr.seq   # re-deliver
                self.delivered.append((fr.src, fr.payload))
            ack = mac_frame_psdu(TYPE_ACK, fr.seq, fr.src, self.addr)
            self.counters["tx_ack"] += 1
            sifs = np.zeros((SIFS_SAMPLES, 2), np.float32)
            return np.concatenate(
                [sifs, self._emit(ack, ACK_RATE_MBPS)], axis=0)
        return None

    def _emit(self, psdu: np.ndarray, rate: int) -> np.ndarray:
        samples = tx.encode_frame(psdu, rate, device=self.device) \
            .cpu().numpy()
        self.now += samples.shape[0]
        return samples


# --------------------------------------------------------------------------
# Link driver
# --------------------------------------------------------------------------


Channel = Callable[[np.ndarray, int], np.ndarray]  # (samples, k) -> samples


def perfect_channel(samples: np.ndarray, _k: int) -> np.ndarray:
    return samples


def run_link(a: Station, b: Station, payloads: List[bytes],
             channel: Channel = perfect_channel,
             max_steps: int = 64) -> None:
    """Send `payloads` from `a` to `b` over `channel` with stop-and-wait
    ARQ. The channel sees every transmission (indexed by k) and may
    corrupt/attenuate it: dropped frames exercise the retransmit path.
    """
    k = 0
    for payload in payloads:
        on_air = a.send(payload, b.addr)
        for _ in range(max_steps):
            # propagate A -> B; B may answer (ACK after SIFS)
            reply = b.on_air(channel(on_air, k))
            k += 1
            if reply is not None:
                a.on_air(channel(reply, k))
                k += 1
            if a._pending is None:       # ACKed or given up
                break
            a.now = max(a.now, a._pending.deadline)  # timeout advance
            nxt = a.poll()
            if nxt is None:
                break                    # retry limit hit
            on_air = nxt
        if a._pending is not None:
            # step budget exhausted with the frame still in flight: fail
            # it explicitly so the next send() isn't poisoned and the
            # outcome is visible in failed/drops
            a.failed.append(a._pending.seq)
            a.counters["drops"] += 1
            a._pending = None
