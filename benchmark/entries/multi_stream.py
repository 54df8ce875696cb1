"""Entry ``multi_stream``: the port's S-stream fleet,
``ziria_tpu_torch.backend.framebatch.MultiStreamReceiver``, driven in a
closed loop over seeded looped streams (traffic kind ``streams``). One
call is one ``push_many`` of ``stride`` (chunk_len - frame_len) new
samples a stream, which fires one chunk-step and drains the one before;
the next call is handed in when the last returns. The window closes
with ``drain_pending``."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark import check, generator

REF_FRAMES = 64           # emitted frames that the reference decodes
REF_MARGIN = 400          # samples of the stream before a frame's start


class Entry:
    unit = "step"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from ziria_tpu_torch.backend import framebatch

        knobs = dict(cfg["knobs"])
        self.device = device
        self.seed = seed
        self.loops, self.truth = generator.make_streams(mix, seed, device)
        self.loop = self.loops[0].shape[0]
        self.chunk = knobs["chunk_len"]
        self.stride = knobs["chunk_len"] - knobs["frame_len"]
        # each loop followed by its first `stride` samples: every slab
        # is one slice
        self.ext = [np.concatenate([x, x[:self.stride]]) for x in self.loops]
        self.msr = framebatch.MultiStreamReceiver(device=device, **knobs)
        self.n = len(self.loops)
        self.pos = 0
        self.calls: List[Dict] = []      # per call: t0, t1, frames

    def _emit(self, t0: float, pairs) -> None:
        self.calls.append({"t0": t0, "t1": time.perf_counter(),
                           "frames": list(pairs)})

    def call(self) -> int:
        """One chunk-step's slabs; returns the samples handed in."""
        p = self.pos % self.loop
        slabs = [e[p:p + self.stride] for e in self.ext]
        t0 = time.perf_counter()
        self._emit(t0, self.msr.push_many(slabs))
        self.pos += self.stride
        return self.n * self.stride

    def warm(self) -> None:
        # the first call only fills the carries; the next ones launch
        # and drain chunk-steps, until a decode has run
        while len(self.calls) < 4 or (
                not any(c["frames"] for c in self.calls)
                and len(self.calls) < 64):
            self.call()

    def close(self) -> int:
        t0 = time.perf_counter()
        self._emit(t0, self.msr.drain_pending())
        return 0

    def _truth_at(self, stream: int, start: int):
        r, s = divmod(start, self.loop)
        for fr in self.truth[stream]:
            if fr.start == s:
                return fr
        return None

    def latencies_s(self, calls: List[Dict]) -> List[float]:
        """Per frame that `calls` emitted: from the start of the call
        that handed in its last sample to the end of the call that
        emitted it."""
        out = []
        for c in calls:
            for i, f in c["frames"]:
                fr = self._truth_at(i, f.start)
                if fr is None:
                    continue
                last = f.start + fr.n_samples - 1
                out.append(c["t1"] - self.calls[last // self.stride]["t0"])
        return out

    def frame_lengths(self, calls: List[Dict]) -> List[int]:
        return [int(f.result.length_bytes) for c in calls
                for _i, f in c["frames"]]

    def release(self) -> None:
        self.msr = None

    def check(self) -> Dict:
        """Every emitted frame against the truth, every true frame that
        starts a chunk or more before the last sample handed in emitted
        exactly once (a fleet's carry holds less than a chunk); a seeded
        sample of emitted frames against the plain reference receiver."""
        seen: Dict = {}
        wrong = attempted = 0
        for c in self.calls:
            for i, f in c["frames"]:
                attempted += 1
                key = (i, int(f.start))
                fr = self._truth_at(i, f.start)
                if key in seen or fr is None \
                        or not check.same_result(f.result, fr):
                    wrong += 1
                seen[key] = f
        missing, due = 0, self.pos - self.chunk
        for i in range(self.n):
            for r in range(due // self.loop + 1):
                for fr in self.truth[i]:
                    if r * self.loop + fr.start < due \
                            and (i, r * self.loop + fr.start) not in seen:
                        missing += 1
        keys = sorted(k for k in seen if self._truth_at(*k) is not None)
        rng = np.random.default_rng([self.seed % (1 << 64), 1])
        picks = [keys[int(k)] for k in
                 rng.choice(len(keys), min(REF_FRAMES, len(keys)),
                            replace=False)] if keys else []
        windows, los = [], []
        for i, start in picks:
            fr = self._truth_at(i, start)
            lo = start % self.loop - REF_MARGIN     # may be < 0: the wrap
            p = lo % self.loop
            windows.append(self.ext[i][p:p + REF_MARGIN + fr.n_samples + 80])
            los.append(lo)
        ref = check.reference_frames(windows)
        mismatch = sum(
            not check.same_as_reference(seen[k].result, r,
                                        self._truth_at(*k), lo,
                                        seen[k].start % self.loop)
            for k, r, lo in zip(picks, ref, los))
        return {"attempted": attempted + missing, "failed": wrong + missing,
                "numbers": [("wrong_frames", wrong, 0),
                            ("missing_frames", missing, 0),
                            ("reference_mismatch", mismatch, 0),
                            ("reference_sample", len(picks), None)]}
