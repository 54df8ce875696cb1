"""Entry ``receive_many``: the port's capture-batch receiver,
``ziria_tpu_torch.backend.framebatch.receive_many``, driven in a closed
loop over a seeded pool of capture batches (traffic kind ``captures``).
One call is one batch; the next is handed in when the last returns."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark import check, generator

REF_PER_RATE = 8          # captures a rate that the reference decodes


class Entry:
    unit = "batch"

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from ziria_tpu_torch.backend import framebatch

        self.receive_many = framebatch.receive_many
        self.knobs = dict(cfg["knobs"])
        self.device = device
        self.seed = seed
        self.pool, self.truth = generator.make_captures(mix, seed, device)
        self.samples = [sum(c.shape[0] for c in b) for b in self.pool]
        self.calls: List[Dict] = []      # per call: batch, t0, t1, results

    def call(self) -> int:
        """One batch through the receiver; returns its samples."""
        b = len(self.calls) % len(self.pool)
        t0 = time.perf_counter()
        res = self.receive_many(self.pool[b], device=self.device,
                                **self.knobs)
        self.calls.append({"batch": b, "t0": t0, "t1": time.perf_counter(),
                           "results": res})
        return self.samples[b]

    def warm(self) -> None:
        for _ in self.pool:
            self.call()

    def close(self) -> int:
        return 0

    def frame_lengths(self, calls: List[Dict]) -> List[int]:
        """PSDU lengths of the frames that `calls` decoded."""
        return [fr.psdu.size for c in calls for fr in self.truth[c["batch"]]]

    def release(self) -> None:
        self.receive_many = None

    def check(self) -> Dict:
        """Every result of every call against the truth; a seeded sample
        of captures against the plain reference receiver."""
        wrong = attempted = 0
        last = {}
        for c in self.calls:
            got = list(c["results"])
            for i, fr in enumerate(self.truth[c["batch"]]):
                res = got[i] if i < len(got) else None
                attempted += 1
                wrong += not check.same_result(res, fr)
                last[(c["batch"], i)] = res
        rng = np.random.default_rng([self.seed % (1 << 64), 1])
        by_rate: Dict[int, List] = {}
        for b, frames in enumerate(self.truth):
            for i, fr in enumerate(frames):
                by_rate.setdefault(fr.mbps, []).append((b, i))
        picks = []
        for keys in by_rate.values():
            sel = rng.choice(len(keys), min(REF_PER_RATE, len(keys)),
                             replace=False)
            picks += [keys[int(k)] for k in sel if keys[int(k)] in last]
        ref = check.reference_frames(
            [self.pool[b][i] for b, i in picks])
        mismatch = sum(
            not check.same_as_reference(last[k], r, self.truth[k[0]][k[1]])
            for k, r in zip(picks, ref))
        return {"attempted": attempted, "failed": wrong,
                "numbers": [("wrong_frames", wrong, 0),
                            ("reference_mismatch", mismatch, 0),
                            ("reference_sample", len(picks), None)]}
