"""On the card: the control at each cell's own size (the reference in
bfloat16 in the port's place) is refused on three seeds. Run there as

    python3 -m pytest benchmark/tests/test_bench_card.py -m gpu -q
"""

import pytest
import torch

from benchmark import control

SEEDS = (3200000001, 3200000002, 3200000003)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["batch_mixed_512", "fleet32_busy",
                                      "fleet32_beacons"])
def test_the_control_is_refused_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in SEEDS:
        got = control.readings(workload, seed, torch.bfloat16,
                               torch.device("cuda"))
        assert got["wrong_frames"] > 0, got
