"""The frozen work counts against hand-worked values."""

from benchmark import roofline


def test_counts_equal_hand_worked_values():
    # 64 steps: 64 states x 6 operations a step, one renorm of 2 x 64
    assert roofline.acs_ops_to([64]) == 64 * 384 + 128 == 24704
    assert roofline.acs_ops_to([64, 10]) == 74 * 384 + 128
    # decisions 8 B a step, metrics 64 x 4 B, bits 1 B a step in and out
    assert roofline.traceback_work(2, 10) == (160 + 512 + 20, 2 * 103)
    # a 1000-byte frame: 16 + 8000 + 6 steps
    assert roofline.frame_steps(1000) == 8022
    ops, nbytes = roofline.trellis_work([1000])
    assert ops == 8022 * 384 + (8022 // 64) * 128 + 8022 * 4 + 63 == 3128599
    assert nbytes == 8022 * 9 == 72198
    t, by = roofline.least_seconds(ops, nbytes)
    assert by == "operations" and t == ops / 67.0e12
    t, by = roofline.least_seconds(1, 3.35e12)
    assert by == "bytes" and t == 1.0
