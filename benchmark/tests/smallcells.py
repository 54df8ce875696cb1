"""Each cell of BENCHMARK.json cut to a size that a CPU test run holds:
overrides of its traffic mix and configuration knobs."""

SMALL_FLEET = {"n_streams": 2, "chunk_len": 8192, "frame_len": 2048,
               "max_frames_per_chunk": 8, "check_fcs": True,
               "viterbi_metric": "float32", "viterbi_radix": 2,
               "sco_track": False, "fused_demap": True}

SMALL = {
    "batch_mixed_512": {
        "mix": {"captures": 8, "pool": 2, "psdu_bytes": [60, 60],
                "lead": [16, 400]}},
    "fleet32_busy": {
        "mix": {"streams": 2, "loop_samples": 65536, "psdu_bytes": [40, 40],
                "spacing": [2400, 2700], "reserve": 2700},
        "config": {"knobs": SMALL_FLEET}},
    "fleet32_beacons": {
        "mix": {"streams": 2, "loop_samples": 65536, "psdu_bytes": [40, 60],
                "first_start": [0, 60000], "reserve": 3000},
        "config": {"knobs": SMALL_FLEET}},
}
