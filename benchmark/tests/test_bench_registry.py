"""The harness finds a configuration, a traffic mix, an entry and a
per-layer metric by name: a dummy of each, added as new files and new
entries of BENCHMARK.json in a copy of the benchmark, runs with no
edit to any file that was there."""

import argparse
import importlib.util
import json
import os
import shutil
import sys

from benchmark import run

DUMMY_ENTRY = '''
import time


class Entry:
    unit = "batch"

    def __init__(self, cfg, mix, seed, device):
        self.n = mix["items"] * cfg["knobs"]["scale"]
        self.calls = []

    def call(self):
        self.calls.append({"t0": time.perf_counter(),
                           "t1": time.perf_counter()})
        time.sleep(0.01)
        return self.n

    def warm(self):
        self.call()

    def close(self):
        return 0

    def release(self):
        pass

    def check(self):
        return {"attempted": len(self.calls), "failed": 0,
                "numbers": [("dummy_wrong", 0, 0)]}
'''

DUMMY_METRIC = '''
def read(ctx):
    return float(len(ctx.window_calls))
'''


def test_a_dummy_cell_is_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.dirname(run.HERE) + "/benchmark",
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              map(str, (root / "benchmark").rglob("*")) if os.path.isfile(p)}
    b = root / "benchmark"
    (b / "entries" / "dummy_entry.py").write_text(DUMMY_ENTRY)
    (b / "metrics" / "dummy.calls.py").write_text(DUMMY_METRIC)
    (b / "configs" / "dummy_config.json").write_text(json.dumps(
        {"entry": "dummy_entry", "knobs": {"scale": 3}}))
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps({"items": 5}))
    spec["configs"].append({"name": "dummy_config", "source": "x",
                            "file": "benchmark/configs/dummy_config.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "dummy", "moves": "rx_samples_per_s",
                              "workloads": ["dummy_cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    # the copy's run.py, loaded from its own file: ROOT is the copy
    spec_ = importlib.util.spec_from_file_location(
        "copied_run", str(b / "run.py"))
    mod = importlib.util.module_from_spec(spec_)
    sys.path.insert(0, str(root))
    try:
        spec_.loader.exec_module(mod)
        assert mod.ROOT == str(root)
        for trace in (0, 1):
            args = argparse.Namespace(workload="dummy_cell", seed=3,
                                      seconds=0.2, trace=trace)
            res, numbers, _w = mod.run(args, device="cpu",
                                       require_card=False)
            assert res["correct"] is True and numbers == [
                ("dummy_wrong", 0, 0)]
            if trace:
                assert set(res["metrics"]) == {"dummy.calls"}
                assert res["metrics"]["dummy.calls"]["value"] >= 1
            else:
                rate = res["metrics"]["rx_samples_per_s"]["value"]
                assert 0 < rate <= 15 / 0.01
    finally:
        sys.path.remove(str(root))
    # the files that were there are unchanged
    for p, data in before.items():
        assert open(p, "rb").read() == data
