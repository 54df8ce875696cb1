"""Harnesses that drive the port as a whole (counterpart of the repo's
``tools/``, which drives the JAX package).

Each of the repo's ``tools/*.py`` and the port's counterpart:

- ``soak.py``: :mod:`ziria_tpu_torch.tools.soak`, the chaos-soak
  campaign of the durable server with real process death
  (``python -m ziria_tpu_torch.tools.soak [--device cpu]``).
- ``windowed_ber.py``: :mod:`ziria_tpu_torch.tools.windowed_ber`, the
  windowed decoder's BER study at low SNR
  (``python -m ziria_tpu_torch.tools.windowed_ber [--device cpu]``).
- ``autotune.py``: the CLI's ``autotune`` subcommand
  (``python -m ziria_tpu_torch autotune``, ``utils/autotune.py``).
- ``trace_report.py``: none needed; it reads the port's traces as they
  are (``tests/test_torch_telemetry_trace.py``).
- ``calibrate_vect.py``: ``scripts/calibrate_vect.py``.
- ``hybrid_tpu_check.py``: the ``compiler`` phase of ``chip_smoke.py``
  (``wifi_rx.zir`` on the hybrid backend on the card).
- ``tpu_probe.py``, ``tpu_watcher.sh``, ``_bank.py`` and
  ``precommit.sh``'s TPU checks: none; they are plumbing of the TPU
  windows (probing, watching and banking a flaky TPU tunnel).
- ``perf_report.py``, ``rx_dispatch_bench.py`` and
  ``viterbi_batch_sweep.py``: none yet; they read or feed the JAX
  package's benchmark, and wait for the port's own.
- ``chaos_smoke.py``, ``durability_smoke.py``, ``serve_smoke.py`` and
  ``geometry_smoke.py``: none; each scenario of these stub canaries is
  a CPU test of the port (``ROADMAP.md`` names the test of each).
"""
