"""The benchmark of ``grayscott_jl_tpu_torch`` on NVIDIA cards.

``python3 -m gsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. The
harness is driven by data: a cell is ``workloads/<cell>.toml`` over
``configs/<config>.toml``, and each per-layer metric is a reader in
``metrics/<metric>.py``. Nothing here imports JAX or the JAX package.
"""
