"""The benchmark of tyrant_tpu_torch: ``python3 perfbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (see ``run.py``)."""
