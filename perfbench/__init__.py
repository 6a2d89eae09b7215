"""The training benchmark of ``easyparallellibrary_tpu_torch`` on one
H100: ``python3 -m perfbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` (``perfbench/run.py``)."""
