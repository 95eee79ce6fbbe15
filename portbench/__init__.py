"""The benchmark of the PyTorch and CUDA port, `tensoralloy_tpu_torch`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell of BENCHMARK.json names its
configuration (`configs/<name>.json`, which names its descriptor family)
and its traffic (`traffic/<name>.json`, which names its driver,
`drivers/<kind>.py`); the driver takes the family's plain reference
from `reference/<family>.py` and its frozen work counts from
`work/<family>.py`; every metric is read by `metrics/<name>.py`.
"""
