"""Package build (reference analog: /root/reference/setup.py).

The native IO runtime (csrc/) is built by `make build` and shipped as
package data; collectives need no native code on TPU (XLA owns them).
"""

from setuptools import find_packages, setup

setup(
    name="easyparallellibrary-tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework: replicate/"
                 "split annotations over a GSPMD mesh with pipeline, "
                 "tensor, expert and sequence parallelism"),
    packages=find_packages(exclude=("tests",)),
    package_data={"easyparallellibrary_tpu": ["lib/*.so"],
                  "easyparallellibrary_tpu_torch": ["kernels/csrc/*.cu",
                                                   "kernels/csrc/*.cuh",
                                                   "kernels/flash_block_table.json",
                                                   "perf_budget.json",
                                                   "analysis/baseline.json"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    entry_points={
        "console_scripts": [
            "epl-tpu-launch = easyparallellibrary_tpu.utils.launcher:main",
        ],
    },
)
