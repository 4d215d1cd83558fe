"""Packaging (reference ``setup.py:1-6`` analog)."""

from setuptools import find_packages, setup

setup(
    name="predict_pv_yield_tpu",
    version="0.1.0",
    description="TPU-native solar PV / GSP nowcasting framework (JAX/XLA/Pallas)",
    packages=find_packages(exclude=("tests", "tests.*")),
    # the PyTorch port builds its CUDA kernels from these sources at first use
    package_data={"predict_pv_yield_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "pandas",
        "pyyaml",
        "einops",
    ],
    extras_require={
        "torch": ["torch"],
        "plots": ["matplotlib"],
        "sweeps": ["optuna"],
    },
)
