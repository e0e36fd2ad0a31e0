from setuptools import find_packages, setup

setup(
    name="score_tpu",
    version="0.1.0",
    description=(
        "TPU-native range-aided SLAM initialization via second-order cone "
        "programming (JAX/XLA/Pallas)"
    ),
    packages=find_packages(exclude=("tests", "examples")),
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    # the PyTorch/CUDA port (score_tpu_torch) needs torch, and nvcc on the
    # machine with the card to build its band kernels at first use
    extras_require={"torch": ["torch"]},
    package_data={
        "score_tpu": ["py.typed"],
        "score_tpu_torch": ["ops/csrc/*.cu"],
    },
)
