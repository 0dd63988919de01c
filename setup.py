"""Install: pip install -e .  (builds the native host-kit on first use)."""

from setuptools import find_packages, setup

setup(
    name="mm2-gb-tpu",
    version="0.1.0",
    description="Long-read mapper with mm2-gb GPU chaining in JAX",
    packages=find_packages(include=["mm2_gb_tpu", "mm2_gb_tpu.*"]),
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={"console_scripts": ["mm2-gb-tpu=mm2_gb_tpu.cli:main"]},
)
