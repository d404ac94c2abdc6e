"""Packaging (reference capability: setup.py:1-43)."""

import os
import re

from setuptools import find_packages, setup

here = os.path.abspath(os.path.dirname(__file__))
about = {}
with open(os.path.join(here, 'pretorched_tpu', '__version__.py')) as f:
    exec(f.read(), about)

setup(
    name=about['__title__'],
    version=about['__version__'],
    description=about['__description__'],
    url=about['__url__'],
    author=about['__author__'],
    license=about['__license__'],
    packages=find_packages(exclude=('tests', 'examples')),
    # the PyTorch port builds its CUDA kernels from these at first use
    package_data={'pretorched_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                          'native/*.cpp']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'optax', 'numpy', 'Pillow',
    ],
    extras_require={
        'convert': ['torch'],          # PyTorch checkpoint conversion
        'datasets': ['scikit-learn', 'tqdm'],
    },
    classifiers=[
        'Programming Language :: Python :: 3',
        'License :: OSI Approved :: MIT License',
    ],
)
