"""Class-conditional generators: BigGAN sampling (BASELINE config 5)."""

from .biggan import BigGAN, biggan128, biggan256, sample  # noqa: F401
