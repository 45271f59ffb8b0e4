"""PyTorch/CUDA port of the learned image-compression engine.

The JAX package ``simple_image_compression_network_tpu`` beside this one is
the reference; this package reproduces its bit-exact int8 and wavelet
codecs, its scale- and mean-scale-hyperprior codecs (float32 and bf16) and
its evaluation harness on an NVIDIA H100.  Every TPU (Pallas)
kernel on those paths has a CUDA C++ counterpart under ``csrc/`` with a
plain PyTorch version beside its wrapper.
This package imports ``torch``, ``numpy`` and the standard library only.
"""

from . import config  # noqa: F401

__version__ = "0.1.0"
