"""PyTorch/CUDA port of fangyan_tts_tpu for NVIDIA Hopper (sm_90a).

The package mirrors the JAX package's module names so each counterpart is
easy to find. It imports torch and numpy only: never jax, flax or
fangyan_tts_tpu. Entry points run on CUDA unless the caller passes
``device="cpu"``; the CPU path exists for the tests, which hold each module
against its JAX counterpart.
"""

__version__ = "0.1.0"
