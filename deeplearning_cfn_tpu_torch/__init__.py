"""deeplearning_cfn_tpu_torch — the PyTorch/CUDA port of deeplearning_cfn_tpu.

A second package beside the JAX one, laid out file for file like it so each
module's counterpart sits at the same relative path. It imports torch,
numpy and the standard library only — never jax, flax or the JAX package.
Its entry points run on the CUDA card unless the caller asks for the CPU
(``--accelerator cpu`` / ``device="cpu"``); the hand-written kernels live
under ``csrc/`` and are built at first use (``kernels.py``).

Slice 1 ports the NMT serving path: config/presets, the flash-attention
forward kernel, the Transformer NMT model, the offline decoders, the weight
bridge from Flax checkpoints, and the continuous-batching serve engine with
its loader and ``serve`` CLI verb.
"""

__version__ = "0.1.0"
