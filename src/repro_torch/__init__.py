"""PyTorch/CUDA port of the in-DRAM shifting reproduction.

Mirrors the module paths of the JAX package ``repro`` (the reference) and
imports nothing of it. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; row tensors are int32 bit patterns of the
reference's uint32 words.
"""
