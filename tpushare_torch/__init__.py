"""PyTorch / CUDA port of the tpushare tenant workload, for NVIDIA Hopper.

Mirrors the layout of :mod:`tpushare` for the code that runs on the
accelerator (the flagship LM, its serving path and the flash-attention
forward) and the tenant half of the grant contract. It imports nothing
from :mod:`tpushare`; the JAX package stays the numerical reference.
"""
